"""The partitioned counting update's grouped schedule
(``countingbf.update_partitioned_model``, the CPU model of the card's
grouped kernel) against ``repro``, and its path rule.

The JAX side is ``repro.core.variants.counting_add`` / ``counting_remove``,
as in ``tests/test_torch_partition.py``: the JAX package's partitioned
Pallas kernels use ``pl.load``, which jax 0.9 no longer has, and a
saturating or guarded nibble update does not depend on the order of the
keys, so its references give the partitioned counters exactly. Keys come
from numpy with a seed; counters are compared as np.uint32, exactly
(tolerance 0). The model walks each segment's slots in chunks, groups a
chunk's keys by row and applies each row's closed form once; tiny chunks
make a row span many chunks. The cases cover more than 15 increments of
one nibble in one call, removes at 15 and at 0, invalid slots, B = 128 and
256, and n_segments 1, 8 and 64. The path rule
(``countingbf.choose_partitioned_path``) is checked as a pure function.
The CUDA kernels are held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro_torch.api.filter import as_keys
from repro_torch.core import partition as TP
from repro_torch.core import variants as TV
from repro_torch.kernels import countingbf as TC

M = 1 << 15
N = 1500
H100_SMEM = 231296          # the H100's opt-in shared memory less the salts
KEYS = JH.random_u64x2(N, seed=17)
# keys 1-2 times, and one key 20 more times: its nibbles pass 15
BATCH = np.concatenate([KEYS, KEYS[:300]] + [KEYS[:1]] * 20)
GONE = np.concatenate([KEYS[:600], JH.probe_u64x2(40, seed=2)])
SLOTS = 4 * BATCH.shape[0] + 16 * 64         # the most slots _part gives


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _specs(k, block_bits):
    kw = dict(k=k, block_bits=block_bits)
    return (JV.FilterSpec("countingbf", M, **kw),
            TV.FilterSpec("countingbf", M, **kw))


@functools.lru_cache(maxsize=None)
def _jax_counters(k, block_bits):
    js, _ = _specs(k, block_bits)
    added = JV.counting_add(js, JV.init(js), jnp.asarray(BATCH))
    removed = JV.counting_remove(js, added, jnp.asarray(GONE))
    return np.asarray(added), np.asarray(removed)


def _part(ts, keys, n_seg):
    part = TP.partition_jit(ts, as_keys(keys), n_seg,
                            4 * keys.shape[0] // n_seg + 16)
    assert int(part.overflow) == 0
    return part


@pytest.mark.parametrize("chunk", [16, TC.GROUPED_CHUNK])
@pytest.mark.parametrize("n_seg", [1, 8, 64])
@pytest.mark.parametrize("k, block_bits", [(8, 256), (4, 128)])
def test_grouped_model_matches_jax(k, block_bits, n_seg, chunk):
    """Add of a multiset (one key 21 times), then remove of present and
    absent keys, each segment walked in chunks; counters equal to JAX's."""
    _, ts = _specs(k, block_bits)
    want, want_rm = _jax_counters(k, block_bits)
    part = _part(ts, BATCH, n_seg)
    got = TC.update_partitioned_model(ts, TV.init(ts), part.keys_by_seg,
                                      part.valid, "add", chunk)
    np.testing.assert_array_equal(_u32(got), want)
    assert (_u32(got) >> 28).max() == 15                   # a nibble at 15
    rpart = _part(ts, GONE, n_seg)
    got = TC.update_partitioned_model(ts, got, rpart.keys_by_seg,
                                      rpart.valid, "remove", chunk)
    np.testing.assert_array_equal(_u32(got), want_rm)


@pytest.mark.parametrize("chunk", [7, TC.GROUPED_CHUNK])
def test_grouped_model_saturation_and_sticky_fifteen(chunk):
    """Hundreds of increments of one nibble in one call, spread over many
    chunks, saturate at 15; a remove leaves a 15 at 15 and a 0 at 0. The
    batches have BATCH's and GONE's lengths, so JAX reuses its compiles."""
    js, ts = _specs(8, 256)
    hot = np.resize(KEYS[:3], BATCH.shape)                 # 3 keys, ~607x
    gone = np.concatenate([hot[:GONE.shape[0] - 40], KEYS[100:140]])
    part = _part(ts, hot, 8)
    got = TC.update_partitioned_model(ts, TV.init(ts), part.keys_by_seg,
                                      part.valid, "add", chunk)
    want = JV.counting_add(js, JV.init(js), jnp.asarray(hot))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    rpart = _part(ts, gone, 8)
    rm = TC.update_partitioned_model(ts, got, rpart.keys_by_seg, rpart.valid,
                                     "remove", chunk)
    np.testing.assert_array_equal(_u32(rm), np.asarray(JV.counting_remove(
        js, want, jnp.asarray(gone))))
    nib = (_u32(got)[:, None] >> (4 * np.arange(8))) & 15
    nib_rm = (_u32(rm)[:, None] >> (4 * np.arange(8))) & 15
    assert (nib == 15).sum() > 0 and (nib_rm == 15).sum() == (nib == 15).sum()
    assert ((nib == 0) <= (nib_rm == 0)).all()              # 0 floors


@pytest.mark.parametrize("n_seg", [1, 8, 64])
def test_grouped_model_skips_invalid_slots(n_seg):
    """Slots whose valid byte is 0 are skipped: the counters are JAX's of
    the valid slots' keys alone."""
    js, ts = _specs(8, 256)
    part = _part(ts, BATCH, n_seg)
    rng = np.random.default_rng(n_seg)
    valid = part.valid.clone()
    valid[torch.from_numpy(rng.random(valid.shape) < 0.3)] = 0
    # every slot, padded to one length (one JAX compile), valid-masked
    slots = np.zeros((SLOTS, 2), dtype=np.uint32)
    mask = np.zeros(SLOTS, dtype=np.uint8)
    slots[:valid.numel()] = part.keys_by_seg.reshape(-1, 2).numpy().view(
        np.uint32)
    mask[:valid.numel()] = valid.reshape(-1).numpy()
    want = JV.counting_add(js, JV.init(js), jnp.asarray(slots),
                           jnp.asarray(mask))
    got = TC.update_partitioned_model(ts, TV.init(ts), part.keys_by_seg,
                                      valid, "add", 32)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_model_leaves_input_and_refuses_partial_rows():
    _, ts = _specs(8, 256)
    part = _part(ts, KEYS[:200], 8)
    base = TV.init(ts)
    TC.update_partitioned_model(ts, base, part.keys_by_seg, part.valid,
                                "add")
    assert not base.any()
    with pytest.raises(ValueError, match="op"):
        TC.update_partitioned_model(ts, base, part.keys_by_seg, part.valid,
                                    "sub")
    wide = TV.FilterSpec("countingbf", M, 8, block_bits=1024)
    by_seg = torch.zeros((64, 4, 2), dtype=torch.int32)  # 64-word segments
    with pytest.raises(ValueError, match="whole rows"):  # of 128-word rows
        TC.update_partitioned_model(wide, TV.init(wide), by_seg,
                                    torch.zeros((64, 4), dtype=torch.uint8),
                                    "add")


def test_path_rule_is_pure_and_keeps_few_segments_global():
    """A function of (n_segments, counter words, row words, shared memory)
    alone. The countingbf cells (32 MiB and 512 MiB of counters, B = 256)
    run grouped at their fitting counts and global at JAX's default
    n_segments = 8; too few segments, rows past the histogram, segments
    that are not whole rows and a card without the shared memory run
    global."""
    args = [(s, w, r, m) for s in (1, 8, 64, 128, 256, 4096, 65536)
            for w in (1 << 12, 1 << 23, 1 << 27) for r in (8, 32, 128)
            for m in (H100_SMEM, 0, 48 * 1024)]
    first = [TC.choose_partitioned_path(*a) for a in args]
    assert first == [TC.choose_partitioned_path(*a) for a in args]
    assert set(first) <= set(TC.PARTITIONED_PATHS)
    l2, dram = 1 << 23, 1 << 27
    assert TC.choose_partitioned_path(256, l2, 32, H100_SMEM) == "grouped"
    assert TC.choose_partitioned_path(4096, dram, 32, H100_SMEM) == "grouped"
    assert TC.choose_partitioned_path(8, l2, 32, H100_SMEM) == "global"
    assert TC.choose_partitioned_path(8, dram, 32, H100_SMEM) == "global"
    least = TC.GROUPED_MIN_SEGMENTS
    assert TC.choose_partitioned_path(least, l2, 32, H100_SMEM) == "grouped"
    assert TC.choose_partitioned_path(least // 2, l2, 32,
                                      H100_SMEM) == "global"
    # 2^27 words in 1024 segments: 4096 rows, the most the rule takes; in
    # 512 segments 8192 rows, which the kernel takes but the rule does not
    assert TC.choose_partitioned_path(1024, dram, 32, H100_SMEM) == "grouped"
    assert TC.choose_partitioned_path(512, dram, 32, H100_SMEM) == "global"
    assert TC.grouped_fits(dram, 512, 32, H100_SMEM)
    assert TC.choose_partitioned_path(256, dram, 32, H100_SMEM) == "global"
    assert TC.choose_partitioned_path(256, l2, 32, 0) == "global"
    assert TC.choose_partitioned_path(256, l2 + 32 * 3, 32,
                                      H100_SMEM) == "global"
    assert TC.grouped_smem_bytes(8192) <= H100_SMEM
    assert not TC.grouped_fits(l2, 256, 32, TC.grouped_smem_bytes(1024) - 1)


def test_partitioned_plan():
    _, ts = _specs(8, 256)
    plan = TC.partitioned_plan(ts, 8, 1000, "grouped")
    assert plan == {"path": "grouped", "n_segments": 8, "capacity": 1000,
                    "rows": ts.n_blocks // 8, "chunks": 1, "ctas": 8}
    plan = TC.partitioned_plan(ts, 8, 10000, "global")
    assert plan["chunks"] == 0 and plan["ctas"] == -(-80000 // 512)
    big = TV.FilterSpec("countingbf", 1 << 30, 8, block_bits=256)
    with pytest.raises(ValueError, match="grouped"):
        TC.partitioned_plan(big, 8, 64, "grouped")          # 2^19 rows
    with pytest.raises(ValueError, match="path"):
        TC.partitioned_plan(ts, 8, 64, "shared")


def test_cpu_wrapper_runs_plain_on_every_path():
    """On CPU tensors the wrapper runs the plain version whatever private
    path it is given, and launches nothing."""
    _, ts = _specs(8, 256)
    want, _ = _jax_counters(8, 256)
    part = _part(ts, BATCH, 8)
    TC.reset_launches()
    for path in (None, "global", "grouped"):
        words = TV.init(ts)
        assert TC.update_partitioned(ts, words, part.keys_by_seg, part.valid,
                                     8, "add", path=path) is words
        np.testing.assert_array_equal(_u32(words), want)
    assert TC.LAUNCHES["update_partitioned"] == 0
    with pytest.raises(ValueError, match="path"):
        TC.update_partitioned(ts, TV.init(ts), part.keys_by_seg, part.valid,
                              8, "add", path="shared")
