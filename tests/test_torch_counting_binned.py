"""The counting update's binned schedule
(``countingbf.update_binned_model``, the CPU model of the card's binned
update) against ``repro``, its path rule, plan and workspace cap, and the
contains' card rule.

The JAX side is ``repro.core.variants.counting_add`` / ``counting_remove``
/ ``bank_counting_update``, the jnp oracles (the interpret-mode Pallas
kernels are slow): a saturating or guarded nibble update does not depend
on the order of the keys, so they give the binned counters exactly. Keys
come from numpy with a seed; counters are compared as np.uint32, exactly
(tolerance 0). The model groups each internal batch's valid keys by bin of
counter rows, walks each bin's keys in chunks, groups a chunk's keys by
row and applies each row's closed form once; tiny bins and chunks make a
row span many chunks, and an over-full bin's parts apply in reverse. The cases cover more than 15 increments of one
nibble in one call, removes at 15 and at 0, invalid slots, B = 128 and
256, several internal batches, and banks with uniform and skewed member
mixes. The rules (``choose_update_path``, ``card_layout``,
``contains_geometry``), ``update_plan`` and ``update_cap_for_memory`` are
checked as pure functions. The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import countingbf as TC
from repro_torch.kernels.sbf import DMA_DEPTHS, Layout

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

M = 1 << 15
N = 1500
B = 6                       # bank members
H100_SMEM = 231296          # the H100's opt-in shared memory less the salts
KEYS = JH.random_u64x2(N, seed=23)
# keys 1-2 times, and one key 20 more times: its nibbles pass 15
BATCH = np.concatenate([KEYS, KEYS[:300]] + [KEYS[:1]] * 20)
GONE = np.concatenate([KEYS[:600], JH.probe_u64x2(40, seed=3)])
RNG = np.random.default_rng(23)
VALID = (RNG.random(BATCH.shape[0]) > 0.3).astype(np.uint8)
UNIFORM = RNG.integers(0, B, BATCH.shape[0]).astype(np.int32)
SKEWED = np.where(RNG.random(BATCH.shape[0]) < 0.6, 0, UNIFORM).astype(
    np.int32)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _specs(k, block_bits, m=M):
    kw = dict(k=k, block_bits=block_bits)
    return (JV.FilterSpec("countingbf", m, **kw),
            TV.FilterSpec("countingbf", m, **kw))


@functools.lru_cache(maxsize=None)
def _jax_counters(k, block_bits):
    js, _ = _specs(k, block_bits)
    added = JV.counting_add(js, JV.init(js), jnp.asarray(BATCH))
    removed = JV.counting_remove(js, added, jnp.asarray(GONE))
    return np.asarray(added), np.asarray(removed)


@pytest.mark.parametrize("chunk", [7, TC.BINNED_CHUNK])
@pytest.mark.parametrize("bin_rows", [1, 16, 1 << 12])
@pytest.mark.parametrize("k, block_bits", [(8, 256), (4, 128)])
def test_binned_model_matches_jax(k, block_bits, bin_rows, chunk):
    """Add of a multiset (one key 21 times), then remove of present and
    absent keys, in bins of 1, 16 and all rows; counters equal to JAX's."""
    _, ts = _specs(k, block_bits)
    want, want_rm = _jax_counters(k, block_bits)
    got = TC.update_binned_model(ts, TV.init(ts), as_keys(BATCH), None,
                                 "add", bin_rows, chunk)
    np.testing.assert_array_equal(_u32(got), want)
    nib = (_u32(got)[:, None] >> (4 * np.arange(8))) & 15
    assert nib.max() == 15                                 # a nibble at 15
    got = TC.update_binned_model(ts, got, as_keys(GONE), None, "remove",
                                 bin_rows, chunk)
    np.testing.assert_array_equal(_u32(got), want_rm)


@pytest.mark.parametrize("cap", [1, 97, 1 << 26])
def test_binned_model_internal_batches(cap):
    """Internal batches of ``cap`` keys (one key a batch too) give the
    same counters: each batch's closed forms compose."""
    _, ts = _specs(8, 256)
    want, want_rm = _jax_counters(8, 256)
    got = TC.update_binned_model(ts, TV.init(ts), as_keys(BATCH), None,
                                 "add", 8, 5, cap=cap)
    np.testing.assert_array_equal(_u32(got), want)
    got = TC.update_binned_model(ts, got, as_keys(GONE), None, "remove", 8,
                                 5, cap=cap)
    np.testing.assert_array_equal(_u32(got), want_rm)


@pytest.mark.parametrize("chunk", [3, TC.BINNED_CHUNK])
def test_binned_model_saturation_and_sticky_fifteen(chunk):
    """Hundreds of increments of one nibble in one call, spread over many
    chunks, saturate at 15; a remove leaves a 15 at 15 and a 0 at 0. The
    batches have BATCH's and GONE's lengths, so JAX reuses its compiles."""
    js, ts = _specs(8, 256)
    hot = np.resize(KEYS[:3], BATCH.shape)                 # 3 keys, ~607x
    gone = np.concatenate([hot[:GONE.shape[0] - 40], KEYS[100:140]])
    got = TC.update_binned_model(ts, TV.init(ts), as_keys(hot), None, "add",
                                 2, chunk)
    want = JV.counting_add(js, JV.init(js), jnp.asarray(hot))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    rm = TC.update_binned_model(ts, got, as_keys(gone), None, "remove", 2,
                                chunk)
    np.testing.assert_array_equal(_u32(rm), np.asarray(JV.counting_remove(
        js, want, jnp.asarray(gone))))
    nib = (_u32(got)[:, None] >> (4 * np.arange(8))) & 15
    nib_rm = (_u32(rm)[:, None] >> (4 * np.arange(8))) & 15
    assert (nib == 15).sum() > 0 and (nib_rm == 15).sum() == (nib == 15).sum()
    assert ((nib == 0) <= (nib_rm == 0)).all()              # 0 floors


@pytest.mark.parametrize("op", TC.OPS)
def test_binned_model_skips_invalid_slots(op):
    """Keys whose valid byte is 0 are skipped: the counters are JAX's of
    the valid keys alone (a remove from JAX's counters of the batch)."""
    js, ts = _specs(8, 256)
    start, _ = _jax_counters(8, 256)
    base = (JV.init(js) if op == "add" else jnp.asarray(start.view(np.int32)))
    fn = JV.counting_add if op == "add" else JV.counting_remove
    want = fn(js, base, jnp.asarray(BATCH), jnp.asarray(VALID))
    got = TC.update_binned_model(
        ts, torch.from_numpy(np.asarray(base).view(np.int32).copy()),
        as_keys(BATCH), torch.from_numpy(VALID), op, 4, 11)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("k, block_bits", [(8, 256), (4, 128)])
def test_binned_model_bank_matches_jax(k, block_bits, skewed):
    """A bank of B members: each key's global row is member * n_blocks +
    block; bins cross member boundaries. Valid-masked add, then remove;
    counters equal to ``bank_counting_update``'s."""
    js, ts = _specs(k, block_bits, m=1 << 12)
    member = SKEWED if skewed else UNIFORM
    bank = jnp.zeros((B, js.storage_words), dtype=jnp.int32)
    want = JV.bank_counting_update(js, bank, jnp.asarray(BATCH),
                                   jnp.asarray(member), jnp.asarray(VALID),
                                   "add")
    want_rm = JV.bank_counting_update(js, want, jnp.asarray(BATCH[:900]),
                                      jnp.asarray(member[:900]), None,
                                      "remove")
    tbank = torch.zeros((B, ts.storage_words), dtype=torch.int32)
    got = TC.update_binned_model(ts, tbank, as_keys(BATCH),
                                 torch.from_numpy(VALID), "add", 3, 13,
                                 member=torch.from_numpy(member))
    assert got.shape == tbank.shape and not tbank.any()
    np.testing.assert_array_equal(_u32(got), np.asarray(want).view(np.uint32))
    got = TC.update_binned_model(ts, got, as_keys(BATCH[:900]), None,
                                 "remove", 3, 13,
                                 member=torch.from_numpy(member[:900]))
    np.testing.assert_array_equal(_u32(got),
                                  np.asarray(want_rm).view(np.uint32))


@pytest.mark.parametrize("part_chunks", [1, 3, 1 << 20])
def test_binned_model_parts_in_any_order(part_chunks):
    """A skewed bank in one bin of 5-key chunks: its chunks grouped in parts
    of 1 or 3 (applied last part first, as the card's parts run in any
    order) or in one part give the same counters as JAX's."""
    js, ts = _specs(8, 256, m=1 << 12)
    bank = jnp.zeros((B, js.storage_words), dtype=jnp.int32)
    want = JV.bank_counting_update(js, bank, jnp.asarray(BATCH),
                                   jnp.asarray(SKEWED), jnp.asarray(VALID),
                                   "add")
    got = TC.update_binned_model(
        ts, torch.zeros((B, ts.storage_words), dtype=torch.int32),
        as_keys(BATCH), torch.from_numpy(VALID), "add", B * ts.n_blocks, 5,
        member=torch.from_numpy(SKEWED), part_chunks=part_chunks)
    np.testing.assert_array_equal(_u32(got), np.asarray(want).view(np.uint32))


def test_model_leaves_input_and_refuses_bad_op():
    _, ts = _specs(8, 256)
    base = TV.init(ts)
    TC.update_binned_model(ts, base, as_keys(KEYS[:200]), None, "add", 4)
    assert not base.any()
    with pytest.raises(ValueError, match="op"):
        TC.update_binned_model(ts, base, as_keys(KEYS[:200]), None, "sub", 4)


def test_update_rule_is_pure_and_bins_large_batches():
    """A function of (n, counter words, row words, shared memory) alone.
    The cells' adds and removes (2^22 and 2^21 keys into 32 MiB of
    counters, 2^26 and 2^25 into 512 MiB) run binned; small batches, hot
    rows (a batch past the size's most keys) and a card without the shared
    memory run one-pass."""
    args = [(n, w, r, m) for n in (0, 1, 1 << 16, 1 << 20, 1 << 22, 1 << 26)
            for w in (1 << 12, 1 << 18, 1 << 23, 1 << 25, 1 << 27, 1 << 29)
            for r in (8, 32, 128) for m in (H100_SMEM, 0, 48 * 1024)]
    first = [TC.choose_update_path(*a) for a in args]
    assert first == [TC.choose_update_path(*a) for a in args]
    assert set(first) <= set(TC.UPDATE_PATHS)
    l2, dram = 1 << 23, 1 << 27
    for n in (1 << 22, 1 << 21):
        assert TC.choose_update_path(n, l2, 32, H100_SMEM) == "binned"
    for n in (1 << 26, 1 << 25):
        assert TC.choose_update_path(n, dram, 32, H100_SMEM) == "binned"
    assert TC.choose_update_path(1 << 16, dram, 32, H100_SMEM) == "one-pass"
    assert TC.choose_update_path(1 << 26, dram, 32, 0) == "one-pass"
    # 2^26 keys into 2^18 words (8192 rows): 8192 keys a row
    assert TC.choose_update_path(1 << 26, 1 << 18, 32, H100_SMEM) == "one-pass"
    for log2b, (least, most) in TC.BINNED_KEYS.items():
        words = 1 << (log2b - 2)
        assert TC.choose_update_path(least, words, 32, H100_SMEM) == "binned"
        assert TC.choose_update_path(least - 1, words, 32,
                                     H100_SMEM) == "one-pass"
        if most is not None:
            assert TC.choose_update_path(most, words, 32,
                                         H100_SMEM) == "binned"
            assert TC.choose_update_path(most + 1, words, 32,
                                         H100_SMEM) == "one-pass"
    top = max(TC.BINNED_KEYS)                   # larger counters: its entry
    assert TC.choose_update_path(TC.BINNED_KEYS[top][0], 1 << (top + 1), 32,
                                 H100_SMEM) == "binned"
    assert TC.choose_update_path(1 << 20, 1 << (min(TC.BINNED_KEYS) - 3), 32,
                                 H100_SMEM) == "one-pass"


def test_bin_rows_hold_about_a_chunk():
    """A bin's keys are about half an apply chunk at the batch's load (more
    than a quarter of one, at most half) where the kernels' limits (at most
    2^13 rows a bin, at most 8192 bins) do not decide."""
    for total in (1, 7, 1 << 10, 1 << 18, 1 << 22, 1 << 24):
        top = min(TC.MAX_BIN_ROW_BITS, (total - 1).bit_length())
        least = max(0, (total - 1).bit_length() - 13)
        for n in (1, 1 << 10, 1 << 16, 1 << 22, 1 << 26):
            b = TC.binned_bin_row_bits(total, n)
            assert least <= b <= top
            assert -(-total // (1 << b)) <= TC.MAX_BINS
            if least < b < top:
                assert (TC.BINNED_CHUNK / 4 < n * (1 << b) / total
                        <= TC.BINNED_CHUNK / 2)
    assert TC.binned_bin_row_bits(1 << 22, 1 << 26) == 9       # DRAM add
    assert TC.binned_bin_row_bits(1 << 22, 1 << 25) == 9       # DRAM remove
    assert TC.binned_bin_row_bits(1 << 18, 1 << 22) == 8       # L2 add
    assert TC.binned_fits(1 << 22, 9, H100_SMEM)
    assert not TC.binned_fits(1 << 22, 9, 1024)             # no histogram
    assert not TC.binned_fits(1 << 22, 8, H100_SMEM)        # 2^14 bins


def test_update_plan_and_workspace():
    _, ts = _specs(8, 256, m=1 << 30)                       # 512 MiB
    plan = TC.update_plan(ts, 1 << 26, "binned", chunks=132)
    assert plan["bin_row_bits"] == 9 and plan["n_bins"] == 8192
    assert plan["batches"] == 1 and plan["batch_keys"] == 1 << 26
    head = -(-(135 * 8192 + 1) // 8) * 8        # counts, starts, ends, parts
    slots = (1 << 26) + 3 * 132 * 8192
    assert plan["workspace_bytes"] == 4 * head + 8 * slots
    assert plan["split_parts"] == slots // TC.PART_SLOTS
    assert TC.update_plan(ts, TC.SPLIT_SLOTS // 2, "binned",
                          chunks=1)["split_parts"] == 0       # no bin can pass
    plan = TC.update_plan(ts, 1000, "binned", members=4, cap=300, chunks=2,
                          bin_row_bits=13)
    assert plan["total_rows"] == 4 * ts.n_blocks and plan["batches"] == 4
    assert plan["n_bins"] == 4 * ts.n_blocks >> 13
    one = TC.update_plan(ts, 1000, "one-pass")
    assert one["workspace_bytes"] == 0 and one["batches"] == 1
    assert one["column_scan"] is None
    assert TC.update_plan(ts, 0, "one-pass")["batches"] == 0
    with pytest.raises(ValueError, match="path"):
        TC.update_plan(ts, 10, "sorted")
    with pytest.raises(ValueError, match="batch"):
        TC.update_plan(ts, 10, "binned", cap=0)
    with pytest.raises(ValueError, match="bins"):
        TC.update_plan(ts, 10, "binned", bin_row_bits=2)    # 2^20 bins
    assert TC.binned_smem_bytes(10) == 4 * (1024 + 8192)


@pytest.mark.parametrize("log2b,log2n,bins,column_scan", [
    (20, 19, 128, "fused"), (23, 19, 128, "fused"), (24, 19, 128, "fused"),
    (23, 22, 1024, "fused"), (23, 23, 2048, "two"), (29, 26, 8192, "two")])
def test_column_scan_is_one_launch_for_few_bins(log2b, log2n, bins,
                                                column_scan):
    """The rule's binned calls near its smallest batches have at most
    COLUMN_SCAN_BINS bins: their count kernel does the column and scan."""
    _, ts = _specs(8, 256, m=(1 << log2b) * 2)       # 2^log2b counter bytes
    assert TC.choose_update_path(1 << log2n, ts.storage_words,
                                 ts.storage_words // ts.n_blocks,
                                 H100_SMEM) == "binned"
    plan = TC.update_plan(ts, 1 << log2n, "binned", chunks=132)
    assert plan["n_bins"] == bins and plan["column_scan"] == column_scan
    assert (plan["n_bins"] <= TC.COLUMN_SCAN_BINS) == (column_scan == "fused")


def test_workspace_cap_halves_until_it_fits():
    _, ts = _specs(8, 256, m=1 << 30)

    def ws(cap):
        return TC.update_plan(ts, 1 << 26, "binned", 1, 9, cap,
                              132)["workspace_bytes"]
    room = TC.WORKSPACE_MARGIN
    assert TC.update_cap_for_memory(ts, 1 << 26, 1, 9, 1 << 26, 132,
                                    room + ws(1 << 26)) == 1 << 26
    assert TC.update_cap_for_memory(ts, 1 << 26, 1, 9, 1 << 26, 132,
                                    room + ws(1 << 26) - 1) == 1 << 25
    assert TC.update_cap_for_memory(ts, 1 << 26, 1, 9, 1 << 26, 132,
                                    room + ws(1 << 20)) == 1 << 20
    with pytest.raises(MemoryError):
        TC.update_cap_for_memory(ts, 1 << 26, 1, 9, 1 << 26, 132,
                                 room + ws(1) - 1)


@pytest.mark.parametrize("block_bits", [32, 64, 128, 256, 512, 1024])
def test_contains_card_rule_and_geometry(block_bits):
    """card_layout gives Θ = s/2 lanes a key with 16-byte loads; the
    geometry clamps Θ to s, down to a power of two and up to s/8 (32
    counter words a lane), caps the load width at 4 words (4 at depth > 1)
    and the depth at 32 words a lane."""
    _, ts = _specs(max(1, block_bits // 32), block_bits)
    lay = TC.card_layout(ts)
    assert lay == Layout(max(1, ts.s // 2), 4)
    for theta in (1, 2, 3, 4, 8, 16, 32, 256):
        for phi in (1, 2, 4, 8, 128):
            for depth in DMA_DEPTHS:
                geo = TC.contains_geometry(ts, Layout(theta, phi), depth)
                least = max(1, ts.s // 8)              # 32 words a lane
                assert geo.theta & (geo.theta - 1) == 0
                assert geo.theta == max(least, min(theta, ts.s)) or (
                    geo.theta < min(theta, ts.s) < 2 * geo.theta)
                assert geo.words == 4 * ts.s // geo.theta
                assert geo.depth <= depth and geo.depth * geo.words <= 32 \
                    or geo.depth == 1
                assert geo.vec == (4 if geo.depth > 1 else min(phi, 4))
    deep = TC.contains_geometry(ts, lay, 8)
    assert deep.depth == (8 if ts.s == 1 else 4)   # 8 words a lane at s/2
    with pytest.raises(ValueError, match="depth"):
        TC.contains_geometry(ts, lay, 3)


def test_cpu_wrappers_run_plain_on_every_path():
    """On CPU tensors the update wrappers run the plain version whatever
    private path they are given, and launch nothing."""
    _, ts = _specs(8, 256)
    want, want_rm = _jax_counters(8, 256)
    TC.reset_launches()
    for path in (None, "one-pass", "binned"):
        words = TV.init(ts)
        assert TC.update_vmem(ts, words, as_keys(BATCH), None, "add",
                              path=path) is words
        np.testing.assert_array_equal(_u32(words), want)
        TC.update_hbm(ts, words, as_keys(GONE), None, "remove", path=path,
                      bin_row_bits=3, cap=5)
        np.testing.assert_array_equal(_u32(words), want_rm)
        bank = torch.zeros((1, ts.storage_words), dtype=torch.int32)
        TC.bank_update_vmem(ts, bank, as_keys(BATCH), torch.zeros(
            BATCH.shape[0], dtype=torch.int32), None, "add", path=path)
        np.testing.assert_array_equal(_u32(bank[0]), want)
    assert all(v == 0 for v in TC.LAUNCHES.values())
    with pytest.raises(ValueError, match="path"):
        TC.update_vmem(ts, TV.init(ts), as_keys(BATCH), None, "add",
                       path="grouped")
    with pytest.raises(ValueError, match="path"):
        TC.bank_update_vmem(ts, torch.zeros((1, ts.storage_words),
                                            dtype=torch.int32),
                            as_keys(BATCH), torch.zeros(BATCH.shape[0],
                                                        dtype=torch.int32),
                            None, "add", path="sorted")
