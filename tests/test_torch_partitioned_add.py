"""The partitioned blocked add's two paths, in their CPU model, against the
JAX package, and the rule that picks them.

``sbf.add_partitioned_model`` is the shared path in plain PyTorch: one CTA
a segment, ORing into its copy of the segment each valid slot at its word
offset ``(block * s) mod seg_words`` and writing the copy back where a key
touched it. It runs here on the JAX package's own ``partition_host``
output, at several segment counts, and is held exactly (np.uint32
words, tolerance 0) against ``repro.kernels.ref.bloom_add_ref``: an OR does
not depend on the order of the keys, so it gives the partitioned words
(the JAX package's partitioned Pallas kernel uses ``pl.load``, which jax
0.9 no longer has). A slot bucketed into a foreign segment lands at its
offset inside the segment that holds it, as the TPU kernel puts it; its
expected words come from the JAX package's hash and masks
(``ref.hash_block_masks_ref``). ``choose_partitioned_path`` and
``partitioned_plan`` are pure functions. The
CUDA kernels are held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import partition as JP
from repro.core import variants as JV
from repro.kernels import ref as JR
from repro_torch.core import variants as TV
from repro_torch.kernels import sbf

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

M = 1 << 15
SMEM = 231296                  # the H100's shared memory a CTA, less salts
SPECS = {"sbf": dict(k=8, block_bits=256), "csbf": dict(k=8, block_bits=512,
                                                        z=2),
         "rbbf": dict(k=4)}
KEYS = JH.random_u64x2(2000, seed=11)


def _specs(variant):
    return (JV.FilterSpec(variant, M, **SPECS[variant]),
            TV.FilterSpec(variant, M, **SPECS[variant]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("variant", sorted(SPECS))
@pytest.mark.parametrize("n_seg", [1, 8, 32])
def test_shared_path_matches_jax(variant, n_seg):
    js, ts = _specs(variant)
    want = np.asarray(JR.bloom_add_ref(js, JV.init(js), jnp.asarray(KEYS)))
    jk, jv, _ = JP.partition_host(js, KEYS, n_seg)
    got = sbf.add_partitioned_model(ts, TV.init(ts), _t(jk),
                                    torch.from_numpy(jv))
    np.testing.assert_array_equal(_u32(got), want)
    # into words already set: each segment starts from its own copy
    base = _t(want ^ np.uint32(0x10001))
    got = sbf.add_partitioned_model(ts, base, _t(jk), torch.from_numpy(jv))
    np.testing.assert_array_equal(_u32(got), want | (want ^ 0x10001))
    np.testing.assert_array_equal(_u32(base), want ^ np.uint32(0x10001))
    # the plain version on the same slots
    np.testing.assert_array_equal(_u32(sbf.add_partitioned_plain(
        ts, TV.init(ts), _t(jk), torch.from_numpy(jv))), want)


@pytest.mark.parametrize("n_seg", [8, 16, 32, 64])
def test_foreign_slot_and_empty_segment(n_seg):
    """A slot held by a segment other than its own ORs its mask at its
    block's offset inside the holding segment; a segment whose slots are
    all invalid is left as it was."""
    js, ts = _specs("sbf")
    keys = KEYS[:400]
    jk, jv, _ = JP.partition_host(js, keys, n_seg)
    jk, jv = jk.copy(), jv.copy()
    seg_words = ts.n_words // n_seg
    jv[5] = 0                                   # segment 5: all invalid
    own = jk[jv != 0]                           # the keys in their segments
    foreign = KEYS[1999]
    fseg = int(np.asarray(JP.segment_ids(js, jnp.asarray(foreign[None]),
                                         n_seg))[0])
    owner = next(i for i in (fseg + 3, fseg + 4) if i % n_seg != 5) % n_seg
    slot = int(np.argmax(jv[owner] == 0))       # a free slot of `owner`
    jk[owner, slot] = foreign
    jv[owner, slot] = 1
    want = np.asarray(JR.bloom_add_ref(js, JV.init(js), jnp.asarray(own)))
    # the foreign key's mask at its offset inside segment `owner`
    blk, masks = JR.hash_block_masks_ref(js, jnp.asarray(foreign[None]))
    off = (int(blk[0]) * ts.s) % seg_words
    rows = want.reshape(-1, ts.s).copy()
    rows[(owner * seg_words + off) // ts.s] |= np.asarray(
        masks[0]).astype(np.uint32)
    want = rows.reshape(-1)
    got = sbf.add_partitioned_model(ts, TV.init(ts), _t(jk),
                                    torch.from_numpy(jv))
    np.testing.assert_array_equal(_u32(got), want)
    assert not _u32(got)[5 * seg_words:6 * seg_words].any()
    np.testing.assert_array_equal(_u32(sbf.add_partitioned_plain(
        ts, TV.init(ts), _t(jk), torch.from_numpy(jv))), want)


def test_choose_partitioned_path_is_a_pure_rule():
    # a filter in L2: shared for segments of at most 32 KiB, else global
    assert sbf.choose_partitioned_path(2048, 2048, 16384, SMEM,
                                       True) == "shared"
    assert sbf.choose_partitioned_path(512, 8192, 16384, SMEM,
                                       True) == "shared"
    assert sbf.choose_partitioned_path(256, 16384, 16384, SMEM,
                                       True) == "global"
    # past L2: global at every count, the fitting one included
    for n_seg, seg_words in ((8, 1 << 24), (4096, 32768), (65536, 2048)):
        assert sbf.choose_partitioned_path(n_seg, seg_words, 1024, SMEM,
                                           False) == "global"
    # no shared memory (a budget of 0), or a segment not of 16-byte vectors
    assert sbf.choose_partitioned_path(4096, 2048, 16384, 0,
                                       True) == "global"
    assert sbf.choose_partitioned_path(64, 2, 8, SMEM, True) == "global"
    for args in ((0, 32768, 8, SMEM, False), (8, 0, 8, SMEM, False)):
        with pytest.raises(ValueError):
            sbf.choose_partitioned_path(*args)
    # the same inputs, the same answer
    assert len({sbf.choose_partitioned_path(512, 1 << 12, 4096, SMEM, True)
                for _ in range(3)}) == 1


def test_partitioned_plan():
    _, ts = _specs("sbf")
    plan = sbf.partitioned_plan(ts, 8, 512, "shared")
    assert plan == {"path": "shared", "n_segments": 8, "capacity": 512,
                    "theta": 0, "ctas": 8}
    plan = sbf.partitioned_plan(ts, 8, 512, "global")
    assert plan["ctas"] == 16
    assert plan["theta"] == sbf.card_layout(ts, "add").theta == ts.s
    with pytest.raises(ValueError, match="path"):
        sbf.partitioned_plan(ts, 8, 512, "other")
    with pytest.raises(ValueError, match="16-byte"):
        sbf.partitioned_plan(ts, ts.n_words // 2, 512, "shared")
    with pytest.raises(ValueError, match="path"):
        sbf.add_partitioned(ts, TV.init(ts), _t(np.zeros((8, 8, 2),
                                                         np.uint32)),
                            torch.zeros((8, 8), dtype=torch.uint8), 8,
                            path="atomics")
