"""Partitioned bulk updates of the PyTorch port against the JAX package, on
the CPU.

The same seeded numpy keys go through the JAX package and through
``repro_torch`` with CPU tensors, where every wrapper runs its plain
version:

* ``segment_ids``, ``partition_host`` and ``partition_jit`` (keys, valid
  mask, keep, overflow and rank) against ``repro.core.partition``;
* ``ops.bloom_add_partitioned`` against ``ref.bloom_add_ref`` (which the
  JAX package's own tests hold equal to ``V.add``; its jnp ``V.add`` takes
  seconds to compile a spec), and ``ops.counting_update_partitioned``
  against ``V.counting_add`` /
  ``V.counting_remove``, at n_segments 1/8/64, with the capacity escalated,
  pinned so that it overflows (the residual pass), and the host partition.
  The JAX package's partitioned Pallas kernels use ``pl.load``, which jax
  0.9 no longer has, so its references stand in: an OR and a saturating or
  guarded nibble update do not depend on the order of the keys, so they
  give the partitioned words exactly;
* the cached dispatch layer (``*_jit``): donation as an in-place update,
  ``donate=False`` leaving the input untouched, and the cache counted as
  the JAX package counts its executables.

Words are compared as np.uint32, exactly (tolerance 0). The CUDA kernels
are held against the plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import partition as JP
from repro.core import variants as JV
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.api.filter import as_keys
from repro_torch.core import partition as TP
from repro_torch.core import variants as TV
from repro_torch.kernels import countingbf as TC
from repro_torch.kernels import ops, sbf

M = 1 << 15
N = 3000
BIT_ARGS = {"sbf": dict(k=8), "csbf": dict(k=8, block_bits=512, z=2),
            "rbbf": dict(k=4), "bbf": dict(k=8)}
SEGMENTS = (1, 8, 64)


def _specs(variant, m=M, **kw):
    kw = {**BIT_ARGS.get(variant, {}), **kw}
    return JV.FilterSpec(variant, m, **kw), TV.FilterSpec(variant, m, **kw)


def _u32(t):
    return t.numpy().view(np.uint32)


KEYS = JH.random_u64x2(N, seed=5)
# the keys of KEYS whose block lies in segment 0 of 8 (of an M-bit sbf)
SKEWED = KEYS[np.asarray(JP.segment_ids(_specs("sbf")[0], jnp.asarray(KEYS),
                                        8)) == 0]


# ---------------------------------------------------------------------------
# The partition itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sbf", "csbf", "countingbf"])
def test_segment_ids_and_host_partition_match_jax(variant):
    js, ts = _specs(variant, k=8)
    u32_keys = KEYS[:, 1].copy()
    for n_seg in SEGMENTS:
        np.testing.assert_array_equal(
            TP.segment_ids(ts, as_keys(KEYS), n_seg).numpy(),
            np.asarray(JP.segment_ids(js, jnp.asarray(KEYS), n_seg)))
        np.testing.assert_array_equal(
            TP.segment_ids(ts, torch.from_numpy(u32_keys.view(np.int32)),
                           n_seg).numpy(),
            np.asarray(JP.segment_ids(js, jnp.asarray(u32_keys), n_seg)))
        jk, jv, jc = JP.partition_host(js, KEYS, n_seg)
        tk, tv, tc = TP.partition_host(ts, as_keys(KEYS), n_seg)
        assert tk.shape[1] % 8 == 0 and tk.shape[1] == jk.shape[1]
        np.testing.assert_array_equal(_u32(tk), jk)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(tc.numpy(), jc)
    with pytest.raises(ValueError, match="divide"):
        TP.segment_ids(ts, as_keys(KEYS), 3)


@pytest.mark.parametrize("n_seg", SEGMENTS)
@pytest.mark.parametrize("capacity", [8, 64, 4000])
def test_partition_jit_matches_jax(n_seg, capacity):
    js, ts = _specs("sbf")
    jp = JP.partition_jit(js, jnp.asarray(KEYS), n_seg, capacity)
    tp = TP.partition_jit(ts, as_keys(KEYS), n_seg, capacity)
    np.testing.assert_array_equal(_u32(tp.keys_by_seg),
                                  np.asarray(jp.keys_by_seg))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.keep.numpy(), np.asarray(jp.keep))
    np.testing.assert_array_equal(tp.rank.numpy(), np.asarray(jp.rank))
    assert int(tp.overflow) == int(jp.overflow) == N - int(tp.keep.sum())


def test_default_capacity_and_escalation_match_jax():
    for n, s in ((1, 8), (3000, 8), (3000, 64), (7, 1)):
        assert ops._default_capacity(n, s) == JO._default_capacity(n, s)
    js, ts = _specs("sbf")
    # every key in segment 0 of 8: 4x the mean overflows, so it escalates
    keys = SKEWED
    jp = JO._partition_device(js, jnp.asarray(keys), 8, None)
    tp = ops._partition_device(ts, as_keys(keys), 8, None)
    assert tp.keys_by_seg.shape == tuple(jp.keys_by_seg.shape)
    assert tp.keys_by_seg.shape[1] > ops._default_capacity(len(keys), 8)
    assert int(tp.overflow) == int(jp.overflow) == 0
    np.testing.assert_array_equal(_u32(tp.keys_by_seg),
                                  np.asarray(jp.keys_by_seg))
    pinned = ops._partition_device(ts, as_keys(keys), 8, 8)
    assert pinned.keys_by_seg.shape[1] == 8 and int(pinned.overflow) > 0


# ---------------------------------------------------------------------------
# Partitioned add and counting update against the JAX references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(BIT_ARGS))
def test_partitioned_add_matches_jax(variant):
    js, ts = _specs(variant)
    want = np.asarray(JR.bloom_add_ref(js, JV.init(js), jnp.asarray(KEYS)))
    for n_seg in SEGMENTS:
        if ts.n_blocks % n_seg:
            continue
        for capacity, partition in ((None, "jit"), (8, "jit"),
                                    (None, "host")):
            base = TV.init(ts)
            got = ops.bloom_add_partitioned(
                ts, base, as_keys(KEYS), n_segments=n_seg,
                capacity=capacity, partition=partition)
            np.testing.assert_array_equal(_u32(got), want)
            assert not base.any()                  # inplace=False
        # a batch in one segment: the default capacity escalates
        skew = KEYS[TP.segment_ids(ts, as_keys(KEYS), n_seg).numpy() == 0]
        got = ops.bloom_add_partitioned(ts, TV.init(ts), as_keys(skew),
                                        n_segments=n_seg)
        np.testing.assert_array_equal(_u32(got), np.asarray(JR.bloom_add_ref(
            js, JV.init(js), jnp.asarray(skew))))
        # the wrapper on the JAX package's own partition
        jk, jv, _ = JP.partition_host(js, KEYS, n_seg)
        got = sbf.add_partitioned(ts, TV.init(ts),
                                  torch.from_numpy(jk.view(np.int32)),
                                  torch.from_numpy(jv), n_seg)
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("k, block_bits", [(8, 256), (4, 128)])
def test_partitioned_counting_update_matches_jax(k, block_bits):
    js, ts = _specs("countingbf", k=k, block_bits=block_bits)
    batch = np.concatenate([KEYS, KEYS[:500], KEYS[:40]] + [KEYS[:1]] * 20)
    gone = np.concatenate([KEYS[:800], JH.probe_u64x2(50, seed=1)])
    added = JV.counting_add(js, JV.init(js), jnp.asarray(batch))
    want = np.asarray(added)
    want_rm = np.asarray(JV.counting_remove(js, added, jnp.asarray(gone)))
    for n_seg in SEGMENTS:
        for capacity, partition in ((None, "jit"), (16, "jit"),
                                    (None, "host")):
            got = ops.counting_update_partitioned(
                ts, TV.init(ts), as_keys(batch), "add", n_segments=n_seg,
                capacity=capacity, partition=partition)
            np.testing.assert_array_equal(_u32(got), want)
            got = ops.counting_update_partitioned(
                ts, got, as_keys(gone), "remove", n_segments=n_seg,
                capacity=capacity, partition=partition, inplace=True)
            np.testing.assert_array_equal(_u32(got), want_rm)
    skew = batch[TP.segment_ids(ts, as_keys(batch), 8).numpy() == 0]
    got = ops.counting_update_partitioned(ts, TV.init(ts), as_keys(skew),
                                          "add", n_segments=8)
    np.testing.assert_array_equal(_u32(got), np.asarray(JV.counting_add(
        js, JV.init(js), jnp.asarray(skew))))
    jk, jv, _ = JP.partition_host(js, batch, 8)
    got = TC.update_partitioned(ts, TV.init(ts),
                                torch.from_numpy(jk.view(np.int32)),
                                torch.from_numpy(jv), 8, "add")
    np.testing.assert_array_equal(_u32(got), want)


def test_partitioned_slot_lands_at_its_segment_offset():
    """A slot updates ``start mod seg_words`` of the segment that owns it,
    as the TPU kernel does, even for a key bucketed into another segment."""
    _, ts = _specs("sbf")
    keys = as_keys(KEYS[:16])
    seg = TP.segment_ids(ts, keys, 8)
    wrong = (seg.to(torch.int64) + 3) % 8
    by_seg = torch.zeros((8, 16, 2), dtype=torch.int32)
    valid = torch.zeros((8, 16), dtype=torch.uint8)
    for i in range(16):
        by_seg[wrong[i], i] = keys[i]
        valid[wrong[i], i] = 1
    got = sbf.add_partitioned(ts, TV.init(ts), by_seg, valid, 8)
    bps = ts.n_blocks // 8
    rows = _u32(got).reshape(ts.n_blocks, ts.s)
    blk, masks = TV._blocks_and_masks(ts, keys)
    for i in range(16):
        row = int(wrong[i]) * bps + int(blk[i]) % bps
        assert (rows[row] & masks[i].numpy().astype(np.uint32)
                == masks[i].numpy().astype(np.uint32)).all()


def test_partitioned_ops_refuse_bad_inputs():
    _, ts = _specs("sbf")
    _, tc = _specs("countingbf", k=8)
    cbf = TV.FilterSpec("cbf", M, 8)
    keys = as_keys(KEYS[:64])
    with pytest.raises(ValueError, match="block locality"):
        ops.bloom_add_partitioned(cbf, TV.init(cbf), keys)
    with pytest.raises(ValueError, match="partition"):
        ops.bloom_add_partitioned(ts, TV.init(ts), keys, partition="numpy")
    with pytest.raises(ValueError, match="counting"):
        ops.bloom_add_partitioned(tc, TV.init(tc), keys)
    with pytest.raises(ValueError, match="countingbf"):
        ops.counting_update_partitioned(ts, TV.init(ts), keys)
    part = TP.partition_jit(ts, keys, 8, 16)
    with pytest.raises(ValueError, match="divide"):
        sbf.add_partitioned(ts, TV.init(ts), part.keys_by_seg, part.valid, 3)
    with pytest.raises(ValueError, match="valid"):
        sbf.add_partitioned(ts, TV.init(ts), part.keys_by_seg,
                            part.valid[:, :4], 8)
    with pytest.raises(ValueError, match="op"):
        TC.update_partitioned(tc, TV.init(tc), part.keys_by_seg, part.valid,
                              8, "sub")
    empty = ops.bloom_add_partitioned(ts, TV.init(ts), keys[:0])
    assert not empty.any()
    assert sbf.LAUNCHES["add_partitioned"] == 0     # the CPU launches none
    assert TC.LAUNCHES["update_partitioned"] == 0


# ---------------------------------------------------------------------------
# The cached dispatch layer
# ---------------------------------------------------------------------------

def test_jit_layer_donates_in_place_and_counts_like_jax():
    js, ts = _specs("sbf", m=1 << 12)
    jc, tc = _specs("countingbf", m=1 << 12, k=8)
    pin = dict(probe="gather", coop="none", mix="full")
    a, b = KEYS[:16], KEYS[16:40]
    JO.jit_cache_clear()
    ops.jit_cache_clear()
    jw = JV.init(js)
    tw = TV.init(ts)
    calls = [("add", a, True), ("add", a, True), ("add", b, True),
             ("add", a, False), ("contains", b, None)]
    for op, keys, donate in calls:
        if op == "add":
            jw = JO.bloom_add_jit(js, jw, jnp.asarray(keys), donate=donate,
                                  **pin)
            before = tw.clone()
            out = ops.bloom_add_jit(ts, tw, as_keys(keys), donate=donate,
                                    **pin)
            if donate:
                assert out is tw                   # updated in place
            else:
                assert out is not tw and torch.equal(tw, before)
                tw = out
            np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
        else:
            np.testing.assert_array_equal(
                ops.bloom_contains_jit(ts, tw, as_keys(keys), **pin).numpy(),
                np.asarray(JO.bloom_contains_jit(js, jw, jnp.asarray(keys),
                                                 **pin)))
    jcw, tcw = JV.init(jc), TV.init(tc)
    for op in ("add", "add", "remove"):
        jcw = JO.counting_update_jit(jc, jcw, jnp.asarray(a), op, **pin)
        tcw = ops.counting_update_jit(tc, tcw, as_keys(a), op, **pin)
        np.testing.assert_array_equal(_u32(tcw), np.asarray(jcw))
    before = tcw.clone()
    kept = ops.counting_update_jit(tc, tcw, as_keys(b), "add", donate=False,
                                   **pin)
    assert torch.equal(tcw, before) and not torch.equal(kept, before)
    jcw = JO.counting_update_jit(jc, jcw, jnp.asarray(b), "add",
                                 donate=False, **pin)
    assert ops.jit_cache_info() == JO.jit_cache_info() == (7,)
    ops.jit_cache_clear()
    assert ops.jit_cache_info() == (0,)
    JO.jit_cache_clear()
