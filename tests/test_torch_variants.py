"""The port's blocked-filter oracle (``repro_torch.core.variants``) against
``repro.core.variants``.

Keys come from numpy with a seed; words are compared as np.uint32 and results
as bool, exactly. The eight specs are ``tests/test_kernels.py``'s
``BLOCKED_SPECS`` (both sbf branches of ``block_patterns``: k % s == 0 and
not). The JAX references run under ``jax.jit``: eager, the segmented scan
costs seconds per shape.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV

M = 1 << 16
SPEC_ARGS = [("sbf", M, 8, 256, 1), ("sbf", M, 16, 512, 1),
             ("sbf", M, 4, 128, 1), ("sbf", M, 2, 64, 1),
             ("rbbf", M, 4, 256, 1), ("bbf", M, 8, 256, 1),
             ("csbf", M, 8, 512, 2), ("csbf", M, 16, 1024, 4)]
IDS = [f"{v}-B{b}-k{k}-z{z}" for v, _, k, b, z in SPEC_ARGS]
# sbf with k % s != 0: the per-salt branch of block_patterns
EXTRA_ARGS = [("sbf", M, 3, 256, 1), ("sbf", M, 12, 256, 1)]

_jit_add_rows = jax.jit(JV.add_rows, static_argnums=0)
_jit_contains = jax.jit(JV.contains, static_argnums=0)


def _specs(args):
    v, m, k, b, z = args
    return (JV.FilterSpec(v, m, k, block_bits=b, z=z),
            TV.FilterSpec(v, m, k, block_bits=b, z=z))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_words(args, n, seed):
    js, _ = _specs(args)
    keys = jnp.asarray(JH.random_u64x2(n, seed=seed))
    return np.asarray(_jit_add_rows(js, JV.init(js), keys))


@pytest.mark.parametrize("args", SPEC_ARGS + EXTRA_ARGS,
                         ids=IDS + ["sbf-B256-k3", "sbf-B256-k12"])
@pytest.mark.parametrize("batched", [True, False])
def test_block_patterns_match(args, batched):
    js, ts = _specs(args)
    h = np.asarray(JH.xxh32_u64x2(jnp.asarray(JH.random_u64x2(2000, 9))))
    want = np.asarray(JV.block_patterns(js, jnp.asarray(h), batched=batched))
    got = TV.block_patterns(ts, torch.from_numpy(h.astype(np.int64)),
                            batched=batched)
    assert got.shape == (2000, ts.s)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_add_and_contains_match(args):
    js, ts = _specs(args)
    n = 1500
    want = _jax_words(args, n, 1)
    keys = as_keys(JH.random_u64x2(n, seed=1))
    for got in (TV.add(ts, TV.init(ts), keys),
                TV.add(ts, TV.init(ts), keys, method="loop")):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_u32(got), want)
    queries = np.concatenate([JH.random_u64x2(n, seed=1),
                              JH.probe_u64x2(3000, seed=2)])
    c_want = np.asarray(_jit_contains(js, jnp.asarray(want),
                                      jnp.asarray(queries)))
    c_got = TV.contains(ts, torch.from_numpy(want.view(np.int32).copy()),
                        as_keys(queries)).numpy()
    np.testing.assert_array_equal(c_got, c_want)
    assert c_got[:n].all()


def test_add_is_cumulative_and_order_free():
    js, ts = _specs(SPEC_ARGS[0])
    keys = JH.random_u64x2(3000, seed=4)
    want = np.asarray(JV.add_loop(js, JV.init(js), jnp.asarray(keys)))
    half = TV.add_rows(ts, TV.init(ts), as_keys(keys[:1000]))
    both = TV.add_rows(ts, half, as_keys(keys[1000:][::-1].copy()))
    np.testing.assert_array_equal(_u32(both), want)


def test_segment_totals_matches():
    rng = np.random.RandomState(0)
    ids = np.sort(rng.randint(0, 40, size=300)).astype(np.int32)
    vals = rng.randint(0, 2**32, size=(300, 3), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jax.jit(JV.segment_totals, static_argnums=2)(
        jnp.asarray(ids), jnp.asarray(vals), jnp.bitwise_or))
    got = TV.segment_totals(torch.from_numpy(ids.astype(np.int64)),
                            torch.from_numpy(vals.astype(np.int64)),
                            torch.bitwise_or)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_fill_fraction_matches():
    args = SPEC_ARGS[1]
    words = _jax_words(args, 1500, 1)
    want = float(JV.fill_fraction(jnp.asarray(words)))
    got = TV.fill_fraction(torch.from_numpy(words.view(np.int32).copy()))
    assert got == pytest.approx(want, rel=1e-6)   # JAX sums in float32


def test_fpr_theory_and_sizing_match():
    for args in SPEC_ARGS:
        js, ts = _specs(args)
        for n in (1, 100, 4096, 20000):
            assert TV.fpr_theory(ts, n) == JV.fpr_theory(js, n)
        assert TV.space_optimal_n(ts) == JV.space_optimal_n(js)
        assert (TV.space_optimal_n(ts, target_fpr=1e-3)
                == JV.space_optimal_n(js, target_fpr=1e-3))
    for c in (4.0, 9.5, 16.0, 24.0):
        assert TV.optimal_k(c) == JV.optimal_k(c)
        assert TV.fpr_min(c) == JV.fpr_min(c)
        assert TV.fpr_cbf(1 << 20, int((1 << 20) / c), 7) == JV.fpr_cbf(
            1 << 20, int((1 << 20) / c), 7)
        for v, b, z in (("sbf", 256, 1), ("sbf", 512, 1), ("bbf", 256, 1),
                        ("csbf", 512, 2), ("rbbf", 32, 1)):
            assert TV.snap_k(v, c, b, z) == JV.snap_k(v, c, b, z)
    for v, b, z in (("sbf", 256, 1), ("csbf", 512, 2), ("bbf", 256, 1)):
        for n, eps in ((1000, 1e-2), (50000, 1e-3)):
            assert (TV.space_optimal_c(v, b, z, n, eps)
                    == JV.space_optimal_c(v, b, z, n, eps))


def test_filterspec_reads_jax_spec_dicts():
    jax_specs = [_specs(a)[0] for a in SPEC_ARGS] + [
        JV.FilterSpec("cbf", M, 8),
        JV.FilterSpec("cuckoo", M, 4, slot_bits=16),
        JV.FilterSpec("quotient", M, 1, slot_bits=16, r_bits=9),
        JV.FilterSpec("countingbf", M, 8)]
    for js in jax_specs:
        ts = TV.FilterSpec(**dataclasses.asdict(js))
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert (ts.n_words, ts.s, ts.n_blocks, ts.storage_words) == (
            js.n_words, js.s, js.n_blocks, js.storage_words)
        assert str(ts) == str(js)


@pytest.mark.parametrize("bad", [
    dict(variant="xbf", m_bits=M, k=8),
    dict(variant="sbf", m_bits=M + 1, k=8),
    dict(variant="sbf", m_bits=M, k=0),
    dict(variant="sbf", m_bits=M, k=97),
    dict(variant="sbf", m_bits=M, k=8, block_bits=48),
    dict(variant="sbf", m_bits=256, k=8, block_bits=512),
    dict(variant="csbf", m_bits=M, k=8, block_bits=512, z=3),
    dict(variant="csbf", m_bits=M, k=9, block_bits=512, z=2),
])
def test_filterspec_rejects_what_jax_rejects(bad):
    with pytest.raises(AssertionError):
        JV.FilterSpec(**bad)
    with pytest.raises(ValueError):
        TV.FilterSpec(**bad)


def test_unported_variants_raise_not_implemented():
    keys = as_keys(JH.random_u64x2(8, seed=0))
    # every variant is ported: the bit references send the fingerprint
    # filters to core.fingerprint and core.quotient, and the FPR theory of
    # a quotient spec is the JAX package's
    quotient = TV.FilterSpec("quotient", M, 1, slot_bits=8, r_bits=4)
    for call in (TV.contains, TV.add):
        with pytest.raises(ValueError, match="core.quotient"):
            call(quotient, TV.init(quotient), keys)
    jq = JV.FilterSpec("quotient", M, 1, slot_bits=8, r_bits=4)
    for n in (100, quotient.n_slots):
        assert TV.fpr_theory(quotient, n) == JV.fpr_theory(jq, n)
    assert TV.space_optimal_n(quotient) == JV.space_optimal_n(jq)
    assert (TV.space_optimal_n(quotient, 1e-2)
            == JV.space_optimal_n(jq, 1e-2))
    assert quotient.q_bits == jq.q_bits
    assert quotient.fingerprint_bits == jq.fingerprint_bits
    cuckoo = TV.FilterSpec("cuckoo", M, 8)
    for call in (TV.contains, TV.add):
        with pytest.raises(ValueError, match="fingerprint"):
            call(cuckoo, TV.init(cuckoo), keys)
