"""The port's classical Bloom filter (``cbf``) against ``repro``.

On the CPU the port runs its plain versions; the JAX side runs its jnp
paths (``V.contains`` / ``V.add_loop`` / ``V.add_scatter`` / ``V.add_rows``
and the ``jnp`` engine): under jax 0.9 the Pallas cbf kernels no longer
trace (``pl.load`` is gone), and no kernel or regime changes a result.
Keys come from numpy with a seed; words are compared as np.uint32, results
as bool and positions as integers, exactly. The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import hashing as JH
from repro.core import variants as JV
import repro_torch.api as api
from repro_torch import interop
from repro_torch.api import registry
from repro_torch.api.filter import as_keys
from repro_torch.core import hashing as TH
from repro_torch.core import variants as TV
from repro_torch.kernels import _build, cbf, ops

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

KS = [1, 7, 11, 32]
MS = [1 << 10, 1 << 16, 1 << 18]
N = 2000


_jit_add_loop = jax.jit(JV.add_loop, static_argnums=0)


def _specs(m, k):
    return JV.FilterSpec("cbf", m, k), TV.FilterSpec("cbf", m, k)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _queries(n, seed):
    return np.concatenate([JH.random_u64x2(n, seed=seed),
                           JH.probe_u64x2(n, seed=seed)])


@pytest.mark.parametrize("m", MS + [1 << 32],
                         ids=["m2^10", "m2^16", "m2^18", "m2^32"])
@pytest.mark.parametrize("k", KS)
def test_cbf_positions_match(m, k):
    """Positions only: at m = 2^32 no filter is allocated."""
    js, ts = _specs(m, k)
    keys = JH.random_u64x2(N, seed=k)
    h1, h2 = JH.hash_keys(jnp.asarray(keys))
    want = np.asarray(JV.cbf_positions(js, h1, h2)).astype(np.int64)
    th1, th2 = TH.hash_keys(as_keys(keys))
    got = TV.cbf_positions(ts, th1, th2)
    assert got.shape == (N, k) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < m
    if m == 1 << 32:                  # the shift is 0: all 32 bits in use
        assert int(got.max()) >= 1 << 31


@pytest.mark.parametrize("m", MS, ids=["m2^10", "m2^16", "m2^18"])
@pytest.mark.parametrize("k", KS)
def test_cbf_add_and_contains_match(m, k):
    """Words after every plain add of the port against the JAX package's
    bit-plane scatter, and contains on inserted keys and probes."""
    js, ts = _specs(m, k)
    keys = JH.random_u64x2(N, seed=m + k)
    want = np.asarray(JV.add_scatter(js, JV.init(js), jnp.asarray(keys)))
    tk = as_keys(keys)
    for add in (TV.add_loop, TV.add_scatter, TV.add_rows,
                lambda s, f, x: TV.add(s, f, x, method="scatter"),
                lambda s, f, x: TV.add(s, f, x, method="loop"),
                cbf.add_plain):
        np.testing.assert_array_equal(_u32(add(ts, TV.init(ts), tk)), want)
    q = _queries(N, m + k)
    want_hits = np.asarray(JV.contains(js, jnp.asarray(want), jnp.asarray(q)))
    words = torch.from_numpy(want.view(np.int32).copy())
    np.testing.assert_array_equal(TV.contains(ts, words, as_keys(q)).numpy(),
                                  want_hits)
    np.testing.assert_array_equal(
        cbf.contains_plain(ts, words, as_keys(q)).numpy(), want_hits)
    assert want_hits[:N].all()


@pytest.mark.parametrize("k", KS)
def test_cbf_add_loop_and_rows_match(k):
    """The JAX package's sequential insert and its ``jnp`` engine's add
    (``add_rows``, which sends cbf to the scatter); one m, since each k
    compiles the unrolled JAX loop anew."""
    js, ts = _specs(1 << 16, k)
    keys = JH.random_u64x2(N, seed=k)
    jkeys = jnp.asarray(keys)
    want = np.asarray(_jit_add_loop(js, JV.init(js), jkeys))
    np.testing.assert_array_equal(
        np.asarray(JV.add_rows(js, JV.init(js), jkeys)), want)
    for add in (TV.add_loop, TV.add_rows):
        np.testing.assert_array_equal(
            _u32(add(ts, TV.init(ts), as_keys(keys))), want)


@pytest.mark.parametrize("regime", ["vmem", "hbm", "auto"])
def test_ops_cbf_on_ragged_sizes(regime):
    _, ts = _specs(1 << 16, 11)
    cbf.reset_launches()
    for n in (0, 1, 255, 257):
        keys = as_keys(JH.random_u64x2(n, seed=n + 3))
        want = TV.add_loop(ts, TV.init(ts), keys)
        got = ops.bloom_add(ts, TV.init(ts), keys, regime=regime)
        np.testing.assert_array_equal(_u32(got), _u32(want))
        base = TV.init(ts)
        assert ops.bloom_add(ts, base, keys, regime=regime,
                             inplace=True) is base
        np.testing.assert_array_equal(_u32(base), _u32(want))
        q = as_keys(_queries(n, n + 3))
        hits = ops.bloom_contains(ts, want, q, regime=regime)
        np.testing.assert_array_equal(hits.numpy(),
                                      TV.contains(ts, want, q).numpy())
        assert hits.shape == (2 * n,) and hits[:n].all()
    assert cbf.LAUNCHES == {"contains_vmem": 0, "add_vmem": 0}
    assert _build._lib is None
    with pytest.raises(ValueError):
        ops.bloom_add(ts, TV.init(ts), keys, regime="l3")
    with pytest.raises(ValueError):
        ops.bloom_contains(ts, want, q, coop="warp")


@pytest.mark.parametrize("n,bits", [(1000, 16.0), (3000, 10.0),
                                    (5000, 8.0)])
def test_filter_api_matches_jax_jnp_engine(n, bits):
    jf = japi.filter_for_n_items(n, bits_per_key=bits, variant="cbf",
                                 backend="jnp")
    tf = api.filter_for_n_items(n, bits_per_key=bits, variant="cbf",
                                device="cpu")
    assert dataclasses.asdict(tf.spec) == dataclasses.asdict(jf.spec)
    assert tf.backend == "torch" and tf.spec.block_bits == tf.spec.m_bits
    keys = JH.random_u64x2(n, seed=n)
    jf, tf = jf.add(keys), tf.add(keys)
    np.testing.assert_array_equal(_u32(tf.dense_words()),
                                  np.asarray(jf.dense_words()))
    q = _queries(n, n)
    np.testing.assert_array_equal(tf.contains(q).numpy(),
                                  np.asarray(jf.contains(q)))
    assert tf.measure_fpr(1 << 14, 5) == jf.measure_fpr(1 << 14, 5)
    assert tf.fpr_theory(n) == jf.fpr_theory(n)
    assert tf.approx_count() == pytest.approx(jf.approx_count(), rel=1e-5)
    # state both ways
    state = {k: (np.asarray(v) if k == "words" else v)
             for k, v in jf.to_state().items()}
    back = interop.from_jax_state(state, device="cpu")
    np.testing.assert_array_equal(_u32(back.words), _u32(tf.words))
    jback = japi.Filter.from_state(interop.to_jax_state(tf))
    assert jback.backend == "jnp"
    np.testing.assert_array_equal(np.asarray(jback.words),
                                  np.asarray(jf.words))


def test_cbf_engine_selection():
    cpu = registry.SelectionContext(device=torch.device("cpu"))
    gpu = registry.SelectionContext(device=torch.device("cuda"))
    small = TV.FilterSpec("cbf", ops.L2_FILTER_BYTES * 8, 11)
    large = TV.FilterSpec("cbf", 1 << 32, 11)
    huge = TV.FilterSpec("cbf", 1 << 33, 11)
    assert registry.select(small, "auto", cpu).name == "torch"
    assert registry.select(small, "auto", gpu).name == "cuda-l2"
    assert registry.select(large, "auto", gpu).name == "cuda-dram"
    assert registry.select(small, "pallas-hbm", gpu).name == "cuda-dram"
    for name, spec in (("cuda-l2", large), ("auto", huge)):
        with pytest.raises(ValueError):
            registry.select(spec, name, gpu)
    assert ops.kernel_supported(large) and not ops.kernel_supported(huge)


def test_cbf_wrappers_refuse_bad_inputs():
    _, ts = _specs(1 << 16, 7)
    words = TV.init(ts)
    keys = as_keys(JH.random_u64x2(8, seed=0))
    with pytest.raises(ValueError, match="int32"):
        cbf.contains_vmem(ts, words, keys.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        cbf.add_vmem(ts, words.to(torch.int64), keys)
    with pytest.raises(ValueError, match="keys on meta"):
        cbf.contains_vmem(ts, words, keys.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cbf.add_vmem(ts, words.to("meta"), keys.to("meta"))
    with pytest.raises(ValueError, match="2\\^32"):
        TV.cbf_positions(TV.FilterSpec("cbf", 1 << 33, 3),
                         torch.zeros(1, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="cbf"):
        TV.block_patterns(ts, torch.zeros(1, dtype=torch.int64))
