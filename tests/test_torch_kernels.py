"""The port's kernel dispatch (``repro_torch.kernels``) on the CPU.

On CPU tensors every wrapper runs its plain PyTorch version, so these tests
hold the port's ``ops.bloom_add`` / ``bloom_contains`` against

* the JAX package's ``repro.kernels.ops`` in Pallas interpret mode, for
  three specs, both regimes of the port and n in {1, 1000}. The JAX side
  runs its vmem kernels with ``probe="gather"``: with jax 0.9 the other
  Pallas schedules (``probe="loop"`` and every hbm kernel) fail to trace
  (``pl.load`` is gone), and no schedule or regime changes a result;
* the port's ``ref.bloom_*_ref`` for the eight blocked specs of
  ``tests/test_kernels.py`` and the ragged sizes n in {0, 1, 255, 257},
  with the port's ``ref`` itself held against the JAX ``ref``.

Words are compared as np.uint32 and results as bool, exactly. The CUDA
path is tested on the card by ``tests/test_torch_gpu.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels import sbf as JS
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import _build, ops, ref, sbf

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

M = 1 << 16
SPEC_ARGS = [("sbf", M, 8, 256, 1), ("sbf", M, 16, 512, 1),
             ("sbf", M, 4, 128, 1), ("sbf", M, 2, 64, 1),
             ("rbbf", M, 4, 256, 1), ("bbf", M, 8, 256, 1),
             ("csbf", M, 8, 512, 2), ("csbf", M, 16, 1024, 4)]
IDS = [f"{v}-B{b}-k{k}-z{z}" for v, _, k, b, z in SPEC_ARGS]
PALLAS_ARGS = [("sbf", M, 16, 256, 1), ("bbf", M, 8, 256, 1),
               ("csbf", M, 8, 512, 2)]


def _specs(args):
    v, m, k, b, z = args
    return (JV.FilterSpec(v, m, k, block_bits=b, z=z),
            TV.FilterSpec(v, m, k, block_bits=b, z=z))


def _u32(t):
    return t.numpy().view(np.uint32)


def _queries(n, seed):
    """n inserted keys followed by n probes from the reserved keyspace."""
    return np.concatenate([JH.random_u64x2(n, seed=seed),
                           JH.probe_u64x2(n, seed=seed)])


@functools.lru_cache(maxsize=None)
def _pallas(args, n):
    """JAX package's kernels, interpret mode: (words, contains results)."""
    js, _ = _specs(args)
    kw = dict(regime="vmem", probe="gather", coop="none", mix="full")
    words = JO.bloom_add(js, JV.init(js),
                         jnp.asarray(JH.random_u64x2(n, seed=n)), **kw)
    hits = JO.bloom_contains(js, words, jnp.asarray(_queries(n, n)), **kw)
    return np.asarray(words), np.asarray(hits)


@pytest.mark.parametrize("args", PALLAS_ARGS,
                         ids=["sbf-B256-k16", "bbf-B256-k8", "csbf-B512-k8-z2"])
@pytest.mark.parametrize("regime", ["vmem", "hbm"])
@pytest.mark.parametrize("n", [1, 1000])
def test_ops_match_jax_pallas(args, regime, n):
    _, ts = _specs(args)
    want_words, want_hits = _pallas(args, n)
    words = ops.bloom_add(ts, TV.init(ts),
                          as_keys(JH.random_u64x2(n, seed=n)), regime=regime)
    np.testing.assert_array_equal(_u32(words), want_words)
    hits = ops.bloom_contains(ts, words, as_keys(_queries(n, n)),
                              regime=regime)
    np.testing.assert_array_equal(hits.numpy(), want_hits)


_jit_add_ref = jax.jit(JR.bloom_add_ref, static_argnums=0)


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_port_ref_matches_jax_ref(args):
    js, ts = _specs(args)
    keys = JH.random_u64x2(257, seed=3)
    want = np.asarray(_jit_add_ref(js, JV.init(js), jnp.asarray(keys)))
    np.testing.assert_array_equal(
        _u32(ref.bloom_add_ref(ts, TV.init(ts), as_keys(keys))), want)
    blk, masks = ref.hash_block_masks_ref(ts, as_keys(keys))
    jblk, jmasks = JR.hash_block_masks_ref(js, jnp.asarray(keys))
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    np.testing.assert_array_equal(masks.numpy().astype(np.uint32),
                                  np.asarray(jmasks))


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
@pytest.mark.parametrize("regime", ["vmem", "hbm", "auto"])
def test_ops_match_ref_on_ragged_sizes(args, regime):
    _, ts = _specs(args)
    for n in (0, 1, 255, 257):
        keys = as_keys(JH.random_u64x2(n, seed=n + 10))
        want = ref.bloom_add_ref(ts, TV.init(ts), keys)
        got = ops.bloom_add(ts, TV.init(ts), keys, regime=regime)
        np.testing.assert_array_equal(_u32(got), _u32(want))
        q = as_keys(_queries(n, n + 10))
        hits = ops.bloom_contains(ts, want, q, regime=regime)
        np.testing.assert_array_equal(
            hits.numpy(), ref.bloom_contains_ref(ts, want, q).numpy())
        assert hits.shape == (2 * n,) and hits[:n].all()


def test_schedule_axes_never_change_results():
    _, ts = _specs(SPEC_ARGS[1])
    keys = as_keys(JH.random_u64x2(700, seed=5))
    q = as_keys(_queries(700, 5))
    want = ref.bloom_add_ref(ts, TV.init(ts), keys)
    want_hits = ref.bloom_contains_ref(ts, want, q).numpy()
    for kw in (dict(probe="loop", coop="none", mix="full"),
               dict(probe="gather", coop="subtile", mix="cheap"),
               dict(layout=sbf.Layout(2, 4), tile=64),
               dict(layout=sbf.Layout(8, 1), tile=8)):
        for regime in ("vmem", "hbm"):
            got = ops.bloom_add(ts, TV.init(ts), keys, regime=regime, **kw)
            np.testing.assert_array_equal(_u32(got), _u32(want))
    for depth in sbf.DMA_DEPTHS:
        hits = ops.bloom_contains(ts, want, q, regime="hbm", depth=depth,
                                  coop="subtile", mix="cheap")
        np.testing.assert_array_equal(hits.numpy(), want_hits)
    for phi in (1, 2, 4, 8):
        hits = ops.bloom_contains(ts, want, q, regime="vmem",
                                  layout=sbf.Layout(1, phi), probe="gather")
        np.testing.assert_array_equal(hits.numpy(), want_hits)


@pytest.mark.parametrize("kw", [dict(probe="scan"), dict(coop="warp"),
                                dict(mix="fast"), dict(regime="l3"),
                                dict(depth=3, regime="hbm"),
                                dict(layout=sbf.Layout(3, 1)),
                                dict(layout=sbf.Layout(16, 1), tile=8)])
def test_ops_reject_bad_axes(kw):
    _, ts = _specs(SPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(16, seed=0))
    with pytest.raises(ValueError):
        if "depth" in kw:
            ops.bloom_contains(ts, TV.init(ts), keys, **kw)
        else:
            ops.bloom_add(ts, TV.init(ts), keys, **kw)


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_layouts_match_jax(args):
    js, ts = _specs(args)
    for op in ("contains", "add"):
        jl, tl = JS.default_layout(js, op), sbf.default_layout(ts, op)
        assert (tl.theta, tl.phi) == (jl.theta, jl.phi)
    for theta, phi, tile in ((1, 8, 256), (2, 4, 64), (8, 16, 8), (4, 2, 2),
                             (1, 3, 8), (3, 1, 6)):
        try:
            jl = JS.Layout(theta, phi).validate(js, tile)
        except AssertionError:
            with pytest.raises(ValueError):
                sbf.Layout(theta, phi).validate(ts, tile)
        else:
            tl = sbf.Layout(theta, phi).validate(ts, tile)
            assert (tl.theta, tl.phi) == (jl.theta, jl.phi)


def test_tile_clamp_and_padding_match_jax():
    for n in (1, 7, 8, 9, 255, 256, 257, 5000):
        assert ops._clamp_tile(n, 256) == JO._clamp_tile(n, 256)
        keys = JH.random_u64x2(n, seed=n)
        tile = ops._clamp_tile(n, 256)
        np.testing.assert_array_equal(
            ops._pad_keys(as_keys(keys), tile).numpy().view(np.uint32),
            np.asarray(JO._pad_keys(jnp.asarray(keys), tile)))


def test_regime_follows_the_l2_budget():
    small = TV.FilterSpec("sbf", ops.L2_FILTER_BYTES * 8, 8)
    big = TV.FilterSpec("sbf", ops.L2_FILTER_BYTES * 16, 8)
    assert ops._regime(small, "auto") == "vmem"
    assert ops._regime(big, "auto") == "hbm"
    assert ops._regime(small, "hbm") == "hbm"
    assert ops.L2_FILTER_BYTES == 64 << 20


def test_bloom_add_inplace_flag():
    _, ts = _specs(SPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(300, seed=1))
    base = TV.init(ts)
    new = ops.bloom_add(ts, base, keys)
    assert not base.any() and new.any()
    same = ops.bloom_add(ts, base, keys, inplace=True)
    assert same is base
    np.testing.assert_array_equal(_u32(base), _u32(new))
    assert ops.bloom_add(ts, new, keys[:0]) is not new          # n == 0
    assert ops.bloom_add(ts, new, keys[:0], inplace=True) is new


def test_cpu_path_launches_nothing_and_builds_nothing():
    _, ts = _specs(SPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(100, seed=2))
    sbf.reset_launches()
    words = ops.bloom_add(ts, TV.init(ts), keys, regime="vmem")
    ops.bloom_add(ts, words, keys, regime="hbm")
    ops.bloom_contains(ts, words, keys, regime="vmem")
    ops.bloom_contains(ts, words, keys, regime="hbm")
    assert sbf.LAUNCHES == dict.fromkeys(sbf.LAUNCHES, 0)
    assert _build._lib is None


def test_wrappers_refuse_bad_inputs():
    _, ts = _specs(SPEC_ARGS[0])
    words = TV.init(ts)
    keys = as_keys(JH.random_u64x2(8, seed=0))
    with pytest.raises(ValueError, match="int32"):
        sbf.contains_vmem(ts, words, keys.to(torch.int64), sbf.Layout())
    with pytest.raises(ValueError, match="int32"):
        sbf.add_hbm(ts, words.to(torch.int64), keys)
    with pytest.raises(ValueError, match="keys on meta"):
        sbf.contains_hbm(ts, words, keys.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sbf.add_vmem(ts, words.to("meta"), keys.to("meta"), sbf.Layout())
    cuckoo = TV.FilterSpec("cuckoo", M, 8)
    with pytest.raises(ValueError, match="cuckoo_add"):
        ops.bloom_add(cuckoo, TV.init(cuckoo), keys)
    quotient = TV.FilterSpec("quotient", M, 1, slot_bits=8, r_bits=4)
    with pytest.raises(ValueError, match="quotient_add"):
        ops.bloom_add(quotient, TV.init(quotient), keys)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "library_path",
                        lambda name="bloom": tmp_path / "lib" / f"{name}.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "lib").exists()


def test_library_names_hash_every_source_file(monkeypatch, tmp_path):
    """An edited header (or any file under csrc/) renames every library,
    so a stale build is never loaded."""
    for path in _build._CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len({p.name.split("-")[1] for p in before.values()}) == 1
    header = tmp_path / "bloom_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    for name in _build.SOURCES:
        assert after[name] != before[name]
        assert after[name].name.startswith(f"{name}-")
    # every bound entry point is declared in its source with as many
    # parameters as it has argument types
    assert {"cbf_contains", "cbf_add", "ring_contains", "cuckoo_contains",
            "cuckoo_update", "bloom_add_partitioned",
            "counting_update_partitioned", "quotient_contains",
            "quotient_update"} <= set(_build.ENTRY_POINTS)
    assert {"cbf", "ring", "cuckoo", "quotient"} <= set(_build.SOURCES)
    for symbol, (source, argtypes) in _build.ENTRY_POINTS.items():
        assert source in _build.SOURCES
        text = (tmp_path / f"{source}.cu").read_text()
        head = text.index(f"int {symbol}(") + len(f"int {symbol}(")
        params = text[head:text.index(")", head)]
        assert params.count(",") + 1 == len(argtypes), symbol
