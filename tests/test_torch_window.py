"""The port's windowed filter (generation ring, ``advance``) against
``repro``.

On the CPU the port runs its plain versions; the JAX side runs the
``windowed`` engine's jnp paths (``V.add_rows`` into the head generation and
``kernels/ring.py:ring_contains_ref``): under jax 0.9 the Pallas ring
kernels no longer trace (``pl.load`` is gone), and no kernel or regime
changes a result. Keys come from numpy with a seed; rings are compared as
np.uint32, heads as ints and results as bool, exactly. The CUDA kernel is
held against the plain version on the card by ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import registry as jregistry
from repro.core import hashing as JH
from repro.core import variants as JV
from repro.kernels import ring as JR
from repro.window import ring as JW
import repro_torch.api as api
from repro_torch import interop
from repro_torch.api import registry
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import _build, ops, ring
from repro_torch.window import WindowedFilter
from repro_torch.window import ring as TW

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

M = 1 << 14
BATCH = 64
GEOMETRIES = [dict(variant="sbf", k=8, block_bits=256),
              dict(variant="bbf", k=8, block_bits=256),
              dict(variant="rbbf", k=4),
              dict(variant="csbf", k=8, block_bits=512, z=2)]
GEO_IDS = [g["variant"] for g in GEOMETRIES]
GENS = [2, 3, 4, 8]


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _batch(i):
    return JH.random_u64x2(BATCH, seed=100 + i)


def _pair(geo, G):
    jf = japi.make_filter(m_bits=M, generations=G, **geo)
    tf = api.make_filter(m_bits=M, generations=G, device="cpu", **geo)
    return jf, tf


def _same(tf, jf):
    assert tf.backend == jf.backend == "windowed"
    np.testing.assert_array_equal(_u32(tf.words), np.asarray(jf.words))
    assert tf.head == int(jf.head)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("G", GENS)
def test_ring_and_head_match_jax(geo, G):
    """A seeded add/advance sequence: the ring and head after every step,
    then contains on live, retired and fresh keys."""
    jf, tf = _pair(geo, G)
    assert tf.words.shape == (G, M // 32) and tf.head == 0
    steps = G + 2
    for t in range(steps):
        keys = _batch(t)
        jf, tf = jf.add(keys), tf.add(keys)
        _same(tf, jf)
        if t < steps - 1:
            jf, tf = jf.advance(), tf.advance()
            _same(tf, jf)
    live = np.concatenate([_batch(t) for t in range(steps - G, steps)])
    retired = np.concatenate([_batch(t) for t in range(steps - G)])
    fresh = JH.probe_u64x2(2000, seed=G)
    q = np.concatenate([live, retired, fresh])
    hits = tf.contains(q).numpy()
    np.testing.assert_array_equal(hits, np.asarray(jf.contains(q)))
    assert hits[:live.shape[0]].all()
    assert tf.nbytes == jf.nbytes == G * M // 8


@pytest.mark.parametrize("G", [2, 4])
def test_windowed_merge_matches_jax(G):
    geo = GEOMETRIES[0]
    ja, ta = _pair(geo, G)
    jb, tb = _pair(geo, G)
    ja, ta = ja.add(_batch(0)).advance(), ta.add(_batch(0)).advance()
    ja, ta = ja.add(_batch(1)), ta.add(_batch(1))
    jb, tb = jb.add(_batch(2)), tb.add(_batch(2))       # heads differ
    jm, tm = ja.merge(jb), ta.merge(tb)
    _same(tm, jm)
    jplain = japi.make_filter(m_bits=M, backend="jnp", **geo).add(_batch(3))
    tplain = api.make_filter(m_bits=M, device="cpu", **geo).add(_batch(3))
    jm, tm = ja.merge(jplain), ta.merge(tplain)         # a plain other
    _same(tm, jm)
    jp, tp = jplain.merge(ja), tplain.merge(ta)         # into a plain self
    assert tp.backend == "torch" and jp.backend == "jnp"
    np.testing.assert_array_equal(_u32(tp.words), np.asarray(jp.words))
    # merged keys join the newest age class: G - 1 advances keep them
    for _ in range(G - 1):
        jm, tm = jm.advance(), tm.advance()
        _same(tm, jm)
    assert tm.contains(_batch(3)).all()
    with pytest.raises(ValueError):
        ta.merge(api.make_filter(m_bits=M, k=4, device="cpu"))
    # the Filter's introspection reads the ring's union
    np.testing.assert_array_equal(_u32(tm.dense_words()),
                                  np.asarray(jm.dense_words()))
    assert tm.fill_fraction() == pytest.approx(jm.fill_fraction(), rel=1e-6)
    assert tm.approx_count() == pytest.approx(jm.approx_count(), rel=1e-5)
    assert tm.measure_fpr(1 << 12, 3) == jm.measure_fpr(1 << 12, 3)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_state_roundtrips_through_interop(geo):
    G = 3
    jf, tf = _pair(geo, G)
    for t in range(4):
        jf, tf = jf.add(_batch(t)).advance(), tf.add(_batch(t)).advance()
    # JAX -> port: the union in generation 0, head 0, ring size kept
    state = {k: (np.asarray(v) if k == "words" else v)
             for k, v in jf.to_state().items()}
    assert state["options"] == {"generations": G}
    back = interop.from_jax_state(state, device="cpu")
    jback = japi.Filter.from_state(state)
    _same(back, jback)
    # port -> JAX
    out = interop.to_jax_state(tf)
    assert out["options"] == {"generations": G}
    assert out["backend"] == "windowed"
    again = japi.Filter.from_state(out)
    _same(back, again)
    # an explicit engine takes the dense union instead
    dense = api.Filter.from_state(tf.to_state(), backend="torch",
                                  device="cpu")
    assert dense.backend == "torch" and dense.head is None
    np.testing.assert_array_equal(_u32(dense.words), _u32(tf.dense_words()))


@pytest.mark.parametrize("G", [2, 3, 4, 8])
def test_raw_ring_and_head_carry_across(G):
    """A ring built by the JAX package goes on sliding in the port, and
    back, without loss."""
    geo = GEOMETRIES[3]
    jf, _ = _pair(geo, G)
    for t in range(G + 1):
        jf = jf.add(_batch(t)).advance()
    jf = jf.add(_batch(50))
    tf = interop.from_jax_words(dataclasses.asdict(jf.spec),
                                np.asarray(jf.words), head=int(jf.head),
                                device="cpu")
    _same(tf, jf)
    jf, tf = jf.advance().add(_batch(51)), tf.advance().add(_batch(51))
    _same(tf, jf)
    fields, words, head = interop.to_jax_words(tf.advance())
    assert fields == dataclasses.asdict(jf.spec)
    back = jf.replace(words=jnp.asarray(words), state=jnp.int32(head))
    ref = jf.advance()
    np.testing.assert_array_equal(np.asarray(back.words),
                                  np.asarray(ref.words))
    assert int(back.head) == int(ref.head)
    for bad in (dict(head=G), dict(head=-1)):
        with pytest.raises(ValueError):
            interop.from_jax_words(fields, words, device="cpu", **bad)
    with pytest.raises(ValueError):
        interop.from_jax_words(fields, words[:, :-4], device="cpu")
    with pytest.raises(ValueError):          # a head needs a ring
        interop.from_jax_words(fields, words[0], head=0, device="cpu")


@pytest.mark.parametrize("window,bits,G,variant,block_bits", [
    (1000, 16.0, 4, "sbf", 256), (5000, 10.0, 2, "sbf", 512),
    (3000, 12.0, 8, "bbf", 256), (20000, 8.0, 3, "csbf", 256),
    (1, 16.0, 4, "rbbf", 32)])
def test_for_window_sizing_matches_jax(window, bits, G, variant, block_bits):
    jw = JW.WindowedFilter.for_window(window, bits, G, variant, block_bits)
    tw = WindowedFilter.for_window(window, bits, G, variant, block_bits,
                                   device="cpu")
    assert dataclasses.asdict(tw.spec) == dataclasses.asdict(jw.spec)
    assert tw.rings.shape == jw.rings.shape and tw.head == 0
    assert tw.nbytes == jw.nbytes
    assert tw.fpr_theory(window) == jw.fpr_theory(window)


# the JAX WindowedFilter is a pytree: jit its ops (eager, the segmented
# scan of its add costs seconds)
_jax_add = jax.jit(lambda w, keys: w.add(keys))
_jax_advance = jax.jit(lambda w: w.advance())
_jax_ring_add = jax.jit(JW.ring_add, static_argnums=0)
_jax_ring_advance = jax.jit(JW.ring_advance)
_jax_ring_contains_ref = jax.jit(JR.ring_contains_ref, static_argnums=0)


@pytest.mark.parametrize("G", [2, 4])
def test_windowed_filter_class_matches_jax(G):
    jw = JW.WindowedFilter.create("sbf", M, 8, 256, generations=G)
    tw = WindowedFilter.create("sbf", M, 8, 256, generations=G, device="cpu")
    for t in range(G + 1):
        jw, tw = _jax_add(jw, _batch(t)), tw.add(_batch(t))
        np.testing.assert_array_equal(_u32(tw.rings), np.asarray(jw.rings))
        np.testing.assert_array_equal(
            tw.generation_fill(), jw.generation_fill())
        jw, tw = _jax_advance(jw), tw.advance()
        assert tw.head == int(jw.head)
    assert tw.add(_batch(0)[:0]) is tw
    assert tw.contains(_batch(0)[:0]).shape == (0,)
    q = np.concatenate([_batch(G), JH.probe_u64x2(1000, seed=G)])
    np.testing.assert_array_equal(tw.contains(q).numpy(),
                                  np.asarray(jw.contains(q)))
    assert tw.fill_fraction() == pytest.approx(jw.fill_fraction(), rel=1e-6)
    assert tw.measure_fpr(1 << 12, 9) == jw.measure_fpr(1 << 12, 9)
    np.testing.assert_array_equal(_u32(tw.dense_words()),
                                  np.asarray(jw.dense_words()))
    assert repr(tw) == f"WindowedFilter({tw.spec}, G={G}, head={tw.head})"


def test_ring_transforms_match_jax():
    js = JV.FilterSpec("bbf", M, 8)
    ts = TV.FilterSpec("bbf", M, 8)
    jr, tr = JW.ring_init(js, 4), TW.ring_init(ts, 4)
    np.testing.assert_array_equal(_u32(tr), np.asarray(jr))
    jh, th = 0, 0
    for t in range(6):
        keys = _batch(t)
        jr = _jax_ring_add(js, jr, jnp.asarray(keys), jh)
        before = tr.clone()
        tr2 = TW.ring_add(ts, tr, as_keys(keys), th)
        assert torch.equal(tr, before)                  # input untouched
        tr = tr2
        np.testing.assert_array_equal(_u32(tr), np.asarray(jr))
        jr, jh = _jax_ring_advance(jr, jh)
        tr, th = TW.ring_advance(tr, th)
        np.testing.assert_array_equal(_u32(tr), np.asarray(jr))
        assert th == int(jh)
    dense = TV.add_rows(ts, TV.init(ts), as_keys(_batch(9)))
    jm = JW.ring_merge_dense(jr, jh, jnp.asarray(_u32(dense)))
    np.testing.assert_array_equal(_u32(TW.ring_merge_dense(tr, th, dense)),
                                  np.asarray(jm))
    np.testing.assert_array_equal(_u32(ring.ring_dense(tr)),
                                  np.asarray(JW.ring_dense(jr)))
    for bad in ((ts, 1), (TV.FilterSpec("countingbf", M, 8), 4)):
        with pytest.raises(ValueError):
            TW.ring_init(*bad)


@pytest.mark.parametrize("regime", ["vmem", "hbm", "auto"])
def test_ops_ring_contains_matches_ref(regime):
    ts = TV.FilterSpec("sbf", M, 8)
    js = JV.FilterSpec("sbf", M, 8)
    rings = torch.stack([TV.add_rows(ts, TV.init(ts), as_keys(_batch(g)))
                         for g in range(3)])
    ring.reset_launches()
    inserted = np.concatenate([_batch(g) for g in range(3)] * 2)
    for n in (0, 1, 255, 257):
        q = np.concatenate([inserted[:n], JH.probe_u64x2(n, seed=n)])
        want = np.asarray(_jax_ring_contains_ref(
            js, jnp.asarray(_u32(rings)), jnp.asarray(q)))
        got = ops.ring_contains(ts, rings, as_keys(q), regime=regime)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (2 * n,) and got[:n].all()
    for depth in (1, 2, 4, 8):
        got = ring.ring_contains_hbm(ts, rings, as_keys(_batch(2)),
                                     depth=depth)
        assert got.all()
    assert ring.LAUNCHES == dict.fromkeys(ring.LAUNCHES, 0)
    assert _build._lib is None
    with pytest.raises(ValueError):
        ring.ring_contains_hbm(ts, rings, as_keys(_batch(2)), depth=3)
    with pytest.raises(ValueError, match="G, n_words"):
        ring.ring_contains_vmem(ts, rings[0], as_keys(_batch(2)))
    with pytest.raises(ValueError):
        ops.ring_contains(ts, rings, as_keys(_batch(2)), regime="l3")


def test_ring_regime_follows_the_whole_ring():
    spec = TV.FilterSpec("sbf", ops.L2_FILTER_BYTES * 2, 8)   # 1/4 of L2
    assert ops._regime(spec, "auto", 4) == "vmem"
    assert ops._regime(spec, "auto", 5) == "hbm"
    assert ops.fits_l2(spec, 4) and not ops.fits_l2(spec, 8)


VARIANT_SPECS = [TV.FilterSpec("sbf", M, 8), TV.FilterSpec("bbf", M, 8),
                 TV.FilterSpec("rbbf", M, 4),
                 TV.FilterSpec("csbf", M, 8, block_bits=512, z=2),
                 TV.FilterSpec("cbf", M, 8),
                 TV.FilterSpec("countingbf", M, 8),
                 TV.FilterSpec("sbf", M, 64, block_bits=2048)]
# the JAX engine each port engine stands in for on the CPU
JAX_OF = {"torch": "jnp", "counting": "counting", "windowed": "windowed"}


@pytest.mark.parametrize("spec", VARIANT_SPECS, ids=str)
@pytest.mark.parametrize("G", [None, 2, 4, 8])
def test_engine_selection_for_every_variant_and_ring(spec, G):
    cpu = registry.SelectionContext(device=torch.device("cpu"),
                                    generations=G)
    gpu = registry.SelectionContext(device=torch.device("cuda"),
                                    generations=G)
    jspec = JV.FilterSpec(**dataclasses.asdict(spec))
    jctx = jregistry.SelectionContext.current(generations=G)
    try:
        want = jregistry.select(jspec, "auto", jctx).name
    except ValueError:
        want = None
    try:
        got = registry.select(spec, "auto", cpu).name
    except ValueError:
        got = None
    assert (JAX_OF[got] if got else None) == want
    try:
        got_gpu = registry.select(spec, "auto", gpu).name
    except ValueError:
        got_gpu = None
    if G is not None:
        blocked = spec.variant in TV.BLOCKED
        assert got == ("windowed" if blocked else None)
        assert got_gpu == ("windowed" if blocked and spec.s <= 32 else None)
    elif spec.is_counting:
        assert got == got_gpu == "counting"
    else:
        assert got == "torch"
        assert got_gpu == ("cuda-l2" if ops.kernel_supported(spec) else None)


def test_advance_needs_the_windowed_engine():
    f = api.make_filter("sbf", m_bits=M, k=8, device="cpu")
    with pytest.raises(NotImplementedError, match="'windowed'"):
        f.advance()
    w = api.make_filter("sbf", m_bits=M, k=8, generations=2, device="cpu")
    for call in (lambda: w.remove(_batch(0)), lambda: w.decay()):
        with pytest.raises(NotImplementedError):
            call()
    assert w.add(_batch(0)[:0]) is w
    assert not w.advance().words.any() and w.advance().head == 1
    with pytest.raises(ValueError):
        api.make_filter("sbf", m_bits=M, k=8, generations=2,
                        backend="torch", device="cpu")
    d = api.describe_backends()
    wd = next(x for x in d if x["name"] == "windowed")
    assert wd["supports_advance"] and wd["bits_per_key_at_ref_fpr"] is None
