"""The port's counting Bloom filter (countingbf) against the JAX package.

All port tensors here live on the CPU, so every wrapper runs its plain
version. Inputs come from ``repro.core.hashing.random_u64x2`` with a seed;
every comparison is exact (tolerance 0): words as np.uint32, results as
bool. The four specs are ``tests/test_counting.py``'s ``CSPECS``. The JAX
kernels run in Pallas interpret mode with the schedules that trace under
jax 0.9 (``probe="gather"``, ``coop="subtile"`` and ``decay``); no schedule
or regime changes a result. The CUDA path is tested on the card by
``tests/test_torch_gpu.py``.
"""
import dataclasses
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import hashing as JH
from repro.core import variants as JV
from repro.kernels import countingbf as JC
from repro.kernels import ops as JO
from repro.kernels.sbf import Layout as JLayout
import repro_torch.api as api
from repro_torch import interop
from repro_torch.api import registry
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import _build, ops
from repro_torch.kernels import countingbf as TC
from repro_torch.kernels.sbf import Layout

M = 1 << 14
CSPEC_ARGS = [(M, 8, 256), (M, 16, 512), (M, 4, 128), (M, 2, 64)]
IDS = [f"B{b}-k{k}" for _, k, b in CSPEC_ARGS]


def _specs(args):
    m, k, b = args
    return (JV.FilterSpec("countingbf", m, k, block_bits=b),
            TV.FilterSpec("countingbf", m, k, block_bits=b))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _i32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def _multiset(n: int, seed: int) -> np.ndarray:
    """n distinct keys, each 1-3 times, plus one key 20 times (its counters
    saturate), shuffled."""
    keys = JH.random_u64x2(n, seed=seed)
    rng = np.random.RandomState(seed)
    reps = rng.randint(1, 4, size=n)
    batch = np.concatenate([np.repeat(keys, reps, axis=0),
                            np.repeat(keys[:1], 20, axis=0)])
    return batch[rng.permutation(len(batch))]


def _valid(n: int, seed: int) -> np.ndarray:
    return (np.random.RandomState(seed + 99).rand(n) > 0.25).astype(np.uint8)


# ---------------------------------------------------------------------------
# Nibble helpers
# ---------------------------------------------------------------------------

def _edge_words() -> np.ndarray:
    """Every combination of 0, 1, 14 and 15 over the 8 nibbles (bits 28-31
    included), 4^8 words."""
    vals = np.array([0, 1, 14, 15], np.uint32)
    out = np.zeros(4 ** 8, np.uint32)
    for i, combo in enumerate(itertools.product(range(4), repeat=8)):
        w = 0
        for b, v in enumerate(combo):
            w |= int(vals[v]) << (4 * b)
        out[i] = w
    return out


@functools.lru_cache(maxsize=None)
def _words():
    rng = np.random.RandomState(0)
    rand = rng.randint(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    a = np.concatenate([_edge_words(), rand])
    b = rng.randint(0, 2 ** 32, size=a.shape[0], dtype=np.uint64).astype(
        np.uint32)
    b[: 4 ** 8] = _edge_words()[rng.permutation(4 ** 8)]
    return a, b


UNARY = ["nib_saturated", "nib_nonzero", "decay_word"]
FLAGGED = ["sat_inc_word", "guard_dec_word"]
BINARY = ["nib_sat_add_words", "nib_guard_sub_words"]


@pytest.mark.parametrize("name", UNARY + FLAGGED + BINARY)
def test_nibble_helpers_match_jax(name):
    a, b = _words()
    if name in FLAGGED:
        b = b & np.uint32(0x11111111)           # one flag per nibble
    jfn, tfn = getattr(JV, name), getattr(TV, name)
    if name in UNARY:
        want, got = jfn(jnp.asarray(a)), tfn(_i32(a))
    else:
        want, got = jfn(jnp.asarray(a), jnp.asarray(b)), tfn(_i32(a), _i32(b))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32


@pytest.mark.parametrize("s", [1, 2, 8, 16])
def test_mask_expand_and_collapse_match_jax(s):
    a, _ = _words()
    masks = a[: (len(a) // s) * s].reshape(-1, s)
    want = np.asarray(JV.expand_mask_words(jnp.asarray(masks)))
    got = TV.expand_mask_words(_i32(masks))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    cw = a[: (len(a) // (4 * s)) * 4 * s].reshape(-1, 4 * s)
    want = np.asarray(JV.collapse_counter_words(jnp.asarray(cw)))
    got = TV.collapse_counter_words(_i32(cw))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # expand then collapse is the identity on bit masks
    np.testing.assert_array_equal(
        TV.collapse_counter_words(TV.expand_mask_words(_i32(masks)))
        .numpy().astype(np.uint32), masks)


# ---------------------------------------------------------------------------
# The counting references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", CSPEC_ARGS, ids=IDS)
def test_counting_functions_match_jax(args):
    js, ts = _specs(args)
    batch = _multiset(600, seed=js.k)
    valid = _valid(len(batch), js.k)
    jb, tb = jnp.asarray(batch), as_keys(batch)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)

    j_add = JV.counting_add(js, JV.init(js), jb, valid=jv)
    t_add = TV.counting_add(ts, TV.init(ts), tb, valid=tv)
    assert t_add.dtype == torch.int32
    np.testing.assert_array_equal(_u32(t_add), np.asarray(j_add))
    np.testing.assert_array_equal(
        _u32(TV.counting_update_loop(ts, TV.init(ts), tb, tv, "add")),
        np.asarray(j_add))
    np.testing.assert_array_equal(
        _u32(TV.add(ts, TV.init(ts), tb)),
        np.asarray(JV.add(js, JV.init(js), jb)))

    gone = JH.random_u64x2(300, seed=js.k)                 # half were added
    gone = np.concatenate([gone, JH.probe_u64x2(100, seed=3)])  # never added
    j_rm = JV.counting_remove(js, j_add, jnp.asarray(gone))
    t_rm = TV.counting_remove(ts, t_add, as_keys(gone))
    np.testing.assert_array_equal(_u32(t_rm), np.asarray(j_rm))
    np.testing.assert_array_equal(
        _u32(TV.counting_update_loop(ts, t_add, as_keys(gone), None,
                                     "remove")), np.asarray(j_rm))

    q = np.concatenate([batch[:500], JH.probe_u64x2(1500, seed=4)])
    for j_words, t_words in ((j_add, t_add), (j_rm, t_rm)):
        np.testing.assert_array_equal(
            TV.counting_contains(ts, t_words, as_keys(q)).numpy(),
            np.asarray(JV.counting_contains(js, j_words, jnp.asarray(q))))
        np.testing.assert_array_equal(
            TV.contains(ts, t_words, as_keys(q)).numpy(),
            np.asarray(JV.contains(js, j_words, jnp.asarray(q))))
        np.testing.assert_array_equal(
            TV.counting_count(ts, t_words, as_keys(q)).numpy(),
            np.asarray(JV.counting_count(js, j_words, jnp.asarray(q))))
        np.testing.assert_array_equal(
            _u32(TV.counting_decay(ts, t_words)),
            np.asarray(JV.counting_decay(js, j_words)))
        np.testing.assert_array_equal(
            _u32(TV.counting_to_bloom(ts, t_words)),
            np.asarray(JV.counting_to_bloom(js, j_words)))
    hot = as_keys(JH.random_u64x2(600, seed=js.k)[:1])
    assert int(TV.counting_count(ts, TV.counting_add(ts, TV.init(ts), tb),
                                 hot)[0]) == 15      # saturated


def test_counting_from_bloom_matches_jax():
    js, ts = _specs(CSPEC_ARGS[0])
    bits = _words()[0][: js.n_words]
    np.testing.assert_array_equal(
        _u32(TV.counting_from_bloom(ts, _i32(bits))),
        np.asarray(JV.counting_from_bloom(js, jnp.asarray(bits))))


def test_bit_references_refuse_counting_specs():
    _, ts = _specs(CSPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(8, seed=0))
    for fn in (TV.add_rows, TV.add_loop):
        with pytest.raises(ValueError, match="counting"):
            fn(ts, TV.init(ts), keys)
    with pytest.raises(ValueError):
        TV.counting_add(TV.FilterSpec("sbf", M, 8), TV.init(ts), keys)


# ---------------------------------------------------------------------------
# The wrappers and ops.counting_* against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def _jax_kernels(js, keys, valid, gone, kw):
    """JAX kernels on padded inputs: (add words, remove words, contains on
    keys + probes of the removed filter, decay of it)."""
    n = keys.shape[0]
    tile = JO._clamp_tile(n, 256)
    pk, pv = JO._pad_keys_valid(jnp.asarray(keys), tile, jnp.asarray(valid))
    w_add = JC.update_vmem(js, JV.init(js), pk, pv, "add", tile=tile, **kw)
    gk, gv = JO._pad_keys_valid(jnp.asarray(gone), tile)
    w_rm = JC.update_vmem(js, w_add, gk, gv, "remove", tile=tile, **kw)
    q = np.concatenate([keys, JH.probe_u64x2(n, seed=n)])
    qt = JO._clamp_tile(len(q), 256)
    hits = JC.contains_vmem(js, w_rm, JO._pad_keys(jnp.asarray(q), qt),
                            tile=qt, **kw)[: len(q)]
    return (np.asarray(w_add), np.asarray(w_rm), q, np.asarray(hits),
            np.asarray(JC.decay(js, w_rm)))


@pytest.mark.parametrize("args", CSPEC_ARGS, ids=IDS)
@pytest.mark.parametrize("n", [1, 257, 1000])
def test_wrappers_and_ops_match_jax_kernels(args, n):
    js, ts = _specs(args)
    keys = JH.random_u64x2(n, seed=n)
    keys = np.concatenate([keys, keys[: n // 3]])             # repeats
    valid = _valid(len(keys), n)
    gone = keys[: max(1, n // 2)]
    tk, tv = as_keys(keys), torch.from_numpy(valid)
    for kw in (dict(probe="gather"), dict(coop="subtile")):
        w_add, w_rm, q, hits, dec = _jax_kernels(js, keys, valid, gone, kw)
        # ops.counting_* pad with valid masks themselves
        for regime in ("vmem", "hbm"):
            got = ops.counting_add(ts, TV.init(ts), tk, valid=tv,
                                   regime=regime, **kw)
            np.testing.assert_array_equal(_u32(got), w_add)
            got = ops.counting_remove(ts, got, as_keys(gone), regime=regime,
                                      **kw)
            np.testing.assert_array_equal(_u32(got), w_rm)
            np.testing.assert_array_equal(
                ops.counting_contains(ts, got, as_keys(q), regime=regime,
                                      **kw).numpy(), hits)
            np.testing.assert_array_equal(_u32(ops.counting_decay(ts, got)),
                                          dec)
    # the wrappers themselves, in place, on unpadded keys
    words = TV.init(ts)
    assert TC.update_vmem(ts, words, tk, tv, "add") is words
    np.testing.assert_array_equal(_u32(words), w_add)
    TC.update_hbm(ts, words, as_keys(gone), None, "remove")
    np.testing.assert_array_equal(_u32(words), w_rm)
    np.testing.assert_array_equal(
        TC.contains_vmem(ts, words, as_keys(q)).numpy(), hits)
    np.testing.assert_array_equal(
        TC.contains_hbm(ts, words, as_keys(q)).numpy(), hits)
    assert TC.decay(ts, words) is words
    np.testing.assert_array_equal(_u32(words), dec)


def test_padding_with_valid_matches_jax():
    for n in (1, 7, 8, 255, 257, 1000):
        keys = JH.random_u64x2(n, seed=n)
        valid = _valid(n, n)
        tile = ops._clamp_tile(n, 256)
        for v in (None, valid):
            jk, jv = JO._pad_keys_valid(
                jnp.asarray(keys), tile, None if v is None else jnp.asarray(v))
            tk, tv = ops._pad_keys_valid(
                as_keys(keys), tile, None if v is None else torch.from_numpy(v))
            np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            assert tv.dtype == torch.uint8


@pytest.mark.parametrize("args", CSPEC_ARGS, ids=IDS)
def test_counting_layouts_match_jax(args):
    js, ts = _specs(args)
    for op in ("contains", "add", "remove"):
        jl = JC.default_counting_layout(js, op)
        tl = TC.default_counting_layout(ts, op)
        assert (tl.theta, tl.phi) == (jl.theta, jl.phi)
    for theta, phi, tile in ((1, 8, 256), (2, 4, 64), (8, 16, 8), (4, 2, 2),
                             (1, 3, 8), (3, 1, 6), (1, 64, 8)):
        try:
            jl = JC.counting_layout(js, JLayout(theta, phi), tile)
        except AssertionError:
            with pytest.raises(ValueError):
                TC.counting_layout(ts, Layout(theta, phi), tile)
        else:
            tl = TC.counting_layout(ts, Layout(theta, phi), tile)
            assert (tl.theta, tl.phi) == (jl.theta, jl.phi)


def test_schedule_axes_never_change_counting_results():
    _, ts = _specs(CSPEC_ARGS[1])
    keys = as_keys(_multiset(400, seed=5))
    q = as_keys(np.concatenate([JH.random_u64x2(400, seed=5),
                                JH.probe_u64x2(400, seed=5)]))
    want = TV.counting_add(ts, TV.init(ts), keys)
    want_hits = TV.counting_contains(ts, want, q).numpy()
    for kw in (dict(probe="loop", coop="none", mix="full"),
               dict(probe="gather", coop="subtile", mix="cheap"),
               dict(layout=Layout(2, 4), tile=64),
               dict(layout=Layout(8, 1), tile=8)):
        for regime in ("vmem", "hbm", "auto"):
            got = ops.counting_add(ts, TV.init(ts), keys, regime=regime, **kw)
            np.testing.assert_array_equal(_u32(got), _u32(want))
            hits = ops.counting_contains(ts, want, q, regime=regime, **kw)
            np.testing.assert_array_equal(hits.numpy(), want_hits)
    for depth in (1, 2, 4, 8):
        hits = ops.counting_contains(ts, want, q, regime="hbm", depth=depth)
        np.testing.assert_array_equal(hits.numpy(), want_hits)


def test_counting_ops_inplace_and_empty():
    _, ts = _specs(CSPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(300, seed=1))
    base = TV.init(ts)
    new = ops.counting_add(ts, base, keys)
    assert not base.any() and new.any()
    same = ops.counting_add(ts, base, keys, inplace=True)
    assert same is base
    np.testing.assert_array_equal(_u32(base), _u32(new))
    assert ops.counting_remove(ts, new, keys[:0]) is not new        # n == 0
    assert ops.counting_remove(ts, new, keys[:0], inplace=True) is new
    assert ops.counting_contains(ts, new, keys[:0]).shape == (0,)
    decayed = ops.counting_decay(ts, new)
    assert decayed is not new
    assert ops.counting_decay(ts, new, inplace=True) is new
    np.testing.assert_array_equal(_u32(new), _u32(decayed))


def test_counting_cpu_path_launches_nothing():
    _, ts = _specs(CSPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(100, seed=2))
    TC.reset_launches()
    for regime in ("vmem", "hbm"):
        words = ops.counting_add(ts, TV.init(ts), keys, regime=regime)
        ops.counting_remove(ts, words, keys, regime=regime)
        ops.counting_contains(ts, words, keys, regime=regime)
    ops.counting_decay(ts, words)
    assert TC.LAUNCHES == dict.fromkeys(TC.LAUNCHES, 0)
    assert _build._lib is None


def test_counting_wrappers_and_ops_refuse_bad_inputs():
    _, ts = _specs(CSPEC_ARGS[0])
    words = TV.init(ts)
    keys = as_keys(JH.random_u64x2(8, seed=0))
    with pytest.raises(ValueError, match="op="):
        TC.update_vmem(ts, words, keys, None, "inc")
    with pytest.raises(ValueError, match="valid"):
        TC.update_hbm(ts, words, keys, torch.ones(7, dtype=torch.uint8), "add")
    with pytest.raises(ValueError, match="valid"):
        TC.update_hbm(ts, words, keys, torch.ones(8, dtype=torch.int32), "add")
    with pytest.raises(ValueError, match="depth"):
        TC.contains_hbm(ts, words, keys, depth=3)
    with pytest.raises(ValueError, match="tile_words"):
        TC.decay(ts, words, tile_words=3)
    with pytest.raises(ValueError, match="int32"):
        TC.contains_vmem(ts, words, keys.to(torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        TC.decay(ts, words.to("meta"))
    sbf = TV.FilterSpec("sbf", M, 8)
    with pytest.raises(ValueError, match="counting"):
        ops.bloom_add(ts, words, keys)
    with pytest.raises(ValueError, match="counting"):
        ops.bloom_contains(ts, words, keys)
    with pytest.raises(ValueError, match="countingbf"):
        ops.counting_add(sbf, TV.init(sbf), keys)
    with pytest.raises(ValueError, match="countingbf"):
        ops.counting_decay(sbf, TV.init(sbf))


# ---------------------------------------------------------------------------
# The slice as a whole: Filter against repro.api
# ---------------------------------------------------------------------------

def _pair(args):
    m, k, b = args
    kw = dict(m_bits=m, k=k, block_bits=b)
    return (japi.make_filter("countingbf", **kw),
            api.make_filter("countingbf", device="cpu", **kw))


@pytest.mark.parametrize("args", CSPEC_ARGS, ids=IDS)
def test_filter_matches_repro_api(args):
    jf, tf = _pair(args)
    assert jf.backend == tf.backend == "counting"
    assert tf.words.shape == (tf.spec.storage_words,)
    a = _multiset(500, seed=args[1])
    b = JH.random_u64x2(800, seed=7)
    gone = np.concatenate([b[:400], JH.probe_u64x2(50, seed=8)])
    jf = jf.add(a).add(b).remove(gone).decay(2)
    tf = tf.add(a).add(b).remove(gone).decay(2)
    np.testing.assert_array_equal(_u32(tf.words), np.asarray(jf.words))
    jo, to = _pair(args)
    jo, to = jo.add(a[:300]).add(a[:300]), to.add(a[:300]).add(a[:300])
    jm, tm = jf.merge(jo), tf.merge(to)
    np.testing.assert_array_equal(_u32(tm.words), np.asarray(jm.words))
    np.testing.assert_array_equal(_u32((tf | to).words), np.asarray(jm.words))
    q = np.concatenate([a, b, JH.probe_u64x2(1000, seed=9)])
    np.testing.assert_array_equal(tm.contains(q).numpy(),
                                  np.asarray(jm.contains(q)))
    np.testing.assert_array_equal(_u32(tm.dense_words()),
                                  np.asarray(jm.dense_words()))
    assert tm.fill_fraction() == pytest.approx(jm.fill_fraction(), rel=1e-6)


def test_filter_merge_needs_the_same_spec_as_in_jax():
    jf, tf = _pair(CSPEC_ARGS[0])
    keys = JH.random_u64x2(300, seed=11)
    bits = api.make_filter("sbf", m_bits=M, k=8, device="cpu").add(keys)
    with pytest.raises(ValueError, match="cannot merge"):
        tf.add(keys).merge(bits)
    with pytest.raises(ValueError, match="cannot merge"):
        jf.add(keys).merge(japi.make_filter("sbf", m_bits=M, k=8).add(keys))


@pytest.mark.parametrize("n,bits", [(1000, 16.0), (70000, 12.0)])
def test_filter_for_n_items_counting_sizes_like_jax(n, bits):
    jf = japi.filter_for_n_items(n, bits_per_key=bits, variant="countingbf")
    tf = api.filter_for_n_items(n, bits_per_key=bits, variant="countingbf",
                                device="cpu")
    assert dataclasses.asdict(tf.spec) == dataclasses.asdict(jf.spec)
    assert tf.backend == jf.backend == "counting"
    assert tf.nbytes == tf.spec.storage_words * 4


def test_counting_engine_capabilities_match_jax():
    mine = api.get_backend("counting").describe()
    theirs = japi.get_backend("counting").describe()
    for key in ("supports_remove", "supports_decay", "supports_count",
                "supports_merge", "bits_per_key_at_ref_fpr", "ref_fpr"):
        assert mine[key] == theirs[key], key
    assert api.get_backend("counting").bits_per_key(1e-2) == pytest.approx(
        japi.get_backend("counting").bits_per_key(1e-2))
    spec = TV.FilterSpec("countingbf", M, 8)
    cpu = registry.SelectionContext(device=torch.device("cpu"))
    gpu = registry.SelectionContext(device=torch.device("cuda"))
    for ctx in (cpu, gpu):
        assert registry.select(spec, "auto", ctx).name == "counting"
        assert registry.select(spec, "counting", ctx).name == "counting"
    for name, ctx in (("torch", cpu), ("jnp", cpu), ("cuda-l2", gpu),
                      ("cuda-dram", gpu), ("pallas", gpu)):
        with pytest.raises(ValueError):
            registry.select(spec, name, ctx)
    wide = TV.FilterSpec("countingbf", M, 64, block_bits=2048)
    assert registry.select(wide, "auto", cpu).name == "counting"
    with pytest.raises(ValueError):
        registry.select(wide, "auto", gpu)             # s > 32: no kernel


def test_remove_and_decay_need_the_counting_engine():
    f = api.make_filter("sbf", m_bits=M, k=8, device="cpu")
    jf = japi.make_filter("sbf", m_bits=M, k=8)
    keys = JH.random_u64x2(4, seed=0)
    for mine, theirs in ((lambda: f.remove(keys), lambda: jf.remove(keys)),
                         (lambda: f.decay(), lambda: jf.decay())):
        with pytest.raises(NotImplementedError) as got:
            mine()
        with pytest.raises(NotImplementedError) as want:
            theirs()
        assert str(got.value).replace("'torch'", "'jnp'") == str(want.value)
    _, cf = _pair(CSPEC_ARGS[0])
    for call in (lambda: cf.add(keys, valid=np.ones(4, np.uint8)),
                 lambda: cf.remove(keys, valid=np.ones(4, np.uint8))):
        with pytest.raises(ValueError, match="valid="):
            call()
    with pytest.raises(ValueError, match="need a bank"):
        cf.remove(keys, tenants=np.zeros(4, np.int32))
    assert cf.remove(keys[:0]) is cf
    assert cf.decay(0) is cf


# ---------------------------------------------------------------------------
# Carrying state across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", CSPEC_ARGS, ids=IDS)
def test_jax_words_carry_counts_losslessly(args):
    jf, _ = _pair(args)
    keys = JH.random_u64x2(600, seed=13)
    jf = jf.add(keys).add(keys[:300]).add(keys[:40])
    tf = interop.from_jax_words(dataclasses.asdict(jf.spec),
                                np.asarray(jf.words), device="cpu")
    assert tf.backend == "counting"
    np.testing.assert_array_equal(_u32(tf.words), np.asarray(jf.words))
    gone = keys[:350]
    jr, tr = jf.remove(gone), tf.remove(gone)
    np.testing.assert_array_equal(_u32(tr.words), np.asarray(jr.words))
    fields, words = interop.to_jax_words(tr.decay(1))
    assert fields == dataclasses.asdict(jr.spec)
    back = jr.replace(words=jnp.asarray(words))
    np.testing.assert_array_equal(np.asarray(back.words),
                                  np.asarray(jr.decay(1).words))
    with pytest.raises(ValueError):
        interop.from_jax_words(fields, words[:-4], device="cpu")
    with pytest.raises(ValueError):
        interop.from_jax_words(fields, words.view(np.int32), device="cpu")


def test_jax_state_is_occupancy_only_as_in_jax():
    jf, _ = _pair(CSPEC_ARGS[0])
    keys = JH.random_u64x2(800, seed=14)
    jf = jf.add(keys).add(keys[:200])
    state = {k: (np.asarray(v) if k == "words" else v)
             for k, v in jf.to_state().items()}
    assert state["words"].shape == (jf.spec.n_words,)
    tf = interop.from_jax_state(state, device="cpu")
    jback = japi.Filter.from_state(state)
    assert tf.backend == jback.backend == "counting"
    np.testing.assert_array_equal(_u32(tf.words), np.asarray(jback.words))
    assert int(TV.counting_count(tf.spec, tf.words,
                                 as_keys(keys[:200])).max()) == 1
    out = interop.to_jax_state(tf)
    assert out["backend"] == "counting"
    np.testing.assert_array_equal(out["words"], np.asarray(jf.dense_words()))
    again = japi.Filter.from_state(out)
    np.testing.assert_array_equal(np.asarray(again.words),
                                  np.asarray(jback.words))
