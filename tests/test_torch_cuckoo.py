"""The cuckoo filter of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy keys, validity masks and tenants go through the JAX
package (``repro.core.fingerprint`` (``F``), its jnp reference, and
``repro.kernels.ops.cuckoo_*``, its Pallas kernels in interpret mode, which
trace under jax 0.9) and through ``repro_torch`` with CPU tensors, where
every wrapper runs its plain version (the sequential tile loop). Hashes,
packing, contains (both ``coop`` values), add and remove words and
``ok``/``found`` flags must be equal bit for bit (tolerance 0), for
multi-tile, masked, duplicate and over-full batches; so must the failure
counts of the API, banks (batched and routed, with valid masks), states
through ``interop`` and the sizing helpers. The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_gpu.py``.

Sizes stay small: tables of at most 2^12 buckets, at most 4096 keys, tiles
of 256 keys for the multi-tile cases (the JAX jnp update compiles each
tile, so it runs on the smaller batches only).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import fingerprint as JF
from repro.core import hashing as JH
from repro.core import variants as JV
from repro.kernels import ops as JO
import repro_torch.api as api
from repro_torch import interop
from repro_torch.api import registry
from repro_torch.api.filter import as_keys
from repro_torch.core import fingerprint as TF
from repro_torch.core import variants as TV
from repro_torch.kernels import cuckoofilter as TK
from repro_torch.kernels import ops

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

GEOMETRIES = [(8, 4, 1 << 10), (16, 2, 1 << 11), (16, 4, 1 << 9),
              (8, 8, 1 << 8)]
IDS = [f"u{sb}x{spb}" for sb, spb, _ in GEOMETRIES]


def _specs(slot_bits, spb, n_buckets):
    kw = dict(m_bits=n_buckets * spb * slot_bits, k=2, slot_bits=slot_bits,
              slots_per_bucket=spb)
    return JV.FilterSpec("cuckoo", **kw), TV.FilterSpec("cuckoo", **kw)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _eq_words(port, jax_words):
    np.testing.assert_array_equal(_u32(port), np.asarray(jax_words))


def _eq(port, jax_value):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(jax_value))


def _batch(n, seed, dup=0.05, invalid=0.25):
    """n keys with about ``dup`` of them repeated, and a valid mask with
    about ``invalid`` zeros."""
    rng = np.random.RandomState(seed)
    keys = JH.random_u64x2(n, seed=seed)
    d = int(n * dup)
    keys = np.concatenate([keys, keys[rng.randint(0, n, size=d)]])
    keys = keys[rng.permutation(len(keys))]
    valid = (rng.rand(len(keys)) > invalid).astype(np.uint8)
    return keys, valid


# ---------------------------------------------------------------------------
# Hashing, packing, contains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_hashes_alt_bucket_and_packing_match_jax(geom):
    js, ts = _specs(*geom)
    keys = JH.random_u64x2(2000, seed=1)
    jb, jfp, jrng = JF.cuckoo_hashes(js, jnp.asarray(keys))
    tb, tfp, trng = TF.cuckoo_hashes(ts, as_keys(keys))
    _eq(tb, jb)
    _eq(tfp, jfp)
    _eq(trng, jrng)
    assert bool((tfp > 0).all()) and bool((tfp < 1 << ts.slot_bits).all())
    alt = TF.alt_bucket(ts, tb, tfp)
    _eq(alt, JF.alt_bucket(js, jb, jfp))
    _eq(TF.alt_bucket(ts, alt, tfp), jb)                # an involution
    assert TF.alt_bucket(ts, int(tb[0]), int(tfp[0])) == int(alt[0])
    words = JH.random_u64x2(300, seed=2).reshape(-1)[: 300 * ts.s]
    words = words.reshape(300, ts.s)
    slots = TF.unpack_slots(ts, torch.from_numpy(words.view(np.int32)))
    _eq(slots, JF.unpack_slots(js, jnp.asarray(words)))
    _eq_words(TF.pack_slots(ts, slots), words)


@pytest.mark.parametrize("geom", GEOMETRIES[:3], ids=IDS[:3])
def test_contains_matches_jax_kernels_and_reference(geom):
    """Against the Pallas kernel, whose body is ``F.cuckoo_contains`` /
    ``F.cuckoo_contains_coop`` (and once against those directly)."""
    js, ts = _specs(*geom)
    keys, _ = _batch(int(ts.n_slots * 0.7), seed=3)
    tt, _ = TF.cuckoo_add(ts, TF.init(ts), as_keys(keys), tile=1024)
    table = jnp.asarray(_u32(tt))
    queries = np.concatenate([keys, JH.probe_u64x2(1000, seed=4)])
    for coop in ("none", "subtile"):
        want = JO.cuckoo_contains(js, table, jnp.asarray(queries), coop=coop)
        _eq(ops.cuckoo_contains(ts, tt, as_keys(queries), coop=coop), want)
        _eq(TK.contains_plain(ts, tt, as_keys(queries), coop), want)
    if geom == GEOMETRIES[0]:
        _eq(TF.cuckoo_contains(ts, tt, as_keys(queries)),
            JF.cuckoo_contains(js, table, jnp.asarray(queries)))
        _eq(TF.cuckoo_contains_coop(ts, tt, as_keys(keys)),
            JF.cuckoo_contains_coop(js, table, jnp.asarray(keys)))
    assert ops.cuckoo_contains(ts, tt, as_keys(keys[:0])).shape == (0,)


# ---------------------------------------------------------------------------
# add / remove: words and flags, multi-tile, masked, duplicates, failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_add_remove_match_jax_kernels(geom):
    js, ts = _specs(*geom)
    keys, valid = _batch(int(ts.n_slots * 0.9), seed=5)
    jt, jok = JO.cuckoo_add(js, JF.init(js), jnp.asarray(keys),
                            valid=jnp.asarray(valid), tile=256)
    base = TF.init(ts)
    tt, tok = ops.cuckoo_add(ts, base, as_keys(keys),
                             valid=torch.from_numpy(valid), tile=256)
    assert not base.any()                          # inplace=False
    _eq_words(tt, jt)
    _eq(tok, jok)
    gone = np.concatenate([keys[: len(keys) // 2],
                           JH.probe_u64x2(40, seed=6)])
    jr, jfound = JO.cuckoo_remove(js, jt, jnp.asarray(gone), tile=256)
    tr, tfound = ops.cuckoo_remove(ts, tt, as_keys(gone), tile=256,
                                   inplace=True)
    assert tr is tt
    _eq_words(tr, jr)
    _eq(tfound, jfound)
    assert not bool(tfound[-40:].all())            # absent probes


@pytest.mark.parametrize("tile, n", [(128, 300)])
def test_add_remove_match_jax_reference(tile, n):
    js, ts = _specs(8, 4, 1 << 8)
    keys, valid = _batch(n, seed=n)
    jt, jok = JF.cuckoo_add(js, JF.init(js), jnp.asarray(keys),
                            valid=jnp.asarray(valid), tile=tile)
    tt, tok = TF.cuckoo_add(ts, TF.init(ts), as_keys(keys),
                            valid=torch.from_numpy(valid), tile=tile)
    _eq_words(tt, jt)
    _eq(tok, jok)
    jr, jf = JF.cuckoo_remove(js, jt, jnp.asarray(keys[:200]), tile=tile)
    tr, tf = TF.cuckoo_remove(ts, tt, as_keys(keys[:200]), tile=tile)
    _eq_words(tr, jr)
    _eq(tf, jf)
    # the tile functions alone, on one sorted tile
    b1, fp, rng = TF.cuckoo_hashes(ts, as_keys(keys[:64]))
    jb1, jfp, jrng = JF.cuckoo_hashes(js, jnp.asarray(keys[:64]))
    v = np.ones(64, bool)
    tt1, tok1 = TF.cuckoo_insert_tile(ts, TF.init(ts), b1, fp, rng,
                                      torch.from_numpy(v))
    jt1, jok1 = JF.cuckoo_insert_tile(js, JF.init(js), jb1, jfp, jrng,
                                      jnp.asarray(v))
    _eq_words(tt1, jt1)
    _eq(tok1, jok1)
    tt2, tf2 = TF.cuckoo_remove_tile(ts, tt1, b1, fp, rng,
                                     torch.from_numpy(v))
    jt2, jf2 = JF.cuckoo_remove_tile(js, jt1, jb1, jfp, jrng, jnp.asarray(v))
    _eq_words(tt2, jt2)
    _eq(tf2, jf2)


@pytest.mark.parametrize("geom", [GEOMETRIES[0], GEOMETRIES[1]],
                         ids=IDS[:2])
def test_kick_failures_match_jax_and_keep_occupancy_exact(geom):
    js, ts = _specs(*geom)
    keys = JH.random_u64x2(int(ts.n_slots * 1.2), seed=7)
    jt, jok = JO.cuckoo_add(js, JF.init(js), jnp.asarray(keys), tile=512)
    tt, tok = ops.cuckoo_add(ts, TF.init(ts), as_keys(keys), tile=512)
    _eq_words(tt, jt)
    _eq(tok, jok)
    assert 0 < int((~tok).sum())
    occupied = TF.occupied_slots(ts, tt)
    assert int(occupied) == int(tok.sum()) == int(JF.occupied_slots(js, jt))
    np.testing.assert_allclose(float(TF.cuckoo_load_factor(ts, tt)),
                               float(JF.cuckoo_load_factor(js, jt)),
                               rtol=0, atol=0)


def test_ops_tiles_and_empty_batches_match_jax():
    for n, tile in ((1, None), (7, None), (2048, None), (2049, None),
                    (300, 256), (256, 256), (9, 4)):
        assert ops._cuckoo_tile(n, tile) == JO._cuckoo_tile(n, tile)
    _, ts = _specs(8, 4, 1 << 6)
    table, flags = ops.cuckoo_add(ts, TF.init(ts), as_keys(
        JH.random_u64x2(4, seed=0))[:0])
    assert flags.shape == (0,) and not table.any()
    _, flags = ops.cuckoo_remove(ts, table, as_keys(
        JH.random_u64x2(4, seed=0))[:0])
    assert flags.shape == (0,)
    assert TK.LAUNCHES == dict.fromkeys(TK.LAUNCHES, 0)   # CPU: none


# ---------------------------------------------------------------------------
# The Filter API, banks, states
# ---------------------------------------------------------------------------

def _filters(n, **kw):
    j = japi.filter_for_n_items(n, variant="cuckoo", impl="jnp", **kw)
    t = api.filter_for_n_items(n, variant="cuckoo", device="cpu", **kw)
    return j, t


def test_insert_failures_accumulate_and_are_not_reset():
    j, t = _filters(300, bits_per_key=8.0, tile=256)
    assert t.backend == "cuckoo" and dataclasses.asdict(t.spec) == \
        dataclasses.asdict(j.spec)
    keys = JH.random_u64x2(int(t.spec.n_slots * 1.3), seed=8)
    valid = np.ones(len(keys), np.uint8)
    valid[::7] = 0
    j1, t1 = j.add(keys, valid=valid), t.add(keys, valid=valid)
    _eq_words(t1.words, j1.words)
    fails = int(t1.insert_failures)
    assert fails > 0 and fails == int(j1.insert_failures)
    assert t1.insert_failures.dtype == torch.int64
    more = JH.random_u64x2(50, seed=9)
    j2, t2 = j1.add(more).remove(keys[:100]), t1.add(more).remove(keys[:100])
    _eq_words(t2.words, j2.words)
    assert int(t2.insert_failures) == int(j2.insert_failures) >= fails
    assert t2.load_factor() == pytest.approx(float(j2.load_factor()), abs=0)
    assert t2.approx_count() == j2.approx_count()
    assert t2.health() == j2.health()
    _eq(t2.contains(keys), j2.contains(keys))


def test_engine_capabilities_match_jax():
    j, t = _filters(1000)
    je, te = j.engine, t.engine
    for flag in ("supports_remove", "supports_merge", "supports_decay",
                 "supports_advance", "stateful_ops"):
        assert getattr(te, flag) == getattr(je, flag), flag
    assert te.bits_per_key() == je.bits_per_key()
    with pytest.raises(ValueError, match="merge") as got:
        t.merge(t)
    with pytest.raises(ValueError, match="merge") as want:
        j.merge(j)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="merged"):
        te.merge(t.spec, t.words, t.words, t.options)
    with pytest.raises(NotImplementedError, match="decay"):
        t.decay()
    with pytest.raises(NotImplementedError, match="fill_fraction"):
        api.make_filter(device="cpu").load_factor()
    with pytest.raises(NotImplementedError, match="insert-failure"):
        api.make_filter(device="cpu").insert_failures
    cpu = registry.SelectionContext(device=torch.device("cpu"))
    gpu = registry.SelectionContext(device=torch.device("cuda"))
    for ctx in (cpu, gpu):
        assert registry.select(t.spec, "auto", ctx).name == "cuckoo"
        for name in ("torch", "cuda-l2", "counting", "windowed"):
            with pytest.raises(ValueError):
                registry.select(t.spec, name, ctx)
    wide = api.FilterSpec("cuckoo", 1 << 16, 2, slot_bits=8,
                          slots_per_bucket=32)
    assert registry.select(wide, "auto", cpu).name == "cuckoo"
    with pytest.raises(ValueError):                # no kernel instance
        registry.select(wide, "auto", gpu)
    with pytest.raises(ValueError, match="impl"):
        api.make_filter("cuckoo", m_bits=1 << 12, k=2, impl="xla",
                        device="cpu").add(JH.random_u64x2(4, seed=0))


@pytest.mark.parametrize("n, kw", [
    (1000, {}), (1 << 14, {"bits_per_key": 12.0}),
    (1 << 14, {"bits_per_key": 16.0}), (5000, {"target_fpr": 5e-2}),
    (5000, {"target_fpr": 1e-3}), (3000, {"slot_bits": 16}),
    (3000, {"slots_per_bucket": 2, "slot_bits": 16})])
def test_filter_for_n_items_sizes_like_jax(n, kw):
    j, t = _filters(n, **kw)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert t.words.shape == tuple(j.words.shape) and not t.words.any()
    js, ts = j.spec, t.spec
    assert TV.fpr_theory(ts, n) == JV.fpr_theory(js, n)
    assert TV.space_optimal_n(ts) == JV.space_optimal_n(js)
    assert TV.space_optimal_n(ts, 1e-3) == JV.space_optimal_n(js, 1e-3)
    assert TF.bits_per_key(ts) == JF.bits_per_key(js)
    assert TF.bits_per_key(ts, n) == JF.bits_per_key(js, n)
    for eps in (0.5, 1e-2, 1e-4, 1e-7):
        assert TF.slot_bits_for_fpr(eps) == JF.slot_bits_for_fpr(eps)
    with pytest.raises(ValueError, match="slot width"):
        TF.spec_for_n(n, target_fpr=1e-9)


def _bank_pair(B, **kw):
    j = japi.make_filter_bank(B, "cuckoo", m_bits=1 << 11, k=2, tile=256,
                              **kw)
    t = api.make_filter_bank(B, "cuckoo", m_bits=1 << 11, k=2, tile=256,
                             device="cpu", **kw)
    return j, t


def test_padded_bank_add_keeps_the_tiles_of_the_jax_bank():
    """A stateful engine's member gets its whole masked batch: invalid slots
    stay in place, so the 256-key tiles are the JAX bank's. Dropping them
    first (what the generic path does for stateless engines) moves the tile
    boundaries and changes the table."""
    B, n = 3, 600
    j, t = _bank_pair(B)
    keys = JH.random_u64x2(B * n, seed=10).reshape(B, n, 2)
    valid = (np.random.RandomState(11).rand(B, n) > 0.3).astype(np.uint8)
    jb, tb = j.add(keys, valid=valid), t.add(keys, valid=valid)
    _eq_words(tb.words, jb.words)
    _eq(tb.insert_failures, jb.insert_failures)
    compacted = [TF.cuckoo_add(t.spec, TF.init(t.spec),
                               as_keys(keys[b][valid[b] != 0]), tile=256)[0]
                 for b in range(B)]
    assert not torch.equal(torch.stack(compacted), tb.words)
    _eq(tb.contains(keys), jb.contains(keys))
    jr = jb.remove(keys[:, :100], valid=valid[:, :100])
    tr = tb.remove(keys[:, :100], valid=valid[:, :100])
    _eq_words(tr.words, jr.words)
    for b in range(B):                             # members as scalars
        m = tr.select(b)
        assert m.bank_shape == () and m.insert_failures.shape == ()
        _eq_words(m.words, jr.words[b])


def test_routed_bank_matches_jax_bank():
    B, n = 4, 900
    j, t = _bank_pair(B)
    keys = JH.random_u64x2(n, seed=12)
    tenants = np.random.RandomState(13).randint(0, B, size=n).astype(np.int32)
    valid = (np.random.RandomState(14).rand(n) > 0.2).astype(np.uint8)
    jb = j.add(keys, tenants=tenants, valid=valid)
    tb = t.add(keys, tenants=tenants, valid=valid)
    _eq_words(tb.words, jb.words)
    _eq(tb.insert_failures, jb.insert_failures)
    _eq(tb.contains(keys, tenants=tenants),
        jb.contains(keys, tenants=tenants))
    jr = jb.remove(keys[:300], tenants=tenants[:300])
    tr = tb.remove(keys[:300], tenants=tenants[:300])
    _eq_words(tr.words, jr.words)
    _eq(tr.insert_failures, jr.insert_failures)
    h = tr.scatter_update(1, tr.select(2))
    assert torch.equal(h.words[1], tr.words[2])
    assert int(h.insert_failures[1]) == int(tr.insert_failures[2])
    assert tr.health() == jr.health()
    with pytest.raises(ValueError, match="merge"):
        tr.bank_merge(tr)


def test_states_and_raw_words_go_both_ways():
    j, t = _filters(2000, bits_per_key=8.0)
    keys = JH.random_u64x2(int(t.spec.n_slots * 1.05), seed=15)
    j, t = j.add(keys), t.add(keys)
    assert int(t.insert_failures) > 0
    # the port's state into the JAX package, and back
    state = interop.to_jax_state(t)
    assert state["backend"] == "cuckoo"
    assert state["engine_state"].dtype == np.uint32
    jback = japi.Filter.from_state(state)
    np.testing.assert_array_equal(np.asarray(jback.words), np.asarray(j.words))
    assert int(jback.insert_failures) == int(j.insert_failures)
    tback = interop.from_jax_state(j.to_state(), device="cpu")
    assert tback.backend == "cuckoo"
    _eq_words(tback.words, j.words)
    assert int(tback.insert_failures) == int(j.insert_failures)
    # raw words with the failure count
    fields = dataclasses.asdict(j.spec)
    raw = interop.from_jax_words(fields, np.asarray(j.words), device="cpu",
                                 engine_state=np.asarray(j.state))
    assert int(raw.insert_failures) == int(j.insert_failures)
    got_fields, words, st = interop.to_jax_words(raw)
    assert got_fields == fields and st.dtype == np.uint32
    np.testing.assert_array_equal(words, np.asarray(j.words))
    assert int(st) == int(j.state)
    with pytest.raises(ValueError, match="engine_state"):
        interop.from_jax_words(dataclasses.asdict(TV.FilterSpec(
            "sbf", 1 << 12, 8)), np.zeros(128, np.uint32), device="cpu",
            engine_state=3)
    # a bank
    jbk, tbk = _bank_pair(2)
    kb = JH.random_u64x2(2 * 700, seed=16).reshape(2, 700, 2)
    jbk, tbk = jbk.add(kb), tbk.add(kb)
    bstate = interop.to_jax_state(tbk)
    assert bstate["bank_shape"] == [2] and bstate["engine_state"].shape == (2,)
    jb2 = japi.Filter.from_state(bstate)
    np.testing.assert_array_equal(np.asarray(jb2.state), np.asarray(jbk.state))
    tb2 = interop.from_jax_state(jbk.to_state(), device="cpu")
    _eq(tb2.insert_failures, jbk.insert_failures)
    raw = interop.from_jax_words(dataclasses.asdict(jbk.spec),
                                 np.asarray(jbk.words), device="cpu",
                                 bank_shape=(2,),
                                 engine_state=np.asarray(jbk.state))
    _, words, st, shape = interop.to_jax_words(raw)
    assert shape == (2,)
    np.testing.assert_array_equal(words, np.asarray(jbk.words))
    np.testing.assert_array_equal(st, np.asarray(jbk.state))
