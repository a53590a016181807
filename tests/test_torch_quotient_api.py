"""The quotient engine of the PyTorch port against the JAX package's, on the
CPU: ``filter_for_n_items(variant="quotient")``, the ``Filter`` ops
(add, contains, remove, merge, resize, ``health``/``load_factor``/
``approx_count``/``insert_failures``), banks (batched and routed, with
valid masks; member-wise merge and resize), states and raw words through
``interop``, ``filter_for_workload`` and ``registry.cheapest_engine``.

The JAX side is ``repro.api`` on the CPU (its quotient engine runs the jnp
reference there). Words, flags, failure counts, results and health dicts
must be equal (tolerance 0). Tables stay at most 2^12 slots.
"""
import dataclasses

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
from repro_torch.core import quotient as TQ
from repro_torch.core import variants as TV


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _eq_words(port, jax_words):
    np.testing.assert_array_equal(_u32(port), np.asarray(jax_words))


def _eq(port, jax_value):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(jax_value))


def _filters(n, **kw):
    j = japi.filter_for_n_items(n, variant="quotient", **kw)
    t = api.filter_for_n_items(n, variant="quotient", device="cpu", **kw)
    return j, t


def test_filter_path_matches_jax_past_capacity():
    j, t = _filters(900)
    assert t.backend == j.backend == "quotient"
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert t.insert_failures.dtype == torch.int64
    keys = JH.random_u64x2(int(t.spec.n_slots * 1.2), seed=1)
    valid = np.ones(len(keys), np.uint8)
    valid[::9] = 0
    j1, t1 = j.add(keys, valid=valid), t.add(keys, valid=valid)
    _eq_words(t1.words, j1.words)
    fails = int(t1.insert_failures)
    assert fails > 0 and fails == int(j1.insert_failures)
    assert t1.load_factor() == float(j1.load_factor())
    assert t1.approx_count() == j1.approx_count() == t1.spec.n_slots - 1
    assert t1.health() == j1.health()
    _eq(t1.contains(keys), j1.contains(keys))
    j2 = j1.remove(keys[:300], valid=valid[:300])
    t2 = t1.remove(keys[:300], valid=valid[:300])
    _eq_words(t2.words, j2.words)
    assert int(t2.insert_failures) == int(j2.insert_failures) == fails
    assert t2.health() == j2.health()
    assert t2.measure_fpr(4096) == j2.measure_fpr(4096)
    assert t.add(keys[:0]) is t


@pytest.mark.parametrize("n, kw", [
    (1000, {}), (3000, {"target_fpr": 1e-3}), (3000, {"slot_bits": 16}),
    (500, {"target_fpr": 1e-5}),
    (2000, {"slot_bits": 32, "target_fpr": 1e-6})])
def test_filter_for_n_items_sizes_like_jax(n, kw):
    j, t = _filters(n, **kw)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert t.words.shape == tuple(j.words.shape) and not t.words.any()
    assert TV.fpr_theory(t.spec, n) == JV.fpr_theory(j.spec, n)
    assert t.fpr_theory(n) == j.fpr_theory(n)
    assert TV.space_optimal_n(t.spec) == JV.space_optimal_n(j.spec)
    assert (TV.space_optimal_n(t.spec, 1e-2)
            == JV.space_optimal_n(j.spec, 1e-2))


def test_merge_and_resize_match_jax():
    j, t = _filters(1500)
    keys = JH.random_u64x2(1400, seed=2)
    ja, jb = j.add(keys[:700]), j.add(keys[700:])
    ta, tb = t.add(keys[:700]), t.add(keys[700:])
    jm, tm = ja.merge(jb), ta | tb
    _eq_words(tm.words, jm.words)
    assert torch.equal(tm.words, t.add(keys).words)      # lossless
    assert api.union(ta, tb).words.equal(tm.words)
    jg, tg = jm.resize(2 * j.spec.m_bits), tm.resize(2 * t.spec.m_bits)
    assert dataclasses.asdict(tg.spec) == dataclasses.asdict(jg.spec)
    assert tg.spec.r_bits == t.spec.r_bits - 1
    _eq_words(tg.words, jg.words)
    assert bool(tg.contains(keys).all())
    assert torch.equal(tg.resize(t.spec.m_bits).words, tm.words)
    assert tg.health() == jg.health()
    # an overflowing merge and shrink are refused, as in JAX
    full = t.add(JH.random_u64x2(t.spec.n_slots, seed=3))
    jfull = j.add(JH.random_u64x2(j.spec.n_slots, seed=3))
    with pytest.raises(ValueError, match="overflows") as got:
        full.merge(ta)
    with pytest.raises(ValueError, match="overflows") as want:
        jfull.merge(ja)
    assert str(got.value) == str(want.value)
    more = JH.random_u64x2(t.spec.n_slots, seed=4)
    with pytest.raises(ValueError, match="shrink") as got:
        tg.add(more).resize(t.spec.m_bits)
    with pytest.raises(ValueError, match="shrink") as want:
        jg.add(more).resize(j.spec.m_bits)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="r must stay"):
        t.resize(t.spec.m_bits << 6)


def test_engine_capabilities_match_jax():
    j, t = _filters(1000)
    je, te = j.engine, t.engine
    for flag in ("supports_remove", "supports_merge", "supports_resize",
                 "supports_decay", "supports_advance", "stateful_ops"):
        assert getattr(te, flag) == getattr(je, flag), flag
    for eps in (None, 0.1, 1e-3, 1e-7):
        kw = {} if eps is None else {"target_fpr": eps}
        assert te.bits_per_key(**kw) == je.bits_per_key(**kw)
    with pytest.raises(ValueError):
        te.bits_per_key(1.5)
    with pytest.raises(NotImplementedError, match="decay"):
        t.decay()
    for name in ("cuckoo", "counting", "torch"):
        with pytest.raises(NotImplementedError, match="resize"):
            registry.get(name).resize(t.spec, t.words, 2 * t.spec.m_bits,
                                      t.options)
    cpu = registry.SelectionContext(device=torch.device("cpu"))
    gpu = registry.SelectionContext(device=torch.device("cuda"))
    for ctx in (cpu, gpu):
        assert registry.select(t.spec, "auto", ctx).name == "quotient"
        for name in ("torch", "cuda-l2", "counting", "cuckoo"):
            with pytest.raises(ValueError):
                registry.select(t.spec, name, ctx)
    huge = api.FilterSpec("quotient", (1 << 30) * 8, 1, slot_bits=8,
                          r_bits=1)
    assert registry.select(huge, "auto", cpu).name == "quotient"
    with pytest.raises(ValueError):                # no kernel instance
        registry.select(huge, "auto", gpu)
    desc = {d["name"]: d for d in api.describe_backends()}["quotient"]
    assert desc["supports_resize"] and desc["supports_merge"]
    # impl pins the plain versions on the CPU
    keys = JH.random_u64x2(100, seed=4)
    pinned = api.make_filter("quotient", m_bits=1 << 13, slot_bits=8,
                             r_bits=5, impl="jnp", device="cpu")
    assert torch.equal(pinned.add(keys).words,
                       api.make_filter("quotient", m_bits=1 << 13,
                                       slot_bits=8, r_bits=5,
                                       device="cpu").add(keys).words)
    with pytest.raises(ValueError, match="impl"):
        api.make_filter("quotient", m_bits=1 << 13, slot_bits=8, r_bits=5,
                        impl="xla", device="cpu").add(keys)


def _bank_pair(B):
    kw = dict(m_bits=(1 << 9) * 8, slot_bits=8, r_bits=5)
    return (japi.make_filter_bank(B, "quotient", **kw),
            api.make_filter_bank(B, "quotient", device="cpu", **kw))


def test_banks_match_jax_batched_and_routed():
    B, n = 3, 400
    j, t = _bank_pair(B)
    assert t.backend == "quotient" and t.bank_shape == (B,)
    keys = JH.random_u64x2(B * n, seed=5).reshape(B, n, 2)
    valid = (np.random.RandomState(6).rand(B, n) > 0.2).astype(np.uint8)
    valid[0] = 1                                  # member 0 past capacity
    keys[0] = JH.random_u64x2(n, seed=7)
    keys[0, 300:] = JH.random_u64x2(100, seed=8)
    jb, tb = j.add(keys, valid=valid), t.add(keys, valid=valid)
    _eq_words(tb.words, jb.words)
    _eq(tb.insert_failures, jb.insert_failures)
    _eq(tb.contains(keys), jb.contains(keys))
    assert tb.health() == jb.health()
    _eq(tb.load_factor(), jb.load_factor())
    assert tb.approx_count() == jb.approx_count()
    jr = jb.remove(keys[:, :100], valid=valid[:, :100])
    tr = tb.remove(keys[:, :100], valid=valid[:, :100])
    _eq_words(tr.words, jr.words)
    # routed
    flat = JH.random_u64x2(600, seed=9)
    tenants = np.random.RandomState(10).randint(0, B, size=600).astype(
        np.int32)
    rv = (np.random.RandomState(11).rand(600) > 0.1).astype(np.uint8)
    jx = jr.add(flat, tenants=tenants, valid=rv)
    tx = tr.add(flat, tenants=tenants, valid=rv)
    _eq_words(tx.words, jx.words)
    _eq(tx.insert_failures, jx.insert_failures)
    _eq(tx.contains(flat, tenants=tenants), jx.contains(flat, tenants=tenants))
    jy = jx.remove(flat[:200], tenants=tenants[:200])
    ty = tx.remove(flat[:200], tenants=tenants[:200])
    _eq_words(ty.words, jy.words)
    # member-wise merge and resize
    _eq_words(t.add(keys[:, :100]).bank_merge(t.add(keys[:, 100:250])).words,
              j.add(keys[:, :100]).bank_merge(j.add(keys[:, 100:250])).words)
    jg, tg = jy.resize(2 * j.spec.m_bits), ty.resize(2 * t.spec.m_bits)
    _eq_words(tg.words, jg.words)
    assert tg.bank_shape == (B,) and tg.words.shape == tuple(jg.words.shape)
    for b in range(B):
        m = tg.select(b)
        assert m.bank_shape == () and m.insert_failures.shape == ()
        _eq_words(m.words, jg.words[b])
    with pytest.raises(ValueError, match="overflows"):
        tb.bank_merge(tb)


def test_states_and_raw_words_go_both_ways():
    j, t = _filters(600)
    keys = JH.random_u64x2(int(t.spec.n_slots * 1.05), seed=12)
    j, t = j.add(keys), t.add(keys)
    assert int(t.insert_failures) > 0
    state = interop.to_jax_state(t)
    assert state["backend"] == "quotient"
    assert state["engine_state"].dtype == np.uint32
    jback = japi.Filter.from_state(state)
    np.testing.assert_array_equal(np.asarray(jback.words), np.asarray(j.words))
    assert int(jback.insert_failures) == int(j.insert_failures)
    tback = interop.from_jax_state(j.to_state(), device="cpu")
    assert tback.backend == "quotient"
    _eq_words(tback.words, j.words)
    assert int(tback.insert_failures) == int(j.insert_failures)
    fields = dataclasses.asdict(j.spec)
    raw = interop.from_jax_words(fields, np.asarray(j.words), device="cpu",
                                 engine_state=np.asarray(j.state))
    assert raw.backend == "quotient"
    assert int(raw.insert_failures) == int(j.insert_failures)
    got_fields, words, st = interop.to_jax_words(raw)
    assert got_fields == fields and st.dtype == np.uint32
    np.testing.assert_array_equal(words, np.asarray(j.words))
    # a bank
    jbk, tbk = _bank_pair(2)
    kb = JH.random_u64x2(2 * 300, seed=13).reshape(2, 300, 2)
    jbk, tbk = jbk.add(kb), tbk.add(kb)
    bstate = interop.to_jax_state(tbk)
    assert bstate["bank_shape"] == [2] and bstate["engine_state"].shape == (2,)
    jb2 = japi.Filter.from_state(bstate)
    np.testing.assert_array_equal(np.asarray(jb2.words), np.asarray(jbk.words))
    tb2 = interop.from_jax_state(jbk.to_state(), device="cpu")
    _eq_words(tb2.words, jbk.words)
    _eq(tb2.insert_failures, jbk.insert_failures)
    raw = interop.from_jax_words(dataclasses.asdict(jbk.spec),
                                 np.asarray(jbk.words), device="cpu",
                                 bank_shape=(2,),
                                 engine_state=np.asarray(jbk.state))
    _eq_words(raw.words, jbk.words)
    *_, st, shape = interop.to_jax_words(raw)
    assert shape == (2,) and st.shape == (2,)


@pytest.mark.parametrize("needs", [
    {}, {"needs_remove": True}, {"needs_remove": True, "needs_merge": True},
    {"needs_resize": True}, {"needs_decay": True},
    {"needs_remove": True, "needs_count": True},
    {"needs_merge": True, "needs_remove": True, "needs_resize": True}])
def test_filter_for_workload_and_cheapest_engine_match_jax(needs):
    for eps in (1e-2, 1e-4):
        want = japi.registry.cheapest_engine(target_fpr=eps, **needs)
        got = registry.cheapest_engine(target_fpr=eps, **needs)
        family = {"counting", "cuckoo", "quotient"}
        assert (got if got in family else "bits") == (
            want if want in family else "bits")
    j = japi.filter_for_workload(3000, **needs)
    t = api.filter_for_workload(3000, device="cpu", **needs)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert t.engine.supports_remove == j.engine.supports_remove
    assert t.engine.supports_resize == j.engine.supports_resize
    with pytest.raises(ValueError, match="no registered engine"):
        registry.cheapest_engine(needs_decay=True, needs_resize=True)


def test_exports_match_the_jax_api():
    assert api.__all__ == japi.__all__
    for name in api.__all__:
        assert hasattr(api, name), name
    spec = TQ.spec_for_n(1000)
    assert api.make_filter("quotient", m_bits=spec.m_bits, r_bits=5,
                           device="cpu").spec == spec
