"""The port's autotuner (``repro_torch.core.tuning``), ``api.tuned_options``
and the ``"auto"`` resolution in ``kernels.ops`` against the JAX package, on
the CPU.

Structural tuning is pure Python on both sides, so the layout grid, the
§4.1 scores, ``tune_layout`` and model-ranked ``tune_plan`` must agree
exactly for the blocked and counting specs x op x regime x pinned or
``"auto"`` coop/mix x tile x bank, on every ``Plan`` field but
``n_segments``: the port measures segments against its partitioned
kernel's shared memory (``CPU_SEGMENT_BYTES`` on the CPU), the JAX package
against its VMEM budget, so ``n_segments`` is checked against the port's
own formula. ``Plan`` dicts cross between the packages; the disk caches
never hand one package's plan to the other; the port's measure mode runs
on the CPU; and ``"auto"`` in ``ops`` reaches the tuner with the clamped
tile and the keys' device, and a tuned call gives the words and results
of a call pinned to the plan.

Every test points both packages' caches at its own ``tmp_path`` and clears
the lru caches. Nothing here runs the JAX measure mode (it fails under jax
0.9) or the JAX ``measure_calibration``.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import repro.api as japi
from repro import perfmodel as JPM
from repro.core import hashing as JH
from repro.core import tuning as JT
from repro.core import variants as JV
from repro.kernels import sbf as JS
import repro_torch.api as api
from repro_torch import perfmodel as PM
from repro_torch.api.filter import as_keys
from repro_torch.core import tuning as TT
from repro_torch.core import variants as TV
from repro_torch.kernels import ops
from repro_torch.kernels import sbf as TS

M = 1 << 16
SPEC_ARGS = [("sbf", M, 8, 256, 1), ("sbf", M, 16, 512, 1),
             ("bbf", M, 8, 256, 1), ("rbbf", M, 4, 32, 1),
             ("csbf", M, 8, 512, 2), ("countingbf", M, 8, 256, 1),
             ("sbf", 1 << 28, 8, 256, 1)]
IDS = [f"{v}-m{m.bit_length() - 1}-B{b}" for v, m, _, b, _ in SPEC_ARGS]
PINS = [("auto", "auto"), ("none", "auto"), ("subtile", "auto"),
        ("auto", "cheap"), ("none", "full")]


def _specs(args):
    v, m, k, b, z = args
    kw = {} if v == "rbbf" else {"block_bits": b, "z": z}
    return JV.FilterSpec(v, m, k, **kw), TV.FilterSpec(v, m, k, **kw)


def _lay(layout):
    return (layout.theta, layout.phi)


_LRU = (JPM.choose_coop, JT.tune_plan, JT.tune_layout, PM.choose_coop,
        TT.tune_plan, TT.tune_layout)


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    for fn in _LRU:
        fn.cache_clear()
    yield
    for fn in _LRU:
        fn.cache_clear()


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_layout_grid_and_scores_match_jax(args):
    js, ts = _specs(args)
    for tile in (8, 64, 256):
        jl, tl = JT.valid_layouts(js, tile), TT.valid_layouts(ts, tile)
        assert [_lay(l) for l in tl] == [_lay(l) for l in jl]
        for j, t in zip(jl, tl):
            for op in ("contains", "add"):
                assert (TT.structural_score(ts, t, op)
                        == JT.structural_score(js, j, op))
                for probe, bank in itertools.product(("loop", "gather"),
                                                     (1, 64)):
                    assert (TT.probe_schedule_steps(ts, t, op, tile, probe,
                                                    bank)
                            == JT.probe_schedule_steps(js, j, op, tile,
                                                       probe, bank))
    for depth in (1, 2, 4, 8, 16):
        assert (TT.depth_structural_score(ts, depth)
                == JT.depth_structural_score(js, depth))


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_tune_layout_matches_jax(args):
    js, ts = _specs(args)
    for op, tile in itertools.product(("contains", "add"), (8, 256)):
        jbest, jscored = JT.tune_layout(js, op, tile=tile)
        tbest, tscored = TT.tune_layout(ts, op, tile=tile, device="cpu")
        assert _lay(tbest) == _lay(jbest) and tscored == jscored
    with pytest.raises(ValueError):
        TT.tune_layout(ts, "remove")


def _port_segments(spec):
    def score(ns):
        if spec.n_blocks % ns or spec.storage_words % ns:
            return float("inf")
        seg = spec.storage_words * 4 / ns
        return (0.0 if seg <= TT.CPU_SEGMENT_BYTES else seg) + ns
    return min(TT.TUNABLE_SEGMENTS, key=score)


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_structural_tune_plan_matches_jax(args, tmp_path):
    js, ts = _specs(args)
    n = 0
    for op, regime, (coop, mix), tile, bank in itertools.product(
            ("contains", "add"), ("vmem", "hbm"), PINS, (8, 256), (1, 64)):
        kw = dict(regime=regime, tile=tile, bank=bank, coop=coop, mix=mix)
        want = JT.tune_plan(js, op, **kw).to_dict()
        got = TT.tune_plan(ts, op, device="cpu", **kw).to_dict()
        assert got.pop("n_segments") == _port_segments(ts)
        want.pop("n_segments")
        assert got == want, (op, kw)
        n += 1
    keys = json.loads((tmp_path / "tuning.json").read_text())
    ours = [k for k in keys if k.startswith("repro_torch|")]
    assert len(ours) == n and all(
        k.startswith("repro_torch|plan2|cpu|") for k in ours)
    assert len(keys) == 2 * n                # the JAX entries, apart


def test_plan_dicts_cross_read():
    plan = TT.Plan(TS.Layout(2, 4), "loop", 8, 16, "subtile", "cheap")
    d = plan.to_dict()
    assert JT.Plan.from_dict(d).to_dict() == d
    assert TT.Plan.from_dict(JT.Plan(JS.Layout(4, 2), "gather", 4, 32,
                                     "none", "full").to_dict()) == \
        TT.Plan(TS.Layout(4, 2), "gather", 4, 32, "none", "full")
    assert TT.Plan.from_dict({"theta": 1, "phi": 8, "probe": "gather",
                              "depth": 2, "n_segments": 8}) == \
        TT.Plan(TS.Layout(1, 8))


def test_plan_cache_keys_validation_and_package_separation(tmp_path):
    _, ts = _specs(SPEC_ARGS[0])
    path = tmp_path / "tuning.json"
    key = TT._plan_key(ts, "contains", "vmem", "structural", 256,
                       backend="cpu")
    assert key.startswith("repro_torch|plan2|cpu|")
    assert TT._plan_key(ts, "contains", "vmem", "structural", 256,
                        bank=4).endswith("|bank4")
    fresh = TT.tune_plan(ts, "contains", device="cpu")
    TT.tune_plan.cache_clear()
    # a cached plan answers; stale or corrupt entries re-tune
    odd = dict(fresh.to_dict(), probe="loop")
    TT._store_disk(key, odd)
    assert TT.tune_plan(ts, "contains", device="cpu").probe == "loop"
    for stale in (dict(odd, depth=3), dict(odd, theta=3), {"theta": 1},
                  dict(odd, coop="x")):
        TT.tune_plan.cache_clear()
        TT._store_disk(key, stale)
        assert TT.tune_plan(ts, "contains", device="cpu") == fresh
    # a JAX entry under the JAX key never answers for the port
    TT.tune_plan.cache_clear()
    data = json.loads(path.read_text())
    data = {k: v for k, v in data.items() if not k.startswith("repro_torch")}
    data[key.replace("repro_torch|", "")] = odd
    path.write_text(json.dumps(data))
    assert TT.tune_plan(ts, "contains", device="cpu") == fresh
    with pytest.raises(ValueError):
        TT.tune_plan(ts, "contains", coop="x", device="cpu")
    with pytest.raises(ValueError):
        TT.tune_plan(ts, "remove", device="cpu")
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError):
            TT.tune_plan(ts, "add")


def test_tune_layout_skips_layouts_that_do_not_validate(monkeypatch):
    _, ts = _specs(SPEC_ARGS[0])
    good = TT.valid_layouts(ts, 256)
    monkeypatch.setattr(TT, "valid_layouts",
                        lambda spec, tile: [TS.Layout(3, 8)] + good)
    with pytest.raises(ValueError):
        TS.Layout(3, 8).validate(ts, 256)
    best, scored = TT.tune_layout(ts, "contains", tile=256, device="cpu")
    assert len(scored) == len(good) and best in good


def test_segments_use_the_partitioned_kernels_budget():
    big = TV.FilterSpec("sbf", 1 << 24, 8)        # 2 MiB of words
    assert TT.segment_budget_bytes("cpu") == TT.CPU_SEGMENT_BYTES
    assert [TT.segments_structural_score(big, ns, "cpu")
            for ns in TT.TUNABLE_SEGMENTS] == [2 ** 19 + 4, 2 ** 18 + 8,
                                               16, 32]
    _, small = _specs(SPEC_ARGS[0])
    assert TT.tune_plan(small, "add", device="cpu").n_segments == 4
    # 128 KiB segments fit the kernel's shared memory; the JAX package's
    # 4 MiB VMEM budget takes the whole filter in 4
    assert TT.tune_plan(big, "add", device="cpu").n_segments == 16
    assert JT.tune_plan(JV.FilterSpec("sbf", 1 << 24, 8), "add").n_segments \
        == 4


@pytest.mark.parametrize("op", ["contains", "add"])
@pytest.mark.parametrize("regime", ["auto", "vmem", "hbm"])
def test_tuned_options_match_jax(op, regime):
    for args in SPEC_ARGS[:6]:
        js, ts = _specs(args)
        for tile in (None, 64):
            want = japi.tuned_options(js, op, regime, tile)
            got = api.tuned_options(ts, op, regime, tile, device="cpu")
            assert isinstance(got, api.BackendOptions)
            assert (_lay(got.layout), got.tile, got.probe, got.depth,
                    got.coop, got.mix) == (
                _lay(want.layout), want.tile, want.probe, want.depth,
                want.coop, want.mix)
    assert api.__all__ == japi.__all__


def test_measure_mode_runs_on_the_cpu():
    for args in (SPEC_ARGS[0], SPEC_ARGS[5]):
        _, ts = _specs(args)
        for op, regime in itertools.product(("contains", "add"),
                                            ("vmem", "hbm")):
            plan = TT.tune_plan(ts, op, regime=regime, mode="measure",
                                n_keys=64, repeats=1, tile=64, device="cpu")
            assert plan.probe in TS.PROBES and plan.depth in TT.TUNABLE_DEPTHS
            assert (plan.coop, plan.mix) == ("none", "full")
            plan.layout.validate(ts, 64)
        best, scored = TT.tune_layout(ts, "contains", mode="measure",
                                      n_keys=64, repeats=2, tile=64,
                                      device="cpu")
        assert len(scored) == len(TT.valid_layouts(ts, 64))
        assert all(t > 0 for _, t in scored)
    pinned = TT.tune_plan(ts, "contains", mode="measure", n_keys=64,
                          repeats=1, coop="subtile", mix="cheap",
                          device="cpu")
    assert (pinned.coop, pinned.mix) == ("subtile", "cheap")
    assert TT._measure(ts, "add", 32, 2, "cpu", tile=32) > 0


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **kw):
        self.calls.append((a, kw))
        return self.fn(*a, **kw)


def test_ops_auto_reaches_the_tuner(monkeypatch):
    spy = _Spy(TT.tune_plan)
    monkeypatch.setattr(TT, "tune_plan", spy)
    _, ts = _specs(SPEC_ARGS[0])
    keys = as_keys(JH.random_u64x2(10, seed=1))
    probes = as_keys(JH.probe_u64x2(300, seed=1))
    words = ops.bloom_add(ts, TV.init(ts), keys)
    (a, kw), = spy.calls
    assert a[:2] == (ts, "add") and kw["tile"] == 16 and \
        kw["regime"] == "vmem" and kw["device"] == torch.device("cpu")
    plan = TT.tune_plan.fn(ts, "add", regime="vmem", tile=16, device="cpu")
    pinned = ops.bloom_add(ts, TV.init(ts), keys, probe=plan.probe,
                           coop=plan.coop, mix=plan.mix)
    assert torch.equal(words, pinned)
    q = torch.cat([keys, probes])
    for regime in ("vmem", "hbm"):
        spy.calls.clear()
        got = ops.bloom_contains(ts, words, q, regime=regime)
        assert spy.calls and all(kw["tile"] == 256 for _, kw in spy.calls)
        assert torch.equal(got, ops.bloom_contains(
            ts, words, q, regime=regime, probe="loop", coop="none",
            mix="full", depth=1))
    # the DRAM depth, the counting, bank and ring forms, the cached layer
    spy.calls.clear()
    ops.bloom_contains(ts, words, q, regime="hbm", coop="none", mix="full")
    assert [kw["regime"] for _, kw in spy.calls] == ["hbm"]
    _, cs = _specs(SPEC_ARGS[5])
    spy.calls.clear()
    counters = ops.counting_add(cs, TV.init(cs), keys)
    assert torch.equal(counters, ops.counting_add(
        cs, TV.init(cs), keys, probe="gather", coop="subtile", mix="cheap"))
    assert torch.equal(ops.counting_contains(cs, counters, q, regime="hbm"),
                       ops.counting_contains(cs, counters, q, regime="hbm",
                                             depth=1, coop="none",
                                             mix="full"))
    assert {kw["regime"] for _, kw in spy.calls} == {"vmem", "hbm"}
    spy.calls.clear()
    bank = torch.stack([words, TV.init(ts)])
    member = torch.tensor([0, 1] * 155, dtype=torch.int32)
    got = ops.bloom_bank_contains(ts, bank, q, member, regime="hbm")
    assert any(kw["bank"] == 2 and kw["regime"] == "hbm"
               for _, kw in spy.calls)
    assert torch.equal(got, ops.bloom_bank_contains(
        ts, bank, q, member, regime="hbm", depth=2, probe="loop",
        mix="full"))
    spy.calls.clear()
    rings = torch.stack([words, TV.init(ts)])
    assert torch.equal(ops.ring_contains(ts, rings, q, regime="hbm"),
                       ops.ring_contains(ts, rings, q, regime="vmem"))
    # no ring schedule on the card takes a DMA depth: none is resolved
    assert spy.calls == []
    spy.calls.clear()
    ops.bloom_add_jit(ts, TV.init(ts), keys, donate=False)
    assert spy.calls and spy.calls[0][1]["tile"] == 16
    with pytest.raises(ValueError):
        ops.bloom_contains(ts, words, q, probe="sideways")


def test_ops_auto_coop_of_the_fingerprint_engines(monkeypatch):
    spy = _Spy(PM.choose_coop)
    monkeypatch.setattr(PM, "choose_coop", spy)
    keys = as_keys(JH.random_u64x2(40, seed=2))
    for variant, kw in (("cuckoo", {"slot_bits": 16,
                                    "slots_per_bucket": 4}),
                        ("quotient", {"slot_bits": 8, "r_bits": 5})):
        spec = TV.FilterSpec(variant, 1 << 14, 1, **kw)
        add = ops.cuckoo_add if variant == "cuckoo" else ops.quotient_add
        contains = (ops.cuckoo_contains if variant == "cuckoo"
                    else ops.quotient_contains)
        table, _ = add(spec, torch.zeros(spec.n_words, dtype=torch.int32),
                       keys)
        spy.calls.clear()
        got = contains(spec, table, keys)
        (a, _), = spy.calls
        assert a == (spec, "contains", "vmem", 64, torch.device("cpu"))
        want = PM.choose_coop.fn(spec, "contains", "vmem", 64, "cpu")
        assert want == JPM.choose_coop(
            JV.FilterSpec(variant, 1 << 14, 1, **kw), "contains", "vmem", 64)
        assert torch.equal(got, contains(spec, table, keys, coop=want[0]))
        assert bool(got.all())
