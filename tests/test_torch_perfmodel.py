"""The port's performance model and calibration against the JAX package, on
the CPU.

``repro_torch.perfmodel`` keeps the JAX package's counting formulas, so
``op_cost`` must give the same floats field for field over a grid of every
engine family (sbf/bbf/rbbf/csbf/cbf/countingbf/cuckoo/quotient at m <=
2^18) x regime x op x probe x coop x mix x depth x tile x bank x layout x
n_keys; ``predict_us``/``ceiling_us``/``ceiling_mops``/``predict_config_us``
must agree under one explicit calibration, and ``choose_coop`` under the
CPU defaults (which are the JAX numbers). Tolerance: exact equality.
Calibration dicts cross between the packages; the disk caches never hand
one package's entry to the other; ``measure_calibration`` runs on the CPU
through the probes' plain versions; ``roofline.report_utils`` formats as
the JAX module does. The probe kernels run on the card in
``tests/test_torch_gpu.py``.

Every test points both packages' caches (``REPRO_CALIB_CACHE``,
``REPRO_TUNING_CACHE``) at its own ``tmp_path`` and clears the lru caches.
Nothing here runs the JAX ``measure_calibration`` (its step probe runs
Pallas in interpret mode).
"""
import dataclasses
import itertools
import json
import math

import numpy as np
import pytest
import torch

from repro import perfmodel as JPM
from repro.core import tuning as JT
from repro.core import variants as JV
from repro.kernels import sbf as JS
from repro.perfmodel import calibrate as JC
from repro.roofline import report_utils as JRU
from repro_torch import perfmodel as PM
from repro_torch.core import tuning as TT
from repro_torch.core import variants as TV
from repro_torch.kernels import calibrate as kc
from repro_torch.kernels import sbf as TS
from repro_torch.perfmodel import calibrate as PC
from repro_torch.roofline import report_utils as RU

# (variant, m_bits, k, extra FilterSpec fields): every engine family
SPEC_ARGS = [("sbf", 1 << 18, 8, {"block_bits": 256}),
             ("bbf", 1 << 18, 8, {"block_bits": 256}),
             ("rbbf", 1 << 18, 4, {}),
             ("csbf", 1 << 18, 8, {"block_bits": 512, "z": 2}),
             ("cbf", 1 << 16, 7, {}),
             ("countingbf", 1 << 18, 8, {"block_bits": 256}),
             ("cuckoo", 1 << 18, 1, {"slot_bits": 16, "slots_per_bucket": 4}),
             ("quotient", 1 << 18, 1, {"slot_bits": 8, "r_bits": 5})]
IDS = [a[0] for a in SPEC_ARGS]
CALIB = dict(bw_hbm_gbs=2900.5, bw_res_gbs=535.25, gops=29673.5,
             launch_us=25.125, step_us=0.0025)


def _specs(args):
    v, m, k, kw = args
    return JV.FilterSpec(v, m, k, **kw), TV.FilterSpec(v, m, k, **kw)


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.delenv("REPRO_CALIB_MEASURE", raising=False)
    for fn in (JPM.choose_coop, JT.tune_plan, JT.tune_layout, PM.choose_coop,
               TT.tune_plan, TT.tune_layout):
        fn.cache_clear()
    yield
    for fn in (JPM.choose_coop, PM.choose_coop, TT.tune_plan,
               TT.tune_layout):
        fn.cache_clear()


def _cost_grid():
    layouts = (None, (1, 1), (4, 2))
    return itertools.product(
        ("vmem", "hbm"), ("contains", "add", "remove"), ("loop", "gather"),
        ("none", "subtile"), ("full", "cheap"), (1, 2, 4, 8), (8, 256),
        (1, 64), layouts, (None, 1000))


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_op_cost_matches_jax(args):
    js, ts = _specs(args)
    n = 0
    for (regime, op, probe, coop, mix, depth, tile, bank, lay,
         n_keys) in _cost_grid():
        jl = None if lay is None else JS.Layout(*lay)
        tl = None if lay is None else TS.Layout(*lay)
        kw = dict(probe=probe, coop=coop, mix=mix, depth=depth, tile=tile,
                  n_keys=n_keys, bank=bank)
        want = JPM.op_cost(js, op, regime, layout=jl, **kw)
        got = PM.op_cost(ts, op, regime, layout=tl, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), (
            regime, op, kw, lay)
        assert (dataclasses.astuple(got.scaled(0.5))
                == dataclasses.astuple(want.scaled(0.5)))
        n += 1
    assert n == 2 * 3 * 2 * 2 * 2 * 4 * 2 * 2 * 3 * 2


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_time_predictors_match_jax(args):
    js, ts = _specs(args)
    jcal = JC.Calibration(backend="cpu", **CALIB)
    tcal = PC.Calibration(backend="cpu", **CALIB)
    for regime, op, coop, mix, depth, tile, bank in itertools.product(
            ("vmem", "hbm"), ("contains", "add"), ("none", "subtile"),
            ("full", "cheap"), (2, 8), (8, 256), (1, 64)):
        kw = dict(coop=coop, mix=mix, depth=depth, tile=tile, bank=bank)
        jc = JPM.op_cost(js, op, regime, n_keys=5000, **kw)
        tc = PM.op_cost(ts, op, regime, n_keys=5000, **kw)
        assert PM.predict_us(tc, tcal) == JPM.predict_us(jc, jcal)
        assert PM.ceiling_us(tc, tcal) == JPM.ceiling_us(jc, jcal)
        assert (PM.ceiling_mops(ts, op, regime, n_keys=5000, calib=tcal,
                                **kw)
                == JPM.ceiling_mops(js, op, regime, n_keys=5000, calib=jcal,
                                    **kw))
        assert (PM.predict_config_us(ts, op, regime, calib=tcal, **kw)
                == JPM.predict_config_us(js, op, regime, calib=jcal, **kw))
    # without a calibration: the device's (the CPU defaults, the JAX numbers)
    tc = PM.op_cost(ts, "contains", "vmem", n_keys=777)
    jc = JPM.op_cost(js, "contains", "vmem", n_keys=777)
    assert PM.predict_us(tc, device="cpu") == JPM.predict_us(jc)
    assert PM.ceiling_us(tc, device="cpu") == JPM.ceiling_us(jc)


@pytest.mark.parametrize("args", SPEC_ARGS, ids=IDS)
def test_choose_coop_matches_jax(args):
    js, ts = _specs(args)
    for op, regime, tile in itertools.product(
            ("contains", "add"), ("vmem", "hbm"), (8, 64, 256)):
        assert (PM.choose_coop(ts, op, regime, tile, "cpu")
                == JPM.choose_coop(js, op, regime, tile))


def test_calibration_dicts_cross_read():
    tcal = PC.Calibration(backend="cuda:NVIDIA H100 80GB HBM3",
                          measured=True, **CALIB)
    d = tcal.to_dict()
    assert d == JC.Calibration.from_dict(d).to_dict()
    assert PC.Calibration.from_dict(
        JC.Calibration(backend="cpu", **CALIB).to_dict()) == \
        PC.Calibration(backend="cpu", **CALIB)
    for mod in (PC, JC):
        with pytest.raises(ValueError):
            mod.Calibration.from_dict({**d, "schema": 0})
    assert PC._SCHEMA == JC._SCHEMA
    # the CPU defaults are the JAX numbers, so CPU plans are JAX plans
    assert PC.default_calibration("cpu") == PC.Calibration.from_dict(
        JC.default_calibration("cpu").to_dict())
    cuda = PC.default_calibration("cuda:NVIDIA H100 80GB HBM3")
    assert cuda.backend == "cuda:NVIDIA H100 80GB HBM3" and not cuda.measured
    assert all(getattr(cuda, f) > 0 for f in CALIB)
    assert "tpu" not in PC._DEFAULTS


def test_calibration_caches_keep_the_packages_apart(tmp_path, monkeypatch):
    assert PC.cache_path() == str(tmp_path / "calib.json")
    monkeypatch.delenv("REPRO_CALIB_CACHE")
    assert PC.cache_path().endswith(".cache/repro_torch/calibration.json")
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    assert PC.get_calibration(device="cpu") == PC.default_calibration("cpu")
    odd = dict(CALIB, bw_hbm_gbs=1.5)
    # a JAX entry in the shared file does not answer for the port
    JC._store_disk(f"calib|{JC._SCHEMA}|cpu",
                   JC.Calibration(backend="cpu", measured=True,
                                  **odd).to_dict())
    assert PC.get_calibration(device="cpu") == PC.default_calibration("cpu")
    # a port entry answers for the port's key only
    key = f"repro_torch|calib|{PC._SCHEMA}|cpu"
    PC._store_disk(key, PC.Calibration(backend="cpu", measured=True,
                                       **CALIB).to_dict())
    assert PC.get_calibration(device="cpu").bw_res_gbs == 535.25
    assert JC.get_calibration().bw_hbm_gbs == 1.5
    data = json.loads((tmp_path / "calib.json").read_text())
    assert sorted(data) == [f"calib|{JC._SCHEMA}|cpu", key]
    # a corrupt entry falls back to the defaults
    PC._store_disk(key, {"schema": 1, "backend": "cpu"})
    assert PC.get_calibration(device="cpu") == PC.default_calibration("cpu")


def test_measure_calibration_runs_on_the_cpu(monkeypatch):
    before = dict(kc.LAUNCHES)
    for name, probe in PC.PROBES.items():
        v = probe(device="cpu")
        assert math.isfinite(v) and v >= 0, (name, v)
    calib = PC.measure_calibration("cpu")
    assert calib.measured and calib.backend == "cpu"
    assert all(math.isfinite(getattr(calib, f)) and getattr(calib, f) > 0
               for f in CALIB)
    # a probe that raises, or returns <= 0, keeps the default for its
    # constant; the result is then not measured, and never cached
    probes = dict(PC.PROBES)
    monkeypatch.setitem(PC.PROBES, "gops", lambda device=None: 1 / 0)
    monkeypatch.setitem(PC.PROBES, "step_us", lambda device=None: -1.0)
    with pytest.warns(UserWarning, match="gops .*step_us"):
        calib = PC.measure_calibration("cpu")
    assert calib.gops == 8.0 and calib.step_us == 150.0
    assert not calib.measured
    monkeypatch.setenv("REPRO_CALIB_MEASURE", "1")
    with pytest.warns(UserWarning):
        assert not PC.get_calibration(device="cpu").measured
    assert PC.get_calibration(measure=False, device="cpu") == \
        PC.default_calibration("cpu")
    # REPRO_CALIB_MEASURE=1 measures and stores
    monkeypatch.setattr(PC, "PROBES", probes)
    stored = PC.get_calibration(device="cpu")
    assert stored.measured and PC.get_calibration(
        measure=False, device="cpu") == stored
    assert kc.LAUNCHES == before           # the CPU runs the plain versions
    assert PC.step_grid("cpu") == 16


def test_probe_plain_versions():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, (16, 128), dtype=np.uint64).astype(np.uint32)
    x[0, 0] = 0xFFFFFFFF
    tx = torch.from_numpy(x.view(np.int32).copy())
    out = kc.step(tx, torch.empty_like(tx))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), x + np.uint32(1))
    n, iters = 300, 48
    a = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for _ in range(iters):
            a = a * np.uint32(kc.CHAIN_MUL) + np.uint32(kc.CHAIN_ADD)
    got = kc.chain(torch.empty((n,), dtype=torch.int32), iters)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), a)

    def mix32(v):
        v = v ^ (v >> np.uint32(16))
        v = v * np.uint32(0x7FEB352D)
        v = v ^ (v >> np.uint32(15))
        v = v * np.uint32(0x846CA68B)
        return v ^ (v >> np.uint32(16))

    words, n, per = 1 << 10, 200, 5
    table = kc.gather_table(words, "cpu")
    ids = (np.arange(per, dtype=np.uint64)[:, None] * n
           + np.arange(n, dtype=np.uint64)[None, :]).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = (mix32(ids) & np.uint32(words - 1)).sum(
            axis=0, dtype=np.uint64).astype(np.uint32)
    got = kc.gather(table, torch.empty((n,), dtype=torch.int32), per)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for bad in (lambda: kc.step(tx[:, :64], tx[:, :64].clone()),
                lambda: kc.step(tx, torch.empty((8, 128), dtype=torch.int32)),
                lambda: kc.chain(torch.empty((4,), dtype=torch.int32), 10),
                lambda: kc.chain(torch.empty((4,), dtype=torch.int64), 16),
                lambda: kc.gather(torch.zeros(3, dtype=torch.int32),
                                  torch.empty(4, dtype=torch.int32), 1),
                lambda: kc.gather(table, torch.empty(4, dtype=torch.int32),
                                  0)):
        with pytest.raises(ValueError):
            bad()


def test_perfmodel_surface_matches_jax():
    assert PM.__all__ == JPM.__all__
    assert TT.TUNABLE_DEPTHS == JT.TUNABLE_DEPTHS
    assert TT.TUNABLE_SEGMENTS == JT.TUNABLE_SEGMENTS
    for name in ("WORD", "KEY_BYTES", "OUT_BYTES", "HASH_FLOPS_FULL",
                 "HASH_FLOPS_CHEAP", "PATTERN_FLOPS_PER_WORD",
                 "COOP_COL_FRACTION", "CUCKOO_ALT_FRACTION",
                 "QUOTIENT_SCAN_FRACTION", "QUOTIENT_SCAN_PASSES",
                 "DMA_ISSUE_VOPS"):
        assert getattr(PM.model, name) == getattr(JPM.model, name), name
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError):
            PC.get_calibration()


def test_report_utils_match_jax(tmp_path):
    for i, rep in enumerate(({"a": 1}, {"b": [2, 3]}, {"c": "x"})):
        (tmp_path / f"r{2 - i}.json").write_text(json.dumps(rep))
    (tmp_path / "skip.txt").write_text("-")
    assert RU.load_reports(str(tmp_path)) == JRU.load_reports(str(tmp_path))
    for b in (None, 0, 1, 1023, 1536, 5 << 20, 3 << 40, 1 << 60, -2048):
        assert RU.fmt_bytes(b) == JRU.fmt_bytes(b)
    for x, d in itertools.product((None, "s", 0, 3, 2.5, -1e-3), (0, 2, 4)):
        assert RU.fmt_float(x, d) == JRU.fmt_float(x, d)
    for x, u, d in itertools.product((None, 0, 999.9, 1234.5, 2e6, -3e9),
                                     ("", "ops/s"), (0, 1)):
        assert RU.fmt_rate(x, u, d) == JRU.fmt_rate(x, u, d)
