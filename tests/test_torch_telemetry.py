"""The port's telemetry against the JAX package's, on the CPU.

``repro_torch.telemetry`` keeps the JAX package's metrics, tracing and
Prometheus export word for word, so each scenario of
``tests/test_telemetry.py`` runs through both packages and the outputs
must be equal exactly: bucket edges, registry snapshots (JSON
round-tripped, labels included), span events under a virtual clock, the
JSONL trace and the Prometheus text. The drift monitor reads the port's
performance model for the filter's device; its alert fires on a
miscalibrated model, stays quiet on a sane one, and the flush plan it
resolves equals the JAX one for the same spec and options. A registry
snapshot written by either package restores in the other.
"""
import io
import json

import numpy as np
import pytest
import torch

import repro.telemetry as J
import repro_torch.telemetry as T

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

PKGS = {"jax": J, "port": T}


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Both packages' calibration and tuning caches in the test's dir."""
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _both(fn):
    out = {name: fn(m) for name, m in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_surface_and_pinned_edges_match_jax():
    assert T.__all__ == J.__all__
    edges = _both(lambda m: m.log_edges(1e-7, 10.0, per_decade=5))
    assert edges == T.DEFAULT_LATENCY_EDGES == J.DEFAULT_LATENCY_EDGES
    assert len(edges) == 41
    assert edges == tuple(10.0 ** (i / 5) for i in range(-35, 6))
    for m in PKGS.values():
        with pytest.raises(ValueError):
            m.log_edges(0.0, 1.0)
    samples = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q in (0.0, 50.0, 99.0, 100.0):
        _both(lambda m: m.nearest_rank(samples, q))
    for bad in ([], [1.0]):
        for m in PKGS.values():
            with pytest.raises(ValueError):
                m.nearest_rank(bad, 101.0 if bad else 50.0)


def test_histograms_match_jax():
    xs = np.random.RandomState(0).exponential(1e-3, 500)

    def run(m):
        h = m.Histogram("lat", (), edges=m.DEFAULT_LATENCY_EDGES)
        h.observe_many(xs)
        h3 = m.Histogram("lat", (), edges=(1.0, 10.0), keep_samples=False)
        h3.observe_many([0.5, 5.0, 5.0])
        return (h.counts, h.sum, h.min, h.max, h.percentile(99.9),
                h.summary(unit=1e6), h3.percentile(50.0))

    got = _both(run)
    assert got[4] in xs and got[5]["n"] == 500 and got[6] == 10.0


def _registry(m):
    reg = m.MetricsRegistry()
    reg.counter("service.flushes").inc(7)
    reg.counter("admission.shed", reason="quota", tenant=3).inc(2)
    reg.gauge("filter.fill", deterministic=False).set(0.123456789)
    reg.histogram("service.latency", op="add").observe_many(
        [1e-4, 2e-3, 0.5])
    return reg


def test_registry_snapshots_match_and_cross_packages():
    states = _both(lambda m: json.loads(json.dumps(
        _registry(m).snapshot_state())))
    _both(lambda m: _registry(m).snapshot_state(deterministic_only=True))
    _both(lambda m: _registry(m).snapshot())
    # a snapshot of either package restores in the other, bit-exactly
    for m in PKGS.values():
        reg = m.MetricsRegistry()
        reg.restore_state(states)
        assert reg.snapshot_state() == states
        c = reg.counter("admission.shed", reason="quota", tenant=3)
        assert c.value == 2 and c.key == "admission.shed{reason=quota,tenant=3}"


def test_registry_guards_match_jax():
    for m in PKGS.values():
        reg = m.MetricsRegistry()
        reg.counter("x").inc()
        with pytest.raises(TypeError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("x").inc(-1)
        with pytest.raises(ValueError):
            reg.counter("x").set_total(0)
        with pytest.raises(ValueError):
            m.Histogram("bad", (), edges=(2.0, 1.0))
        with pytest.raises(ValueError):
            reg.restore_state({"metrics": [{"kind": "nope", "name": "y"}]})


def _step_clock():
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    return clock


def _trace(m):
    tr = m.Tracer(clock=_step_clock())
    with tr.span("outer", op="add") as sp:
        with tr.span("inner"):
            pass
        sp.set(extra=1, n=np.int64(3))
    with tr.span("flush", op="add"):
        pass
    buf = io.StringIO()
    tr.export_jsonl(buf)
    return tr.spans(), tr.spans("inner"), buf.getvalue(), tr.n_started


def test_traces_match_jax():
    spans, inner, text, n = _both(_trace)
    assert n == 3 and inner[0]["parent"] == spans[1]["span"]
    assert text.splitlines()[2] == (
        '{"dur": 1.0, "name": "flush", "op": "add", "parent": null, '
        '"span": 2, "t0": 5.0, "t1": 6.0}')
    for m in PKGS.values():
        tr = m.Tracer(enabled=False)
        with tr.span("a") as sp:
            sp.set(x=1)
        assert tr.spans() == [] and tr.n_started == 0


def test_prometheus_text_matches_jax():
    def build(m):
        reg = m.MetricsRegistry()
        reg.histogram("lat", edges=(1.0, 10.0)).observe_many(
            [0.5, 5.0, 50.0])
        reg.counter("service.requests", tenant=0).inc(3)
        reg.gauge("temp").set(1.5)
        reg.counter("1bad.name", z="1").inc(2)
        return m.prometheus_text(reg)

    text = _both(build)
    assert text.startswith('# TYPE _1bad_name counter\n')
    assert 'lat_bucket{le="+Inf"} 3\n' in text


def test_telemetry_bundle_matches_jax(tmp_path):
    def run(m):
        tel = m.Telemetry(m.TelemetryConfig(drift=False),
                          clock=_step_clock())
        tel.registry.counter("a").inc(4)
        with tel.tracer.span("s"):
            pass
        path = tmp_path / f"{m.__name__}.prom"
        tel.write_prometheus(str(path))
        tel.write_trace_jsonl(str(tmp_path / f"{m.__name__}.jsonl"))
        off = m.Telemetry(m.TelemetryConfig(enabled=False))
        return (tel.snapshot_state(), path.read_text(),
                (tmp_path / f"{m.__name__}.jsonl").read_text(),
                tel.drift is None, off.drift is None, off.tracer.enabled)

    _both(run)


# -- drift monitor ------------------------------------------------------------

def _filters():
    import repro.api as japi
    import repro_torch.api as tapi
    return {"jax": japi.make_filter_bank(2, m_bits=1 << 10, k=4),
            "port": tapi.make_filter_bank(2, m_bits=1 << 10, k=4,
                                          device="cpu")}


def test_drift_alert_fires_on_miscalibrated_model():
    from repro_torch.perfmodel import Calibration
    fast = Calibration(backend="cpu", bw_hbm_gbs=1e9, bw_res_gbs=1e9,
                       gops=1e9, launch_us=1e-6, step_us=1e-6,
                       measured=True)
    reg = T.MetricsRegistry()
    mon = T.DriftMonitor(reg, T.DriftConfig(window=8, min_samples=3,
                                            tolerance=16.0), calib=fast)
    filt = _filters()["port"]
    for _ in range(3):
        ann = mon.observe(filt, "add", 64, measured_s=1e-2)
    assert ann["drift_ratio"] > 16.0
    assert reg.gauge("perfmodel.drift.alert", deterministic=False,
                     op="add").value == 1.0
    assert reg.counter("perfmodel.drift.alerts", deterministic=False,
                       op="add").value >= 1


def test_drift_predictions_and_plans_match_jax():
    from repro import perfmodel as JPM
    from repro_torch import perfmodel as TPM
    filts = _filters()
    calib = {"jax": JPM.get_calibration(),
             "port": TPM.get_calibration(device="cpu")}
    assert calib["jax"].to_dict() == calib["port"].to_dict()
    for op in ("add", "contains"):
        plans = {k: PKGS[k].resolve_flush_plan(filts[k], op) for k in PKGS}
        assert plans["port"] == plans["jax"]
        assert plans["port"]["bank"] == 2
        preds = {}
        for k, m in PKGS.items():
            reg = m.MetricsRegistry()
            mon = m.DriftMonitor(reg, m.DriftConfig(window=8, min_samples=3,
                                                    tolerance=16.0),
                                 calib=calib[k])
            preds[k] = mon.predict(filts[k], op, 64)
            assert preds[k] is not None
            for _ in range(4):
                mon.observe(filts[k], op, 64,
                            measured_s=preds[k][0] * 1e-6)
            assert reg.gauge("perfmodel.drift.alert", deterministic=False,
                             op=op).value == 0.0
        assert preds["port"] == preds["jax"]
