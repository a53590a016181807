"""The port's filter service against the JAX package's, on the CPU.

Each scenario of ``tests/test_service.py`` runs through the JAX service
and the port's (banks built with ``device="cpu"``) on the same request
stream, with the same virtual service clock. Compared exactly: the
returned seq ids, the contains results, the shed counts by reason and
tenant, the deterministic part of the metrics registry, the names of the
traced spans in order, and the final words (as uint32) and engine state.
Each scenario also keeps its own assertions, on both packages. Banks stay
small (4-8 members, m <= 2^13 bits, <= 600 requests).

The recovery drills run the port's driver twice (clean, and with a
``SimulatedFailure`` midway) and the JAX driver once, clean. The
flush-barrier checkpoints of each package restore in the other.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.runtime.fault_tolerance as jft
import repro.service as jsvc
import repro_torch.api as tapi
import repro_torch.runtime.fault_tolerance as tft
import repro_torch.service as tsvc
from repro.checkpoint import checkpoint as jckpt
from repro_torch import interop
from repro_torch.checkpoint import checkpoint as tckpt

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

T = 4

JAX = types.SimpleNamespace(
    name="jax", api=japi, svc=jsvc, ft=jft, ckpt=jckpt,
    bank=lambda n, **kw: japi.make_filter_bank(n, **kw),
    sized=lambda n, **kw: japi.filter_for_n_items(n, **kw),
    arr=jnp.asarray, words=lambda w: np.asarray(w, np.uint32),
    state=lambda s: None if s is None else np.asarray(s).astype(np.int64))
PORT = types.SimpleNamespace(
    name="port", api=tapi, svc=tsvc, ft=tft, ckpt=tckpt,
    bank=lambda n, **kw: tapi.make_filter_bank(n, device="cpu", **kw),
    sized=lambda n, **kw: tapi.filter_for_n_items(n, device="cpu", **kw),
    arr=lambda a: torch.from_numpy(np.asarray(a).view(np.int32)
                                   if np.asarray(a).dtype == np.uint32
                                   else np.asarray(a)),
    words=lambda w: w.cpu().numpy().view(np.uint32),
    state=lambda s: (None if s is None else np.asarray(
        s.cpu().numpy() if isinstance(s, torch.Tensor) else s, np.int64)))


def _bank(p, variant="sbf", bank=T, **kw):
    kw.setdefault("m_bits", 1 << 13)
    if variant != "sbf":
        kw["variant"] = variant
    return p.bank(bank, **kw)


def _requests(n, seed=0, n_tenants=T):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 32, (n, 2)).astype(np.uint32)
    tenants = rng.randint(0, n_tenants, n).astype(np.int64)
    return keys, tenants


class _Clock:
    """A virtual service clock both packages read the same way."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _service(p, filt, clock=None, **cfg):
    adm = cfg.pop("admission", None)
    if adm is not None:
        cfg["admission"] = p.svc.AdmissionPolicy(**adm)
    return p.svc.FilterService(filt, p.svc.ServiceConfig(**cfg),
                               clock=clock or _Clock())


class _Record:
    """What a scenario produced, in package-neutral numpy form."""

    def __init__(self, p):
        self.p = p
        self.out = {"seqs": [], "results": [], "extra": []}

    def seqs(self, s):
        self.out["seqs"].append(np.asarray(s, np.int64))
        return s

    def results(self, svc):
        res = svc.take_results()
        self.out["results"].append(sorted((int(k), bool(v))
                                          for k, v in res.items()))
        return res

    def note(self, x):
        self.out["extra"].append(x)

    def service(self, svc, tag="svc"):
        p = self.p
        reg = svc.telemetry.registry
        self.out[tag] = {
            "shed_counts": dict(svc.admission.shed_counts),
            "shed_by_tenant": svc.admission.shed_by_tenant.copy(),
            "unhealthy": svc.admission.unhealthy.copy(),
            "metrics": reg.snapshot_state(deterministic_only=True),
            "spans": [s["name"] for s in svc.telemetry.tracer.spans()],
            "counters": svc.counters, "seq": svc._seq,
            "words": p.words(svc.filt.words),
            "state": p.state(svc.filt.state),
            "m_bits": svc.filt.spec.m_bits}

    def filt(self, f, tag="filt"):
        self.out[tag] = {"words": self.p.words(f.words),
                         "state": self.p.state(f.state),
                         "bank_shape": tuple(f.bank_shape)}


def _equal(a, b, path="record"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


# -- the scenarios of tests/test_service.py -----------------------------------

def size_trigger_flushes_inline(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16, flush_deadline=None)
    keys, tenants = _requests(40)
    r.seqs(svc.submit_many("add", keys, tenants))
    assert svc.counters["size_flushes"] == 2
    assert svc.pending_total == 8
    svc.drain()
    assert svc.pending_total == 0
    assert svc.counters["flushed_ops"] == 40
    r.service(svc)


def deadline_trigger_via_pump(p, r, tmp):
    clock = _Clock()
    svc = _service(p, _bank(p), clock, max_batch=64, flush_deadline=1.0)
    keys, tenants = _requests(10)
    r.seqs(svc.submit_many("add", keys, tenants))
    assert svc.pump() == 0
    clock.t = 2.0
    assert svc.pump() == 1
    assert svc.counters["deadline_flushes"] == 1
    assert svc.pending_total == 0
    r.service(svc)


def streamed_equals_bulk_sbf(p, r, tmp):
    keys, tenants = _requests(150, seed=3)
    svc = _service(p, _bank(p), max_batch=32)
    for i in range(0, 150, 7):
        r.seqs(svc.submit_many("add", keys[i:i + 7], tenants[i:i + 7]))
    svc.drain()
    direct = _bank(p).add(p.arr(keys), tenants=p.arr(tenants))
    np.testing.assert_array_equal(p.words(svc.filt.words),
                                  p.words(direct.words))
    r.service(svc)


def contains_tickets_and_padding(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=32)
    keys, tenants = _requests(20, seed=4)
    r.seqs(svc.submit_many("add", keys, tenants))
    svc.drain()
    seqs = r.seqs(svc.submit_many("contains", keys, tenants))
    other_k, other_t = _requests(20, seed=99)
    neg = r.seqs(svc.submit_many("contains", other_k, other_t))
    svc.drain()
    res = r.results(svc)
    assert all(res[s] for s in seqs)
    assert svc.take_results() == {}
    assert len(res) == len(seqs) + len(neg)
    r.service(svc)


def remove_requires_capable_engine(p, r, tmp):
    svc = _service(p, _bank(p))
    with pytest.raises(NotImplementedError) as e:
        svc.submit("remove", np.ones((1, 2), np.uint32))
    r.note(str(e.value).replace("'torch'", "'jnp'"))


def counting_remove_roundtrip(p, r, tmp):
    svc = _service(p, _bank(p, "countingbf"), max_batch=16)
    keys, tenants = _requests(12, seed=5)
    r.seqs(svc.submit_many("add", keys, tenants))
    r.seqs(svc.submit_many("remove", keys[:6], tenants[:6]))
    svc.drain()
    seqs = r.seqs(svc.submit_many("contains", keys, tenants))
    svc.drain()
    res = r.results(svc)
    hits = [res[s] for s in seqs]
    assert not any(hits[:6]) and all(hits[6:])
    r.service(svc)


def tenant_validation(p, r, tmp):
    svc = _service(p, _bank(p))
    with pytest.raises(ValueError) as e:
        svc.submit("add", np.ones((1, 2), np.uint32), tenant=T)
    r.note(str(e.value))


def queue_bound_sheds_excess(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None,
                   admission=dict(queue_limit=50))
    keys, tenants = _requests(80, seed=6)
    seqs = r.seqs(svc.submit_many("add", keys, tenants))
    assert (seqs >= 0).sum() == 50 and (seqs < 0).sum() == 30
    assert svc.admission.shed_counts["queue"] == 30
    assert svc.health()["admission.shed_rate"] == pytest.approx(30 / 80)
    svc.drain()
    r.service(svc)


def tenant_quota_sheds_hot_tenant(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None,
                   admission=dict(tenant_quota=5))
    keys = np.ones((20, 2), np.uint32)
    seqs = r.seqs(svc.submit_many("add", keys, np.zeros(20, np.int64)))
    assert (seqs >= 0).sum() == 5
    cold = r.seqs(svc.submit_many("add", keys[:3], np.full(3, 1)))
    assert (cold >= 0).all()
    svc.drain()
    r.service(svc)


def health_sheds_adds_not_reads_bloom(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16,
                   admission=dict(shed_fill=0.0, health_every=1))
    keys, tenants = _requests(16, seed=7)
    r.seqs(svc.submit_many("add", keys, tenants))
    assert svc.admission.unhealthy.all()
    s_add = r.seqs(svc.submit_many("add", keys, tenants))
    s_read = r.seqs(svc.submit_many("contains", keys, tenants))
    assert (s_add < 0).all() and (s_read >= 0).all()
    assert svc.admission.shed_counts["health"] == 16
    svc.drain()
    r.results(svc)
    r.service(svc)


def health_sheds_on_cuckoo_insert_failures(p, r, tmp):
    svc = _service(p, _bank(p, "cuckoo", m_bits=1 << 8), max_batch=64,
                   admission=dict(health_every=1))
    keys, tenants = _requests(512, seed=8)
    r.seqs(svc.submit_many("add", keys, tenants))
    svc.drain()
    assert int(p.state(svc.filt.state).sum()) > 0
    assert svc.admission.unhealthy.any()
    blocked = r.seqs(svc.submit_many("add", keys[:8], tenants[:8]))
    assert (blocked < 0).any()
    svc.drain()
    r.service(svc)


def maintenance_advance_and_decay_cadence(p, r, tmp):
    svc = _service(p, _bank(p, generations=4), max_batch=16)
    maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(advance_every=2))
    keys, tenants = _requests(8, seed=9)
    for step in range(6):
        r.seqs(svc.submit_many("add", keys[step:step + 2],
                               tenants[step:step + 2]))
        maint.tick(svc, step + 1)
    assert sum(1 for e in maint.events if e["kind"] == "advance") == 3
    r.note(maint.events)
    r.note([int(h) for h in np.asarray(svc.filt.state).reshape(-1)])
    r.service(svc, "windowed")

    svc = _service(p, _bank(p, "countingbf"), max_batch=16)
    maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(decay_every=3))
    r.seqs(svc.submit_many("add", keys, tenants))
    for step in range(3):
        maint.tick(svc, step + 1)
    svc.drain()
    seqs = r.seqs(svc.submit_many("contains", keys, tenants))
    svc.drain()
    res = r.results(svc)
    assert not any(res[s] for s in seqs)
    r.note(maint.events)
    r.service(svc, "counting")


def checkpoint_is_flush_barrier(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None)
    maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(
        checkpoint_every=1, ckpt_dir=str(tmp / p.name),
        async_checkpoint=False))
    keys, tenants = _requests(10, seed=10)
    r.seqs(svc.submit_many("add", keys, tenants))
    assert svc.pending_total == 10
    maint.tick(svc, 1)
    assert svc.pending_total == 0
    r.service(svc)
    # each package's flush-barrier checkpoint restores in both packages:
    # the port reads the JAX engine names as aliases; the JAX package is
    # told the port engine's JAX counterpart
    for q in (JAX, PORT):
        svc2 = _service(q, _bank(q), max_batch=1 << 10, flush_deadline=None)
        if q is JAX and p is PORT:
            step, filt = jckpt.restore_filter(
                str(tmp / p.name),
                backend=interop.JAX_ENGINE[svc.filt.backend])
            svc2.restore_state(filt, jckpt.manifest_extra(
                str(tmp / p.name))["service"])
        else:
            kw = {"device": "cpu"} if q is PORT else {}
            step = q.svc.restore_service(svc2, None, str(tmp / p.name), **kw)
        assert step == 1
        np.testing.assert_array_equal(q.words(svc2.filt.words),
                                      p.words(svc.filt.words))
        assert svc2._seq == svc._seq
        assert (svc2.telemetry.registry.snapshot_state(
            deterministic_only=True)["metrics"]
            == [m for m in svc.telemetry.registry.snapshot_state(
                deterministic_only=True)["metrics"]])


def snapshot_refuses_non_barrier(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None)
    r.seqs([svc.submit("add", np.ones((1, 2), np.uint32))])
    with pytest.raises(RuntimeError) as e:
        svc.snapshot_state()
    r.note(str(e.value))


def grow_bank_preserves_members(p, r, tmp):
    filt = _bank(p)
    keys, tenants = _requests(40, seed=11)
    filt = filt.add(p.arr(keys), tenants=p.arr(tenants))
    grown = p.svc.grow_bank(filt, 7)
    assert tuple(grown.bank_shape) == (7,)
    np.testing.assert_array_equal(p.words(grown.words[:T]), p.words(filt.words))
    assert not p.words(grown.words[T:]).any()
    hits = grown.contains(p.arr(keys), tenants=p.arr(tenants))
    assert bool(np.asarray(hits).all())
    with pytest.raises(ValueError):
        p.svc.grow_bank(filt, 2)
    r.filt(grown)


def grow_bank_carries_cuckoo_state(p, r, tmp):
    filt = _bank(p, "cuckoo", m_bits=1 << 8)
    keys, tenants = _requests(300, seed=12)
    filt = filt.add(p.arr(keys), tenants=p.arr(tenants))
    grown = p.svc.grow_bank(filt, 6)
    np.testing.assert_array_equal(p.state(grown.state)[:T],
                                  p.state(filt.state))
    assert not p.state(grown.state)[T:].any()
    r.filt(grown)


def reshard_service_live(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None)
    keys, tenants = _requests(30, seed=13)
    r.seqs(svc.submit_many("add", keys, tenants))
    svc.admission.unhealthy[1] = True
    p.svc.reshard_service(svc, bank=8)
    assert svc.pending_total == 0 and svc.n_tenants == 8
    assert svc.admission.unhealthy[1] and not svc.admission.unhealthy[7]
    s = r.seqs(svc.submit_many("add", keys[:4], np.full(4, 7)))
    assert (s >= 0).all()
    svc.drain()
    hits = svc.filt.contains(p.arr(keys), tenants=p.arr(tenants))
    assert bool(np.asarray(hits).all())
    r.service(svc)


def grow_capacity_resizes_saturating_quotient_in_place(p, r, tmp):
    fb = p.sized(100, variant="quotient", target_fpr=1e-3, bank=T)
    svc = _service(p, fb, max_batch=16, flush_deadline=None,
                   admission=dict(health_every=1))
    maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(resize_every=1))
    m0 = svc.filt.spec.m_bits
    keys, tenants = _requests(600, seed=14)
    shed = 0
    for step, i in enumerate(range(0, 600, 16)):
        seqs = r.seqs(svc.submit_many("add", keys[i:i + 16],
                                      tenants[i:i + 16]))
        shed += int((np.asarray(seqs) < 0).sum())
        svc.drain()
        maint.tick(svc, step + 1)
    assert shed == 0
    assert int(p.state(svc.filt.state).sum()) == 0
    assert svc.filt.spec.m_bits > m0
    resizes = [e for e in maint.events if e["kind"] == "resize"]
    assert resizes and all(e["load"] >= 0.80 for e in resizes)
    assert not svc.admission.unhealthy.any()
    hits = svc.filt.contains(p.arr(keys), tenants=p.arr(tenants))
    assert bool(np.asarray(hits).all())
    r.note(maint.events)
    r.service(svc)


def grow_capacity_requires_resizable_engine(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16)
    with pytest.raises(ValueError, match="resize"):
        p.svc.grow_capacity(svc)
    maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(resize_every=1))
    with pytest.raises(ValueError, match="resize"):
        maint.tick(svc, 1)


def filter_health_keys(p, r, tmp):
    for variant, kw in (("sbf", {}), ("cuckoo", {"m_bits": 1 << 8}),
                        ("sbf", {"generations": 3})):
        h = _bank(p, variant, **kw).health()
        h.pop("backend")               # engine names differ by design
        r.note(h)
    h = _bank(p).health()
    assert h["variant"] == "sbf" and "fill_fraction" in h
    assert h["bank_shape"] == [T]


def service_health_is_namespaced(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16)
    keys, tenants = _requests(16, seed=14)
    r.seqs(svc.submit_many("add", keys, tenants))
    h = svc.health()
    for k in ("filter.fill_fraction", "service.flushes",
              "admission.shed_rate", "service.pending",
              "admission.admitted"):
        assert k in h
    assert "fill_fraction" not in h and "flushes" not in h
    assert all("." in k for k in h)
    h.pop("filter.backend")            # engine names differ by design
    # the drift gauges are wall-clock report metrics (not deterministic)
    r.note(sorted((k, v) for k, v in h.items()
                  if not k.startswith("perfmodel.")))


def service_legacy_health_view(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16)
    keys, tenants = _requests(16, seed=14)
    r.seqs(svc.submit_many("add", keys, tenants))
    with pytest.warns(DeprecationWarning):
        h = svc.legacy_health()
    assert h["flushes"] == svc.counters["flushes"]
    h.pop("backend")
    r.note(sorted(h.items()))


def flush_spans_carry_perfmodel_prediction(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16)
    keys, tenants = _requests(32, seed=15)
    r.seqs(svc.submit_many("add", keys, tenants))
    svc.drain()
    flushes = svc.telemetry.tracer.spans("service.flush")
    assert flushes
    for sp in flushes:
        assert sp["predicted_us"] > 0 and sp["ceiling_us"] > 0
        assert sp["regime"] in ("vmem", "hbm")
    kids = [s for s in svc.telemetry.tracer.spans()
            if s["name"].startswith("service.flush.")]
    flush_ids = {s["span"] for s in flushes}
    assert kids and all(k["parent"] in flush_ids for k in kids)
    # the plan the prediction was made for (not the wall-clock figures)
    r.note([{k: s[k] for k in ("regime", "probe", "coop", "mix", "span",
                               "parent", "take", "padded")}
            for s in flushes])
    r.service(svc)


def per_tenant_shed_counters(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None,
                   admission=dict(tenant_quota=5))
    keys = np.ones((20, 2), np.uint32)
    r.seqs(svc.submit_many("add", keys, np.zeros(20, np.int64)))
    r.seqs(svc.submit_many("add", keys[:3], np.full(3, 1)))
    assert svc.admission.shed_by_tenant[0].sum() == 15
    assert svc.admission.shed_by_tenant[1].sum() == 0
    c = svc.telemetry.registry.counter("admission.shed", reason="quota",
                                       tenant=0)
    assert c.value == 15 and c.key == "admission.shed{reason=quota,tenant=0}"
    r.service(svc)


def counter_continuity_across_snapshot_restore(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=16, flush_deadline=None)
    keys, tenants = _requests(48, seed=16)
    r.seqs(svc.submit_many("add", keys, tenants))
    svc.drain()
    state = svc.snapshot_state()
    svc2 = _service(p, _bank(p), max_batch=16, flush_deadline=None)
    svc2.restore_state(svc.filt, state)
    assert (svc2.telemetry.registry.snapshot_state()
            == svc.telemetry.registry.snapshot_state())
    r.seqs(svc2.submit_many("add", keys[:16], tenants[:16]))
    svc2.drain()
    assert svc2.counters["flushed_ops"] == svc.counters["flushed_ops"] + 16
    r.note({k: state[k] for k in ("seq", "counters", "admission")})
    r.service(svc2)


def counter_continuity_across_reshard_and_grow(p, r, tmp):
    svc = _service(p, _bank(p), max_batch=1 << 10, flush_deadline=None,
                   admission=dict(tenant_quota=5))
    keys = np.ones((20, 2), np.uint32)
    r.seqs(svc.submit_many("add", keys, np.zeros(20, np.int64)))
    shed_before = svc.admission.shed_by_tenant.copy()
    flushes_before = svc.counters["flushes"]
    p.svc.reshard_service(svc, bank=8)
    assert svc.admission.shed_by_tenant.shape == (8, 3)
    assert (svc.admission.shed_by_tenant[:T] == shed_before).all()
    assert svc.telemetry.registry.counter(
        "admission.shed", reason="quota", tenant=0).value == 15
    assert svc.counters["flushes"] >= flushes_before
    assert svc.telemetry.registry.counter("resharding.reshards").value == 1
    r.service(svc)


SCENARIOS = [size_trigger_flushes_inline, deadline_trigger_via_pump,
             streamed_equals_bulk_sbf, contains_tickets_and_padding,
             remove_requires_capable_engine, counting_remove_roundtrip,
             tenant_validation, queue_bound_sheds_excess,
             tenant_quota_sheds_hot_tenant,
             health_sheds_adds_not_reads_bloom,
             health_sheds_on_cuckoo_insert_failures,
             maintenance_advance_and_decay_cadence,
             checkpoint_is_flush_barrier, snapshot_refuses_non_barrier,
             grow_bank_preserves_members, grow_bank_carries_cuckoo_state,
             reshard_service_live,
             grow_capacity_resizes_saturating_quotient_in_place,
             grow_capacity_requires_resizable_engine, filter_health_keys,
             service_health_is_namespaced, service_legacy_health_view,
             flush_spans_carry_perfmodel_prediction,
             per_tenant_shed_counters,
             counter_continuity_across_snapshot_restore,
             counter_continuity_across_reshard_and_grow]


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Both packages' calibration and tuning caches in the test's dir."""
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_service_scenario_matches_jax(scenario, tmp_path):
    records = []
    for p in (JAX, PORT):
        r = _Record(p)
        scenario(p, r, tmp_path)
        records.append(r.out)
    _equal(records[0], records[1])


# -- recovery (the acceptance invariant) --------------------------------------

def _stream(seed):
    def stream_fn(step):
        rng = np.random.RandomState(seed * 7919 + step)
        out = []
        for i in range(2):
            keys = rng.randint(0, 2 ** 32, (18, 2)).astype(np.uint32)
            tenants = rng.randint(0, T, 18)
            out.append((("add", "contains")[i % 2], keys, tenants))
        return out
    return stream_fn


def _driver_run(p, variant, tmpdir, fail_at=None, steps=9):
    kw = {"m_bits": 1 << 9} if variant == "cuckoo" else {}
    svc = _service(p, _bank(p, variant, **kw), max_batch=32,
                   flush_deadline=2.5)
    maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(
        checkpoint_every=3, ckpt_dir=str(tmpdir)))
    fired = []

    def hook(step):
        if fail_at is not None and step == fail_at and not fired:
            fired.append(step)
            raise p.ft.SimulatedFailure("injected")

    drv = p.svc.ServiceDriver(svc, _stream(42), maint,
                              p.svc.ServiceDriverConfig(virtual_dt=1.0),
                              failure_hook=hook)
    results = []
    feed = drv._feed

    def _feed(step):                 # collect every flushed result in order
        feed(step)
        results.append([(int(k), bool(v))
                        for k, v in sorted(svc.take_results().items())])

    drv._feed = _feed
    final = drv.run(steps)
    results.append([(int(k), bool(v))
                    for k, v in sorted(svc.take_results().items())])
    return final, drv, results


@pytest.mark.parametrize("variant", ["sbf", "cuckoo"])
def test_recovery_bit_exact_matches_jax(variant, tmp_path):
    jfilt, jdrv, jres = _driver_run(JAX, variant, tmp_path / "jax")
    clean, cdrv, cres = _driver_run(PORT, variant, tmp_path / "clean")
    failed, fdrv, fres = _driver_run(PORT, variant, tmp_path / "failed",
                                     fail_at=7)
    kinds = [e["kind"] for e in fdrv.events]
    assert kinds.count("failure") == 1 and "restore" in kinds
    assert len(fdrv.recovery_times) == 1 and fdrv.recovery_times[0] > 0
    for f in (clean, failed):
        np.testing.assert_array_equal(PORT.words(f.words), JAX.words(
            jfilt.words))
        _equal(PORT.state(f.state), JAX.state(jfilt.state))
    # every flush's results, by seq id; a replayed step's flushes give the
    # clean run's results for the same seq ids
    assert cres == jres
    replayed = {}
    for step in fres:
        replayed.update(step)
    assert replayed == {k: v for step in cres for k, v in step}
    reg_j = jdrv.service.telemetry.registry
    for drv in (cdrv, fdrv):
        assert (drv.service.telemetry.registry.snapshot_state(
            deterministic_only=True)
            == reg_j.snapshot_state(deterministic_only=True))
    assert fdrv.service.telemetry.registry.counter(
        "service.restores", deterministic=False).value == 1
    # the port's last flush-barrier checkpoint restores in the JAX package
    step, jback = jckpt.restore_filter(str(tmp_path / "failed"),
                                       backend=interop.JAX_ENGINE[
                                           failed.backend])
    assert step == 9
    np.testing.assert_array_equal(np.asarray(jback.words),
                                  JAX.words(jfilt.words))


def test_driver_max_restarts(tmp_path):
    for p in (JAX, PORT):
        def hook(step):
            raise p.ft.SimulatedFailure("always")

        svc = _service(p, _bank(p), max_batch=32, flush_deadline=2.5)
        maint = p.svc.MaintenanceLoop(p.svc.MaintenanceConfig(
            checkpoint_every=2, ckpt_dir=str(tmp_path / p.name)))
        drv = p.svc.ServiceDriver(svc, _stream(1), maint,
                                  p.svc.ServiceDriverConfig(max_restarts=2),
                                  failure_hook=hook)
        with pytest.raises(p.ft.SimulatedFailure):
            drv.run(5)
        assert sum(1 for e in drv.events if e["kind"] == "failure") == 3


# -- the port's own surface ---------------------------------------------------

def test_service_exports_match_jax():
    assert tsvc.__all__ == jsvc.__all__
    assert tsvc.SHED_REASONS == jsvc.SHED_REASONS and tsvc.OPS == jsvc.OPS
    for cls in ("AdmissionPolicy", "ServiceConfig", "MaintenanceConfig",
                "ServiceDriverConfig"):
        mine = getattr(tsvc, cls)()
        theirs = getattr(jsvc, cls)()
        for f in type(theirs).__dataclass_fields__:
            if f in ("admission", "telemetry"):
                continue
            assert getattr(mine, f) == getattr(theirs, f), (cls, f)
    keys = np.arange(6, dtype=np.uint64) << np.uint64(33)
    np.testing.assert_array_equal(tsvc.service_keys(keys),
                                  jsvc.service_keys(keys))
    with pytest.raises(ValueError):
        tsvc.service_keys(np.zeros((3, 3), np.uint32))


@pytest.mark.parametrize("variant", ["sbf", "countingbf"])
def test_member_fill_matches_jax(variant):
    """Each member's fill of random words (the counting engine's counters
    seen as occupancy bits) in both packages, bit for bit."""
    jbank = JAX.bank(5, variant=variant, m_bits=1 << 13)
    rng = np.random.RandomState(17)
    words = rng.randint(0, 2 ** 32, np.asarray(jbank.words).shape,
                        dtype=np.uint64).astype(np.uint32)
    words &= rng.randint(0, 2 ** 32, words.shape,
                         dtype=np.uint64).astype(np.uint32)   # not all full
    jbank = jbank.replace(words=jnp.asarray(words))
    tbank = interop.from_jax_words(dataclasses.asdict(jbank.spec), words,
                                   device="cpu", bank_shape=(5,))
    got = tsvc.member_fill(tbank)
    assert got.dtype == np.float64 and got.shape == (5,)
    np.testing.assert_array_equal(got, jsvc.member_fill(jbank))


def test_popcount_matches_numpy():
    rng = np.random.RandomState(0)
    w = rng.randint(0, 2 ** 32, (3, 4099), dtype=np.uint64).astype(np.uint32)
    w[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = tsvc.admission.popcount32(torch.from_numpy(w.view(np.int32)))
    np.testing.assert_array_equal(
        got.numpy(), np.unpackbits(w.view(np.uint8).reshape(3, -1, 4),
                                   axis=-1).sum(-1))


def test_service_stays_on_its_banks_device_and_needs_a_card(tmp_path):
    svc = _service(PORT, _bank(PORT), max_batch=8)
    keys, tenants = _requests(8, seed=18)
    svc.submit_many("add", keys, tenants)
    assert svc.filt.device.type == "cpu"
    tckpt.save_filter(str(tmp_path), 1, svc.filt,
                      extra={"service": svc.snapshot_state()})
    if not torch.cuda.is_available():     # device=None is the card
        with pytest.raises(RuntimeError):
            tapi.make_filter_bank(T, m_bits=1 << 13)
        with pytest.raises(RuntimeError):
            tsvc.restore_service(svc, None, str(tmp_path))
        with pytest.raises(RuntimeError):
            tckpt.restore_filter(str(tmp_path))
    with pytest.raises(NotImplementedError, match="distributed"):
        tsvc.reshard_service(svc, mesh=object())
