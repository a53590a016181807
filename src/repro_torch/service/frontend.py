"""Streaming front end: request accumulation into fixed-shape device batches.

Counterpart of ``repro.service.frontend``. The service serves on the
device of the bank it is given: a flush uploads its padded batch to that
device, runs the port's routed bank op (the engines' bank kernels, or the
generic path a member at a time), and in its ``sync`` span waits for the
device (a contains result's copy to the host, or a synchronize after an
update), so the drift monitor's measured time counts device time.

The serving problem the bulk benchmarks don't answer: requests arrive one
at a time (or in small bursts), but the engines want large fixed-shape
batches — retracing per batch size would destroy latency, and tiny
launches destroy throughput. The front end bridges the two:

* **Accumulate**: ``submit``/``submit_many`` append admitted requests to a
  per-op FIFO (one queue per op class so ``add``/``contains``/``remove``
  each compile to their own stable executable).
* **Flush on size or deadline**: a queue flushes as soon as it holds
  ``max_batch`` requests (size trigger, throughput path) or when its
  oldest request has waited ``flush_deadline`` (deadline trigger via
  ``pump()``, tail-latency path).
* **Pad to tile**: every flush executes the SAME static shape —
  ``(max_batch, 2)`` keys + ``(max_batch,)`` tenants + a valid mask —
  so there is exactly one compiled executable per op regardless of how
  full the batch is. Padding slots carry ``valid=False`` (adds/removes
  must mask: fingerprint and counting updates are not idempotent) and
  their lookup results are discarded.
* **Route by tenant**: requests address bank members by tenant id; the
  flush issues the Filter API's routed bank ops (flat ``(keys, tenants)``
  through ``route_by_id``-based scatter or the engines' native routed
  kernels), so a whole mixed-tenant batch is ONE device launch on native
  bank engines.

The service is deliberately single-threaded and clock-parameterized: the
replay harness drives it with the real clock for honest latency numbers,
while the recovery driver drives it with a virtual step clock so a
replayed stream makes bit-identical decisions (DESIGN.md §14).

**Telemetry** (DESIGN.md §17): the service owns one
:class:`repro_torch.telemetry.Telemetry` bundle. Deterministic counters and
the service-clock latency histograms live in its metrics registry —
namespaced (``service.flushes``, ``admission.shed{reason=,tenant=}``)
so filter health and service counters can merge into one ``health()``
dict without key collisions — and ride in every flush-barrier
checkpoint, bit-exactly. The flush pipeline is traced as nested spans
(``service.flush`` wrapping ``pad -> launch -> sync -> results``) on the
service clock, and each flush span is annotated with the perfmodel's
OpCost prediction; the drift monitor turns those annotations into
rolling measured-vs-predicted gauges.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.service.admission import AdmissionController, AdmissionPolicy
from repro_torch.telemetry import Telemetry, TelemetryConfig

OPS = ("add", "contains", "remove")

# Legacy counter name -> registry metric name (the pre-telemetry flat
# dict keys, kept as a deprecated read view for one release).
_LEGACY_COUNTERS = ("submitted", "flushes", "size_flushes",
                    "deadline_flushes", "flushed_ops", "padded_slots")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    max_batch: int = 256               # static flush shape (pad-to-tile)
    flush_deadline: Optional[float] = 2e-3   # seconds on the service clock
    admission: AdmissionPolicy = AdmissionPolicy()
    telemetry: TelemetryConfig = TelemetryConfig()


class _Pending:
    """One op's FIFO accumulator (columnar numpy, appended per submission)."""

    def __init__(self):
        self.keys: List[np.ndarray] = []      # (n_i, 2) uint32 chunks
        self.tenants: List[np.ndarray] = []   # (n_i,) int32
        self.t_enq: List[np.ndarray] = []     # (n_i,) float64 service clock
        self.seq: List[np.ndarray] = []       # (n_i,) int64 ticket ids
        self.count = 0

    def append(self, keys, tenants, t_enq, seq):
        self.keys.append(keys)
        self.tenants.append(tenants)
        self.t_enq.append(t_enq)
        self.seq.append(seq)
        self.count += keys.shape[0]

    def take(self, n: int):
        """Pop the n oldest requests (columnar concatenation, FIFO)."""
        keys = np.concatenate(self.keys, axis=0)
        tenants = np.concatenate(self.tenants)
        t_enq = np.concatenate(self.t_enq)
        seq = np.concatenate(self.seq)
        head = (keys[:n], tenants[:n], t_enq[:n], seq[:n])
        self.keys = [keys[n:]] if n < keys.shape[0] else []
        self.tenants = [tenants[n:]] if n < keys.shape[0] else []
        self.t_enq = [t_enq[n:]] if n < keys.shape[0] else []
        self.seq = [seq[n:]] if n < keys.shape[0] else []
        self.count -= head[0].shape[0]
        return head

    def oldest(self) -> float:
        return float(self.t_enq[0][0])

    def clear(self):
        self.__init__()


def service_keys(keys) -> np.ndarray:
    """Normalize caller keys to host (n, 2) uint32 u64x2 pairs."""
    keys = np.asarray(keys)
    if keys.dtype == np.uint64:
        from repro_torch.core.hashing import u64x2_from_u64
        keys = u64x2_from_u64(keys)
    keys = np.asarray(keys, np.uint32)
    if keys.ndim == 1:
        keys = keys.reshape(1, 2)
    if keys.ndim != 2 or keys.shape[-1] != 2:
        raise ValueError(f"service keys must be (n, 2) u64x2 pairs or "
                         f"uint64 (n,); got shape {keys.shape}")
    return keys


class FilterService:
    """Batched streaming front end over one tenant :class:`FilterBank`.

    The backing filter must be a 1-D bank (``make_filter_bank(T, ...)``;
    ``T=1`` serves the single-tenant case) — every engine then takes the
    same routed, valid-masked path, including the non-idempotent ones.

    ``contains`` results are delivered through tickets: ``submit*`` returns
    sequence ids (−1 for shed requests); after the flush that carries a
    request executes, its boolean lands in :attr:`results` keyed by seq.
    """

    def __init__(self, filt, cfg: ServiceConfig = ServiceConfig(),
                 clock: Callable[[], float] = time.perf_counter):
        if len(filt.bank_shape) != 1:
            raise ValueError(
                "FilterService fronts a 1-D FilterBank (tenants = bank "
                f"members); got bank_shape={filt.bank_shape} — build with "
                "repro_torch.api.make_filter_bank(n_tenants, ...)")
        self.filt = filt
        self.cfg = cfg
        self.clock = clock
        # the tracer reads the clock through this indirection so the
        # driver's post-construction ``service.clock`` rebind (virtual
        # step clock) is picked up by span timestamps too
        self.telemetry = Telemetry(cfg.telemetry,
                                   clock=lambda: self.clock())
        self.n_tenants = filt.bank_shape[0]
        self.admission = AdmissionController(
            cfg.admission, self.n_tenants,
            registry=self.telemetry.registry)
        self.pending: Dict[str, _Pending] = {op: _Pending() for op in OPS}
        self.pending_per_tenant = np.zeros(self.n_tenants, np.int64)
        self.results: Dict[int, bool] = {}
        self._seq = 0
        self._supports_remove = filt.engine.supports_remove
        # pre-register the hot-path metrics (one dict lookup per use)
        reg = self.telemetry.registry
        self._c_submitted = reg.counter("service.submitted")
        self._c_flushes = reg.counter("service.flushes")
        self._c_trigger = {t: reg.counter(f"service.{t}_flushes")
                          for t in ("size", "deadline")}
        self._c_flushed_ops = reg.counter("service.flushed_ops")
        self._c_padded = reg.counter("service.padded_slots")
        self._h_latency = {op: reg.histogram("service.latency", op=op)
                           for op in OPS}

    # -- intake ---------------------------------------------------------------
    @property
    def pending_total(self) -> int:
        return sum(p.count for p in self.pending.values())

    @property
    def counters(self) -> Dict[str, int]:
        """DEPRECATED flat counter view (pre-§17 names). Reads from the
        telemetry registry; mutate through telemetry, not this dict."""
        reg = self.telemetry.registry
        return {name: reg.counter(f"service.{name}").value
                for name in _LEGACY_COUNTERS}

    def submit(self, op: str, key, tenant: int = 0,
               now: Optional[float] = None) -> int:
        """Enqueue one request; returns its seq id, or −1 if shed."""
        return int(self.submit_many(op, service_keys(key),
                                    np.asarray([tenant]), now=now)[0])

    def submit_many(self, op: str, keys, tenants, now: Optional[float] = None
                    ) -> np.ndarray:
        """Enqueue a FIFO burst of same-op requests; returns per-request
        seq ids ((n,) int64, −1 where admission shed). Size-triggered
        flushes happen inline, so a long burst drains as it arrives."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        if op == "remove" and not self._supports_remove:
            raise NotImplementedError(
                f"backend {self.filt.backend!r} cannot remove keys; front "
                f"the service with a counting or cuckoo bank")
        keys = service_keys(keys)
        tenants = np.asarray(tenants, np.int64).reshape(-1)
        if keys.shape[0] != tenants.shape[0]:
            raise ValueError(f"keys/tenants length mismatch: "
                             f"{keys.shape[0]} vs {tenants.shape[0]}")
        if tenants.size and (tenants.min() < 0
                             or tenants.max() >= self.n_tenants):
            raise ValueError(f"tenant ids must be in [0, {self.n_tenants}); "
                             f"got range [{tenants.min()}, {tenants.max()}]")
        now = self.clock() if now is None else now
        tracer = self.telemetry.tracer
        with tracer.span("service.submit", op=op,
                         n=int(keys.shape[0])) as sp:
            self._c_submitted.inc(int(keys.shape[0]))
            with tracer.span("service.admit", op=op):
                ok = self.admission.admit_many(op, tenants,
                                               self.pending_total,
                                               self.pending_per_tenant)
            seqs = np.full(keys.shape[0], -1, np.int64)
            n_ok = int(ok.sum())
            sp.set(admitted=n_ok, shed=int(keys.shape[0]) - n_ok)
            if n_ok:
                seqs[ok] = self._seq + np.arange(n_ok)
                self._seq += n_ok
                self.pending[op].append(
                    keys[ok].astype(np.uint32),
                    tenants[ok].astype(np.int32),
                    np.full(n_ok, now, np.float64), seqs[ok])
                np.add.at(self.pending_per_tenant, tenants[ok], 1)
                while self.pending[op].count >= self.cfg.max_batch:
                    self._flush_op(op, trigger="size")
        return seqs

    # -- flushing -------------------------------------------------------------
    def pump(self, now: Optional[float] = None) -> int:
        """Deadline sweep: flush every queue whose oldest request has aged
        past ``flush_deadline``. Returns the number of flushes issued.
        Call this from the serving loop's idle path."""
        if self.cfg.flush_deadline is None:
            return 0
        now = self.clock() if now is None else now
        n = 0
        for op in OPS:
            p = self.pending[op]
            if p.count and now - p.oldest() >= self.cfg.flush_deadline:
                while p.count:
                    self._flush_op(op, trigger="deadline")
                    n += 1
        return n

    def drain(self) -> int:
        """Flush everything pending (checkpoint barrier / shutdown)."""
        n = 0
        for op in OPS:
            while self.pending[op].count:
                self._flush_op(op, trigger="deadline")
                n += 1
        return n

    def _flush_op(self, op: str, trigger: str) -> None:
        """Execute one fixed-shape batch of ``op`` (FIFO head, padded).

        Traced as the span pipeline ``service.flush`` > ``pad`` >
        ``launch`` > ``sync`` > ``results``; the flush span carries the
        perfmodel OpCost annotation for its exact padded configuration.
        Launch+sync wall time is measured on the REAL clock for the
        drift monitor even when the service clock is virtual — drift is
        a report metric, not replayed service state."""
        mb = self.cfg.max_batch
        tracer = self.telemetry.tracer
        with tracer.span("service.flush", op=op, trigger=trigger) as sp:
            keys, tenants, t_enq, seq = self.pending[op].take(mb)
            take = keys.shape[0]
            sp.set(take=int(take), padded=int(mb - take))
            with tracer.span("service.flush.pad", op=op):
                kb = np.zeros((mb, 2), np.uint32)
                tb = np.zeros((mb,), np.int32)
                vb = np.zeros((mb,), bool)
                kb[:take] = keys
                tb[:take] = tenants
                vb[:take] = True
                dev = self.filt.device
                kj = torch.from_numpy(kb.view(np.int32)).to(dev)
                tj = torch.from_numpy(tb).to(dev)
            t0_real = time.perf_counter()
            if op == "contains":
                with tracer.span("service.flush.launch", op=op):
                    hits = self.filt.contains(kj, tenants=tj)
                with tracer.span("service.flush.sync", op=op):
                    hits = hits.cpu().numpy()[:take]
            else:
                with tracer.span("service.flush.launch", op=op):
                    vj = torch.from_numpy(vb.view(np.uint8)).to(dev)
                    if op == "add":
                        self.filt = self.filt.add(kj, tenants=tj, valid=vj)
                    else:
                        self.filt = self.filt.remove(kj, tenants=tj,
                                                     valid=vj)
                with tracer.span("service.flush.sync", op=op):
                    if self.filt.words.is_cuda:
                        torch.cuda.synchronize(self.filt.device)
            measured_s = time.perf_counter() - t0_real
            with tracer.span("service.flush.results", op=op):
                if op == "contains":
                    self.results.update(zip(seq.tolist(), hits.tolist()))
                t_done = self.clock()
                self._h_latency[op].observe_many(t_done - t_enq)
                np.subtract.at(self.pending_per_tenant, tenants, 1)
            self._c_flushes.inc()
            self._c_trigger[trigger].inc()
            self._c_flushed_ops.inc(take)
            self._c_padded.inc(mb - take)
            if self.telemetry.drift is not None:
                sp.set(**self.telemetry.drift.observe(self.filt, op, mb,
                                                      measured_s))
            if self._c_flushes.value % self.cfg.admission.health_every == 0:
                self.admission.refresh(self.filt)

    # -- results / observability ----------------------------------------------
    def take_results(self) -> Dict[int, bool]:
        out, self.results = self.results, {}
        return out

    def health(self) -> dict:
        """One namespaced, JSON-able operational snapshot: filter health
        under ``filter.*``, service counters and latency summaries under
        ``service.*``, admission under ``admission.*``, drift gauges
        under ``perfmodel.*`` — no key collisions by construction (the
        pre-§17 surface merged raw counter names into the filter-health
        dict; :meth:`legacy_health` keeps that shape as a deprecated
        view)."""
        out = {f"filter.{k}": v for k, v in self.filt.health().items()}
        out.update(self.telemetry.registry.snapshot())
        out["service.pending"] = self.pending_total
        sub = self._c_submitted.value
        out["admission.shed_rate"] = (
            (self.admission.shed_total / sub) if sub else 0.0)
        return out

    def legacy_health(self) -> dict:
        """DEPRECATED pre-§17 health dict (raw filter-health keys with
        flat counters merged on top — the key-collision surface). Kept
        as a read-only view for one release; use :meth:`health`."""
        import warnings
        warnings.warn("FilterService.legacy_health() is deprecated; use "
                      "health() (namespaced telemetry snapshot)",
                      DeprecationWarning, stacklevel=2)
        out = self.filt.health()
        out.update(self.counters)
        out["pending"] = self.pending_total
        out["admitted"] = self.admission.admitted
        out["shed"] = dict(self.admission.shed_counts)
        sub = self._c_submitted.value
        out["shed_rate"] = (self.admission.shed_total / sub) if sub else 0.0
        return out

    def latency_summary(self, op: Optional[str] = None,
                        unit: float = 1e6) -> dict:
        """Nearest-rank tail summary ({n, p50, p99, p999, mean, max},
        seconds scaled by ``unit``) from the telemetry histograms — one
        op's, or all ops pooled (the replay harness's report row)."""
        if op is not None:
            return self._h_latency[op].summary(unit=unit)
        from repro_torch.telemetry import Histogram
        pooled = Histogram("service.latency.all", ())
        for o in OPS:
            pooled.observe_many(self._h_latency[o].samples)
        return pooled.summary(unit=unit)

    def all_latencies(self) -> np.ndarray:
        return np.asarray([l for op in OPS
                           for l in self._h_latency[op].samples])

    def reset_latencies(self) -> None:
        """Zero the latency histograms (benchmark warmup exclusion)."""
        for h in self._h_latency.values():
            h.reset()

    # -- recovery plumbing ----------------------------------------------------
    def snapshot_state(self) -> dict:
        """JSON-able cursor of everything a deterministic replay needs
        besides the filter itself. Only meaningful at a flush barrier
        (pending queues empty — ``drain()`` first); in-flight requests are
        deliberately NOT checkpointed, they are re-fed by replay. The
        telemetry registry (counters, histograms) rides along bit-exactly;
        the ``counters`` dict is the deprecated flat view, written for
        old readers."""
        if self.pending_total:
            raise RuntimeError(
                f"snapshot_state() at a non-barrier: {self.pending_total} "
                f"requests pending — drain() first")
        return {"seq": self._seq, "counters": dict(self.counters),
                "admission": self.admission.snapshot_state(),
                "telemetry": self.telemetry.snapshot_state()}

    def restore_state(self, filt, state: dict) -> None:
        """Install a checkpointed filter + cursor; pending queues reset
        (lost in-flight requests are the stream replayer's to re-feed)."""
        if tuple(filt.bank_shape) != tuple(self.filt.bank_shape):
            raise ValueError(
                f"restored bank shape {filt.bank_shape} != service bank "
                f"shape {self.filt.bank_shape}")
        self.filt = filt
        self._seq = int(state["seq"])
        if "telemetry" in state:
            self.telemetry.restore_state(state["telemetry"])
        else:                      # pre-§17 checkpoint: flat counters only
            reg = self.telemetry.registry
            for k, v in state.get("counters", {}).items():
                reg.counter(f"service.{k}").set_total(int(v))
        # re-bind the pre-registered metric objects to the restored
        # registry contents (restore_state replaced the instances)
        reg = self.telemetry.registry
        self._c_submitted = reg.counter("service.submitted")
        self._c_flushes = reg.counter("service.flushes")
        self._c_trigger = {t: reg.counter(f"service.{t}_flushes")
                          for t in ("size", "deadline")}
        self._c_flushed_ops = reg.counter("service.flushed_ops")
        self._c_padded = reg.counter("service.padded_slots")
        self._h_latency = {op: reg.histogram("service.latency", op=op)
                           for op in OPS}
        self.admission.restore_state(state["admission"])
        for p in self.pending.values():
            p.clear()
        self.pending_per_tenant[:] = 0
        self.results = {}
