"""``repro_torch.telemetry`` — the unified observability subsystem.

Counterpart of ``repro.telemetry``; the drift monitor reads the port's
performance model (:mod:`repro_torch.perfmodel`) for the filter's device.

Replaces the four divergent ad-hoc stats surfaces that grew alongside
the serving stack (``FilterService.counters``, ``Engine.stats()``,
``AdmissionController.shed_counts``, bench-only ``latency_summary``)
with one contract:

* :class:`MetricsRegistry` — deterministic, namespaced, labeled
  :class:`Counter`/:class:`Gauge`/:class:`Histogram` metrics with
  fixed log-spaced bucket edges, bit-exact ``snapshot_state`` /
  ``restore_state`` through the service's flush-barrier checkpoints;
* :class:`Tracer` — clock-parameterized span tracing of the service hot
  path (``submit -> admit -> pad -> launch -> sync -> results``), JSONL
  event export;
* :func:`prometheus_text` — deterministic Prometheus text snapshots;
* :class:`DriftMonitor` — every flush annotated with the perfmodel's
  :class:`~repro_torch.perfmodel.OpCost` prediction and rolling
  measured/predicted drift gauges that flag stale calibration or plan
  regressions at runtime;
* :class:`Telemetry` — the per-service bundle of all three.

See DESIGN.md §17 for the determinism rules, the namespacing scheme and
the drift-gauge definition.
"""
from repro_torch.telemetry.drift import (DriftConfig, DriftMonitor,
                                         resolve_flush_plan)
from repro_torch.telemetry.export import prometheus_text, write_prometheus
from repro_torch.telemetry.hub import Telemetry, TelemetryConfig
from repro_torch.telemetry.metrics import (DEFAULT_LATENCY_EDGES, Counter,
                                           Gauge, Histogram, MetricsRegistry,
                                           log_edges, nearest_rank)
from repro_torch.telemetry.tracing import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_edges",
    "nearest_rank", "DEFAULT_LATENCY_EDGES", "Span", "Tracer",
    "prometheus_text", "write_prometheus", "DriftConfig", "DriftMonitor",
    "resolve_flush_plan", "Telemetry", "TelemetryConfig",
]
