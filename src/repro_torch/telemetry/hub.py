"""The per-service telemetry bundle: registry + tracer + drift monitor.

One :class:`Telemetry` instance is owned by each :class:`FilterService`
(and anything else that wants the full surface): the metrics registry is
ALWAYS on — its counters are load-bearing service state (the flush count
drives the admission health-refresh cadence, and every counter must
survive checkpoint/restore bit-exactly) — while tracing and drift
detection are the optional, disableable layers the overhead gate
measures.

``snapshot_state``/``restore_state`` round-trip the registry through the
service's flush-barrier checkpoints; the tracer's event ring is a trace
*log*, not state, and deliberately does not checkpoint (a restored
service starts a fresh trace, the way it starts fresh request queues).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.telemetry.drift import DriftConfig, DriftMonitor
from repro_torch.telemetry.export import prometheus_text, write_prometheus
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracing import Tracer

__all__ = ["TelemetryConfig", "Telemetry"]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry knobs (metrics are unconditional — see module
    doc; ``enabled=False`` turns off the optional layers in one switch,
    the configuration the warn-only overhead gate compares against)."""

    enabled: bool = True          # master switch for tracing + drift
    trace: bool = True            # span tracing of the flush pipeline
    drift: bool = True            # perfmodel measured-vs-predicted gauges
    max_spans: int = 4096         # tracer ring capacity
    drift_window: int = 32
    drift_min_samples: int = 8
    drift_tolerance: float = 16.0


class Telemetry:
    def __init__(self, cfg: TelemetryConfig = TelemetryConfig(),
                 clock: Callable[[], float] = time.perf_counter,
                 calib=None):
        self.cfg = cfg
        self.registry = MetricsRegistry()
        self.tracer = Tracer(clock=clock,
                             enabled=cfg.enabled and cfg.trace,
                             max_spans=cfg.max_spans)
        self.drift: Optional[DriftMonitor] = (
            DriftMonitor(self.registry,
                         DriftConfig(window=cfg.drift_window,
                                     min_samples=cfg.drift_min_samples,
                                     tolerance=cfg.drift_tolerance),
                         calib=calib)
            if (cfg.enabled and cfg.drift) else None)

    # -- export ----------------------------------------------------------------
    def prometheus_text(self) -> str:
        return prometheus_text(self.registry)

    def write_prometheus(self, path: str) -> str:
        return write_prometheus(self.registry, path)

    def write_trace_jsonl(self, path: str) -> int:
        return self.tracer.export_jsonl(path)

    # -- checkpoint round-trip -------------------------------------------------
    def snapshot_state(self) -> dict:
        return self.registry.snapshot_state()

    def restore_state(self, state: dict) -> None:
        self.registry.restore_state(state)
