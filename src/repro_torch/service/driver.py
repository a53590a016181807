"""Fault-tolerant serving driver: trap / restore / replay for the service.

Counterpart of ``repro.service.driver``; a restore lands the filter on
the device the service served on.

``runtime.fault_tolerance.TrainingDriver`` adapted from train steps to
request streams. The driver executes a **seeded, step-indexed** request
stream (``stream_fn(step) -> [(op, keys, tenants), ...]`` must be a pure
function of ``step``) against a :class:`FilterService`, with the
maintenance loop ticking — and checkpointing at flush barriers — between
steps. A trapped :class:`SimulatedFailure` (or any injected fault from
``failure_hook``) restores the last good checkpoint and resumes from its
cursor step; because the stream is deterministic and every admission /
flush / maintenance decision is a pure function of checkpointed state
(DESIGN.md §14), the replayed filter is **bit-exact** with an
uninterrupted run — the property the recovery tests pin.

The driver runs on a **virtual clock** by default (service time advances
``virtual_dt`` per step): deadline-triggered flushes then depend only on
step arithmetic, never on wall time, which is what makes replay exact.
Recovery *time* is still measured on the real clock — it is a report
metric, not service state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.runtime.fault_tolerance import SimulatedFailure
from repro_torch.service.frontend import FilterService
from repro_torch.service.maintenance import MaintenanceLoop, restore_service


@dataclasses.dataclass(frozen=True)
class ServiceDriverConfig:
    max_restarts: int = 3
    virtual_dt: Optional[float] = 1.0   # service-clock step; None = real time


class ServiceDriver:
    """Runs a deterministic request stream with checkpoint/restart around it.

    ``failure_hook(step)`` may raise :class:`SimulatedFailure` to exercise
    recovery (tests / chaos drills); in production the trap catches real
    step failures the same way.
    """

    def __init__(self, service: FilterService, stream_fn: Callable,
                 maintenance: MaintenanceLoop,
                 cfg: ServiceDriverConfig = ServiceDriverConfig(),
                 failure_hook: Optional[Callable[[int], None]] = None):
        if maintenance.cfg.ckpt_dir is None:
            raise ValueError("ServiceDriver needs a checkpointing "
                             "MaintenanceLoop (ckpt_dir set)")
        self.service = service
        self.stream_fn = stream_fn
        self.maintenance = maintenance
        self.cfg = cfg
        self.failure_hook = failure_hook
        self.events: List[dict] = []
        self._vnow = 0.0
        if cfg.virtual_dt is not None:
            # rebind the service clock so deadline flushes are step-driven
            service.clock = lambda: self._vnow

    # -- internals -----------------------------------------------------------
    def _restore(self) -> int:
        step = restore_service(self.service, self.maintenance,
                               self.maintenance.cfg.ckpt_dir,
                               device=self.service.filt.device)
        self.events.append({"kind": "restore", "step": step})
        return step

    def _feed(self, step: int) -> None:
        if self.cfg.virtual_dt is not None:
            self._vnow = step * self.cfg.virtual_dt
        for op, keys, tenants in self.stream_fn(step):
            self.service.submit_many(op, keys, tenants)
        self.service.pump()

    # -- main loop -------------------------------------------------------------
    def run(self, total_steps: int, start_step: int = 0):
        """Serve ``total_steps`` stream steps; returns the final filter."""
        from repro_torch.checkpoint import checkpoint as ckpt
        step = start_step
        restarts = 0
        recovering = None                  # (failed_step, t0_real)
        if ckpt.latest_step(self.maintenance.cfg.ckpt_dir) is None:
            # baseline: recoverable even from step 0
            self.maintenance.checkpoint(self.service, step)
        while step < total_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                self._feed(step)
                done = step
                step += 1
                self.maintenance.tick(self.service, step)
                if recovering is not None and done >= recovering[0]:
                    self.events.append(
                        {"kind": "recovered", "step": done,
                         "failed_step": recovering[0],
                         "recovery_s": time.perf_counter() - recovering[1]})
                    recovering = None
            except SimulatedFailure as e:
                restarts += 1
                self.events.append({"kind": "failure", "step": step,
                                    "error": str(e)})
                if restarts > self.cfg.max_restarts:
                    raise
                if recovering is None:
                    recovering = (step, time.perf_counter())
                step = self._restore()
        self.service.drain()
        self.maintenance.wait()
        return self.service.filt

    @property
    def recovery_times(self) -> List[float]:
        return [e["recovery_s"] for e in self.events
                if e["kind"] == "recovered"]
