"""Background maintenance: generation/decay ticks and periodic checkpoints.

Counterpart of ``repro.service.maintenance``; checkpoints go through
:mod:`repro_torch.checkpoint.checkpoint` (the JAX package's layout), and
a restored service's filter lands on ``device`` (the card by default).

A long-lived filter service is maintained state, not a build-once artifact
(the feature-complete-GPU-filters literature's operating model): windowed
banks must ``advance()`` on a cadence or the window stops sliding, counting
banks must ``decay()`` or they saturate, and everything must checkpoint or
a worker loss is unrecoverable.

The loop is *cooperative*: the serving driver calls :meth:`tick` once per
stream step. Cadences count ticks (not wall time), so a replayed stream
re-issues exactly the same maintenance ops at the same points — aging is
part of filter state, so nondeterministic aging would break recovery
bit-exactness.

Checkpoints are **flush barriers**: the service drains before the filter
is snapshotted, so a checkpoint is always a clean prefix of the request
stream — restore + re-feed from the cursor reproduces the lost state
exactly (DESIGN.md §14 recovery invariants). The write itself is async by
default (snapshot-to-host first, background thread after), so serving
continues while the bytes land.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    advance_every: Optional[int] = None    # ticks between window advances
    decay_every: Optional[int] = None      # ticks between counting decays
    checkpoint_every: Optional[int] = None  # ticks between checkpoints
    ckpt_dir: Optional[str] = None
    async_checkpoint: bool = True
    keep: int = 3
    # Saturation-triggered capacity growth (resizable engines — the
    # quotient filter): every ``resize_every`` ticks the worst member's
    # load factor is measured; at or above ``resize_at_load`` the whole
    # bank grows ``resize_factor``x in place via ``grow_capacity`` (drain
    # barrier, lossless fingerprint re-homing — zero shed adds). The
    # check fires BELOW the admission shed_load threshold by design:
    # growth is the escalation that makes health shedding unnecessary.
    resize_every: Optional[int] = None     # ticks between load checks
    resize_at_load: float = 0.80           # grow at/above this load factor
    resize_factor: int = 2                 # m_bits multiplier per growth
    resize_max_m_bits: Optional[int] = None  # growth ceiling (None = off)


class MaintenanceLoop:
    """Tick-driven maintenance over one :class:`FilterService`."""

    def __init__(self, cfg: MaintenanceConfig):
        if cfg.checkpoint_every is not None and cfg.ckpt_dir is None:
            raise ValueError("checkpoint_every set but no ckpt_dir")
        self.cfg = cfg
        self.events: List[dict] = []
        self._ticks = 0
        self._pending_save = None

    def tick(self, service, step: int) -> None:
        """One maintenance step (call after each stream step). ``step`` is
        the NEXT stream step to execute — the value a restore resumes at —
        and is what checkpoints are labeled with. Each maintenance event
        increments its tick-driven (hence deterministic) telemetry
        counter and is traced as a ``maintenance.*`` span."""
        self._ticks += 1
        cfg = self.cfg
        reg = service.telemetry.registry
        tracer = service.telemetry.tracer
        reg.counter("maintenance.ticks").inc()
        if cfg.advance_every and self._ticks % cfg.advance_every == 0:
            with tracer.span("maintenance.advance", step=step):
                service.drain()  # inserts racing an advance would straddle
                service.filt = service.filt.advance()   # age classes
            reg.counter("maintenance.advances").inc()
            self.events.append({"kind": "advance", "step": step})
        if cfg.decay_every and self._ticks % cfg.decay_every == 0:
            with tracer.span("maintenance.decay", step=step):
                service.drain()
                service.filt = service.filt.decay()
            reg.counter("maintenance.decays").inc()
            self.events.append({"kind": "decay", "step": step})
        if cfg.resize_every and self._ticks % cfg.resize_every == 0:
            self._maybe_resize(service, step)
        if cfg.checkpoint_every and self._ticks % cfg.checkpoint_every == 0:
            self.checkpoint(service, step)

    def _maybe_resize(self, service, step: int) -> None:
        """Grow the bank in place when the worst member saturates."""
        cfg = self.cfg
        filt = service.filt
        if not filt.engine.supports_resize:
            raise ValueError(
                f"resize_every is set but engine {filt.backend!r} does not "
                f"support resize(); use variant='quotient' or drop the "
                f"resize maintenance config")
        lf = filt.load_factor()
        if isinstance(lf, torch.Tensor):
            lf = lf.cpu().numpy()
        load = float(np.max(np.atleast_1d(np.asarray(lf, np.float64))))
        if load < cfg.resize_at_load:
            return
        target = filt.spec.m_bits * int(cfg.resize_factor)
        if cfg.resize_max_m_bits is not None \
                and target > cfg.resize_max_m_bits:
            return                     # at the ceiling: shedding takes over
        from repro_torch.service.resharding import grow_capacity
        grow_capacity(service, new_m_bits=target)
        service.telemetry.registry.counter("maintenance.resizes").inc()
        self.events.append({"kind": "resize", "step": step,
                            "load": round(load, 4),
                            "m_bits": service.filt.spec.m_bits})

    def checkpoint(self, service, step: int) -> None:
        """Flush-barrier checkpoint: drain, snapshot filter + cursors.
        The checkpoint counter increments BEFORE the snapshot is built so
        the checkpoint being written already counts itself — a restored
        twin and a clean twin then agree on the counter at every step."""
        with service.telemetry.tracer.span("maintenance.checkpoint",
                                           step=step):
            service.drain()
            self.wait()         # at most one async write in flight
            service.telemetry.registry.counter(
                "maintenance.checkpoints").inc()
            extra = {"service": service.snapshot_state(),
                     "maintenance": self.snapshot_state()}
            self._pending_save = ckpt.save_filter(
                self.cfg.ckpt_dir, step, service.filt,
                sync=not self.cfg.async_checkpoint, keep=self.cfg.keep,
                extra=extra)
        self.events.append({"kind": "checkpoint", "step": step})

    def wait(self) -> None:
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None

    # -- recovery plumbing ----------------------------------------------------
    def snapshot_state(self) -> dict:
        return {"ticks": self._ticks}

    def restore_state(self, state: dict) -> None:
        self._ticks = int(state["ticks"])


def restore_service(service, maintenance: Optional[MaintenanceLoop],
                    ckpt_dir: str, step: Optional[int] = None,
                    device=None) -> int:
    """Restore a service (and its maintenance cursors) from the newest —
    or an explicit — flush-barrier checkpoint; returns the stream step to
    resume at. The restored filter lands on the engine that wrote it, on
    ``device`` (``None`` = the card)."""
    if maintenance is not None:
        maintenance.wait()
    saved_step, filt = ckpt.restore_filter(ckpt_dir, step=step,
                                           device=device)
    extra = ckpt.manifest_extra(ckpt_dir, step=saved_step)
    service.restore_state(filt, extra["service"])
    if maintenance is not None and "maintenance" in extra:
        maintenance.restore_state(extra["maintenance"])
    # restores are a fact about THIS process, not the replayed stream —
    # non-deterministic by definition (the clean twin never restores)
    service.telemetry.registry.counter(
        "service.restores", deterministic=False).inc()
    return saved_step
