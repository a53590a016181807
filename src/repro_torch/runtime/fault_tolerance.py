"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler watch.

Counterpart of ``repro.runtime.fault_tolerance``; the state is any nest
the port's checkpoints take (tensors, arrays, port ``Filter`` objects),
and a step waits for the device of the state's first tensor.

On a 1000-node pod, failures are routine: the driver (a) checkpoints every N
steps (async), (b) traps step failures, restores the last good checkpoint and
replays the data stream to the restored step (the data pipeline is seeded +
step-indexed, so replay is deterministic), (c) tracks per-step wall time with
an EWMA and flags stragglers (on a real cluster this feeds the re-slicing /
hot-spare controller; here it is surfaced via ``events`` and asserted in
tests).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests/examples)."""


def _first_tensor(node) -> Optional[torch.Tensor]:
    """The first tensor among the state's leaves in checkpoint order."""
    if isinstance(node, torch.Tensor):
        return node
    if isinstance(node, dict):
        node = [node[k] for k in sorted(node)]
    elif ckpt._is_filter(node):
        return node.words                       # a Filter's first leaf
    if isinstance(node, (list, tuple)):
        for v in node:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def block_until_ready(state) -> None:
    """Wait for the work queued on the device of the state's first tensor
    (a no-op on the CPU), so a step's wall time counts its device time."""
    t = _first_tensor(state)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    async_ckpt: bool = True
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0   # step > factor * EWMA -> straggler event
    ewma_alpha: float = 0.2


class TrainingDriver:
    """Runs step(state, batch) with checkpoint/restart around it.

    ``batch_fn(step) -> batch`` must be deterministic in step (seeded
    pipeline) so that replay after restart consumes identical data.
    ``failure_hook(step)`` may raise SimulatedFailure to exercise recovery.
    """

    def __init__(self, step_fn: Callable, state: Any, batch_fn: Callable,
                 cfg: DriverConfig = DriverConfig(),
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.state = state
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.failure_hook = failure_hook
        self.events: List[Dict] = []
        self.metrics_log: List[Dict] = []
        self._ewma: Optional[float] = None
        self._pending_save = None

    # -- internals -----------------------------------------------------------
    def _maybe_checkpoint(self, step: int):
        if step % self.cfg.ckpt_every == 0:
            if self._pending_save is not None:
                self._pending_save.join()
            self._pending_save = ckpt.save(
                self.cfg.ckpt_dir, step, self.state,
                sync=not self.cfg.async_ckpt, keep=self.cfg.keep)
            self.events.append({"kind": "checkpoint", "step": step})

    def _watch_straggler(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma and step > 3:
            self.events.append({"kind": "straggler", "step": step,
                                "dt": dt, "ewma": self._ewma})
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt

    def _restore(self) -> int:
        step, self.state = ckpt.restore(self.cfg.ckpt_dir, self.state)
        self.events.append({"kind": "restore", "step": step})
        return step

    # -- main loop -------------------------------------------------------------
    def run(self, total_steps: int, start_step: int = 0) -> Any:
        step = start_step
        restarts = 0
        if ckpt.latest_step(self.cfg.ckpt_dir) is None:
            ckpt.save(self.cfg.ckpt_dir, step, self.state, sync=True,
                      keep=self.cfg.keep)   # baseline: recover even from step 0
        while step < total_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                self.state, metrics = self.step_fn(self.state, batch)
                block_until_ready(self.state)
                dt = time.perf_counter() - t0
                self._watch_straggler(step, dt)
                self.metrics_log.append(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()}})
                step += 1
                self._maybe_checkpoint(step)
            except SimulatedFailure as e:
                restarts += 1
                self.events.append({"kind": "failure", "step": step,
                                    "error": str(e)})
                if restarts > self.cfg.max_restarts:
                    raise
                step = self._restore()
        if self._pending_save is not None:
            self._pending_save.join()
        return self.state
