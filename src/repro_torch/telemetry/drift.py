"""Perfmodel drift detection: measured-vs-predicted flush cost at runtime.

Counterpart of ``repro.telemetry.drift``, over the port's performance
model (:mod:`repro_torch.perfmodel`): the calibration and the ``coop``
choice are those of the filter's device. A plan regression (an extra
pass, a lost fusion, a stale tuning cache) or a stale calibration shows
up as a drifting measured/predicted ratio while the service runs.

Every service flush is annotated with the model's :class:`OpCost`
prediction for its exact configuration — (spec, op, regime, resolved
plan, padded batch size, bank) — and the monitor maintains, per op, a
rolling window of ``measured_us / predicted_us`` ratios:

* ``perfmodel.predicted_us{op=}`` / ``perfmodel.ceiling_us{op=}`` — the
  model's full prediction and its speed-of-light floor for one flush;
* ``perfmodel.drift.ratio{op=}`` — rolling **median** ratio (median, not
  mean: one GC pause or checkpoint stall must not trip the gauge);
* ``perfmodel.drift.alert{op=}`` — 1.0 when the window holds at least
  ``min_samples`` ratios and the median sits outside
  ``[1/tolerance, tolerance]``. The tolerance is wide (the model's
  constants steer ranking, not absolute time), so an alert means a model
  term or the calibration is *structurally* wrong for this host, not
  mistuned.

Flush wall time is measured with the real clock even when the service
runs on the virtual clock — drift is a report metric, not service state
(the same split the driver uses for recovery time), so every drift
metric is registered ``deterministic=False`` and excluded from the
recovery drill's bit-exactness comparison.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Optional, Tuple

from repro_torch.telemetry.metrics import MetricsRegistry

__all__ = ["DriftConfig", "DriftMonitor", "resolve_flush_plan"]


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    window: int = 32         # rolling ratios kept per op
    min_samples: int = 8     # gauge arms only with this much evidence
    tolerance: float = 16.0  # alert outside [1/tol, tol] median ratio


def resolve_flush_plan(filt, op: str) -> dict:
    """The concrete (regime, probe, coop, mix, depth, tile, bank) a
    service flush of ``op`` executes under — "auto" fields resolved the
    same way the kernels resolve them (perfmodel ``choose_coop`` for the
    coop/mix pair on the filter's device), engine regime read off the
    backend (``cuda-l2`` is vmem, ``cuda-dram`` hbm; engines without a
    regime, ``torch`` among them, are modeled as vmem, as the JAX package
    models ``jnp``)."""
    from repro_torch import perfmodel as PM

    opts = filt.options
    regime = getattr(filt.engine, "regime", None)
    if regime not in ("vmem", "hbm"):
        regime = "vmem"
    tile = int(opts.tile) if opts.tile else 256
    probe = opts.probe if opts.probe in ("loop", "gather") else "gather"
    coop, mix = opts.coop, opts.mix
    if coop not in ("none", "subtile") or mix not in ("full", "cheap"):
        auto_coop, auto_mix = PM.choose_coop(filt.spec, op, regime, tile,
                                             device=filt.device)
        if coop not in ("none", "subtile"):
            coop = auto_coop
        if mix not in ("full", "cheap"):
            mix = auto_mix
    depth = int(opts.depth) if opts.depth else 2
    return {"regime": regime, "probe": probe, "coop": coop, "mix": mix,
            "depth": depth, "tile": tile,
            "bank": max(int(filt.bank_size), 1)}


class DriftMonitor:
    """Per-op rolling measured/predicted gauges over one registry."""

    def __init__(self, registry: MetricsRegistry,
                 cfg: DriftConfig = DriftConfig(), calib=None):
        self.registry = registry
        self.cfg = cfg
        self._calib = calib            # None -> get_calibration() lazily,
                                       # for the first flush's device
        self._windows: Dict[str, deque] = {}
        self._cost_cache: Dict[Tuple, tuple] = {}

    def _calibration(self, device):
        if self._calib is None:
            from repro_torch.perfmodel import get_calibration
            self._calib = get_calibration(device=device)
        return self._calib

    def predict(self, filt, op: str, n_keys: int) -> Optional[tuple]:
        """(predicted_us, ceiling_us, plan) for one padded flush; cached
        per (spec, backend, options, op, n_keys, bank) — static between
        reshard/resize events. None when the spec falls outside the
        model (the flush is then traced without an annotation)."""
        key = (filt.spec, filt.backend, filt.options, op, int(n_keys))
        hit = self._cost_cache.get(key)
        if hit is not None:
            return hit if hit != () else None
        try:
            from repro_torch import perfmodel as PM
            plan = resolve_flush_plan(filt, op)
            cost = PM.op_cost(filt.spec, op, plan["regime"],
                              probe=plan["probe"], coop=plan["coop"],
                              mix=plan["mix"], depth=plan["depth"],
                              tile=plan["tile"], n_keys=int(n_keys),
                              bank=plan["bank"])
            calib = self._calibration(filt.device)
            out = (PM.predict_us(cost, calib), PM.ceiling_us(cost, calib),
                   plan)
        except Exception:
            self._cost_cache[key] = ()
            self.registry.counter("perfmodel.predict_errors",
                                  deterministic=False).inc()
            return None
        self._cost_cache[key] = out
        return out

    def observe(self, filt, op: str, n_keys: int,
                measured_s: float) -> dict:
        """Record one flush measurement; updates the gauges and returns
        the span annotation (empty when the spec is unmodeled)."""
        pred = self.predict(filt, op, n_keys)
        if pred is None:
            return {}
        predicted_us, ceil_us, plan = pred
        measured_us = float(measured_s) * 1e6
        ratio = measured_us / max(predicted_us, 1e-9)
        win = self._windows.get(op)
        if win is None:
            win = self._windows[op] = deque(maxlen=self.cfg.window)
        win.append(ratio)
        med = sorted(win)[len(win) // 2]
        alert = (len(win) >= self.cfg.min_samples
                 and not (1.0 / self.cfg.tolerance <= med
                          <= self.cfg.tolerance))
        reg = self.registry
        reg.gauge("perfmodel.predicted_us", deterministic=False,
                  op=op).set(predicted_us)
        reg.gauge("perfmodel.ceiling_us", deterministic=False,
                  op=op).set(ceil_us)
        reg.gauge("perfmodel.drift.ratio", deterministic=False,
                  op=op).set(med)
        reg.gauge("perfmodel.drift.alert", deterministic=False,
                  op=op).set(1.0 if alert else 0.0)
        if alert:
            reg.counter("perfmodel.drift.alerts", deterministic=False,
                        op=op).inc()
        return {"predicted_us": round(predicted_us, 3),
                "ceiling_us": round(ceil_us, 3),
                "measured_us": round(measured_us, 3),
                "drift_ratio": round(ratio, 4),
                "regime": plan["regime"], "probe": plan["probe"],
                "coop": plan["coop"], "mix": plan["mix"]}
