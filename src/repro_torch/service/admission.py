"""Admission control: bounded queues, per-tenant quotas, health shedding.

Counterpart of ``repro.service.admission``: the same gates and the same
decisions; a bank on the card counts its members' set bits on the card
and brings back one count a member.

The service's contract with its callers is *bounded* degradation: when
traffic exceeds what the filters can absorb, requests are refused at the
door (cheap, explicit, counted) instead of queuing without bound (latency
collapse) or silently corrupting filter state (a cuckoo table pushed past
its achievable load factor starts failing inserts — the keys are simply
not stored).

Three gates, applied in order to every submission batch:

* **health** (write ops only): a bank member flagged unhealthy sheds its
  ``add`` traffic. Bloom-family members are unhealthy above a fill-fraction
  threshold (FPR grows without bound as fill -> 1); fingerprint members are
  unhealthy above a load-factor threshold or when their traced
  ``insert_failures`` counter grew since the last health refresh — the
  filter itself is telling us inserts are being dropped. Reads are never
  health-shed: a saturated filter still answers ``contains`` correctly
  (its FPR is degraded, not its completeness).
* **quota**: per-tenant cap on *pending* (queued, unflushed) requests, so
  one hot tenant cannot occupy the whole batch pipeline.
* **queue**: global bound on total pending requests across all ops.

All decisions are pure functions of (policy, tenant ids, pending counts,
health flags) evaluated in FIFO order — deterministic, so a replayed
request stream sheds identically (the recovery bit-exactness invariant,
DESIGN.md §14). Health flags refresh lazily every ``health_every`` flushes
(reading fill/load syncs with the device; per-request reads would stall
the pipeline) and are part of the service's checkpointed cursor state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

SHED_REASONS = ("health", "quota", "queue")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Static admission knobs (all thresholds inclusive-shed)."""

    queue_limit: int = 1 << 14         # max total pending requests
    tenant_quota: Optional[int] = None  # max pending per tenant (None = off)
    shed_fill: float = 0.95            # Bloom-family: shed adds above this
    shed_load: float = 0.95            # fingerprint: shed adds above this
    shed_on_insert_failures: bool = True   # cuckoo: shed when failures grow
    health_every: int = 8              # flushes between health refreshes


def _rank_within(ids: np.ndarray) -> np.ndarray:
    """rank[i] = number of occurrences of ids[i] in ids[:i] (stable)."""
    n = ids.shape[0]
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    starts = np.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - starts
    return rank


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, in int32 on the words' device: SWAR
    over the low 31 bits (no step overflows), plus the sign bit."""
    y = words & 0x7FFFFFFF
    y = y - ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    y = y + (y >> 8)
    y = y + (y >> 16)
    return (y & 0x3F) + (words < 0).to(torch.int32)


def member_fill(filt) -> np.ndarray:
    """Per-member fill fraction of a bank's canonical bit view, shape (B,).

    ``Filter.fill_fraction`` aggregates the whole bank; admission needs the
    worst member, not the average — one saturated tenant must not hide
    behind seven empty ones. The set bits are counted per member on the
    words' device and only the B counts come back; each count over the
    member's bits in float64 is the JAX package's ``bits.mean`` bit for
    bit (a sum of 0/1 values is exact in float64)."""
    dense = filt.dense_words().reshape(filt.bank_size, -1)
    counts = popcount32(dense).sum(dim=-1, dtype=torch.int64)
    bits = dense.shape[-1] * 32
    return counts.cpu().numpy().astype(np.float64) / bits


def _host(x) -> np.ndarray:
    """A float or int, or a tensor on any device, as a 1-D host array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.atleast_1d(np.asarray(x))


class AdmissionController:
    """Mutable admission state for one service: health flags + shed counts.

    ``snapshot_state``/``restore_state`` round-trip everything a replayed
    stream's decisions depend on (the measurement counters ride along for
    continuity of dashboards, but only ``unhealthy``/``_seen_failures``
    are semantically load-bearing).

    When constructed with a telemetry ``registry`` the controller also
    maintains labeled counters ``admission.shed{reason=,tenant=}`` (the
    per-tenant blast-radius view — which tenant is being refused, and by
    which gate) and ``admission.admitted``; the aggregate
    ``shed_counts`` dict stays authoritative for policy, the numpy
    ``shed_by_tenant`` matrix is the checkpoint carrier, and the labeled
    counters are re-derived from it on restore."""

    def __init__(self, policy: AdmissionPolicy, n_tenants: int,
                 registry=None):
        self.policy = policy
        self.n_tenants = int(n_tenants)
        self.registry = registry
        self.unhealthy = np.zeros(self.n_tenants, bool)
        self._seen_failures = np.zeros(self.n_tenants, np.int64)
        self.shed_counts: Dict[str, int] = {r: 0 for r in SHED_REASONS}
        # rows = tenants, cols = SHED_REASONS order
        self.shed_by_tenant = np.zeros(
            (self.n_tenants, len(SHED_REASONS)), np.int64)
        self.admitted = 0

    # -- health ---------------------------------------------------------------
    def refresh(self, filt) -> None:
        """Re-derive per-member health flags from the live filter."""
        p = self.policy
        if filt.spec.is_fingerprint:
            load = _host(filt.load_factor()).astype(np.float64)
            flags = load >= p.shed_load
            if p.shed_on_insert_failures:
                fails = _host(filt.state).astype(np.int64).reshape(-1)
                flags = flags | (fails > self._seen_failures)
                self._seen_failures = fails.copy()
        else:
            flags = member_fill(filt) >= p.shed_fill
        self.unhealthy = flags.reshape(-1).astype(bool)

    # -- the gate -------------------------------------------------------------
    def _record_shed(self, reason: str, tenants: np.ndarray,
                     mask: np.ndarray) -> None:
        n = int(mask.sum())
        if not n:
            return
        self.shed_counts[reason] += n
        col = SHED_REASONS.index(reason)
        per = np.bincount(tenants[mask], minlength=self.n_tenants)
        self.shed_by_tenant[:, col] += per
        if self.registry is not None:
            for t in np.nonzero(per)[0]:
                self.registry.counter("admission.shed", reason=reason,
                                      tenant=int(t)).inc(int(per[t]))

    def admit_many(self, op: str, tenants: np.ndarray, pending_total: int,
                   pending_per_tenant: np.ndarray) -> np.ndarray:
        """FIFO-order admission for one submission batch; returns an
        accept mask (n,) bool and updates the shed counters."""
        p = self.policy
        tenants = np.asarray(tenants, np.int64)
        ok = np.ones(tenants.shape[0], bool)
        if op in ("add", "remove") and self.unhealthy.any():
            bad = self.unhealthy[tenants] & (op == "add")
            self._record_shed("health", tenants, bad)
            ok &= ~bad
        if p.tenant_quota is not None:
            rank = np.full(tenants.shape[0], np.iinfo(np.int64).max)
            rank[ok] = _rank_within(tenants[ok])
            over = ok & (pending_per_tenant[tenants] + rank
                         >= p.tenant_quota)
            self._record_shed("quota", tenants, over)
            ok &= ~over
        free = max(p.queue_limit - pending_total, 0)
        idx = np.cumsum(ok) - 1          # running index among accepted
        over_q = ok & (idx >= free)
        self._record_shed("queue", tenants, over_q)
        ok &= ~over_q
        self.admitted += int(ok.sum())
        if self.registry is not None:
            self.registry.counter("admission.admitted").inc(int(ok.sum()))
        return ok

    @property
    def shed_total(self) -> int:
        return sum(self.shed_counts.values())

    # -- checkpoint cursor ----------------------------------------------------
    def snapshot_state(self) -> dict:
        return {"unhealthy": self.unhealthy.astype(int).tolist(),
                "seen_failures": self._seen_failures.tolist(),
                "shed_counts": dict(self.shed_counts),
                "shed_by_tenant": self.shed_by_tenant.tolist(),
                "admitted": self.admitted}

    def restore_state(self, state: dict) -> None:
        self.unhealthy = np.asarray(state["unhealthy"], bool)
        self._seen_failures = np.asarray(state["seen_failures"], np.int64)
        self.shed_counts = {r: int(state["shed_counts"].get(r, 0))
                            for r in SHED_REASONS}
        if "shed_by_tenant" in state:     # absent in pre-§17 checkpoints
            self.shed_by_tenant = np.asarray(state["shed_by_tenant"],
                                             np.int64)
        else:
            self.shed_by_tenant = np.zeros(
                (self.n_tenants, len(SHED_REASONS)), np.int64)
        self.admitted = int(state["admitted"])
        if self.unhealthy.shape[0] != self.n_tenants:
            raise ValueError(
                f"admission snapshot covers {self.unhealthy.shape[0]} "
                f"tenants; this service has {self.n_tenants}")
        if self.shed_by_tenant.shape != (self.n_tenants,
                                         len(SHED_REASONS)):
            raise ValueError(
                f"shed_by_tenant shape {self.shed_by_tenant.shape} != "
                f"({self.n_tenants}, {len(SHED_REASONS)})")
        if self.registry is not None:
            # re-derive the labeled counters (set_total is monotone: a
            # telemetry restore may already have installed these values)
            for col, reason in enumerate(SHED_REASONS):
                for t in np.nonzero(self.shed_by_tenant[:, col])[0]:
                    self.registry.counter(
                        "admission.shed", reason=reason, tenant=int(t)
                    ).set_total(int(self.shed_by_tenant[t, col]))
            self.registry.counter("admission.admitted").set_total(
                self.admitted)
