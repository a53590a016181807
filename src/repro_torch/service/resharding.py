"""Live bank resharding: grow the tenant layout and a member's capacity.

Counterpart of ``repro.service.resharding``, on the bank's device. The
JAX package also moves a sharded bank across meshes; that ``mesh=`` path
of :func:`reshard_service` needs the distributed engines, which the port
does not have yet, and raises ``NotImplementedError``.

Two elastic events a production bank must survive without losing filter
state or serving a false negative:

* **A tenant population outgrows the bank** — new tenants need members, or
  hot tenants need to split across more members. :func:`grow_bank` rebuilds
  the bank layout in place: existing members keep their words (and traced
  state) verbatim, new members start empty. Because members are
  independent filters, growth is exact — no rehash, no FPR change for
  existing tenants.
* **A member outgrows its own capacity** — the filter itself saturates
  (quotient/cuckoo load factor, Bloom fill). For resizable engines (the
  quotient filter) :func:`grow_capacity` escalates in place: drain, then
  ``Filter.resize()`` re-homes every stored fingerprint into a larger
  table losslessly — no raw keys, no dropped adds, bit-exact membership
  across the boundary. This is the escalation path health shedding was
  standing in for: instead of refusing a saturating member's adds at the
  door, the member grows.

:func:`reshard_service` is the live entry point: drain (a flush barrier —
in-flight batches must not straddle two layouts), rebuild, and swap the
service's filter + admission state atomically from the caller's view.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.service.admission import AdmissionController


def grow_bank(filt, new_bank: int):
    """Grow a 1-D bank to ``new_bank`` members; returns the new Filter.

    Members ``[0, B)`` carry over bit-exactly (words AND traced state —
    ring heads, cuckoo failure counters); members ``[B, new_bank)`` are
    empty. Single-host engines only: a mesh-sharded bank reshapes through
    ``reshard_filter_bank`` / checkpoint restore instead (its words
    placement is mesh-defined)."""
    if len(filt.bank_shape) != 1:
        raise ValueError(f"grow_bank needs a 1-D bank; "
                         f"bank_shape={filt.bank_shape}")
    B = filt.bank_shape[0]
    if new_bank < B:
        raise ValueError(
            f"cannot shrink a bank {B} -> {new_bank}: member filters hold "
            f"live keys; retire tenants by select()/scatter_update instead")
    if new_bank == B:
        return filt
    pad = new_bank - B
    words = torch.cat(
        [filt.words, filt.words.new_zeros((pad,) + filt.words.shape[1:])],
        dim=0)
    state = filt.state
    if state is not None:
        fresh = filt.engine.init_state(filt.spec, filt.options, filt.device)
        if isinstance(state, torch.Tensor):
            state = torch.cat([state, fresh.expand((pad,) + fresh.shape)],
                              dim=0)
        else:                        # a windowed bank's heads: Python ints
            state = tuple(state) + (fresh,) * pad
    return filt.replace(words=words, state=state)


def grow_capacity(service, *, factor: int = 2,
                  new_m_bits: Optional[int] = None):
    """Grow the service's filter capacity in place (drain-barrier
    semantics); returns the new per-member ``m_bits``.

    Resizable engines only (``supports_resize`` — the quotient filter):
    the whole bank resizes member-wise under the flush barrier, every
    stored fingerprint re-homed losslessly, so a member approaching its
    load ceiling escalates to a bigger table instead of having its adds
    health-shed. Admission health is refreshed immediately afterwards:
    flags derived from the pre-resize load factor are exactly the ones the
    resize just relieved, and leaving them set would keep shedding a
    now-healthy member until the next lazy refresh."""
    filt = service.filt
    if not filt.engine.supports_resize:
        raise ValueError(
            f"engine {filt.backend!r} does not support resize(); "
            f"grow_capacity needs a resizable engine "
            f"(variant='quotient') — reshard_service(bank=...) grows the "
            f"tenant axis instead")
    target = int(new_m_bits) if new_m_bits is not None \
        else filt.spec.m_bits * int(factor)
    if target < filt.spec.m_bits:
        raise ValueError(
            f"grow_capacity cannot shrink ({filt.spec.m_bits} -> {target} "
            f"bits): use Filter.resize() directly for deliberate shrinks")
    with service.telemetry.tracer.span("resharding.grow_capacity",
                                       m_bits=target):
        service.drain()         # in-flight batches must not straddle specs
        service.filt = service.filt.resize(target)
        service.admission.refresh(service.filt)
    service.telemetry.registry.counter("resharding.grow_capacity").inc()
    return service.filt.spec.m_bits


def reshard_service(service, *, bank: Optional[int] = None, mesh=None,
                    axis: str = "data") -> None:
    """Rebuild the service's bank layout live (drain-barrier semantics).

    ``bank=B2`` grows the tenant axis; ``mesh=`` moves a (shardable) bank
    onto a new mesh via the elastic path. Admission state is rebuilt for
    the new tenant count: existing tenants keep their health flags (and
    per-tenant shed history — telemetry counters are continuous across a
    reshard, since the new controller shares the service's registry), new
    tenants start healthy."""
    with service.telemetry.tracer.span("resharding.reshard",
                                       bank=bank or 0):
        service.drain()
        filt = service.filt
        if bank is not None:
            filt = grow_bank(filt, bank)
        if mesh is not None:
            raise NotImplementedError(
                "reshard_service(mesh=...) needs the distributed engines, "
                "which the port does not have yet")
        old = service.admission
        service.filt = filt
        service.n_tenants = filt.bank_shape[0]
        ctl = AdmissionController(old.policy, service.n_tenants,
                                  registry=old.registry)
        n_keep = min(old.n_tenants, service.n_tenants)
        ctl.unhealthy[:n_keep] = old.unhealthy[:n_keep]
        ctl._seen_failures[:n_keep] = old._seen_failures[:n_keep]
        ctl.shed_counts = dict(old.shed_counts)
        ctl.shed_by_tenant[:n_keep] = old.shed_by_tenant[:n_keep]
        ctl.admitted = old.admitted
        service.admission = ctl
        service.pending_per_tenant = np.zeros(service.n_tenants, np.int64)
    service.telemetry.registry.counter("resharding.reshards").inc()
