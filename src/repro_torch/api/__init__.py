"""``repro_torch.api`` — the public Bloom-filter surface of the port.

Counterpart of ``repro.api`` for the blocked and classical Bloom filters,
the counting Bloom filter, the windowed filter and the cuckoo and quotient
fingerprint filters, scalar or as banks of same-spec members::

    import repro_torch.api as api

    f = api.filter_for_n_items(1_000_000, bits_per_key=16)   # on the card
    f = f.add(keys)                       # immutable: returns a new Filter
    hits = f.contains(keys)
    g = api.union(f, other)               # OR-union, cross-engine OK

    c = api.filter_for_n_items(1_000_000, variant="countingbf")
    c = c.add(keys).remove(keys[:10]).decay(1)    # engine 'counting'

    w = api.filter_for_n_items(1_000_000, generations=4)   # 'windowed'
    w = w.add(keys).advance().add(more)   # the oldest generation retires

    b = api.filter_for_n_items(1_000_000, variant="cbf")   # classical

    q = api.filter_for_n_items(1_000_000, variant="cuckoo")  # 'cuckoo'
    q = q.add(keys).remove(keys[:10])     # q.insert_failures, q.load_factor()

    d = api.filter_for_n_items(1_000_000, variant="quotient")  # 'quotient'
    d = d.add(keys).remove(keys[:10]).merge(other_d).resize(2 * d.spec.m_bits)
    w = api.filter_for_workload(1_000_000, needs_remove=True,
                                needs_merge=True)  # the cheapest engine

    t = api.filter_for_n_items(8192, bank=1024)   # 1024 tenant filters
    t = t.add(keys, tenants=ids)          # routed: one launch for the bank
    hits = t.contains(keys, tenants=ids)
    kb, valid = api.route(keys, ids, 1024)         # per-tenant batches

    api.backends()
    # ('counting', 'cuckoo', 'cuda-dram', 'cuda-l2', 'quotient', 'torch',
    #  'windowed')
    f2 = api.make_filter("sbf", m_bits=1 << 24, k=8, device="cpu")

``device=None`` means the card; without one a call raises ``RuntimeError``.
The JAX engine names are aliases: on a CPU device ``jnp``, ``pallas``,
``pallas-vmem`` and ``pallas-hbm`` all resolve to ``torch``; on a CUDA
device ``pallas-vmem`` is ``cuda-l2``, ``pallas-hbm`` is ``cuda-dram``, and
``jnp`` and ``pallas`` pick the CUDA engine by L2 fit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import fingerprint as _F
from repro_torch.core import quotient as _Q
from repro_torch.core import variants as _V
from repro_torch.core.partition import route_by_id
from repro_torch.core.variants import FilterSpec
from repro_torch.api import registry
from repro_torch.api.filter import BackendOptions, Filter, as_keys, bank_state
from repro_torch.api import backends as _backends
from repro_torch.api.backends import tuned_options

_backends.register_all()


def _alias(cuda_engine: Optional[str]):
    """Alias resolver: ``torch`` on a CPU device; on a CUDA device
    ``cuda_engine``, or the L2-resident engine while it fits when None."""
    def resolve(spec: FilterSpec, ctx: registry.SelectionContext) -> str:
        if ctx.device.type == "cpu":
            return "torch"
        if cuda_engine is not None:
            return cuda_engine
        return ("cuda-l2" if registry.get("cuda-l2").supports(spec, ctx)
                else "cuda-dram")
    return resolve


registry.register_alias("jnp", _alias(None))
registry.register_alias("pallas", _alias(None))
registry.register_alias("pallas-vmem", _alias("cuda-l2"))
registry.register_alias("pallas-hbm", _alias("cuda-dram"))


def make_filter(variant: str = "sbf", m_bits: int = 1 << 20, k: int = 8,
                block_bits: int = 256, z: int = 1, backend: str = "auto",
                layout=None, tile: Optional[int] = None,
                probe: str = "auto", depth: Optional[int] = None,
                coop: str = "auto", mix: str = "auto",
                generations: Optional[int] = None, slot_bits: int = 8,
                slots_per_bucket: int = 4, r_bits: int = 0,
                impl: Optional[str] = None, device=None) -> Filter:
    """Build an empty :class:`Filter` for an explicit geometry on ``device``
    (``None`` = the card). ``backend="auto"`` runs the registry's ranked
    query; ``generations=G`` selects the windowed engine (``advance``);
    ``variant="cuckoo"`` the cuckoo engine (``remove``, ``slot_bits`` /
    ``slots_per_bucket`` geometry, ``impl`` pins its kernel or plain path);
    ``variant="quotient"`` the quotient engine (``remove``, lossless
    ``merge`` / ``resize``; ``slot_bits`` lanes storing ``r_bits`` of
    remainder); the kernel knobs are validated and passed to
    ``kernels.ops``."""
    spec = FilterSpec(variant=variant, m_bits=m_bits, k=k,
                      block_bits=block_bits, z=z, slot_bits=slot_bits,
                      slots_per_bucket=slots_per_bucket, r_bits=r_bits)
    options = BackendOptions(layout=layout, tile=tile, probe=probe,
                             depth=depth, coop=coop, mix=mix,
                             generations=generations, impl=impl)
    ctx = options.ctx(device)
    eng = registry.select(spec, backend, ctx)
    return Filter(spec=spec, words=eng.init(spec, options, ctx.device),
                  backend=eng.name, options=options,
                  state=eng.init_state(spec, options, ctx.device))


def make_filter_bank(bank, variant: str = "sbf", m_bits: int = 1 << 14,
                     k: int = 8, block_bits: int = 256, z: int = 1,
                     backend: str = "auto", layout=None,
                     tile: Optional[int] = None, probe: str = "auto",
                     depth: Optional[int] = None, coop: str = "auto",
                     mix: str = "auto", generations: Optional[int] = None,
                     slot_bits: int = 8, slots_per_bucket: int = 4,
                     r_bits: int = 0, impl: Optional[str] = None,
                     device=None) -> Filter:
    """Build an empty bank: ``bank`` (an int, or a shape tuple) independent
    same-spec member filters of ``m_bits`` bits each behind one
    :class:`Filter`, the bank dims leading its words. Per-member batches
    address members by position (``keys: bank_shape + (n, 2)``); routed ops
    take flat ``(keys, tenants)`` with ``tenants`` indexing a 1-D bank. The
    engine is selected for the whole bank's bytes; the other knobs are
    :func:`make_filter`'s."""
    bank_shape = ((int(bank),) if isinstance(bank, (int, np.integer))
                  else tuple(int(d) for d in bank))
    if not bank_shape or any(d <= 0 for d in bank_shape):
        raise ValueError(f"bank shape must be non-empty and positive; "
                         f"got {bank_shape}")
    spec = FilterSpec(variant=variant, m_bits=m_bits, k=k,
                      block_bits=block_bits, z=z, slot_bits=slot_bits,
                      slots_per_bucket=slots_per_bucket, r_bits=r_bits)
    options = BackendOptions(layout=layout, tile=tile, probe=probe,
                             depth=depth, coop=coop, mix=mix,
                             generations=generations, impl=impl)
    ctx = options.ctx(device, bank=int(np.prod(bank_shape)))
    eng = registry.select(spec, backend, ctx)
    state = bank_state(eng.init_state(spec, options, ctx.device), bank_shape)
    return Filter(spec=spec,
                  words=eng.init_bank(spec, bank_shape, options, ctx.device),
                  backend=eng.name, options=options, state=state)


def route(keys, tenants, n_tenants: int, capacity: Optional[int] = None):
    """Scatter flat routed keys into fixed-shape per-tenant batches:
    ``(keys_by_tenant (T, cap, 2) int32, valid (T, cap) uint8)``, on the
    keys' device (the CPU for arrays). ``capacity`` defaults to
    ``len(keys)`` (nothing can overflow); a smaller capacity bounds memory
    and drops each tenant's keys beyond it (the routed bank ops are exact).
    Tenant ids outside ``[0, n_tenants)`` raise ``ValueError``."""
    keys = as_keys(keys)
    ids = (tenants if isinstance(tenants, torch.Tensor)
           else torch.as_tensor(np.asarray(tenants, dtype=np.int64)))
    part = route_by_id(keys, ids, int(n_tenants),
                       int(capacity or max(keys.shape[0], 1)))
    return part.keys_by_seg, part.valid


def filter_for_n_items(n: int, bits_per_key: float = 16.0,
                       variant: str = "sbf", block_bits: int = 256,
                       k: Optional[int] = None, bank=None,
                       target_fpr: Optional[float] = None, **kw) -> Filter:
    """Size a Bloom filter for ~n items at c = bits_per_key (m rounded up to
    a power of two), with k near the space-optimal k* = c ln 2 snapped to
    the variant's constraints. ``target_fpr`` sizes by the analytic FPR
    instead. ``bank=B`` sizes each of B members for ~n items and returns the
    bank. ``**kw`` goes to :func:`make_filter` (``device``, ``backend``,
    ``generations``, kernel knobs).

    ``variant="cuckoo"`` sizes buckets for ~n keys at load factor <=
    ``fingerprint.CUCKOO_MAX_LOAD`` (0.95) instead: the slot width is the
    smallest meeting ``target_fpr`` when one is given, else u8 up to 12
    bits a key and u16 above; ``slot_bits=`` pins it.
    ``variant="quotient"`` sizes a quotient table for ~n keys at load <=
    ``quotient.QUOTIENT_MAX_LOAD`` (0.90), the q/r split from ``target_fpr``
    (``slot_bits=`` pins the lane width)."""
    if variant == "quotient":
        spec = _Q.spec_for_n(n, target_fpr=target_fpr,
                             slot_bits=kw.pop("slot_bits", None))
        common = dict(m_bits=spec.m_bits, slot_bits=spec.slot_bits,
                      r_bits=spec.r_bits, **kw)
        if bank is not None:
            return make_filter_bank(bank, variant="quotient", **common)
        return make_filter(variant="quotient", **common)
    if variant == "cuckoo":
        sb = kw.pop("slot_bits", None)
        spb = kw.pop("slots_per_bucket", 4)
        if sb is None and target_fpr is None:
            sb = 8 if bits_per_key <= 12.0 else 16
        spec = _F.spec_for_n(n, target_fpr=target_fpr, slot_bits=sb,
                             slots_per_bucket=spb)
        common = dict(m_bits=spec.m_bits, k=spec.k, slot_bits=spec.slot_bits,
                      slots_per_bucket=spec.slots_per_bucket, **kw)
        if bank is not None:
            return make_filter_bank(bank, variant="cuckoo", **common)
        return make_filter(variant="cuckoo", **common)
    if target_fpr is not None:
        bits_per_key = _V.space_optimal_c(
            variant, block_bits, kw.get("z", 1), n, target_fpr)
    m = 1 << max(int(np.ceil(np.log2(max(n, 1) * bits_per_key))), 10)
    if k is None:
        k = _V.snap_k(variant, m / max(n, 1), block_bits, kw.get("z", 1))
    if bank is not None:
        return make_filter_bank(bank, variant=variant, m_bits=m, k=k,
                                block_bits=block_bits, **kw)
    return make_filter(variant=variant, m_bits=m, k=k, block_bits=block_bits,
                       **kw)


def filter_for_workload(n: int, target_fpr: float = 1e-3,
                        needs_remove: bool = False,
                        needs_decay: bool = False,
                        needs_count: bool = False,
                        needs_merge: bool = False,
                        needs_resize: bool = False,
                        bank=None, **kw) -> Filter:
    """Capability- and memory-aware ``"auto"``: the cheapest engine (by
    ``bits_per_key`` at ``target_fpr``, :func:`registry.cheapest_engine`)
    whose flags cover the requested ops, sized for ~n keys.
    ``needs_remove`` alone picks the cuckoo engine over the counting one;
    ``needs_decay`` or ``needs_count`` picks counters; ``needs_merge`` or
    ``needs_resize`` with it the quotient engine."""
    engine = registry.cheapest_engine(needs_remove=needs_remove,
                                      needs_decay=needs_decay,
                                      needs_count=needs_count,
                                      needs_merge=needs_merge,
                                      needs_resize=needs_resize,
                                      target_fpr=target_fpr)
    variant = {"counting": "countingbf", "cuckoo": "cuckoo",
               "quotient": "quotient"}.get(engine, "sbf")
    kw.setdefault("backend", "auto")   # the variant picks the engine family
    return filter_for_n_items(n, variant=variant, target_fpr=target_fpr,
                              bank=bank, **kw)


def union(*filters: Filter) -> Filter:
    """OR-union of same-spec filters (cross-engine allowed); the result
    lives on the first filter's engine and device."""
    if not filters:
        raise ValueError("union() needs at least one filter")
    out = filters[0]
    for f in filters[1:]:
        out = out.merge(f)
    return out


def backends() -> tuple:
    """Registered engine names."""
    return registry.names()


def describe_backends() -> tuple:
    return registry.describe()


def get_backend(name: str) -> registry.Backend:
    return registry.get(name)


__all__ = ["Filter", "FilterSpec", "BackendOptions", "as_keys", "registry",
           "make_filter", "make_filter_bank", "route", "filter_for_n_items",
           "filter_for_workload", "union", "backends", "describe_backends",
           "get_backend", "tuned_options"]
