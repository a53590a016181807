"""Single-host engines: the plain PyTorch engine, the two CUDA regimes, the
counting engine, the windowed engine, the cuckoo engine and the quotient
engine.

Counterpart of ``repro.api.backends`` (``jnp``, ``pallas-vmem``,
``pallas-hbm``, ``counting``, ``windowed``, ``cuckoo``, ``quotient``). For
the bit filters the device decides first: ``torch`` serves CPU devices
only, and the CUDA engines serve CUDA devices only, so a CUDA tensor never
reaches a plain version. The CUDA engines take the blocked variants with
``s <= 32`` words per block and the classical filter ``cbf`` up to 2^32
bits, so ``"auto"`` never picks an engine that would raise. Among the
CUDA engines the L2-resident one wins while the filter fits
``ops.L2_FILTER_BYTES``.

The ``counting`` and ``windowed`` engines claim their workloads alone, on
both devices: ``countingbf`` specs belong to ``counting`` and a context
with ``generations`` set belongs to ``windowed``, so the bit engines
decline both (``_plain_bits``). Each runs its plain versions on the CPU and
its CUDA kernels on the card (the regime by L2 fit), so there too a CUDA
tensor never reaches a plain version. The ``cuckoo`` and ``quotient``
engines likewise claim ``variant="cuckoo"`` and ``variant="quotient"``
alone.

Banks (``ctx.bank`` set). ``torch`` runs the plain ``bank_*_rows`` on the
CPU; ``cuda-l2`` and ``cuda-dram`` the bank kernels, one launch for the
whole bank, the engine chosen by the whole bank's bytes
(``ops.bank_l2_resident``); ``counting`` its bank kernels (and one decay
launch over the flat bank). A ``cbf`` bank has no bank kernel and a
windowed bank keeps one head per member: both take the registry's generic
path, one scalar op per member (on the card, the scalar CUDA kernels), and
so do cuckoo and quotient banks, each member with its whole batch and
valid mask; a quotient bank merges and resizes member by member.
"""
from __future__ import annotations

import torch

from repro_torch.core import fingerprint as F
from repro_torch.core import hashing as H
from repro_torch.core import quotient as Q
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.api.registry import (Backend, SelectionContext,
                                      flat_members, register)
from repro_torch.kernels import ops
from repro_torch.kernels import quotientfilter as qf
from repro_torch.kernels.ring import ring_dense
from repro_torch.window import ring as R


def _plain_bits(spec: FilterSpec, ctx: SelectionContext) -> bool:
    """Workloads the bit engines compete for: not a counting or fingerprint
    spec, not a windowed (generations) context."""
    return (not spec.is_counting and not spec.is_fingerprint
            and ctx.generations is None)


class _BitBankBackend(Backend):
    """The native bank path of the bit engines: per-member batches flatten
    to routed keys, and a routed op is one ``_bank_add`` / ``_bank_contains``
    over the whole bank. A cbf bank has no bank form and takes the generic
    per-member path."""

    supports_bank = True

    def add_bank(self, spec, words, keys, options, valid=None, state=None):
        if spec.variant == "cbf":
            return super().add_bank(spec, words, keys, options, valid=valid,
                                    state=state)
        flat, member = flat_members(keys)
        vf = None if valid is None else valid.reshape(-1)
        return self._bank_add(spec, words, flat, member, options, vf)

    def contains_bank(self, spec, words, keys, options, state=None):
        if spec.variant == "cbf":
            return super().contains_bank(spec, words, keys, options,
                                         state=state)
        flat, member = flat_members(keys)
        return self._bank_contains(spec, words, flat, member, options
                                   ).reshape(keys.shape[:2])

    def add_bank_routed(self, spec, words, keys, member, options, valid=None,
                        state=None):
        if spec.variant == "cbf":
            return super().add_bank_routed(spec, words, keys, member, options,
                                           valid=valid, state=state)
        return self._bank_add(spec, words, keys, member, options, valid)

    def contains_bank_routed(self, spec, words, keys, member, options,
                             state=None):
        if spec.variant == "cbf":
            return super().contains_bank_routed(spec, words, keys, member,
                                                options, state=state)
        return self._bank_contains(spec, words, keys, member, options)


class TorchBackend(_BitBankBackend):
    """The plain PyTorch versions on the CPU: one row gather per lookup
    (``contains``) and the sorted segmented-OR bulk insert (``add_rows``).
    The semantic oracle of the port."""

    name = "torch"

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return ctx.device.type == "cpu" and _plain_bits(spec, ctx)

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 1.0

    def init(self, spec, options, device):
        return V.init(spec, device)

    def add(self, spec, words, keys, options):
        return V.add_rows(spec, words, keys)

    def contains(self, spec, words, keys, options):
        return V.contains(spec, words, keys)

    def _bank_add(self, spec, words, keys, member, options, valid):
        return V.bank_add_rows(spec, words, keys, member, valid=valid)

    def _bank_contains(self, spec, words, keys, member, options):
        return V.bank_contains_rows(spec, words, keys, member)


def _fits_l2(spec: FilterSpec, ctx: SelectionContext) -> bool:
    """The filter, or the whole bank when ``ctx.bank`` is set, fits the
    L2-resident regime."""
    if ctx.bank is not None:
        return ops.bank_l2_resident(spec, ctx.bank)
    return ops.fits_l2(spec)


class _CudaBackend(_BitBankBackend):
    regime = "auto"

    def _runs(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return (ctx.device.type == "cuda" and _plain_bits(spec, ctx)
                and ops.kernel_supported(spec))

    def init(self, spec, options, device):
        return V.init(spec, device)

    def _kw(self, options):
        kw = {"regime": self.regime, "probe": options.probe,
              "coop": options.coop, "mix": options.mix}
        if options.layout is not None:
            kw["layout"] = options.layout
        if options.tile is not None:
            kw["tile"] = options.tile
        return kw

    def add(self, spec, words, keys, options):
        return ops.bloom_add(spec, words, keys, inplace=False,
                             **self._kw(options))

    def contains(self, spec, words, keys, options):
        return ops.bloom_contains(spec, words, keys, depth=options.depth,
                                  **self._kw(options))

    # -- native bank path: one bank-kernel launch for the whole bank -------
    def _bank_kw(self, options):
        kw = {"probe": options.probe, "mix": options.mix}
        if options.layout is not None:
            kw["layout"] = options.layout
        if options.tile is not None:
            kw["tile"] = options.tile
        return kw

    def _bank_add(self, spec, words, keys, member, options, valid):
        return ops.bloom_bank_add(spec, words, keys, member, valid=valid,
                                  **self._bank_kw(options))

    def _bank_contains(self, spec, words, keys, member, options):
        return ops.bloom_bank_contains(spec, words, keys, member,
                                       regime=self.regime,
                                       depth=options.depth,
                                       **self._bank_kw(options))


class CudaL2Backend(_CudaBackend):
    """CUDA kernels for a filter that fits the L2 cache (the paper's
    cache-resident regime; ``pallas-vmem``'s counterpart)."""

    name = "cuda-l2"
    regime = "vmem"

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return self._runs(spec, ctx) and _fits_l2(spec, ctx)

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 0.4


class CudaDramBackend(_CudaBackend):
    """CUDA kernels for a filter in device memory (the DRAM-resident
    regime; ``pallas-hbm``'s counterpart)."""

    name = "cuda-dram"
    regime = "hbm"

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return self._runs(spec, ctx)

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        # dispreferred while the filter (or bank) still fits the L2
        return 1.2 if _fits_l2(spec, ctx) else 0.7


class CountingBackend(Backend):
    """Counting Bloom filter (variant='countingbf'): packed 4-bit saturating
    counters, so keys can be removed and the filter decayed. The plain
    versions on the CPU, the CUDA counting kernels on the card (atomicCAS
    nibble updates). 4x the memory of the equivalent bit filter."""

    name = "counting"
    supports_remove = True
    supports_decay = True
    supports_bank = True
    supports_count = True              # counting_count multiplicity bound

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        if ctx.generations is not None:
            return False
        if ctx.device.type == "cuda":
            return ops.counting_kernel_supported(spec)
        return ctx.device.type == "cpu" and spec.is_counting

    def bits_per_key(self, target_fpr: float = Backend.REF_FPR) -> float:
        """4-bit counters store 4x the equivalent bit filter."""
        return 4.0 * super().bits_per_key(target_fpr)

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 1.0   # sole claimant of countingbf specs

    def init(self, spec, options, device):
        return V.init(spec, device)                # (storage_words,) counters

    def _kw(self, options):
        kw = {"layout": options.layout, "probe": options.probe,
              "coop": options.coop, "mix": options.mix}
        if options.tile is not None:
            kw["tile"] = options.tile
        return kw

    def add(self, spec, words, keys, options):
        if words.is_cuda:
            return ops.counting_add(spec, words, keys, **self._kw(options))
        return V.counting_add(spec, words, keys)

    def remove(self, spec, words, keys, options):
        if words.is_cuda:
            return ops.counting_remove(spec, words, keys, **self._kw(options))
        return V.counting_remove(spec, words, keys)

    def contains(self, spec, words, keys, options):
        if words.is_cuda:
            return ops.counting_contains(spec, words, keys,
                                         depth=options.depth,
                                         **self._kw(options))
        return V.counting_contains(spec, words, keys)

    def decay(self, spec, words, options):
        if words.is_cuda:
            return ops.counting_decay(spec, words)
        return V.counting_decay(spec, words)

    def merge(self, spec, a, b, options):
        """Counter-true union: nibble-wise saturating add (not OR, so the
        merged counts support the merged removes)."""
        return H.to_i32(V.nib_sat_add_words(a, b))

    def to_dense(self, spec, words, options):
        """The occupancy bit filter (counts are an engine detail)."""
        return V.counting_to_bloom(spec, words)

    def from_dense(self, spec, dense, options):
        """Occupancy -> counters at 1: membership-preserving, count-lossy."""
        return V.counting_from_bloom(spec, dense)

    # -- native bank path: the counter super-filter, one launch ------------
    def _bank_update(self, spec, words, keys, member, valid, op, options):
        if words.is_cuda:
            kw = {"layout": options.layout, "probe": options.probe,
                  "mix": options.mix}
            if options.tile is not None:
                kw["tile"] = options.tile
            return ops.counting_bank_update(spec, words, keys, member, op,
                                            valid=valid, **kw)
        return V.bank_counting_update(spec, words, keys, member, valid, op)

    def add_bank(self, spec, words, keys, options, valid=None, state=None):
        flat, member = flat_members(keys)
        vf = None if valid is None else valid.reshape(-1)
        return self._bank_update(spec, words, flat, member, vf, "add",
                                 options)

    def remove_bank(self, spec, words, keys, options, valid=None, state=None):
        flat, member = flat_members(keys)
        vf = None if valid is None else valid.reshape(-1)
        return self._bank_update(spec, words, flat, member, vf, "remove",
                                 options)

    def contains_bank(self, spec, words, keys, options, state=None):
        flat, member = flat_members(keys)
        return self.contains_bank_routed(spec, words, flat, member, options
                                         ).reshape(keys.shape[:2])

    def add_bank_routed(self, spec, words, keys, member, options, valid=None,
                        state=None):
        return self._bank_update(spec, words, keys, member, valid, "add",
                                 options)

    def remove_bank_routed(self, spec, words, keys, member, options,
                           valid=None, state=None):
        return self._bank_update(spec, words, keys, member, valid, "remove",
                                 options)

    def contains_bank_routed(self, spec, words, keys, member, options,
                             state=None):
        if words.is_cuda:
            return ops.counting_bank_contains(spec, words, keys, member,
                                              depth=options.depth)
        return V.bank_counting_contains(spec, words, keys, member)

    def decay_bank(self, spec, words, options):
        """Aging is elementwise on packed counters: the bank decays whole
        (one launch over the flat bank on the card)."""
        return self.decay(spec, words, options)


class WindowedBackend(Backend):
    """Generation-ring sliding window (``options.generations`` = G):
    inserts land in the head generation, queries OR the ring in one fused
    pass, ``advance()`` retires the oldest generation in O(1). Forgets by
    age class, not per key; G x the memory of one generation. The head is
    per-filter host state (``Filter.state``). On the card the add runs the
    blocked add kernel on the head row and the query the ring kernel, the
    regime by L2 fit; on the CPU their plain versions. A bank keeps one
    head per member and runs the generic per-member bank path."""

    name = "windowed"
    supports_advance = True
    words_ndim = 2                     # (G, n_words)

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        if ctx.generations is None or spec.variant not in V.BLOCKED:
            return False               # declines countingbf, cbf, fingerprints
        if ctx.device.type == "cuda":
            return ops.kernel_supported(spec)
        return ctx.device.type == "cpu"

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 1.0   # sole claimant of generations contexts

    def bits_per_key(self, target_fpr: float = Backend.REF_FPR):
        return None      # G generations: the cost depends on the ring length

    def init(self, spec, options, device):
        return R.ring_init(spec, options.generations, device)

    def init_state(self, spec, options, device=None):
        return 0                                   # the insert head

    def add(self, spec, words, keys, options, state=None):
        return R.ring_add(spec, words, keys, 0 if state is None else state)

    def contains(self, spec, words, keys, options):
        return R.ring_contains_dispatch(spec, words, keys)

    def advance(self, spec, words, options, state=None):
        return R.ring_advance(words, 0 if state is None else state)

    def to_dense(self, spec, words, options):
        return ring_dense(words)

    def from_dense(self, spec, dense, options):
        """The whole window in generation 0 (age classes are not
        recoverable from the canonical form); the head restarts at 0.
        Leading bank dims of ``dense`` lead the rings."""
        ring = R.ring_init(spec, options.generations, dense.device)
        words = ring.expand(tuple(dense.shape[:-1]) + tuple(ring.shape))
        words = words.clone()
        words[..., 0, :] = dense
        return words


IMPLS = (None, "pallas", "jnp")


class CuckooBackend(Backend):
    """Bucketed cuckoo fingerprint filter (variant='cuckoo'): u8/u16
    fingerprints in buckets of 2-16 slots, partial-key hashing,
    bounded-kick eviction. ``remove`` at ~1x storage, with an explicit
    insert-failure count as engine state (``Filter.insert_failures``, a
    0-d int64 tensor on the words' device, so an add syncs nothing); no
    counters, no decay, no merge. On the card the CUDA kernels (ordered
    single-CTA updates, one-thread-a-key contains), on the CPU the plain
    versions; ``options.impl`` pins the path: ``None`` or ``"pallas"`` the
    kernels on the card and the plain versions on the CPU, ``"jnp"`` the
    plain versions, on the CPU only (``ValueError`` on the card). Banks take
    the generic path with real valid masks (inserts are not idempotent)."""

    name = "cuckoo"
    supports_remove = True
    supports_merge = False             # slots hold values, not OR-able bits
    stateful_ops = True

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        if spec.variant != "cuckoo" or ctx.generations is not None:
            return False
        if ctx.device.type == "cuda":
            return ops.cuckoo_kernel_supported(spec)
        return ctx.device.type == "cpu"

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 1.0   # sole claimant of cuckoo specs

    def bits_per_key(self, target_fpr: float = Backend.REF_FPR):
        """f / 0.95: the slot width meeting the target, at the standard
        0.95 achievable load of 4-slot buckets."""
        f = F.slot_bits_for_fpr(target_fpr)
        return None if f is None else f / F.CUCKOO_MAX_LOAD

    def init(self, spec, options, device):
        return F.init(spec, device)

    def init_state(self, spec, options, device=None):
        return torch.zeros((), dtype=torch.int64, device=device)

    def _kernels(self, words, options) -> bool:
        """True where the CUDA kernels run; raises for ``impl="jnp"`` on
        the card (nothing switches path quietly)."""
        if options.impl not in IMPLS:
            raise ValueError(f"impl={options.impl!r} not in {IMPLS}")
        if not words.is_cuda:
            return False
        if options.impl == "jnp":
            raise ValueError("impl='jnp' pins the plain versions, which run "
                             "on the CPU only; use impl=None or 'pallas' on "
                             "the card")
        return True

    def _update(self, spec, words, keys, options, state, valid, op):
        if self._kernels(words, options):
            fn = ops.cuckoo_add if op == "add" else ops.cuckoo_remove
            new, flags = fn(spec, words, keys, valid=valid,
                            tile=options.tile)
        else:
            fn = F.cuckoo_add if op == "add" else F.cuckoo_remove
            new, flags = fn(spec, words, keys, valid=valid,
                            tile=options.tile)
        st = (self.init_state(spec, options, words.device) if state is None
              else state)
        if op == "add":
            # the failure signal is never dropped: it accumulates in the
            # state, on the device (no host sync)
            st = st + (~flags).sum()
        return new, st

    def add(self, spec, words, keys, options, state=None, valid=None):
        return self._update(spec, words, keys, options, state, valid, "add")

    def remove(self, spec, words, keys, options, state=None, valid=None):
        return self._update(spec, words, keys, options, state, valid,
                            "remove")

    def contains(self, spec, words, keys, options):
        if self._kernels(words, options):
            return ops.cuckoo_contains(spec, words, keys,
                                       tile=options.tile or None,
                                       coop=options.coop)
        return F.cuckoo_contains(spec, words, keys)

    def merge(self, spec, a, b, options):
        raise NotImplementedError(
            "cuckoo filters cannot be merged by elementwise union (slots "
            "hold fingerprint values, not OR-able bits); re-insert the "
            "other filter's keys, or use variant='quotient' (lossless "
            "fingerprint merge) when union is required")


class QuotientBackend(CuckooBackend):
    """Counting quotient filter (variant='quotient'): p-bit fingerprints
    split into a q-bit home slot and an r-bit stored remainder, with three
    metadata bits packing runs into clusters. The one engine with
    ``remove`` and **lossless** ``merge`` and ``resize``: every stored
    fingerprint is recoverable, so a union decodes both tables and rebuilds,
    and a resize re-splits p = q + r at the new size. Capacity failures
    accumulate in ``Filter.insert_failures`` as cuckoo's do (on the device).
    On the card the CUDA kernels run contains and the updates (one
    sorted-stream rebuild a call), and merge and resize too (the update's
    decode, merge, position and write stages on the decoded streams); on
    the CPU the plain versions; ``options.impl`` as for cuckoo. Banks take the generic path
    with real valid masks; merge and resize go member by member."""

    name = "quotient"
    supports_remove = True
    supports_merge = True
    supports_resize = True
    stateful_ops = True

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        if not spec.is_quotient or ctx.generations is not None:
            return False
        if ctx.device.type == "cuda":
            return ops.quotient_kernel_supported(spec)
        return ctx.device.type == "cpu"

    def bits_per_key(self, target_fpr: float = Backend.REF_FPR):
        """lane / 0.9: the remainder meeting the target at load 0.9, snapped
        up to the smallest u8/u16/u32 lane that holds it with 3 metadata
        bits."""
        if not 0.0 < target_fpr < 1.0:
            raise ValueError(f"target_fpr must be in (0, 1): {target_fpr}")
        r = Q.r_bits_for_fpr(target_fpr, 20)     # q barely moves it
        for sb in V.QUOTIENT_SLOT_BITS:
            if r <= sb - V.QF_META_BITS:
                return sb / Q.QUOTIENT_MAX_LOAD
        return None

    def init(self, spec, options, device):
        return Q.init(spec, device)

    def _update(self, spec, words, keys, options, state, valid, op):
        if self._kernels(words, options):
            fn = ops.quotient_add if op == "add" else ops.quotient_remove
        else:
            fn = Q.quotient_add if op == "add" else Q.quotient_remove
        new, flags = fn(spec, words, keys, valid=valid, tile=options.tile)
        st = (self.init_state(spec, options, words.device) if state is None
              else state)
        if op == "add":
            st = st + (~flags).sum()
        return new, st

    def contains(self, spec, words, keys, options):
        if self._kernels(words, options):
            return ops.quotient_contains(spec, words, keys,
                                         tile=options.tile or None,
                                         coop=options.coop)
        return Q.quotient_contains(spec, words, keys)

    def merge(self, spec, a, b, options):
        """Lossless union: decode both multisets and rebuild, equal to the
        table built from the concatenated key streams. The capacity is
        checked first, on the host (an overflow would lose keys); a bank
        merges member by member and every member must fit."""
        fa = a.reshape(-1, a.shape[-1])
        fb = b.reshape(-1, b.shape[-1])
        worst = int((Q.occupied_slots(spec, fa)
                     + Q.occupied_slots(spec, fb)).max())
        cap = spec.n_slots - 1
        if worst > cap:
            raise ValueError(
                f"quotient merge overflows: {worst} combined fingerprints "
                f"> capacity {cap} of {spec}; resize() one side first")
        fn = (qf.merge_vmem if self._kernels(a, options)
              else Q.quotient_merge)
        out = torch.stack([fn(spec, x, y) for x, y in zip(fa, fb)])
        return out.reshape(a.shape)

    def resize(self, spec, words, new_m_bits, options):
        """(new_spec, new_words): re-split p = q + r at the new size and
        re-home every stored fingerprint. A shrink is refused, on the host,
        when a member stores more than the new capacity."""
        new_spec = Q.spec_for_resize(spec, int(new_m_bits))
        flat = words.reshape(-1, words.shape[-1])
        if new_spec.n_slots < spec.n_slots:
            worst = int(Q.occupied_slots(spec, flat).max())
            cap = new_spec.n_slots - 1
            if worst > cap:
                raise ValueError(
                    f"cannot shrink {spec} to m_bits={new_m_bits}: a "
                    f"member stores {worst} fingerprints > new capacity "
                    f"{cap}")
        fn = (qf.resize_vmem if self._kernels(words, options)
              else Q.quotient_resize)
        out = torch.stack([fn(spec, w, new_spec) for w in flat])
        return new_spec, out.reshape(words.shape[:-1] + (new_spec.n_words,))


def tuned_options(spec: FilterSpec, op: str = "contains",
                  regime: str = "auto", tile: int = None, device=None):
    """Pin a ``BackendOptions`` to the autotuner's plan for (spec, op) on
    ``device`` (default the card).

    ``make_filter(probe="auto")`` already resolves per call; this helper
    materializes the tuned (layout, probe, depth, coop, mix) eagerly, for a
    caller that wants the plan recorded in the filter's options, inspected
    or logged. On a CUDA device a blocked filter's layout is the card's own
    (``sbf.card_layout(spec, op)``, the lanes a key), and so is a counting
    filter's contains layout (``countingbf.card_layout(spec)``): the
    tuner's layout grid scores the JAX package's schedule, which on the
    card would run another Θ. The CPU keeps the tuner's layout, as in the
    JAX package.
    """
    from repro_torch import resolve_device
    from repro_torch.api.filter import BackendOptions
    from repro_torch.core import tuning
    from repro_torch.kernels import countingbf, sbf
    tile = tile or sbf.DEFAULT_TILE
    device = resolve_device(device)
    plan = tuning.tune_plan(spec, op, regime=ops._regime(spec, regime),
                            tile=tile, device=device)
    layout = plan.layout
    if device.type == "cuda" and spec.variant in sbf.BLOCKED_VARIANTS:
        layout = sbf.card_layout(spec, op)
    elif device.type == "cuda" and spec.is_counting and op == "contains":
        layout = countingbf.card_layout(spec)
    return BackendOptions(layout=layout, tile=tile, probe=plan.probe,
                          depth=plan.depth, coop=plan.coop, mix=plan.mix)


def register_all():
    register(TorchBackend())
    register(CudaL2Backend())
    register(CudaDramBackend())
    register(CountingBackend())
    register(WindowedBackend())
    register(CuckooBackend())
    register(QuotientBackend())
