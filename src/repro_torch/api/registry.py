"""Backend registry: named, introspectable Bloom-filter engines.

Counterpart of ``repro.api.registry``. Every engine declares
``supports(spec, ctx)`` and ``cost(spec, ctx)``; ``"auto"`` selection is
``min(cost)`` over the supporting engines. Engines registered by
``repro_torch.api``:

=========== ==============================================================
name        execution strategy
=========== ==============================================================
torch       the plain PyTorch versions (row gather / sorted segmented-OR
            insert); CPU devices only
cuda-l2     the CUDA kernels, L2-resident regime (``pallas-vmem``'s
            counterpart)
cuda-dram   the CUDA kernels, DRAM-resident regime (``pallas-hbm``'s
            counterpart)
counting    the counting filter (countingbf, 4-bit counters: ``remove``,
            ``decay``); its plain versions on the CPU, its CUDA kernels in
            either regime on the card
windowed    the generation-ring sliding window (``generations`` = G:
            ``advance``); sole claimant of contexts with ``generations``
cuckoo      the cuckoo fingerprint filter (variant='cuckoo': ``remove``,
            an insert-failure count as engine state); its plain versions
            on the CPU, its CUDA kernels on the card
quotient    the counting quotient filter (variant='quotient': ``remove``,
            lossless ``merge`` and ``resize``, the cuckoo engine's failure
            count); its plain versions on the CPU, its CUDA kernels on the
            card
=========== ==============================================================

:func:`cheapest_engine` ranks the engines whose capability flags cover a
workload by ``bits_per_key``: the memory-aware half of ``"auto"``.

The JAX engine names are registered as aliases (see ``repro_torch.api``),
so a state dict written by the JAX package names a port engine.

Banks. A bank's words are ``(B, *base)``: per-member batches
``(B, n, 2)`` (with ``valid (B, n)``) or routed flat keys ``(N, 2)`` with
member ids ``(N,)``. The ``*_bank`` defaults below are the generic path: a
loop over the members of the engine's scalar op, one launch per member
(JAX: a ``vmap`` of the scalar op). Engines with a native member-offset
path (one launch for the whole bank) override them and set
``supports_bank``. A stateful engine (``stateful_ops``: its add and remove
return ``(words, state)``) gets each member's whole batch with its valid
mask, as JAX's ``vmap`` hands it over, and the generic path returns the
bank's words and a ``(B,)`` tensor of member states.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.partition import route_by_id
from repro_torch.core.variants import FilterSpec


def flat_members(keys: torch.Tensor):
    """(B, n, 2) per-member batches -> flat (keys (B*n, 2), member (B*n,)
    int32): the one batch-to-routed flattening convention."""
    B, n = keys.shape[0], keys.shape[1]
    member = torch.arange(B, dtype=torch.int32,
                          device=keys.device).repeat_interleave(n)
    return keys.reshape(-1, 2), member


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Everything ``supports``/``cost`` may rank on, besides the spec."""

    device: torch.device
    generations: Optional[int] = None  # ring size -> the windowed engine
    bank: Optional[int] = None         # bank member count (None = scalar)

    @classmethod
    def current(cls, device=None, generations: Optional[int] = None,
                bank: Optional[int] = None) -> "SelectionContext":
        from repro_torch import resolve_device
        return cls(device=resolve_device(device), generations=generations,
                   bank=bank)


class Backend:
    """Engine interface. Engines are stateless; the words travel in the
    :class:`repro_torch.api.Filter`. The bit engines store the dense
    ``(n_words,)`` int32 words, so ``to_dense``/``from_dense`` are the
    identity; the counting engine stores ``(storage_words,)`` counters and
    the windowed engine a ``(G, n_words)`` ring."""

    name: str = "?"

    # Array dims of one filter's words.
    words_ndim: int = 1

    supports_remove: bool = False
    supports_decay: bool = False
    supports_advance: bool = False
    supports_bank: bool = False
    supports_count: bool = False
    supports_merge: bool = True
    supports_resize: bool = False
    # add/remove return (words, state) and take ``state=`` and ``valid=``
    stateful_ops: bool = False

    REF_FPR = 1e-3

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        raise NotImplementedError

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        raise NotImplementedError

    def bits_per_key(self, target_fpr: float = REF_FPR) -> Optional[float]:
        """Storage bits per key needed for ``target_fpr`` (information-
        theoretic Bloom sizing c = ln(1/eps) / ln(2)^2)."""
        if not 0.0 < target_fpr < 1.0:
            raise ValueError(f"target_fpr must be in (0, 1): {target_fpr}")
        return math.log(1.0 / target_fpr) / (math.log(2.0) ** 2)

    def describe(self) -> Dict[str, object]:
        bpk = self.bits_per_key()
        return {"name": self.name, "doc": (self.__doc__ or "").strip(),
                "supports_remove": self.supports_remove,
                "supports_decay": self.supports_decay,
                "supports_advance": self.supports_advance,
                "supports_bank": self.supports_bank,
                "supports_count": self.supports_count,
                "supports_merge": self.supports_merge,
                "supports_resize": self.supports_resize,
                "bits_per_key_at_ref_fpr":
                    None if bpk is None else round(bpk, 2),
                "ref_fpr": self.REF_FPR}

    def init(self, spec: FilterSpec, options, device) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, spec: FilterSpec, options, device=None):
        """Per-filter engine state beside the words (``Filter.state``): the
        windowed engine's ring head, the cuckoo engine's failure count (a
        0-d tensor on ``device``); ``None`` for every other engine."""
        return None

    def init_bank(self, spec: FilterSpec, bank_shape: Tuple[int, ...],
                  options, device) -> torch.Tensor:
        """Zeroed words for a whole bank: the bank dims lead."""
        base = self.init(spec, options, device)
        return torch.zeros(tuple(bank_shape) + tuple(base.shape),
                           dtype=base.dtype, device=device)

    def to_dense(self, spec: FilterSpec, words: torch.Tensor, options
                 ) -> torch.Tensor:
        """Canonical (n_words,) bit words; leading bank dims pass through
        (every engine's conversion is elementwise over them)."""
        return words

    def from_dense(self, spec: FilterSpec, dense: torch.Tensor, options
                   ) -> torch.Tensor:
        return dense

    def add(self, spec: FilterSpec, words: torch.Tensor, keys: torch.Tensor,
            options) -> torch.Tensor:
        """OR ``keys`` (n, 2) int32 in; returns new words (``words`` is
        left unchanged)."""
        raise NotImplementedError

    def contains(self, spec: FilterSpec, words: torch.Tensor,
                 keys: torch.Tensor, options) -> torch.Tensor:
        """(n,) bool membership for ``keys`` (n, 2) int32."""
        raise NotImplementedError

    def merge(self, spec: FilterSpec, a: torch.Tensor, b: torch.Tensor,
              options) -> torch.Tensor:
        """OR-union of two same-shape word tensors (default: elementwise)."""
        return a | b

    def resize(self, spec: FilterSpec, words: torch.Tensor, new_m_bits: int,
               options) -> Tuple[FilterSpec, torch.Tensor]:
        """Lossless capacity change: ``(new_spec, new_words)`` with every
        stored element re-homed (``supports_resize`` engines only)."""
        raise NotImplementedError(
            f"engine {self.name!r} does not support resize(); use "
            f"variant='quotient' (engine 'quotient') for lossless "
            f"grow-in-place")

    def remove(self, spec: FilterSpec, words: torch.Tensor,
               keys: torch.Tensor, options) -> torch.Tensor:
        """Delete ``keys`` (counting engines); returns new words."""
        raise NotImplementedError(
            f"engine {self.name!r} does not support remove(); use the "
            f"'counting' engine (variant='countingbf')")

    def decay(self, spec: FilterSpec, words: torch.Tensor, options
              ) -> torch.Tensor:
        """One uniform aging step (counting engines); returns new words."""
        raise NotImplementedError(
            f"engine {self.name!r} does not support decay(); use the "
            f"'counting' engine (variant='countingbf')")

    def advance(self, spec: FilterSpec, words: torch.Tensor, options,
                state=None):
        """Slide the window (windowed engine): returns (words, state)."""
        raise NotImplementedError(
            f"engine {self.name!r} does not support advance(); use the "
            f"'windowed' engine (generations=...)")


    # -- bank ops (the generic path: one scalar op per member) --------------
    # Batched form: ``words`` (B, *base), keys (B, n, 2), optional valid
    # (B, n). Routed form: flat keys (N, 2) + member ids (N,). ``state`` is
    # one engine state per member (the windowed heads, the cuckoo failure
    # counts) or None. A stateless engine's member drops its invalid keys
    # before its op (JAX repeats one of its valid keys instead: OR is
    # idempotent, so the words are the same). A stateful engine's member
    # gets its whole batch and valid mask: its inserts are not idempotent,
    # and dropping keys would move the tile boundaries that fix its words.
    # A member with no valid key keeps its words (and state).

    def _update_bank(self, op: str, spec: FilterSpec, words: torch.Tensor,
                     keys: torch.Tensor, options, valid, state):
        out = words.clone()
        run = getattr(self, op)
        if self.stateful_ops:
            states = []
            for b in range(words.shape[0]):
                out[b], st = run(spec, words[b], keys[b].contiguous(),
                                 options,
                                 state=None if state is None else state[b],
                                 valid=None if valid is None else valid[b])
                states.append(st)
            return out, torch.stack(states)
        for b in range(words.shape[0]):
            kb = keys[b] if valid is None else keys[b][valid[b] != 0]
            kw = {} if state is None else {"state": state[b]}
            if kb.shape[0]:
                out[b] = run(spec, words[b], kb.contiguous(), options, **kw)
        return out

    def add_bank(self, spec: FilterSpec, words: torch.Tensor,
                 keys: torch.Tensor, options, valid=None, state=None):
        return self._update_bank("add", spec, words, keys, options, valid,
                                 state)

    def contains_bank(self, spec: FilterSpec, words: torch.Tensor,
                      keys: torch.Tensor, options, state=None
                      ) -> torch.Tensor:
        return torch.stack([self.contains(spec, words[b], keys[b], options)
                            for b in range(words.shape[0])])

    def remove_bank(self, spec: FilterSpec, words: torch.Tensor,
                    keys: torch.Tensor, options, valid=None, state=None):
        return self._update_bank("remove", spec, words, keys, options,
                                 valid, state)

    def decay_bank(self, spec: FilterSpec, words: torch.Tensor, options
                   ) -> torch.Tensor:
        return torch.stack([self.decay(spec, words[b], options)
                            for b in range(words.shape[0])])

    def advance_bank(self, spec: FilterSpec, words: torch.Tensor, options,
                     state):
        """Advance every member by its own head: (words, heads tuple)."""
        out, heads = words.clone(), []
        for b in range(words.shape[0]):
            out[b], head = self.advance(spec, words[b], options,
                                        state=state[b])
            heads.append(head)
        return out, tuple(heads)

    # The routed generic path scatters into a (B, N) batch (capacity N, so
    # no key can overflow: exactness over memory). Beyond this many slots
    # the cost is certainly a mistake: fail loudly instead.
    _ROUTE_FALLBACK_MAX_SLOTS = 1 << 22

    def _route(self, words: torch.Tensor, keys: torch.Tensor,
               member: torch.Tensor, valid=None):
        """Scatter flat routed keys into per-member batches (capacity N).
        Returns (keys (B, N, 2), valid (B, N), rank (N,)). O(B·N) memory
        and work: for the engines without a native routed path (cbf and
        windowed banks) at serving batch sizes."""
        B, n = words.shape[0], keys.shape[0]
        if B * n > self._ROUTE_FALLBACK_MAX_SLOTS:
            raise ValueError(
                f"routed fallback on engine {self.name!r} would scatter "
                f"{B} members x {n} keys = {B * n} slots; route this "
                f"traffic through an engine with native bank support or "
                f"pre-scatter with repro_torch.api.route(..., capacity=...)")
        part = route_by_id(keys, member, B, capacity=max(n, 1))
        v = part.valid
        if valid is not None:
            # the caller's validity rides along to the same slots
            flat_v = torch.zeros(v.numel(), dtype=torch.uint8,
                                 device=v.device)
            flat_v[member.to(torch.int64) * v.shape[1] + part.rank] = (
                valid.to(torch.uint8))
            v = v * flat_v.reshape(v.shape)
        return part.keys_by_seg, v, part.rank

    def add_bank_routed(self, spec: FilterSpec, words: torch.Tensor,
                        keys: torch.Tensor, member: torch.Tensor, options,
                        valid=None, state=None) -> torch.Tensor:
        kb, vb, _ = self._route(words, keys, member, valid)
        return self.add_bank(spec, words, kb, options, valid=vb, state=state)

    def contains_bank_routed(self, spec: FilterSpec, words: torch.Tensor,
                             keys: torch.Tensor, member: torch.Tensor,
                             options, state=None) -> torch.Tensor:
        kb, _, rank = self._route(words, keys, member)
        res = self.contains_bank(spec, words, kb, options, state=state)
        return res[member.to(torch.int64), rank]

    def remove_bank_routed(self, spec: FilterSpec, words: torch.Tensor,
                           keys: torch.Tensor, member: torch.Tensor, options,
                           valid=None, state=None) -> torch.Tensor:
        kb, vb, _ = self._route(words, keys, member, valid)
        return self.remove_bank(spec, words, kb, options, valid=vb,
                                state=state)


_REGISTRY: Dict[str, Backend] = {}
_ALIASES: Dict[str, Callable[[FilterSpec, SelectionContext], str]] = {}


def register(backend: Backend, overwrite: bool = False) -> Backend:
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def register_alias(name: str,
                   resolve: Callable[[FilterSpec, SelectionContext], str]):
    _ALIASES[name] = resolve


def get(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def describe() -> Tuple[Dict[str, object], ...]:
    return tuple(_REGISTRY[n].describe() for n in names())


def cheapest_engine(needs_remove: bool = False, needs_decay: bool = False,
                    needs_count: bool = False, needs_merge: bool = False,
                    needs_resize: bool = False,
                    target_fpr: float = Backend.REF_FPR) -> str:
    """The name of the engine with the fewest :meth:`Backend.bits_per_key`
    at ``target_fpr`` among those whose capability flags cover the needs.
    ``needs_remove`` alone picks the cuckoo engine over the counting one
    (4x a bit filter) unless counts or decay are needed too;
    ``needs_merge`` or ``needs_resize`` with it picks the quotient engine,
    the only one with deletion and lossless union and grow-in-place."""
    best = None
    for name in names():
        eng = get(name)
        if ((needs_remove and not eng.supports_remove)
                or (needs_decay and not eng.supports_decay)
                or (needs_count and not eng.supports_count)
                or (needs_merge and not eng.supports_merge)
                or (needs_resize and not eng.supports_resize)):
            continue
        bpk = eng.bits_per_key(target_fpr)
        if bpk is not None and (best is None or bpk < best[0]):
            best = (bpk, name)
    if best is None:
        raise ValueError(
            f"no registered engine satisfies needs_remove={needs_remove}, "
            f"needs_decay={needs_decay}, needs_count={needs_count}, "
            f"needs_merge={needs_merge}, needs_resize={needs_resize} at "
            f"fpr {target_fpr:g}")
    return best[1]


def select(spec: FilterSpec, backend: str = "auto",
           ctx: Optional[SelectionContext] = None) -> Backend:
    """Resolve a backend name (or ``"auto"``/alias) to an engine."""
    ctx = ctx or SelectionContext.current()
    if backend in _ALIASES:
        backend = _ALIASES[backend](spec, ctx)
    if backend != "auto":
        eng = get(backend)
        if not eng.supports(spec, ctx):
            raise ValueError(f"backend {backend!r} does not support {spec} "
                             f"in context {ctx}")
        return eng
    ranked = sorted((eng.cost(spec, ctx), name)
                    for name, eng in _REGISTRY.items()
                    if eng.supports(spec, ctx))
    if not ranked:
        raise ValueError(f"no registered backend supports {spec} ({ctx})")
    return _REGISTRY[ranked[0][1]]
