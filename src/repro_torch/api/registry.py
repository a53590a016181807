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
=========== ==============================================================

The JAX engine names are registered as aliases (see ``repro_torch.api``),
so a state dict written by the JAX package names a port engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.variants import FilterSpec


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Everything ``supports``/``cost`` may rank on, besides the spec."""

    device: torch.device
    generations: Optional[int] = None  # ring size -> the windowed engine

    @classmethod
    def current(cls, device=None, generations: Optional[int] = None
                ) -> "SelectionContext":
        from repro_torch import resolve_device
        return cls(device=resolve_device(device), generations=generations)


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

    def init_state(self, spec: FilterSpec, options):
        """Per-filter engine state beside the words (``Filter.state``): the
        windowed engine's ring head; ``None`` for every other engine."""
        return None

    def to_dense(self, spec: FilterSpec, words: torch.Tensor, options
                 ) -> torch.Tensor:
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
