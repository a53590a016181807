"""The immutable ``Filter``: one interface over every engine.

Counterpart of ``repro.api.filter`` for a scalar filter. A ``Filter`` holds
its spec, its words (the engine's int32 storage on the filter's device:
``(n_words,)`` bits, ``(storage_words,)`` counters for the counting engine,
or a ``(G, n_words)`` ring for the windowed engine), its engine name, its
engine options and its engine state (the windowed engine's ring head, a
Python ``int``; ``None`` elsewhere). Every operation that looks like a
mutation returns a new ``Filter`` and leaves the old one as it was: the
engines clone the words before an update, as JAX's immutable arrays behave.

``remove`` and ``decay`` run on engines that support them (``counting``),
``advance`` on the ``windowed`` engine, and each raises the JAX package's
``NotImplementedError`` elsewhere. Banks and routed ops are a later slice
of the port; they raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.api import registry
from repro_torch.window.ring import ring_merge_dense


@dataclasses.dataclass(frozen=True)
class BackendOptions:
    """Kernel parameters carried by a filter. ``layout``/``tile``/``probe``/
    ``depth``/``coop``/``mix`` are validated and passed to
    ``kernels.ops``; ``"auto"`` and ``None`` resolve to its fixed defaults."""

    layout: Optional[object] = None    # kernels.sbf.Layout
    tile: Optional[int] = None
    probe: str = "auto"                # "loop" | "gather" | "auto"
    depth: Optional[int] = None        # DRAM-regime keys per thread
    coop: str = "auto"                 # "none" | "subtile" | "auto"
    mix: str = "auto"                  # "full" | "cheap" | "auto"
    generations: Optional[int] = None  # windowed engine: ring size G

    def ctx(self, device=None) -> registry.SelectionContext:
        return registry.SelectionContext.current(
            device=device, generations=self.generations)


def _int32_bits(x) -> torch.Tensor:
    """A tensor or array of u32 values as an int32 tensor of the same bits
    (torch cannot wrap a read-only array, such as a JAX array's view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32)
        return x if x.dtype == torch.int32 else H.to_i32(H.u32(x))
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32, copy=False))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32))


def as_keys(keys, device=None) -> torch.Tensor:
    """Keys as a contiguous ``(n, 2)`` int32 ``[hi, lo]`` tensor on ``device``
    (``None`` keeps a tensor's own device, and puts arrays on the CPU).

    Accepts ``np.uint64`` keys ``(n,)``, ``(n, 2)`` u32 arrays, and torch
    tensors of ``(n, 2)`` int32, uint32 or int64 u32 values."""
    if isinstance(keys, np.ndarray) and keys.dtype == np.uint64:
        keys = H.u64x2_from_u64(keys)
    keys = _int32_bits(keys)
    if keys.ndim != 2 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (n, 2) [hi, lo] words or (n,) "
                         f"np.uint64; got shape {tuple(keys.shape)}")
    if device is not None:
        keys = keys.to(device)
    return keys.contiguous()


def as_words(words, device=None) -> torch.Tensor:
    """Filter words (u32 array or int32/uint32 tensor) as a contiguous int32
    tensor on ``device``, bits unchanged."""
    words = _int32_bits(words)
    if device is not None:
        words = words.to(device)
    return words.contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class Filter:
    """Immutable Bloom filter bound to a registry engine.

    Build one with :func:`repro_torch.api.make_filter` /
    :func:`repro_torch.api.filter_for_n_items`, or :meth:`from_state`.
    ``eq=False``: compare ``dense_words()`` to test equality."""

    spec: FilterSpec
    words: torch.Tensor
    backend: str = "torch"
    options: BackendOptions = BackendOptions()
    state: Optional[int] = None        # engine state (the ring head)

    @property
    def engine(self) -> registry.Backend:
        return registry.get(self.backend)

    @property
    def head(self) -> Optional[int]:
        """Windowed engine: the generation that takes inserts."""
        return self.state

    @property
    def device(self) -> torch.device:
        return self.words.device

    def replace(self, **kw) -> "Filter":
        return dataclasses.replace(self, **kw)

    # -- bulk ops ------------------------------------------------------------
    def _check_scalar_form(self, op: str, tenants, valid) -> None:
        if tenants is not None:
            raise not_ported(f"routed (bank) {op}", "queue 1 item 7")
        if valid is not None:
            raise ValueError(f"valid= masks apply to bank ops only; filter "
                             f"the keys instead for a scalar {op}")

    def add(self, keys, tenants=None, valid=None) -> "Filter":
        """Insert ``keys`` (OR the bits, or increment the counters); returns
        the updated filter (self unchanged)."""
        self._check_scalar_form("add", tenants, valid)
        keys = as_keys(keys, self.device)
        if keys.shape[0] == 0:
            return self
        if self.state is None:
            new = self.engine.add(self.spec, self.words, keys, self.options)
        else:
            new = self.engine.add(self.spec, self.words, keys, self.options,
                                  state=self.state)
        return self.replace(words=new)

    def contains(self, keys, tenants=None) -> torch.Tensor:
        """Membership: (n,) bool on the filter's device. No false
        negatives; false positives at about ``fpr_theory``."""
        if tenants is not None:
            raise not_ported("routed (bank) contains", "queue 1 item 7")
        keys = as_keys(keys, self.device)
        if keys.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.bool, device=self.device)
        return self.engine.contains(self.spec, self.words, keys, self.options)

    def remove(self, keys, tenants=None, valid=None) -> "Filter":
        """Delete keys (counting engine): guarded decrements (a counter at 0
        stays 0, one at 15 stays 15). Removing keys that were added leaves
        no false negative among the keys still present; removing a key that
        was never added can clear a counter it shares with one."""
        if not self.engine.supports_remove:
            raise NotImplementedError(
                f"backend {self.backend!r} cannot remove keys; build the "
                f"filter with variant='countingbf' (engine 'counting'), "
                f"variant='cuckoo' or variant='quotient' (~1x storage)")
        self._check_scalar_form("remove", tenants, valid)
        keys = as_keys(keys, self.device)
        if keys.shape[0] == 0:
            return self
        return self.replace(words=self.engine.remove(
            self.spec, self.words, keys, self.options))

    def decay(self, steps: int = 1) -> "Filter":
        """Age the filter: ``steps`` uniform decrements of every nonzero
        counter (counting engine). Keys inserted once disappear after one
        step; keys re-inserted every step persist."""
        if not self.engine.supports_decay:
            raise NotImplementedError(
                f"backend {self.backend!r} cannot decay; build the filter "
                f"with variant='countingbf' (engine 'counting')")
        out = self
        for _ in range(steps):
            out = out.replace(words=out.engine.decay(out.spec, out.words,
                                                     out.options))
        return out

    def advance(self) -> "Filter":
        """Slide the window one generation (windowed engine only): the
        oldest generation is cleared in O(1) in keys and becomes the new
        insert target."""
        if not self.engine.supports_advance:
            raise NotImplementedError(
                f"backend {self.backend!r} cannot advance; build the filter "
                f"with generations=G (engine 'windowed')")
        words, state = self.engine.advance(self.spec, self.words,
                                           self.options, state=self.state)
        return self.replace(words=words, state=state)

    def merge(self, other: "Filter") -> "Filter":
        """Union. Same spec required; engines and devices may differ (the
        result lives on self's engine and device). A windowed self lands
        the other filter's dense union in its own head generation (rings
        cannot be merged slot by slot: slot g is a different age class in
        each). Otherwise, same engine and shape: the engine's own merge (OR
        for bits, a saturating counter add for the counting engine); else
        the OR of the dense words, re-homed into self's engine."""
        if other.spec != self.spec:
            raise ValueError(f"cannot merge {other.spec} into {self.spec}")
        if self.engine.supports_advance:
            new = ring_merge_dense(self.words, self.state,
                                   other.dense_words().to(self.device))
        elif (other.backend == self.backend
                and other.words.shape == self.words.shape):
            new = self.engine.merge(self.spec, self.words,
                                    other.words.to(self.device), self.options)
        else:
            dense = other.dense_words().to(self.device)
            new = self.engine.from_dense(self.spec,
                                         self.dense_words() | dense,
                                         self.options)
        return self.replace(words=new)

    __or__ = merge

    # -- introspection -------------------------------------------------------
    def dense_words(self) -> torch.Tensor:
        """Canonical (n_words,) int32 words (u32 bits)."""
        return self.engine.to_dense(self.spec, self.words, self.options)

    def fill_fraction(self) -> float:
        return V.fill_fraction(self.dense_words())

    def fpr_theory(self, n: int) -> float:
        """Analytic FPR at load n."""
        return V.fpr_theory(self.spec, n)

    def measure_fpr(self, n_probe: int = 1 << 16, seed: int = 1234) -> float:
        """Empirical FPR against probes from the reserved keyspace
        (``hashing.probe_u64x2``), disjoint from every insert set."""
        probes = as_keys(H.probe_u64x2(n_probe, seed=seed), self.device)
        hits = self.contains(probes)
        return float(hits.to(torch.float64).mean().item())

    def approx_count(self) -> float:
        """Swamidass-Baldi estimate of the distinct keys inserted."""
        fill = min(self.fill_fraction(), 1.0 - 1e-12)
        return max(0.0, -(self.spec.m_bits / self.spec.k)
                   * math.log(1.0 - fill))

    @property
    def nbytes(self) -> int:
        return int(self.words.numel()) * self.words.element_size()

    # -- checkpointing -------------------------------------------------------
    def to_state(self) -> dict:
        """Engine-independent state: dense words (occupancy bits for the
        counting engine, the ring's union for the windowed engine) + spec
        fields + engine, and a windowed filter's ring size under
        ``"options"``. The head is not recorded: the dense form collapses
        the age classes, so :meth:`from_state` restores the union into
        generation 0 with head 0."""
        state = {"words": self.dense_words(),
                 "spec": dataclasses.asdict(self.spec),
                 "backend": self.backend}
        if self.options.generations is not None:
            state["options"] = {"generations": self.options.generations}
        return state

    @classmethod
    def from_state(cls, state: dict, backend: Optional[str] = None,
                   options: BackendOptions = BackendOptions(),
                   device=None) -> "Filter":
        """Rebuild a filter from :meth:`to_state` output (or the JAX
        package's, whose engine names are registered as aliases).
        ``device=None`` is the card. A windowed state comes back windowed,
        with its ring size, unless ``backend=`` names another engine (which
        then takes the dense union)."""
        if state.get("bank_shape"):
            raise not_ported("filter banks", "queue 1 item 7")
        if "engine_state" in state:
            raise not_ported("fingerprint engine state", "queue 1 item 9")
        spec = FilterSpec(**{k: (v if isinstance(v, str) else int(v))
                             for k, v in state["spec"].items()})
        name = backend or state.get("backend", "auto")
        st_opts = state.get("options") or {}
        if (name == "windowed" and options.generations is None
                and "generations" in st_opts):
            options = dataclasses.replace(
                options, generations=int(st_opts["generations"]))
        ctx = options.ctx(device)
        eng = registry.select(spec, name, ctx)
        words = as_words(state["words"], ctx.device)
        if words.shape != (spec.n_words,):
            raise ValueError(f"state words {tuple(words.shape)} do not match "
                             f"{spec} ({spec.n_words} dense words)")
        return cls(spec=spec, words=eng.from_dense(spec, words, options),
                   backend=eng.name, options=options,
                   state=eng.init_state(spec, options))

    def __repr__(self):
        return (f"Filter({self.spec}, backend={self.backend!r}, "
                f"words={tuple(self.words.shape)}, device={self.device})")
