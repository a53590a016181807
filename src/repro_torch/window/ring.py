"""Generation-ring aging: sliding-window membership without per-key deletes.

Counterpart of ``repro.window.ring``. A :class:`WindowedFilter` holds G
same-spec generation sub-filters stacked ``(G, n_words)`` plus a head index:

* ``add`` inserts into the **head** generation only;
* ``contains`` ORs the whole ring inside the probe (one launch of the
  generation-ring kernel on the card, ``kernels/ring.py``); the head is
  irrelevant to queries;
* ``advance()`` rotates the head to the oldest slot and zeroes it: O(1) in
  keys (one sub-filter cleared, no rehashing), retiring every key whose last
  insert was G or more advances ago.

A key inserted into generation g stays queryable for at least G-1 and at
most G advances.

The pure ``ring_*`` functions are the engine seam: both
:class:`WindowedFilter` and the ``"windowed"`` registry engine
(``repro_torch.api.backends``) call them, so the two surfaces agree bit for
bit. They never modify their input ring: each returns a new one (one clone
of the ``(G, n_words)`` ring), as JAX's immutable arrays behave.

The head is host state, a Python ``int``. The JAX package carries it as a
traced device scalar only so that ``jit``/``scan`` do not retrace on a
window slide; eager PyTorch has no retrace to avoid, and a device scalar
would cost a host sync on every add.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ring import ring_dense

# ---------------------------------------------------------------------------
# Pure ring transforms (engine seam)
# ---------------------------------------------------------------------------


def ring_init(spec: FilterSpec, generations: int, device=None
              ) -> torch.Tensor:
    """Zeroed ``(generations, n_words)`` int32 ring."""
    if generations < 2:
        raise ValueError(f"a ring needs >= 2 generations to slide, got "
                         f"{generations}")
    if spec.is_counting:
        raise ValueError("ring generations are bit filters, not counters")
    return torch.zeros((generations, spec.n_words), dtype=torch.int32,
                       device=device)


def ring_add(spec: FilterSpec, rings: torch.Tensor, keys: torch.Tensor,
             head: int) -> torch.Tensor:
    """Insert into the head generation: one bulk add into the head row of a
    copy of the ring (the head row is a contiguous view, so the add runs in
    place there; its regime comes from one generation's bytes)."""
    out = rings.clone()
    ops.bloom_add(spec, out[head], keys, inplace=True)
    return out


def ring_contains_dispatch(spec: FilterSpec, rings: torch.Tensor,
                           keys: torch.Tensor) -> torch.Tensor:
    """Fused OR-ring membership (the ring kernel on the card, the OR-fold
    and one row gather per key on the CPU)."""
    return ops.ring_contains(spec, rings, keys)


def ring_advance(rings: torch.Tensor, head: int) -> tuple:
    """Retire the oldest generation: it becomes the new, empty head.
    Returns (new ring, new head)."""
    new_head = (head + 1) % rings.shape[0]
    out = rings.clone()
    out[new_head].zero_()
    return out, new_head


def ring_merge_dense(rings: torch.Tensor, head: int, dense: torch.Tensor
                     ) -> torch.Tensor:
    """OR a dense key-set union into the HEAD generation.

    Two rings cannot be ORed slot by slot: their heads generally differ, so
    slot g holds a different age class in each, and a later advance would
    retire merged keys early (a false negative inside the window). Landing
    the other union in the head is conservative: merged keys join the
    newest age class and live at least G-1 more advances."""
    out = rings.clone()
    out[head] |= dense
    return out


# ---------------------------------------------------------------------------
# WindowedFilter — the convenience surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class WindowedFilter:
    """Immutable sliding-window Bloom filter over a generation ring.

    ``rings`` is the ``(G, n_words)`` int32 ring on the filter's device and
    ``head`` the generation that takes inserts."""

    spec: FilterSpec
    rings: torch.Tensor
    head: int = 0

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, variant: str = "sbf", m_bits: int = 1 << 20, k: int = 8,
               block_bits: int = 256, z: int = 1, generations: int = 4,
               device=None) -> "WindowedFilter":
        """An empty ring on ``device`` (``None`` = the card)."""
        spec = FilterSpec(variant=variant, m_bits=m_bits, k=k,
                          block_bits=block_bits, z=z)
        return cls(spec=spec, rings=ring_init(spec, generations,
                                              resolve_device(device)))

    @classmethod
    def for_window(cls, window_keys: int, bits_per_key: float = 16.0,
                   generations: int = 4, variant: str = "sbf",
                   block_bits: int = 256, device=None) -> "WindowedFilter":
        """Size the ring for a sliding window of ``window_keys`` at c
        bits/key.

        Generations share hash functions, so the queried union behaves like
        one m-bit filter holding the whole window: each generation is sized
        for the full window load, and the ring costs G x m bits (the price
        of O(1) eviction)."""
        n = max(window_keys, 1)
        m = 1 << max(int(np.ceil(np.log2(n * bits_per_key))), 10)
        s = block_bits // V.WORD_BITS
        k = max(int(round(V.optimal_k(m / n))), 1)
        if variant == "sbf":
            k = max(s, (k // s) * s) if k >= s else k
        k = min(k, 32)
        return cls.create(variant=variant, m_bits=m, k=k,
                          block_bits=block_bits, generations=generations,
                          device=device)

    # -- ops -----------------------------------------------------------------
    @property
    def generations(self) -> int:
        return self.rings.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rings.device

    def add(self, keys) -> "WindowedFilter":
        from repro_torch.api.filter import as_keys
        keys = as_keys(keys, self.device)
        if keys.shape[0] == 0:
            return self
        return dataclasses.replace(
            self, rings=ring_add(self.spec, self.rings, keys, self.head))

    def contains(self, keys) -> torch.Tensor:
        from repro_torch.api.filter import as_keys
        keys = as_keys(keys, self.device)
        if keys.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.bool, device=self.device)
        return ring_contains_dispatch(self.spec, self.rings, keys)

    def advance(self) -> "WindowedFilter":
        """Slide the window: drop the oldest generation, open a fresh head."""
        rings, head = ring_advance(self.rings, self.head)
        return dataclasses.replace(self, rings=rings, head=head)

    # -- introspection -------------------------------------------------------
    def dense_words(self) -> torch.Tensor:
        return ring_dense(self.rings)

    def fill_fraction(self) -> float:
        """Fill of the ring union (the quantity governing the window FPR)."""
        return V.fill_fraction(self.dense_words())

    def generation_fill(self) -> np.ndarray:
        """(G,) per-generation fill: a saw-tooth in steady state."""
        return np.array([V.fill_fraction(self.rings[g])
                         for g in range(self.generations)])

    def fpr_theory(self, window_n: int) -> float:
        """Analytic FPR with ``window_n`` keys spread across the ring: the
        union of G same-spec filters at load n/G each behaves like one
        filter at load n."""
        return V.fpr_theory(self.spec, window_n)

    def measure_fpr(self, n_probe: int = 1 << 16, seed: int = 1234) -> float:
        """Empirical FPR against probes from the reserved keyspace."""
        hits = self.contains(H.probe_u64x2(n_probe, seed=seed))
        return float(hits.to(torch.float64).mean().item())

    @property
    def nbytes(self) -> int:
        return self.generations * self.spec.m_bits // 8

    def __repr__(self):
        return (f"WindowedFilter({self.spec}, G={self.generations}, "
                f"head={self.head})")
