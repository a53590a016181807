"""Plain oracles for the kernels in this package.

Counterpart of ``repro.kernels.ref``: each pins the (spec, filter, keys) ->
result contract that the kernels reproduce bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec


def bloom_contains_ref(spec: FilterSpec, filt: torch.Tensor,
                       keys: torch.Tensor) -> torch.Tensor:
    """(n,) bool — oracle for every contains kernel."""
    return V.contains(spec, filt, keys)


def bloom_add_ref(spec: FilterSpec, filt: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """(n_words,) int32 — oracle for every add kernel. ``add_loop`` inserts
    in key order; OR commutes and is idempotent, so any order (the kernels'
    atomics included) gives the same words."""
    return V.add_loop(spec, filt, keys)


def hash_block_masks_ref(spec: FilterSpec, keys: torch.Tensor):
    """(block index (n,), masks (n, s)) of each key."""
    h1, h2 = H.hash_keys(keys)
    return H.block_index(h2, spec.n_blocks), V.block_patterns(spec, h1)
