"""Scatter of flat keys into fixed-shape per-bucket batches.

Counterpart of ``repro.core.partition.JitPartition`` and ``route_by_id``:
tenant routing (``repro_torch.api.route``, the generic bank path of
``api.registry``) scatters flat ``(keys, ids)`` into ``(n_buckets,
capacity)`` batches with a validity mask. Keys beyond a bucket's capacity
do not fit; they go to a spare bin that is cut off, and ``keep`` /
``overflow`` report them, so no key is lost silently. The hash-segment
partition (``segment_ids``, ``partition_*``) comes with the partitioned
updates (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class JitPartition(NamedTuple):
    """Result of :func:`route_by_id` (tensors on the keys' device).

    ``keep`` marks the keys that landed inside their bucket's capacity;
    ``overflow`` counts the ones that did not (they are absent from
    ``keys_by_seg`` and the caller must handle them)."""

    keys_by_seg: torch.Tensor   # (n_buckets, capacity, 2) int32 (u32 bits)
    valid: torch.Tensor         # (n_buckets, capacity) uint8
    keep: torch.Tensor          # (n,) bool: the key survived into its bucket
    overflow: torch.Tensor      # () int64: number of dropped keys
    rank: torch.Tensor          # (n,) int64: the key's slot in its bucket


def check_ids(ids: torch.Tensor, n_buckets: int) -> None:
    """Raise ``ValueError`` unless every id lies in ``[0, n_buckets)`` (one
    reduction; a host sync for a CUDA tensor)."""
    if ids.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.stack(torch.aminmax(ids)).tolist())
    if lo < 0 or hi >= n_buckets:
        raise ValueError(f"ids must lie in [0, {n_buckets}); got values in "
                         f"[{lo}, {hi}]")


def route_by_id(keys: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                capacity: int) -> JitPartition:
    """Scatter flat ``keys`` (n, 2) into per-bucket batches by ``ids`` (n,)
    in ``[0, n_buckets)``. A key's slot is its stable rank among the keys
    of its bucket; ranks at or beyond ``capacity`` go to the spare bin."""
    n = keys.shape[0]
    dev = keys.device
    ids = ids.to(device=dev, dtype=torch.int64)
    check_ids(ids, n_buckets)
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    idx_in_run = (torch.arange(n, device=dev)
                  - torch.searchsorted(sorted_ids, sorted_ids, right=False))
    rank = torch.empty((n,), dtype=torch.int64, device=dev)
    rank[order] = idx_in_run
    keep = rank < capacity
    spare = n_buckets * capacity
    slot = torch.where(keep, ids * capacity + rank, spare)
    flat_keys = torch.zeros((spare + 1, 2), dtype=torch.int32, device=dev)
    flat_keys[slot] = keys.to(torch.int32)
    flat_valid = torch.zeros((spare + 1,), dtype=torch.uint8, device=dev)
    flat_valid[slot] = 1
    return JitPartition(
        flat_keys[:-1].reshape(n_buckets, capacity, 2),
        flat_valid[:-1].reshape(n_buckets, capacity),
        keep, n - keep.sum(), rank)
