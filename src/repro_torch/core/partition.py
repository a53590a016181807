"""Scatter of flat keys into fixed-shape per-bucket batches.

Counterpart of ``repro.core.partition``: tenant routing
(``repro_torch.api.route``, the generic bank path of ``api.registry``)
scatters flat ``(keys, ids)`` into ``(n_buckets, capacity)`` batches with a
validity mask (``route_by_id``), and the partitioned updates
(``kernels.ops.bloom_add_partitioned`` / ``counting_update_partitioned``)
bucket keys by the filter segment their block falls in, so that each
kernel CTA owns one segment (``segment_ids``, ``partition_jit``, and the
exact-capacity numpy form ``partition_host``). Keys beyond a bucket's
capacity do not fit; they go to a spare bin that is cut off, and ``keep`` /
``overflow`` report them, so no key is lost silently.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core.variants import FilterSpec


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


def segment_ids(spec: FilterSpec, keys: torch.Tensor, n_segments: int
                ) -> torch.Tensor:
    """(n,) int32 segment owning each key's block; segments are contiguous
    block ranges of ``n_blocks / n_segments`` blocks. ``keys`` are u64x2
    ``(n, 2)`` or u32 ``(n,)``."""
    if n_segments < 1 or spec.n_blocks % n_segments:
        raise ValueError(f"n_segments={n_segments} must divide the "
                         f"{spec.n_blocks} blocks of {spec}")
    blocks_per_seg = spec.n_blocks // n_segments
    if keys.ndim >= 1 and keys.shape[-1] == 2:
        h2 = H.xxh32_u64x2(keys, H.SEED_BLOCK)
    else:
        h2 = H.xxh32_u32(keys, H.SEED_BLOCK)
    blk = H.block_index(h2, spec.n_blocks)
    return (blk // blocks_per_seg).to(torch.int32)


def partition_host(spec: FilterSpec, keys, n_segments: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact partition on the host: (keys_by_seg (S, cap, 2) int32 [hi, lo],
    valid (S, cap) uint8, counts (S,) int64), CPU tensors; ``cap`` is the
    largest segment's count rounded up to a multiple of 8 (at least 8).
    Within a segment the keys keep their order."""
    keys = torch.as_tensor(keys).cpu()
    keys_np = keys.numpy().view(np.uint32) if keys.dtype == torch.int32 \
        else keys.numpy().astype(np.uint32)
    seg = segment_ids(spec, torch.from_numpy(keys_np.view(np.int32)),
                      n_segments).numpy()
    counts = np.bincount(seg, minlength=n_segments)
    cap = max(int(counts.max()) if counts.size else 0, 1)
    cap = (cap + 7) & ~7
    out = np.zeros((n_segments, cap, 2), dtype=np.uint32)
    valid = np.zeros((n_segments, cap), dtype=np.uint8)
    order = np.argsort(seg, kind="stable")
    sorted_keys = keys_np[order]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for sidx in range(n_segments):
        lo, hi = offsets[sidx], offsets[sidx + 1]
        out[sidx, : hi - lo] = sorted_keys[lo:hi]
        valid[sidx, : hi - lo] = 1
    return (torch.from_numpy(out.view(np.int32)), torch.from_numpy(valid),
            torch.from_numpy(counts.astype(np.int64)))


def partition_jit(spec: FilterSpec, keys: torch.Tensor, n_segments: int,
                  capacity: int) -> JitPartition:
    """Partition with a fixed per-segment ``capacity``, on the keys' device
    (no host sync). Keys beyond a segment's capacity are reported by
    ``keep``/``overflow``, never dropped silently: the caller escalates the
    capacity or runs a residual pass over ``~keep``."""
    seg = segment_ids(spec, keys, n_segments)
    return route_by_id(keys, seg, n_segments, capacity, check=False)


def route_by_id(keys: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                capacity: int, check: bool = True) -> JitPartition:
    """Scatter flat ``keys`` (n, 2) into per-bucket batches by ``ids`` (n,)
    in ``[0, n_buckets)``. A key's slot is its stable rank among the keys
    of its bucket; ranks at or beyond ``capacity`` go to the spare bin.
    ``check=False`` skips the range check (and its host sync) for ids that
    lie in range by construction."""
    n = keys.shape[0]
    dev = keys.device
    ids = ids.to(device=dev, dtype=torch.int64)
    if check:
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
