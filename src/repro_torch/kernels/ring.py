"""Generation-ring membership kernel (the windowed filter's query) for
Hopper, and its plain PyTorch version.

Counterpart of ``repro.kernels.ring``. A windowed filter
(``repro_torch.window``) holds G same-spec generations stacked
``(G, n_words)``; a key is in the window iff it is in the OR of the
generations. The kernel hashes each key once and ORs the G rows of its
block before the one mask test, so the O(m) union is never built:

=================== ============================= ===========================
wrapper             replaces (repro/kernels/      CUDA kernel
                    ring.py)                      (csrc/ring.cu)
=================== ============================= ===========================
ring_contains_vmem  ring_contains_vmem (L2)       ring_contains_kernel,
                                                  DEPTH=1, PHI=min(s, 4)
ring_contains_hbm   ring_contains_hbm (DRAM)      ring_contains_kernel,
                                                  DEPTH=depth, PHI=min(s, 4)
=================== ============================= ===========================

``depth`` (keys per thread, their first loads in flight together) takes the
place of ``_ring_hbm_kernel``'s double-buffered DMA; it accepts the values
of ``sbf.DMA_DEPTHS`` and runs at most ``MAX_DEPTH``. The Pallas kernels'
key ``tile`` exists for the plain path's padding (``ops``), so the wrappers
take none.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
rings ``(G, n_words)``. For CPU tensors a wrapper runs the plain version
(:func:`ring_contains_ref`); for CUDA tensors it launches its kernel or
raises. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels import sbf
from repro_torch.kernels.sbf import DEFAULT_DMA_DEPTH, DMA_DEPTHS

MAX_DEPTH = 4        # keys per thread the kernel is instantiated for

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"ring_contains_vmem": 0, "ring_contains_hbm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ring_dense(rings: torch.Tensor) -> torch.Tensor:
    """(..., n_words) OR-fold of the (..., G, n_words) generations."""
    dense = rings[..., 0, :]
    for g in range(1, rings.shape[-2]):
        dense = dense | rings[..., g, :]
    return dense


def ring_contains_ref(spec: FilterSpec, rings: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
    """Plain version of both wrappers: contains against the OR-fold of all
    generations. (n,) bool."""
    return V.contains(spec, ring_dense(rings), keys)


def _on_cuda(rings: torch.Tensor, keys: torch.Tensor) -> bool:
    if rings.ndim != 2 or rings.shape[0] < 1:
        raise ValueError(f"rings must be (G, n_words) int32 with G >= 1, "
                         f"got {tuple(rings.shape)} {rings.dtype}")
    return sbf._on_cuda(rings[0], keys)


def _launch(name: str, spec: FilterSpec, rings: torch.Tensor,
            keys: torch.Tensor, depth: int) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = sbf._geometry(spec, rings[0], keys)
    if not rings.is_contiguous():
        raise ValueError("rings must be contiguous")
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.ring_contains(keys.data_ptr(), rings.data_ptr(),
                                out.data_ptr(),
                                sbf._salts(keys.device).data_ptr(), n,
                                spec.n_words, rings.shape[0], block_mask, s,
                                depth, variant, k, z, log2g, stream)
    sbf._raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def ring_contains_vmem(spec: FilterSpec, rings: torch.Tensor,
                       keys: torch.Tensor) -> torch.Tensor:
    """Ring membership, L2-resident regime. (n,) bool."""
    if not _on_cuda(rings, keys):
        return ring_contains_ref(spec, rings, keys)
    return _launch("ring_contains_vmem", spec, rings, keys, depth=1)


def ring_contains_hbm(spec: FilterSpec, rings: torch.Tensor,
                      keys: torch.Tensor, depth: int = DEFAULT_DMA_DEPTH
                      ) -> torch.Tensor:
    """Ring membership, DRAM-resident regime. (n,) bool."""
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not _on_cuda(rings, keys):
        return ring_contains_ref(spec, rings, keys)
    return _launch("ring_contains_hbm", spec, rings, keys,
                   depth=min(depth, MAX_DEPTH))
