"""Classical Bloom filter kernels (cbf) for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.cbf``. The two wrappers keep the JAX names,
so each row of the kernel table maps one to one:

=============== ================================ ===========================
wrapper         replaces (repro/kernels/cbf.py)  CUDA kernel (csrc/cbf.cu)
=============== ================================ ===========================
contains_vmem   contains_vmem                    cbf_contains_kernel
add_vmem        add_vmem                         cbf_add_kernel
=============== ================================ ===========================

One kernel pair for both sizes. The JAX package has only a VMEM-resident
cbf kernel and runs larger classical filters on its jnp engine: a DRAM cbf
on the TPU would need k DMAs a key. On Hopper a probe is one load wherever
its word lives, so ``kernels.ops`` calls these two wrappers for a classical
filter in L2 and for one in DRAM alike; the regime never changes a result.
The Pallas kernels' key ``tile`` exists for the plain path's padding
(``ops``), so the wrappers take none: a CUDA thread owns its key.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
filter words ``(n_words,)``. For CPU tensors a wrapper runs its plain
version (:func:`contains_plain`, :func:`add_plain`); for CUDA tensors it
launches its kernel or raises. ``add_vmem`` updates ``filt`` in place and
returns it. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import _on_cuda, _raise_on, _salts

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def contains_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of ``contains_vmem``: (n,) bool."""
    return V.contains(spec, filt, keys)


def add_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
              ) -> torch.Tensor:
    """Plain version of ``add_vmem``: new (n_words,) int32 words (the
    batch's unique bit positions ORed in; ``filt`` is not modified)."""
    return V.add_scatter(spec, filt, keys)


def _geometry(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
              ) -> int:
    """log2 m of a classical spec whose tensors the kernels take."""
    if spec.variant != "cbf" or spec.m_bits > 1 << 32:
        raise ValueError(f"the cbf kernels serve classical filters of at "
                         f"most 2^32 bits, not {spec}")
    if filt.numel() != spec.n_words:
        raise ValueError(f"filter has {filt.numel()} words, spec "
                         f"{spec.n_words}")
    if not (keys.is_contiguous() and filt.is_contiguous()):
        raise ValueError("keys and filter words must be contiguous")
    if keys.data_ptr() % 8 or filt.data_ptr() % 4:
        raise ValueError("keys must be 8-byte and words 4-byte aligned")
    return V._log2i(spec.m_bits)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def contains_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
                  ) -> torch.Tensor:
    """Bulk membership, k single-bit probes a key. (n,) bool."""
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    from repro_torch.kernels._build import library
    log2m = _geometry(spec, filt, keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.cbf_contains(keys.data_ptr(), filt.data_ptr(),
                               out.data_ptr(), _salts(keys.device).data_ptr(),
                               n, log2m, spec.k, _stream(keys.device))
    _raise_on(err, "contains_vmem")
    LAUNCHES["contains_vmem"] += 1
    return out


def add_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
             ) -> torch.Tensor:
    """Bulk insert, k single-bit sets a key; updates ``filt`` in place."""
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    from repro_torch.kernels._build import library
    log2m = _geometry(spec, filt, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.cbf_add(keys.data_ptr(), filt.data_ptr(),
                          _salts(keys.device).data_ptr(), n, log2m, spec.k,
                          _stream(keys.device))
    _raise_on(err, "add_vmem")
    LAUNCHES["add_vmem"] += 1
    return filt
