"""Blocked Bloom filter kernels (sbf/bbf/rbbf/csbf) for Hopper, and their
plain PyTorch versions.

Counterpart of ``repro.kernels.sbf``. The four wrappers keep the JAX names,
so each row of the kernel table maps one to one:

=============== ================================ ===========================
wrapper         replaces (repro/kernels/sbf.py)  CUDA kernel (csrc/bloom.cu)
=============== ================================ ===========================
contains_vmem   contains_vmem (L2 regime)        bloom_contains_kernel,
                                                 DEPTH=1, PHI=min(phi, 4)
contains_hbm    contains_hbm (DRAM regime)       bloom_contains_kernel,
                                                 DEPTH=depth, PHI=min(s, 4)
add_vmem        add_vmem                         bloom_add_kernel
add_hbm         add_hbm                          bloom_add_kernel
=============== ================================ ===========================

Schedule axes. The kernels act on ``layout.phi`` (the vector width of the
block loads, capped at 4 words = 128 bits, the widest load) in
``contains_vmem`` and on ``depth`` (keys per thread, all their loads in
flight together) in ``contains_hbm``. At most 64 block words stay in flight
per thread, so ``depth`` is capped at ``64 // s`` for s >= 16. Every other
axis is accepted and validated as the JAX package does it, and runs the same
kernel: ``layout.theta`` and ``tile`` (a CUDA thread owns its keys; tiles
exist for the plain path's padding, so the DRAM wrappers take none),
``probe="gather"`` and ``coop="subtile"`` (the per-thread walk already is
the gather, and a thread stops at its first failing chunk), and
``mix="cheap"`` (the kernels always share the lane products of the two
hash streams, which gives the same hashes). No axis changes a result.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
filter words ``(n_words,)``. For CPU tensors a wrapper runs its plain
version (:func:`contains_plain`, :func:`add_plain`); for CUDA tensors it
launches its kernel or raises. The add wrappers update ``filt`` in place and
return it. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec

DEFAULT_TILE = 256
PROBES = ("loop", "gather")
COOPS = ("none", "subtile")
MIXES = ("full", "cheap")
DMA_DEPTHS = (1, 2, 4, 8)
DEFAULT_DMA_DEPTH = 2
MAX_WORDS_IN_FLIGHT = 64        # block words a contains thread holds

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0, "contains_hbm": 0,
            "add_hbm": 0}

_VARIANT_CODE = {"sbf": 0, "bbf": 1, "rbbf": 1, "csbf": 2}
_salts_on: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Layout:
    """(Θ, Φ) vectorization layout of the paper (§4.1).

    theta: keys processed per inner step; phi: contiguous words per load.
    On Hopper only phi acts (capped at 4 words by the 128-bit load)."""
    theta: int = 1
    phi: int = 8

    def validate(self, spec: FilterSpec, tile: int) -> "Layout":
        s = spec.s
        phi = min(self.phi, s)
        if not (_is_pow2(self.theta) and _is_pow2(phi)):
            raise ValueError(f"theta={self.theta}, phi={phi} must be powers "
                             f"of two")
        if s % phi:
            raise ValueError(f"phi={phi} must divide s={s}")
        if tile % self.theta:
            raise ValueError(f"theta={self.theta} must divide tile={tile}")
        return Layout(self.theta, phi)

    def __str__(self):
        return f"Θ{self.theta}Φ{self.phi}"


def default_layout(spec: FilterSpec, op: str) -> Layout:
    """The paper's empirically-optimal layouts (§5.2), as in the JAX package."""
    s = spec.s
    if op == "contains":
        theta = min(max(1, spec.block_bits // 256), 8)
        return Layout(theta, max(1, min(8, s // theta)))
    theta = min(s, 8)
    return Layout(theta, max(1, s // theta))


def _check_axes(probe: str = "loop", coop: str = "none", mix: str = "full"):
    if probe not in PROBES:
        raise ValueError(f"probe={probe!r} not in {PROBES}")
    if coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS}")
    if mix not in MIXES:
        raise ValueError(f"mix={mix!r} not in {MIXES}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def contains_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of ``contains_vmem`` and ``contains_hbm``: (n,) bool."""
    return V.contains(spec, filt, keys)


def add_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
              ) -> torch.Tensor:
    """Plain version of ``add_vmem`` and ``add_hbm``: new (n_words,) int32
    words (sort-and-segment OR; ``filt`` is not modified)."""
    return V.add_rows(spec, filt, keys)


# ---------------------------------------------------------------------------
# CUDA launch plumbing
# ---------------------------------------------------------------------------

def _on_cuda(filt: torch.Tensor, keys: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on anything else."""
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (n, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if filt.ndim != 1 or filt.dtype != torch.int32:
        raise ValueError(f"filter words must be (n_words,) int32, got "
                         f"{tuple(filt.shape)} {filt.dtype}")
    if filt.device != keys.device:
        raise ValueError(f"filter on {filt.device}, keys on {keys.device}")
    if filt.device.type == "cpu":
        return False
    if filt.device.type != "cuda":
        raise ValueError(f"unsupported device {filt.device}")
    return True


def _salts(device: torch.device) -> torch.Tensor:
    """(3, 96) int32 salt table on ``device`` (bit, word, group salts)."""
    if device not in _salts_on:
        table = np.stack([H.SALTS, H.WORD_SALTS, H.GROUP_SALTS])
        _salts_on[device] = torch.from_numpy(
            table.view(np.int32).copy()).to(device)
    return _salts_on[device]


def _geometry(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor):
    if spec.variant not in _VARIANT_CODE or spec.s > 32:
        raise ValueError(f"the CUDA kernels serve sbf/bbf/rbbf/csbf with "
                         f"s <= 32 words per block, not {spec}")
    if spec.n_words >= 1 << 31:
        raise ValueError(f"{spec} has {spec.n_words} words; block starts "
                         f"must fit int32")
    if filt.numel() != spec.n_words:
        raise ValueError(f"filter has {filt.numel()} words, spec "
                         f"{spec.n_words}")
    if not (keys.is_contiguous() and filt.is_contiguous()):
        raise ValueError("keys and filter words must be contiguous")
    if keys.data_ptr() % 8 or filt.data_ptr() % 16:
        raise ValueError("keys must be 8-byte and words 16-byte aligned")
    log2g = V._log2i(spec.g) if spec.variant == "csbf" else 0
    return (spec.n_blocks - 1, spec.s, _VARIANT_CODE[spec.variant], spec.k,
            spec.z, log2g)


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what}: no kernel instance for this shape")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _launch_contains(name: str, spec, filt, keys, phi: int, depth: int
                     ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, filt, keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.bloom_contains(keys.data_ptr(), filt.data_ptr(),
                                 out.data_ptr(), _salts(keys.device).data_ptr(),
                                 n, block_mask, s, phi, depth, variant, k, z,
                                 log2g, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _launch_add(name: str, spec, filt, keys) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, filt, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.bloom_add(keys.data_ptr(), filt.data_ptr(),
                            _salts(keys.device).data_ptr(), n, block_mask, s,
                            variant, k, z, log2g, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return filt


def _depth_in_flight(spec: FilterSpec, depth: int) -> int:
    return min(depth, max(1, MAX_WORDS_IN_FLIGHT // spec.s))


# ---------------------------------------------------------------------------
# The four wrappers
# ---------------------------------------------------------------------------

def contains_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  layout: Layout, tile: int = DEFAULT_TILE,
                  probe: str = "loop", coop: str = "none",
                  mix: str = "full") -> torch.Tensor:
    """Bulk membership, L2-resident regime. (n,) bool."""
    _check_axes(probe, coop, mix)
    layout = layout.validate(spec, tile)
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_vmem", spec, filt, keys,
                            phi=min(layout.phi, 4), depth=1)


def add_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
             layout: Layout, tile: int = DEFAULT_TILE, probe: str = "loop",
             coop: str = "none", mix: str = "full") -> torch.Tensor:
    """Bulk insert, L2-resident regime; updates ``filt`` in place."""
    _check_axes(probe, coop, mix)
    layout.validate(spec, tile)
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    return _launch_add("add_vmem", spec, filt, keys)


def contains_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 depth: int = DEFAULT_DMA_DEPTH, coop: str = "none",
                 mix: str = "full") -> torch.Tensor:
    """Bulk membership, DRAM-resident regime. (n,) bool."""
    _check_axes(coop=coop, mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_hbm", spec, filt, keys,
                            phi=min(spec.s, 4),
                            depth=_depth_in_flight(spec, depth))


def add_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
            coop: str = "none", mix: str = "full") -> torch.Tensor:
    """Bulk insert, DRAM-resident regime; updates ``filt`` in place."""
    _check_axes(coop=coop, mix=mix)
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    return _launch_add("add_hbm", spec, filt, keys)
