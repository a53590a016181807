"""Calibration probe kernels for Hopper, and their plain PyTorch versions.

Counterpart of the Pallas kernel of ``repro.perfmodel.calibrate.
measure_step_us`` and, as kernels, of the two jnp probes beside it whose
eager PyTorch form would time launches instead of the card:

=========== ====================================== ==========================
wrapper     replaces (repro/perfmodel/              CUDA kernel
            calibrate.py)                           (csrc/calibrate.cu)
=========== ====================================== ==========================
step        measure_step_us's inline ``kern``       step_kernel, one CTA an
            (``pallas_call``, grid ``(g,)``)        (8, 128) block
chain       measure_gops (jnp ``fori_loop``)        chain_kernel
gather      measure_bw_res (jnp ``take``)           gather_kernel
=========== ====================================== ==========================

* :func:`step`: ``o = x + 1`` (u32 wrap) on an ``(8 g, 128)`` tensor, one
  CTA a block; the probe times it at two grids.
* :func:`chain`: thread t runs ``a = a * CHAIN_MUL + CHAIN_ADD`` for
  ``iters`` dependent steps from ``a = t`` (u32 wrap) and writes ``a``.
* :func:`gather`: thread t of n sums ``table[mix32(t + j n) & (len - 1)]``
  over ``j < per_thread`` (u32 wrap); :func:`mix32` is the lowbias32 hash.

Wrappers take ``int32`` tensors (u32 bits) and write into the ``out`` they
are given. For CPU tensors a wrapper runs its plain version; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches per wrapper. :func:`blocks_per_sm` and :func:`sm_count` size the
probes' grids from the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing as H
from repro_torch.kernels.sbf import _raise_on

THREADS = 256                  # threads a CTA, every calibration kernel
BLOCK_ROWS, BLOCK_COLS = 8, 128   # the Pallas probe's (8, 128) u32 block
CHAIN_MUL = 2654435761         # the JAX probe's chain constants
CHAIN_ADD = 0x9E3779B9
CHAIN_UNROLL = 16              # iters must be a multiple of this
KERNELS = {"step": 0, "chain": 1, "gather": 2}

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"step": 0, "chain": 0, "gather": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA int32 contiguous inputs on one device, False for CPU
    ones; raises on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"expected a contiguous int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# step: o = x + 1 on (8, 128) blocks
# ---------------------------------------------------------------------------

def step_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`step`: ``x + 1`` in u32 arithmetic."""
    return H.to_i32((H.u32(x) + 1) & H.M32)


def step(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = x + 1`` (u32 wrap) for ``x``, ``out`` ``(8 g, 128)`` int32:
    one CTA a block, ``g`` CTAs. Returns ``out``."""
    if (x.ndim != 2 or x.shape[1] != BLOCK_COLS or x.shape[0] == 0
            or x.shape[0] % BLOCK_ROWS or out.shape != x.shape):
        raise ValueError(f"x and out must be (8 g, 128) with g >= 1, got "
                         f"{tuple(x.shape)} and {tuple(out.shape)}")
    if not _on_cuda(x, out):
        return out.copy_(step_plain(x))
    from repro_torch.kernels._build import library
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.calibrate_step(x.data_ptr(), out.data_ptr(),
                                 x.shape[0] // BLOCK_ROWS, _stream(x.device))
    _raise_on(err, "step")
    LAUNCHES["step"] += 1
    return out


# ---------------------------------------------------------------------------
# chain: dependent u32 multiply-add steps, one chain a thread
# ---------------------------------------------------------------------------

def chain_plain(n: int, iters: int, device) -> torch.Tensor:
    """Plain version of :func:`chain`: (n,) int32."""
    a = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(iters):
        a = (H._mul32(a, CHAIN_MUL) + CHAIN_ADD) & H.M32
    return H.to_i32(a)


def chain(out: torch.Tensor, iters: int) -> torch.Tensor:
    """Thread t of ``out.numel()`` runs ``iters`` dependent steps ``a = a *
    CHAIN_MUL + CHAIN_ADD`` from ``a = t`` and writes ``a`` to ``out[t]``
    (``out`` (n,) int32; ``iters`` a positive multiple of 16)."""
    if out.ndim != 1 or out.shape[0] == 0:
        raise ValueError(f"out must be (n,) with n >= 1, got "
                         f"{tuple(out.shape)}")
    if iters <= 0 or iters % CHAIN_UNROLL:
        raise ValueError(f"iters={iters} must be a positive multiple of "
                         f"{CHAIN_UNROLL}")
    if not _on_cuda(out):
        return out.copy_(chain_plain(out.shape[0], iters, out.device))
    from repro_torch.kernels._build import library
    lib = library()
    with torch.cuda.device(out.device):
        err = lib.calibrate_chain(out.data_ptr(), out.shape[0], iters,
                                  CHAIN_MUL, CHAIN_ADD, _stream(out.device))
    _raise_on(err, "chain")
    LAUNCHES["chain"] += 1
    return out


# ---------------------------------------------------------------------------
# gather: hashed random reads of a resident table
# ---------------------------------------------------------------------------

def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 of int64 u32 values (the kernel's index hash)."""
    x = x ^ (x >> 16)
    x = H._mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = H._mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gather_table(n_words: int, device) -> torch.Tensor:
    """The probes' table: ``(n_words,)`` int32 holding its own indices."""
    return torch.arange(n_words, dtype=torch.int32, device=device)


def gather_plain(table: torch.Tensor, n: int, per_thread: int
                 ) -> torch.Tensor:
    """Plain version of :func:`gather`: (n,) int32."""
    mask = table.shape[0] - 1
    t = torch.arange(n, dtype=torch.int64, device=table.device)
    acc = torch.zeros_like(t)
    for j in range(per_thread):
        idx = mix32((t + j * n) & H.M32) & mask
        acc = (acc + H.u32(table[idx])) & H.M32
    return H.to_i32(acc)


def gather(table: torch.Tensor, out: torch.Tensor, per_thread: int
           ) -> torch.Tensor:
    """Thread t of n = ``out.numel()`` writes the u32 sum of ``table[
    mix32(t + j n) & (len(table) - 1)]`` over ``j < per_thread`` to
    ``out[t]``. ``table`` (words,) int32 with a power-of-two length; n *
    per_thread at most 2^32."""
    words = table.shape[0] if table.ndim == 1 else 0
    if words == 0 or words & (words - 1):
        raise ValueError(f"table must be (2^j,) int32, got "
                         f"{tuple(table.shape)}")
    n = out.shape[0] if out.ndim == 1 else 0
    if n == 0 or per_thread <= 0 or n * per_thread > 1 << 32:
        raise ValueError(f"out (n,) with n >= 1 and 0 < per_thread, n * "
                         f"per_thread <= 2^32; got {tuple(out.shape)}, "
                         f"{per_thread}")
    if not _on_cuda(table, out):
        return out.copy_(gather_plain(table, n, per_thread))
    from repro_torch.kernels._build import library
    lib = library()
    with torch.cuda.device(out.device):
        err = lib.calibrate_gather(table.data_ptr(), words - 1,
                                   out.data_ptr(), n, per_thread,
                                   _stream(out.device))
    _raise_on(err, "gather")
    LAUNCHES["gather"] += 1
    return out


# ---------------------------------------------------------------------------
# The card's shape, for sizing the probes' grids
# ---------------------------------------------------------------------------

def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def blocks_per_sm(kernel: str, device) -> int:
    """CTAs of calibration kernel ``kernel`` ("step", "chain", "gather")
    resident on one SM of a CUDA ``device`` at ``THREADS`` threads."""
    from repro_torch.kernels._build import library
    lib = library()
    with torch.cuda.device(device):
        blocks = lib.calibrate_blocks_per_sm(KERNELS[kernel])
    if blocks <= 0:
        raise RuntimeError(f"cannot read the occupancy of {kernel} on "
                           f"{device}")
    return blocks
