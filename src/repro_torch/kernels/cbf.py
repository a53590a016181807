"""Classical Bloom filter kernels (cbf) for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.cbf``. The two wrappers keep the JAX names,
so each row of the kernel table maps one to one:

=============== ================================ ===========================
wrapper         replaces (repro/kernels/cbf.py)  CUDA kernels (csrc/cbf.cu)
=============== ================================ ===========================
contains_vmem   contains_vmem                    cbf_contains_kernel
add_vmem        add_vmem                         cbf_add_kernel (one-pass),
                                                 or the binned add:
                                                 cbf_bin_count_kernel,
                                                 cbf_bin_column_kernel,
                                                 cbf_bin_scan_kernel,
                                                 cbf_bin_scatter_kernel,
                                                 cbf_bin_apply_kernel
=============== ================================ ===========================

The same kernels serve both sizes. The JAX package has only a VMEM-resident
cbf kernel and runs larger classical filters on its jnp engine: a DRAM cbf
on the TPU would need k DMAs a key. On Hopper a probe is one load wherever
its word lives, so ``kernels.ops`` calls these two wrappers for a classical
filter in L2 and for one in DRAM alike; the regime never changes a result.
The Pallas kernels' key ``tile`` exists for the plain path's padding
(``ops``), so the wrappers take none: a CUDA thread owns its key.

The add has two paths on the card, which give the same words. The
*one-pass* path (``cbf_add_kernel``) gives a key one thread and k atomicOr
on global words: cheapest for small batches and filters in L2, but in DRAM
it runs at the card's random read-modify-write rate. The *binned* path
groups a batch's positions by bin (2^b contiguous bits held whole in one
CTA's shared memory), ORs each bin in shared memory and writes it back
once; ``csrc/cbf.cu`` describes its five kernels. :func:`choose_path`, a
pure function of (n, m, k, the card's shared memory), picks the path; its
thresholds come from a sweep of both paths in turns on the H100
(``chip_smoke.py``; the table is in PERF.md). ``LAST_ADD_PLAN`` keeps the
last card add's plan (:func:`add_plan`). :func:`add_binned_model` is the
binned path's stages in plain PyTorch, for tests.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
filter words ``(n_words,)``. For CPU tensors a wrapper runs its plain
version (:func:`contains_plain`, :func:`add_plain`); for CUDA tensors it
launches its kernels or raises. ``add_vmem`` updates ``filt`` in place and
returns it. ``LAUNCHES`` counts wrapper calls that launched kernels (one
a call, whatever the path).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import (_on_cuda, _raise_on, _salts,
                                     partition_smem_bytes)

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0}

PATHS = ("one-pass", "binned")
# A bin of the binned add: 2^19 bits, 64 KiB of shared memory (three CTAs
# an SM on the H100); smaller where the card's shared memory is
BIN_BITS = 19
MIN_BIN_BITS, MAX_BIN_BITS = 5, 20      # one word .. 128 KiB
LOG2_MAX_BINS = 13                      # 8192 bins: 32 KiB of histogram
# Positions an internal batch of the binned add holds: 2^29 u32, a 2 GiB
# workspace (~48.8M keys a batch at k = 11; 6 batches for 2^28 keys). Each
# batch reads and writes the touched bins once, so a larger cap saves
# filter passes and costs device memory. Counts, offsets and slots are u32:
# the kernels refuse a batch of more than 2^31 positions.
POSITION_CAP = 1 << 29
FILLER = 0xFFFFFFFF                     # pads a run to a whole sector
SECTOR_SLOTS = 8                        # u32 slots of a 32-byte sector
# The path rule: the fewest positions (n * k) at which the binned add is
# the faster, by log2 m. Crossovers of a sweep of both paths in turns on
# an H100 80GB HBM3 at 700 W (k = 11; keys 2^14 ... 2^28, every power of
# two from 2^17 to 2^23; PERF.md), each set to a power of two between the
# last size where one-pass won and the first where binned did. Filters of
# 2^27 bits and fewer sit in L2, where one-pass won at every size.
BINNED_MIN_POSITIONS = {28: 1 << 24, 29: 1 << 21, 30: 1 << 21, 31: 1 << 22,
                        32: 1 << 23}

# The plan of the last add_vmem call on the card (add_plan's keys)
LAST_ADD_PLAN: dict = {}


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


def bin_geometry(m_bits: int, bin_bits: int) -> tuple:
    """(log2 of a bin's bits, number of bins) of the binned add: bins of
    2^bin_bits bits, one bin of the whole filter where m <= 2^bin_bits."""
    log2m = V._log2i(m_bits)
    return min(bin_bits, log2m), 1 << max(0, log2m - bin_bits)


def bin_bits_for(smem_bytes: int) -> int:
    """The bin size a card with ``smem_bytes`` of shared memory a CTA
    takes: ``BIN_BITS``, less where 2^BIN_BITS bits do not fit."""
    b = BIN_BITS
    while b > MIN_BIN_BITS and 1 << (b - 3) > smem_bytes:
        b -= 1
    return b


def binned_fits(m_bits: int, bin_bits: int) -> bool:
    """Whether the binned kernels take this filter size and bin size."""
    return (MIN_BIN_BITS <= bin_bits <= MAX_BIN_BITS
            and V._log2i(m_bits) - bin_bits <= LOG2_MAX_BINS)


def choose_path(n: int, m_bits: int, k: int, smem_bytes: int) -> str:
    """The add's path on the card, a pure function of the batch (n keys), the
    filter (m bits, k probes a key) and the card's shared memory a CTA.

    Binned where the filter's size has a threshold in
    ``BINNED_MIN_POSITIONS`` (filters past L2, whose one-pass atomics go to
    DRAM), the batch has at least that many positions (enough that reading
    and writing every touched bin once costs less than the atomics it
    replaces) and the card's shared memory holds a bin. The path never
    changes a result."""
    least = BINNED_MIN_POSITIONS.get(V._log2i(m_bits))
    if least is None or not binned_fits(m_bits, bin_bits_for(smem_bytes)):
        return "one-pass"
    return "binned" if n * k >= least else "one-pass"


def _round8(x: int) -> int:
    return -(-x // SECTOR_SLOTS) * SECTOR_SLOTS


def add_plan(n: int, m_bits: int, k: int, path: str,
             bin_bits: int = BIN_BITS, cap: int = POSITION_CAP,
             chunks: int = 1) -> dict:
    """What an add of n keys runs: ``path``, ``bin_bits``, ``n_bins``,
    ``batches`` (internal batches), ``positions`` (n * k), ``batch_keys``
    (keys a batch), ``chunks`` (the binned kernels' CTAs, one a chunk of a
    batch's keys; the card's SMs) and ``workspace_bytes`` (device memory
    the call allocates: per-chunk counts, each bin's start and end, and a
    batch's positions with each chunk's run in a bin padded to a sector;
    u32 each)."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    if path == "one-pass":
        return {"path": path, "bin_bits": None, "n_bins": 0,
                "batches": int(n > 0), "positions": n * k, "batch_keys": n,
                "chunks": 0, "workspace_bytes": 0}
    if not binned_fits(m_bits, bin_bits):
        raise ValueError(f"no binned add for m = {m_bits} bits in bins of "
                         f"2^{bin_bits} bits")
    batch = cap // k
    if batch < 1 or batch * k > 1 << 31:
        raise ValueError(f"a batch must hold 1 .. 2^31 / k keys, not "
                         f"cap {cap} // k {k}")
    _, n_bins = bin_geometry(m_bits, bin_bits)
    batch_keys = min(n, batch)
    slots = batch_keys * k + (SECTOR_SLOTS - 1) * chunks * n_bins
    return {"path": path, "bin_bits": bin_bits, "n_bins": n_bins,
            "batches": -(-n // batch), "positions": n * k,
            "batch_keys": batch_keys, "chunks": chunks,
            "workspace_bytes": 4 * (_round8((chunks + 2) * n_bins)
                                    + _round8(slots))}


def add_binned_model(spec: FilterSpec, filt: torch.Tensor,
                     keys: torch.Tensor, bin_bits: int = BIN_BITS,
                     cap: int = POSITION_CAP, chunks: int = 132) -> tuple:
    """The binned add's stages in plain PyTorch, for tests: (new words,
    plan). Per internal batch of ``cap // k`` keys, cut into ``chunks``
    equal ranges: count each chunk's positions by bin (stage 1), lay out
    each bin's slice as the chunks' runs in chunk order, each padded to a
    whole sector (2, 3), write each position's offset inside its bin into
    its chunk's run in key order and ``FILLER`` into the padding (4; the
    kernel's order inside a run differs, and OR does not care), and OR each
    touched bin's offsets into its words (5). ``filt`` is not modified."""
    if spec.variant != "cbf":
        raise ValueError(f"the binned add serves classical filters, not "
                         f"{spec}")
    n = keys.shape[0]
    plan = add_plan(n, spec.m_bits, spec.k, "binned", bin_bits, cap, chunks)
    log2_bin, n_bins = bin_geometry(spec.m_bits, bin_bits)
    bins_view = H.u32(filt).reshape(n_bins, -1).clone()      # (bins, words)
    batch = cap // spec.k
    for first in range(0, n, batch):
        h1, h2 = H.hash_keys(keys[first:first + batch])
        nb = h1.shape[0]
        pos = V.cbf_positions(spec, h1, h2)                   # (nb, k)
        bounds = torch.tensor([c * nb // chunks for c in range(chunks + 1)])
        chunk = torch.searchsorted(bounds, torch.arange(nb), right=True) - 1
        cell = ((pos >> bin_bits) * chunks + chunk[:, None]).reshape(-1)
        counts = torch.bincount(cell, minlength=n_bins * chunks)
        runs = (counts + SECTOR_SLOTS - 1) // SECTOR_SLOTS * SECTOR_SLOTS
        run_at = torch.cumsum(runs, 0) - runs            # bin-major, chunks
        lengths = runs.reshape(n_bins, chunks).sum(1)
        starts = torch.cumsum(lengths, 0) - lengths
        order = torch.argsort(cell, stable=True)         # key order in a run
        rank = torch.arange(cell.numel()) - (torch.cumsum(counts, 0)
                                             - counts)[cell[order]]
        work = torch.full((int(lengths.sum()),), FILLER, dtype=torch.int64)
        work[run_at[cell[order]] + rank] = (pos.reshape(-1)[order]
                                            & ((1 << log2_bin) - 1))
        live = work != FILLER
        if int(live.sum()) != cell.numel() or not torch.equal(
                run_at.reshape(n_bins, chunks)[:, 0], starts):
            raise AssertionError("the runs do not tile the bins' slices")
        owner = torch.repeat_interleave(torch.arange(n_bins), lengths)[live]
        local = torch.unique(owner << log2_bin | work[live])    # by bin
        cells, inv = torch.unique_consecutive(local >> 5, return_inverse=True)
        acc = torch.zeros_like(cells).index_add_(      # distinct bits: OR
            0, inv, torch.ones_like(local) << (local & 31))
        flat = bins_view.view(-1)
        flat[cells] = flat[cells] | acc
    return H.to_i32(bins_view.reshape(-1)), plan


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


def binned_chunks(spec: FilterSpec, bin_bits: int,
                  device: torch.device) -> int:
    """The binned kernels' chunks on a CUDA ``device`` (the scatter's CTAs
    that fill the card)."""
    from repro_torch.kernels._build import library
    with torch.cuda.device(device):
        chunks = library().cbf_binned_chunks(V._log2i(spec.m_bits), spec.k,
                                             bin_bits)
    if chunks < 1:
        raise ValueError(f"add_vmem: no binned kernels for {spec} in bins "
                         f"of 2^{bin_bits} bits on {device}")
    return chunks


def add_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor, *,
             path: Optional[str] = None, bin_bits: Optional[int] = None,
             cap: int = POSITION_CAP) -> torch.Tensor:
    """Bulk insert, k single-bit sets a key; updates ``filt`` in place.

    On the card the path is :func:`choose_path`'s. ``path``, ``bin_bits``
    and ``cap`` are private (tests and the smoke; ``ops`` never passes
    them): a forced path, the bin size and the positions an internal batch
    holds."""
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    from repro_torch.kernels._build import library
    log2m = _geometry(spec, filt, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    smem = partition_smem_bytes(keys.device)
    if bin_bits is None:
        bin_bits = bin_bits_for(smem)
    if path is None:
        path = choose_path(n, spec.m_bits, spec.k, smem)
    chunks = (binned_chunks(spec, bin_bits, keys.device)
              if path == "binned" else 0)
    plan = add_plan(n, spec.m_bits, spec.k, path, bin_bits, cap, chunks)
    lib = library()
    salts = _salts(keys.device).data_ptr()
    with torch.cuda.device(keys.device):
        if path == "one-pass":
            err = lib.cbf_add(keys.data_ptr(), filt.data_ptr(), salts, n,
                              log2m, spec.k, _stream(keys.device))
        else:
            # freed when the call returns: the caching allocator orders its
            # reuse after these kernels on the same stream
            work = torch.empty(plan["workspace_bytes"] // 4,
                               dtype=torch.int32, device=keys.device)
            err = lib.cbf_add_binned(keys.data_ptr(), filt.data_ptr(), salts,
                                     work.data_ptr(), n, log2m, spec.k,
                                     bin_bits, cap // spec.k, chunks,
                                     _stream(keys.device))
    _raise_on(err, "add_vmem")
    LAUNCHES["add_vmem"] += 1
    LAST_ADD_PLAN.clear()
    LAST_ADD_PLAN.update(plan)
    return filt
