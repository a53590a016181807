"""Classical Bloom filter kernels (cbf) for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.cbf``. The two wrappers keep the JAX names,
so each row of the kernel table maps one to one:

=============== ================================ ===========================
wrapper         replaces (repro/kernels/cbf.py)  CUDA kernels (csrc/cbf.cu)
=============== ================================ ===========================
contains_vmem   contains_vmem                    cbf_contains_kernel
                                                 (one-pass), or the binned
                                                 contains:
                                                 cbf_bin_count_kernel,
                                                 bin_column_kernel,
                                                 bin_scan_kernel,
                                                 cbf_bin_scatter_kernel
                                                 <uint64_t>,
                                                 cbf_bin_test_kernel
add_vmem        add_vmem                         cbf_add_kernel (one-pass),
                                                 or the binned add:
                                                 cbf_bin_count_kernel,
                                                 bin_column_kernel,
                                                 bin_scan_kernel,
                                                 cbf_bin_scatter_kernel
                                                 <uint32_t>,
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

The contains has the same two paths. The binned one groups a batch's
probes by bin with the add's first three kernels, records each probe's
key beside its offset (a u64 slot), and tests each touched bin's probes
against the bin held in shared memory, storing ``False`` for a miss;
:func:`choose_contains_path` picks it, ``LAST_CONTAINS_PLAN`` keeps the
plan (:func:`contains_plan`) and :func:`contains_binned_model` is its CPU
model. A binned call's workspace is bounded by the card's free memory:
:func:`cap_for_memory` lowers the positions a batch holds until the plan
fits, which only adds internal batches.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
filter words ``(n_words,)``. For CPU tensors a wrapper runs its plain
version (:func:`contains_plain`, :func:`add_plain`); for CUDA tensors it
launches its kernels or raises. ``add_vmem`` updates ``filt`` in place and
returns it. ``LAUNCHES`` counts wrapper calls that launched kernels (one
a call, whatever the path).
"""
from __future__ import annotations

import functools
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
# Probes an internal batch of the binned contains holds: 2^27 (~12.2M keys a
# batch at k = 11, a 1 GiB workspace). A miss stores False to its key's
# result byte at random, so a batch's results (one byte a key) should stay
# in L2: for 2^28 keys that are not members of a 2^32-bit filter the test
# kernel took 26.0 ms with 12.2 MB of results a batch and 59.7 ms with
# 48.8 MB (2^29 probes), the whole contains 63.9 against 97.8 ms; for
# members 49.9 against 47.0 (H100 80GB HBM3, tools/cbf_sweep.py; PERF.md).
CONTAINS_POSITION_CAP = 1 << 27
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
# The contains' path rule, as BINNED_MIN_POSITIONS: the fewest probes (n *
# k) from which the binned contains is no slower whatever share of the keys
# are members, by log2 m. The rule cannot see that share, and it moves the
# crossover: a key that is not a member ends early on one-pass (~8 probes,
# not 11) and stores misses on binned. A sweep of both paths in turns on an
# H100 80GB HBM3 at 700 W (tools/cbf_sweep.py: k = 11, keys 2^14 ... 2^28
# of which none, half or all are members of a filter filled to 16 bits a
# key; PERF.md): at 2^32 bits binned first won at 2^21 keys for half and
# all members and at 2^23 for none (2^22: 0.96x), so the threshold lies
# between 2^22 and 2^23 keys; at 2^30 and 2^31 bits it lost 1-7 % at every
# size for none (and won 1.2-1.75x for half or all), and at 2^29 bits and
# fewer it lost, so those filters stay one-pass.
CONTAINS_BINNED_MIN_POSITIONS = {32: 1 << 26}
# Device memory a binned call leaves free beside its workspace where the
# workspace at the cap did not fit
WORKSPACE_MARGIN = 1 << 28

# The plans of the last add_vmem and contains_vmem calls on the card
LAST_ADD_PLAN: dict = {}
LAST_CONTAINS_PLAN: dict = {}


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


def _rule(table: dict, n: int, m_bits: int, k: int, smem_bytes: int) -> str:
    least = table.get(V._log2i(m_bits))
    if least is None or not binned_fits(m_bits, bin_bits_for(smem_bytes)):
        return "one-pass"
    return "binned" if n * k >= least else "one-pass"


def choose_path(n: int, m_bits: int, k: int, smem_bytes: int) -> str:
    """The add's path on the card, a pure function of the batch (n keys), the
    filter (m bits, k probes a key) and the card's shared memory a CTA.

    Binned where the filter's size has a threshold in
    ``BINNED_MIN_POSITIONS`` (filters past L2, whose one-pass atomics go to
    DRAM), the batch has at least that many positions (enough that reading
    and writing every touched bin once costs less than the atomics it
    replaces) and the card's shared memory holds a bin. The path never
    changes a result."""
    return _rule(BINNED_MIN_POSITIONS, n, m_bits, k, smem_bytes)


def choose_contains_path(n: int, m_bits: int, k: int, smem_bytes: int
                         ) -> str:
    """The contains' path on the card, a pure function as
    :func:`choose_path`: binned where the filter's size has a threshold in
    ``CONTAINS_BINNED_MIN_POSITIONS`` (filters past L2), the batch has at
    least that many probes and the card's shared memory holds a bin. The L2
    cell and small batches stay one-pass. The path never changes a
    result."""
    return _rule(CONTAINS_BINNED_MIN_POSITIONS, n, m_bits, k, smem_bytes)


def _round(x: int, to: int = SECTOR_SLOTS) -> int:
    return -(-x // to) * to


def _plan(what: str, n: int, m_bits: int, k: int, path: str, bin_bits: int,
          cap: int, chunks: int, slot_bytes: int) -> dict:
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    if path == "one-pass":
        return {"path": path, "bin_bits": None, "n_bins": 0,
                "batches": int(n > 0), "positions": n * k, "batch_keys": n,
                "chunks": 0, "workspace_bytes": 0}
    if not binned_fits(m_bits, bin_bits):
        raise ValueError(f"no binned {what} for m = {m_bits} bits in bins "
                         f"of 2^{bin_bits} bits")
    batch = cap // k
    if batch < 1 or batch * k > 1 << 31:
        raise ValueError(f"a batch must hold 1 .. 2^31 / k keys, not "
                         f"cap {cap} // k {k}")
    _, n_bins = bin_geometry(m_bits, bin_bits)
    batch_keys = min(n, batch)
    sector = 32 // slot_bytes                      # slots a sector
    slots = batch_keys * k + (sector - 1) * chunks * n_bins
    return {"path": path, "bin_bits": bin_bits, "n_bins": n_bins,
            "batches": -(-n // batch), "positions": n * k,
            "batch_keys": batch_keys, "chunks": chunks,
            "workspace_bytes": (4 * _round((chunks + 2) * n_bins)
                                + slot_bytes * _round(slots, sector))}


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
    return _plan("add", n, m_bits, k, path, bin_bits, cap, chunks, 4)


def contains_plan(n: int, m_bits: int, k: int, path: str,
                  bin_bits: int = BIN_BITS, cap: int = CONTAINS_POSITION_CAP,
                  chunks: int = 1) -> dict:
    """What a contains of n keys runs, with :func:`add_plan`'s keys; the
    binned workspace's slots are u64, each probe's key index beside its
    offset, 4 a sector, so each chunk's run in a bin pads to 4 slots. The
    (n,) result is not workspace."""
    return _plan("contains", n, m_bits, k, path, bin_bits, cap, chunks, 8)


def cap_for_memory(planner, n: int, m_bits: int, k: int, bin_bits: int,
                   cap: int, chunks: int, free_bytes: int) -> int:
    """The largest cap, ``cap`` halved as often as needed, whose binned
    plan (``planner``: :func:`add_plan` or :func:`contains_plan`) has a
    workspace that fits ``free_bytes`` less ``WORKSPACE_MARGIN``. A smaller
    cap only adds internal batches, so the words and results stay the
    same. Raises ``MemoryError`` where a batch of one key does not fit."""
    room = free_bytes - WORKSPACE_MARGIN
    while cap >= k:
        if planner(n, m_bits, k, "binned", bin_bits, cap,
                   chunks)["workspace_bytes"] <= room:
            return cap
        cap //= 2
    raise MemoryError(f"no binned workspace for {n} keys fits {free_bytes} B "
                      f"of free device memory")


def free_device_bytes(device: torch.device) -> int:
    """Device memory a call can allocate: the card's free memory and what
    PyTorch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _binned_slots(spec: FilterSpec, keys: torch.Tensor, bin_bits: int,
                  chunks: int, sector: int = SECTOR_SLOTS) -> tuple:
    """One internal batch's slots as the kernels lay them out, for the CPU
    models: each key's k positions counted by (bin, chunk) (stage 1), each
    bin's slice the chunks' runs in chunk order, each padded to a whole
    sector of ``sector`` slots (2, 3), and each position's offset inside its
    bin (and, for the contains, its key's index) written into
    its chunk's run in key order, ``FILLER`` into the padding (4; the
    kernels' order inside a run differs, and neither OR nor a test cares).
    Returns (bin, offset, key index) of the slots that are not padding."""
    log2_bin, n_bins = bin_geometry(spec.m_bits, bin_bits)
    h1, h2 = H.hash_keys(keys)
    nb = h1.shape[0]
    pos = V.cbf_positions(spec, h1, h2)                       # (nb, k)
    bounds = torch.tensor([c * nb // chunks for c in range(chunks + 1)])
    chunk = torch.searchsorted(bounds, torch.arange(nb), right=True) - 1
    cell = ((pos >> bin_bits) * chunks + chunk[:, None]).reshape(-1)
    counts = torch.bincount(cell, minlength=n_bins * chunks)
    runs = (counts + sector - 1) // sector * sector
    run_at = torch.cumsum(runs, 0) - runs                # bin-major, chunks
    lengths = runs.reshape(n_bins, chunks).sum(1)
    starts = torch.cumsum(lengths, 0) - lengths
    order = torch.argsort(cell, stable=True)             # key order in a run
    rank = torch.arange(cell.numel()) - (torch.cumsum(counts, 0)
                                         - counts)[cell[order]]
    slot = run_at[cell[order]] + rank
    work = torch.full((int(lengths.sum()),), FILLER, dtype=torch.int64)
    work[slot] = pos.reshape(-1)[order] & ((1 << log2_bin) - 1)
    key = torch.zeros_like(work)
    key[slot] = order // spec.k
    live = work != FILLER
    if int(live.sum()) != cell.numel() or not torch.equal(
            run_at.reshape(n_bins, chunks)[:, 0], starts):
        raise AssertionError("the runs do not tile the bins' slices")
    owner = torch.repeat_interleave(torch.arange(n_bins), lengths)
    return owner[live], work[live], key[live]


def add_binned_model(spec: FilterSpec, filt: torch.Tensor,
                     keys: torch.Tensor, bin_bits: int = BIN_BITS,
                     cap: int = POSITION_CAP, chunks: int = 132) -> tuple:
    """The binned add's stages in plain PyTorch, for tests: (new words,
    plan). Per internal batch of ``cap // k`` keys, cut into ``chunks``
    equal ranges, the slots of :func:`_binned_slots` (stages 1-4), then each
    touched bin's offsets ORed into its words (5). ``filt`` is not
    modified."""
    if spec.variant != "cbf":
        raise ValueError(f"the binned add serves classical filters, not "
                         f"{spec}")
    n = keys.shape[0]
    plan = add_plan(n, spec.m_bits, spec.k, "binned", bin_bits, cap, chunks)
    log2_bin, n_bins = bin_geometry(spec.m_bits, bin_bits)
    bins_view = H.u32(filt).reshape(n_bins, -1).clone()      # (bins, words)
    batch = cap // spec.k
    for first in range(0, n, batch):
        owner, offset, _ = _binned_slots(spec, keys[first:first + batch],
                                         bin_bits, chunks)
        local = torch.unique(owner << log2_bin | offset)         # by bin
        cells, inv = torch.unique_consecutive(local >> 5, return_inverse=True)
        acc = torch.zeros_like(cells).index_add_(      # distinct bits: OR
            0, inv, torch.ones_like(local) << (local & 31))
        flat = bins_view.view(-1)
        flat[cells] = flat[cells] | acc
    return H.to_i32(bins_view.reshape(-1)), plan


def contains_binned_model(spec: FilterSpec, filt: torch.Tensor,
                          keys: torch.Tensor,
                          bin_bits: int = BIN_BITS,
                          cap: int = CONTAINS_POSITION_CAP,
                          chunks: int = 132) -> tuple:
    """The binned contains' stages in plain PyTorch, for tests: ((n,) bool,
    plan). Per internal batch, the slots of :func:`_binned_slots` with each
    probe's key index, runs padded to 4 u64 slots (stages 1-4), then each
    slot's bit tested in its bin
    and ``False`` stored for its key on a miss, from a result that starts
    all ``True`` (5). Every probe is tested: there is no early exit."""
    if spec.variant != "cbf":
        raise ValueError(f"the binned contains serves classical filters, "
                         f"not {spec}")
    n = keys.shape[0]
    plan = contains_plan(n, spec.m_bits, spec.k, "binned", bin_bits, cap,
                         chunks)
    log2_bin, _ = bin_geometry(spec.m_bits, bin_bits)
    words = H.u32(filt)
    out = torch.ones((n,), dtype=torch.bool)
    batch = cap // spec.k
    for first in range(0, n, batch):
        owner, offset, key = _binned_slots(spec, keys[first:first + batch],
                                           bin_bits, chunks, sector=4)
        bit = (owner << log2_bin) | offset
        miss = ((words[bit >> 5] >> (bit & 31)) & 1) == 0
        out[first + key[miss]] = False
    return out, plan


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def contains_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  *, path: Optional[str] = None,
                  bin_bits: Optional[int] = None,
                  cap: int = CONTAINS_POSITION_CAP) -> torch.Tensor:
    """Bulk membership, k single-bit probes a key. (n,) bool.

    On the card the path is :func:`choose_contains_path`'s. ``path``,
    ``bin_bits`` and ``cap`` are private (tests and the smoke; ``ops``
    never passes them), as for :func:`add_vmem`."""
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    from repro_torch.kernels._build import library
    log2m = _geometry(spec, filt, keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    plan, cap, work = _card_plan(contains_plan, choose_contains_path, spec,
                                 n, keys.device, path, bin_bits, cap)
    lib = library()
    salts = _salts(keys.device).data_ptr()
    with torch.cuda.device(keys.device):
        if plan["path"] == "one-pass":
            err = lib.cbf_contains(keys.data_ptr(), filt.data_ptr(),
                                   out.data_ptr(), salts, n, log2m, spec.k,
                                   _stream(keys.device))
        else:
            err = lib.cbf_contains_binned(
                keys.data_ptr(), filt.data_ptr(), out.data_ptr(), salts,
                work.data_ptr(), n, log2m, spec.k, plan["bin_bits"],
                cap // spec.k, plan["chunks"], _stream(keys.device))
    _raise_on(err, "contains_vmem")
    LAUNCHES["contains_vmem"] += 1
    LAST_CONTAINS_PLAN.clear()
    LAST_CONTAINS_PLAN.update(plan)
    return out


def binned_chunks(spec: FilterSpec, bin_bits: int, device: torch.device,
                  keys: bool = False) -> int:
    """The binned kernels' chunks on a CUDA ``device`` (the scatter's CTAs
    that fill the card); ``keys`` for the contains' scatter."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _chunks_on(index, V._log2i(spec.m_bits), spec.k, bin_bits, keys)


@functools.lru_cache(maxsize=None)
def _chunks_on(index: int, log2m: int, k: int, bin_bits: int,
               keys: bool) -> int:
    from repro_torch.kernels._build import library
    with torch.cuda.device(index):
        chunks = library().cbf_binned_chunks(log2m, k, bin_bits, int(keys))
    if chunks < 1:
        raise ValueError(f"no binned kernels for 2^{log2m} bits, k = {k} in "
                         f"bins of 2^{bin_bits} bits on cuda:{index}")
    return chunks


def _workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """A binned call's u32 workspace (a test substitutes a fake). Freed
    when the call returns: the caching allocator orders its reuse after
    the call's kernels on the same stream."""
    return torch.empty(nbytes // 4, dtype=torch.int32, device=device)


def _card_plan(planner, rule, spec: FilterSpec, n: int,
               device: torch.device, path: Optional[str],
               bin_bits: Optional[int], cap: int) -> tuple:
    """(plan, cap, workspace) of a call on the card: the rule's path unless
    one is given; for the binned path the bins that fit the card's shared
    memory and the workspace, allocated. Free memory is asked for (a
    `cudaMemGetInfo` call and the allocator's statistics, ~0.5 ms that
    stall the stream on the H100) only where the allocation fails: then the
    cap drops to :func:`cap_for_memory`'s from half the cap that failed,
    until the workspace allocates; ``MemoryError`` where none does."""
    smem = partition_smem_bytes(device)
    if bin_bits is None:
        bin_bits = bin_bits_for(smem)
    if path is None:
        path = rule(n, spec.m_bits, spec.k, smem)
    if path == "one-pass":
        return planner(n, spec.m_bits, spec.k, path), cap, None
    chunks = binned_chunks(spec, bin_bits, device,
                           keys=planner is contains_plan)
    while True:
        plan = planner(n, spec.m_bits, spec.k, path, bin_bits, cap, chunks)
        try:
            return plan, cap, _workspace(plan["workspace_bytes"], device)
        except torch.cuda.OutOfMemoryError:
            cap = cap_for_memory(planner, n, spec.m_bits, spec.k, bin_bits,
                                 cap // 2, chunks, free_device_bytes(device))


def add_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor, *,
             path: Optional[str] = None, bin_bits: Optional[int] = None,
             cap: int = POSITION_CAP) -> torch.Tensor:
    """Bulk insert, k single-bit sets a key; updates ``filt`` in place.

    On the card the path is :func:`choose_path`'s. ``path``, ``bin_bits``
    and ``cap`` are private (tests and the smoke; ``ops`` never passes
    them): a forced path, the bin size and the positions an internal batch
    holds (lowered where its workspace does not fit the free memory)."""
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    from repro_torch.kernels._build import library
    log2m = _geometry(spec, filt, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    plan, cap, work = _card_plan(add_plan, choose_path, spec, n,
                                 keys.device, path, bin_bits, cap)
    lib = library()
    salts = _salts(keys.device).data_ptr()
    with torch.cuda.device(keys.device):
        if plan["path"] == "one-pass":
            err = lib.cbf_add(keys.data_ptr(), filt.data_ptr(), salts, n,
                              log2m, spec.k, _stream(keys.device))
        else:
            err = lib.cbf_add_binned(keys.data_ptr(), filt.data_ptr(), salts,
                                     work.data_ptr(), n, log2m, spec.k,
                                     plan["bin_bits"], cap // spec.k,
                                     plan["chunks"], _stream(keys.device))
    _raise_on(err, "add_vmem")
    LAUNCHES["add_vmem"] += 1
    LAST_ADD_PLAN.clear()
    LAST_ADD_PLAN.update(plan)
    return filt
