"""Generation-ring membership kernels (the windowed filter's query) for
Hopper, and their plain PyTorch version.

Counterpart of ``repro.kernels.ring``. A windowed filter
(``repro_torch.window``) holds G same-spec generations stacked
``(G, n_words)``; a key is in the window iff it is in the OR of the
generations. The kernels never build the O(m) union:

=================== ============================= ===========================
wrapper             replaces (repro/kernels/      CUDA kernels
                    ring.py)                      (csrc/ring.cu)
=================== ============================= ===========================
ring_contains_vmem  ring_contains_vmem (L2)       ring_contains_kernel
                                                  (one-pass, depth 1), or the
                                                  binned contains
ring_contains_hbm   ring_contains_hbm (DRAM)      ring_contains_kernel
                                                  (one-pass, depth), or the
                                                  binned contains
=================== ============================= ===========================

Two paths on the card give the same results. The *one-pass* kernel hashes
each key once; a group of Θ lanes (:func:`contains_geometry`, Θ from
``sbf.card_layout``) loads the key's row generation by generation (from
the last, down) and ends the key once the OR so far covers its mask (a
member of a generation stops there; a key that is not a member reads all
G rows). The *binned* contains (five kernels an internal batch: count,
column, scan, scatter, test) groups a batch's keys by bin of block rows,
ORs each touched bin's rows over the G generations into shared memory
once and tests its keys there, so a DRAM ring is read in coalesced runs
instead of G random sectors a key. :func:`choose_contains_path`, a pure
function fitted to a sweep of both paths on the H100, picks the path for
both wrappers; ``LAST_CONTAINS_PLAN`` keeps the last card call's plan
(:func:`contains_plan`) and :func:`contains_binned_model` is the binned
path's bins, slots and per-bin OR in plain PyTorch, for tests. A binned
call's workspace is bounded by the card's free memory
(:func:`cap_for_memory`).

``ring_contains_hbm`` accepts and validates the JAX package's ``depth``
(the keys ``_ring_hbm_kernel``'s DMA ring keeps in flight); no schedule
on the card takes it: the one-pass kernel keeps one key a group in flight
and stops it early, which beat issuing every generation's loads of
several keys before one test (PERF.md, row 19). The Pallas kernels' key
``tile`` exists for the plain path's padding (``ops``), so the wrappers
take none.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
rings ``(G, n_words)``. For CPU tensors a wrapper runs the plain version
(:func:`ring_contains_ref`); for CUDA tensors it launches its kernels or
raises. ``LAUNCHES`` counts wrapper calls that launched kernels (one a
call, whatever the path).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels import sbf
from repro_torch.kernels.cbf import (chunk_of_model, free_device_bytes,
                                     slot_runs_model)
from repro_torch.kernels.sbf import DEFAULT_DMA_DEPTH, DMA_DEPTHS

PATHS = ("one-pass", "binned")
MAX_LANE_WORDS = 16          # row words a one-pass lane holds (32 spilled)
# A bin of the binned contains: 2^14 words of ORed rows (64 KiB of shared
# memory, three CTAs an SM on the H100); 2^14 / s rows
BIN_WORD_BITS = 14
LOG2_MAX_BINS = 13           # 8192 bins: 32 KiB of histogram
SLOT_BYTES = 16              # (key index, pattern hash, row in bin, 0)
SECTOR_SLOTS = 2             # slots of a 32-byte sector
FILLER = 0xFFFFFFFF          # the key index of a slot that pads a run
# Keys an internal batch of the binned contains holds: each key stores its
# result byte at random, so a batch's results should stay in L2 (16 MiB);
# each batch reads the touched bins of the ring once
CONTAINS_KEY_CAP = 1 << 24
# The path rule: the fewest keys from which the binned contains is no
# slower whatever share of the keys are members, by (generations, log2 of
# the ring's bytes), from a sweep of both paths in turns on an H100 80GB
# HBM3 at 700 W (chip_smoke.py phase_ring_rule: sbf B = 256 generations
# at their design load, rings of 32 / 128 / 512 MiB, G = 2 / 4 / 8, 2^16
# ... 2^26 keys with none, half or all members; PERF.md). Members are what
# one-pass does best (the early stop), so they set each threshold: the
# first swept size where binned won at all three shares. A ring in L2 (32
# MiB) and a ring of 2 or 3 generations stayed one-pass at every size.
# Between the swept points a ring takes the row of the next larger ring
# size and of the largest swept G at or below its own. Only rows of the
# swept width (SWEPT_ROW_WORDS) take the table: a bin holds 2^14 / s rows
# and a key reads s / 8 sectors, so other widths stay one-pass until a
# sweep fits them.
BINNED_MIN_KEYS = {(4, 27): 1 << 24, (4, 29): 1 << 24,
                   (8, 27): 1 << 20, (8, 29): 1 << 22}
SWEPT_ROW_WORDS = 8
# Device memory a binned call leaves free beside its workspace where the
# workspace at the cap did not fit
WORKSPACE_MARGIN = 1 << 28

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"ring_contains_vmem": 0, "ring_contains_hbm": 0}
# The plan of the last contains on the card (either wrapper)
LAST_CONTAINS_PLAN: dict = {}


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


@functools.lru_cache(maxsize=None)
def contains_geometry(spec: FilterSpec,
                      theta: Optional[int] = None) -> sbf.Geometry:
    """How the one-pass kernel runs: Θ lanes a key (``sbf.card_layout``'s
    contains Θ unless given, clamped to s and to at least s /
    ``MAX_LANE_WORDS``), each lane loading its s/Θ words up to 4 at a time,
    one key a group in flight."""
    s = spec.s
    if theta is None:
        theta = sbf.card_layout(spec, "contains").theta
    if not (sbf._is_pow2(theta) and theta <= sbf.WARP):
        raise ValueError(f"theta={theta} must be a power of two <= 32")
    theta = min(max(theta, s // MAX_LANE_WORDS), s)
    return sbf.Geometry(s, theta, min(s // theta, sbf.MAX_VEC), 1)


def bin_row_bits_for(s: int, smem_bytes: int) -> int:
    """Rows a bin holds (log2): 2^BIN_WORD_BITS words of s-word rows, fewer
    where the card's shared memory a CTA does not hold them."""
    bits = BIN_WORD_BITS - V._log2i(s)
    while bits > 0 and (4 * s) << bits > smem_bytes:
        bits -= 1
    return bits


def bin_geometry(n_words: int, s: int, bin_row_bits: int) -> tuple:
    """(log2 rows a bin, number of bins) of a generation of ``n_words``
    words in rows of s words: one bin of the whole generation where it has
    at most 2^bin_row_bits rows."""
    log2_blocks = V._log2i(n_words // s)
    shift = min(bin_row_bits, log2_blocks)
    return shift, 1 << (log2_blocks - shift)


def binned_fits(n_words: int, s: int, bin_row_bits: int) -> bool:
    """Whether the binned kernels take this generation and bin size."""
    return (bin_row_bits >= 0
            and V._log2i(n_words // s) - bin_row_bits <= LOG2_MAX_BINS)


def binned_min_keys(n_words: int, generations: int) -> Optional[int]:
    """The fewest keys from which a DRAM ring of ``generations`` of
    ``n_words`` words in rows of ``SWEPT_ROW_WORDS`` takes the binned path
    (``BINNED_MIN_KEYS``), or None where it stays one-pass at every size."""
    ring_bytes = 4 * generations * n_words
    rows = [g for g, _ in BINNED_MIN_KEYS if g <= generations]
    if not rows:
        return None
    g = max(rows)
    sizes = sorted(b for gg, b in BINNED_MIN_KEYS if gg == g)
    log2 = ring_bytes.bit_length() - 1
    b = next((b for b in sizes if b >= log2), sizes[-1])
    return BINNED_MIN_KEYS[(g, b)]


def choose_contains_path(n: int, n_words: int, generations: int, s: int,
                         smem_bytes: int, l2_resident: bool) -> str:
    """The ring contains' path on the card, a pure function of the batch (n
    keys), the ring (``generations`` of ``n_words`` words in rows of s), the
    card's shared memory a CTA and the caller's regime (``l2_resident``:
    :func:`ring_contains_vmem`).

    Binned for a ring in DRAM with rows of the swept width where the batch
    holds at least :func:`binned_min_keys` keys for this ring (four
    generations or more) and a bin fits the card's shared memory; else
    one-pass. The rule cannot see how many keys are members, so its
    thresholds are where binned is no slower at any share. The path never
    changes a result."""
    if l2_resident or s != SWEPT_ROW_WORDS:
        return "one-pass"
    least = binned_min_keys(n_words, generations)
    if least is None or not binned_fits(n_words, s,
                                        bin_row_bits_for(s, smem_bytes)):
        return "one-pass"
    return "binned" if n >= least else "one-pass"


def _round(x: int, to: int = 8) -> int:
    return -(-x // to) * to


def contains_plan(n: int, n_words: int, generations: int, s: int,
                  path: str, bin_row_bits: int = BIN_WORD_BITS - 3,
                  cap: int = CONTAINS_KEY_CAP, chunks: int = 1) -> dict:
    """What a ring contains of n keys runs: ``path``, ``bin_row_bits``
    (rows a bin, log2), ``n_bins``, ``batches`` (internal batches),
    ``batch_keys`` (keys a batch), ``chunks`` (the count and scatter
    kernels' CTAs, the card's) and ``workspace_bytes`` (per-chunk counts,
    each bin's start and end, padded to 8 words, and a batch's 16-byte
    slots, each chunk's run in a bin padded to 2 slots). The (n,) result is
    not workspace."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    if path == "one-pass":
        return {"path": path, "bin_row_bits": None, "n_bins": 0,
                "batches": int(n > 0), "batch_keys": n, "chunks": 0,
                "workspace_bytes": 0}
    if not binned_fits(n_words, s, bin_row_bits):
        raise ValueError(f"no binned contains for {n_words} words in bins "
                         f"of 2^{bin_row_bits} rows of {s} words")
    if not 1 <= cap <= 1 << 31:
        raise ValueError(f"a batch must hold 1 .. 2^31 keys, not {cap}")
    shift, n_bins = bin_geometry(n_words, s, bin_row_bits)
    batch_keys = min(n, cap)
    slots = batch_keys + (SECTOR_SLOTS - 1) * chunks * n_bins
    return {"path": path, "bin_row_bits": shift, "n_bins": n_bins,
            "batches": -(-n // cap), "batch_keys": batch_keys,
            "chunks": chunks,
            "workspace_bytes": (4 * _round((chunks + 2) * n_bins)
                                + SLOT_BYTES * slots)}


def cap_for_memory(n: int, n_words: int, generations: int, s: int,
                   bin_row_bits: int, cap: int, chunks: int,
                   free_bytes: int) -> int:
    """The largest cap, ``cap`` halved as often as needed, whose binned
    plan's workspace fits ``free_bytes`` less ``WORKSPACE_MARGIN``. A
    smaller cap only adds internal batches, so the results stay the same.
    Raises ``MemoryError`` where a batch of one key does not fit."""
    room = free_bytes - WORKSPACE_MARGIN
    while cap >= 1:
        if contains_plan(n, n_words, generations, s, "binned", bin_row_bits,
                         cap, chunks)["workspace_bytes"] <= room:
            return cap
        cap //= 2
    raise MemoryError(f"no binned ring workspace for {n} keys fits "
                      f"{free_bytes} B of free device memory")


def contains_binned_model(spec: FilterSpec, rings: torch.Tensor,
                          keys: torch.Tensor,
                          bin_row_bits: int = BIN_WORD_BITS - 3,
                          cap: int = CONTAINS_KEY_CAP,
                          chunks: int = 132) -> tuple:
    """The binned contains' stages in plain PyTorch, for tests: ((n,) bool,
    plan). Per internal batch of ``cap`` keys cut into ``chunks`` equal
    ranges: each key counted by (bin, chunk) (stage 1); each bin's slice
    the chunks' runs in chunk order, each padded to a whole sector of 2
    slots (2, 3); each key's slot (index in the batch, pattern hash, row in
    the bin) in its chunk's run, filler slots in the padding (4;
    :func:`cbf.slot_runs_model`); then each touched bin's rows ORed over
    the G generations and each slot's mask tested against its row of that
    OR (5)."""
    G, n_words = rings.shape
    s = spec.s
    n = keys.shape[0]
    plan = contains_plan(n, n_words, G, s, "binned", bin_row_bits, cap,
                         chunks)
    shift = plan["bin_row_bits"]
    n_bins = plan["n_bins"]
    rows = H.u32(rings).reshape(G, n_bins, -1, s)       # (G, bin, row, s)
    out = torch.zeros((n,), dtype=torch.bool)
    for first in range(0, n, cap):
        batch = keys[first:first + cap]
        nb = batch.shape[0]
        h1, h2 = H.hash_keys(batch)
        blk = H.block_index(h2, spec.n_blocks)
        cell = (blk >> shift) * chunks + chunk_of_model(nb, chunks)
        slot, total, owner = slot_runs_model(cell, n_bins, chunks,
                                             SECTOR_SLOTS)
        index = torch.full((total,), FILLER, dtype=torch.int64)
        index[slot] = torch.arange(nb)
        live = index != FILLER
        idx, bins = index[live], owner[live]
        touched = torch.unique(bins)
        union = torch.zeros((n_bins,) + rows.shape[2:], dtype=rows.dtype)
        for g in range(G):
            union[touched] |= rows[g, touched]
        row = union[bins, blk[idx] & ((1 << shift) - 1)]      # (slots, s)
        masks = V.block_patterns(spec, h1[idx])
        out[first + idx] = ((row & masks) == masks).all(dim=-1)
    return out, plan


def _on_cuda(rings: torch.Tensor, keys: torch.Tensor) -> bool:
    if rings.ndim != 2 or rings.shape[0] < 1:
        raise ValueError(f"rings must be (G, n_words) int32 with G >= 1, "
                         f"got {tuple(rings.shape)} {rings.dtype}")
    return sbf._on_cuda(rings[0], keys)


def binned_chunks(spec: FilterSpec, bin_row_bits: int,
                  device: torch.device) -> int:
    """The binned kernels' chunks on a CUDA ``device`` (the scatter's CTAs
    that fill the card)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _chunks_on(index, spec.s, V._log2i(spec.n_blocks), bin_row_bits)


@functools.lru_cache(maxsize=None)
def _chunks_on(index: int, s: int, log2_blocks: int,
               bin_row_bits: int) -> int:
    from repro_torch.kernels._build import library
    with torch.cuda.device(index):
        chunks = library().ring_binned_chunks(s, log2_blocks, bin_row_bits)
    if chunks < 1:
        raise ValueError(f"no binned ring kernels for s = {s}, 2^"
                         f"{log2_blocks} blocks in bins of 2^{bin_row_bits} "
                         f"rows on cuda:{index}")
    return chunks


def _workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """A binned call's u32 workspace (a test substitutes a fake). Freed
    when the call returns: the caching allocator orders its reuse after
    the call's kernels on the same stream."""
    return torch.empty(nbytes // 4, dtype=torch.int32, device=device)


def _card_plan(spec: FilterSpec, G: int, n: int, device: torch.device,
               l2_resident: bool, path: Optional[str],
               bin_row_bits: Optional[int], cap: int) -> tuple:
    """(plan, cap, workspace) of a call on the card: the rule's path unless
    one is given; for the binned path the bins that fit the card's shared
    memory and the workspace, allocated. Where the allocation fails the cap
    drops to :func:`cap_for_memory`'s from half the cap that failed, until
    the workspace allocates; ``MemoryError`` where none does."""
    smem = sbf.partition_smem_bytes(device)
    if bin_row_bits is None:
        bin_row_bits = bin_row_bits_for(spec.s, smem)
    if path is None:
        path = choose_contains_path(n, spec.n_words, G, spec.s, smem,
                                    l2_resident)
    if path == "one-pass":
        return contains_plan(n, spec.n_words, G, spec.s, path), cap, None
    chunks = binned_chunks(spec, bin_row_bits, device)
    while True:
        plan = contains_plan(n, spec.n_words, G, spec.s, path, bin_row_bits,
                             cap, chunks)
        try:
            return plan, cap, _workspace(plan["workspace_bytes"], device)
        except torch.cuda.OutOfMemoryError:
            cap = cap_for_memory(n, spec.n_words, G, spec.s, bin_row_bits,
                                 cap // 2, chunks, free_device_bytes(device))


def _launch(name: str, spec: FilterSpec, rings: torch.Tensor,
            keys: torch.Tensor, path: Optional[str],
            bin_row_bits: Optional[int], cap: int,
            theta: Optional[int]) -> torch.Tensor:
    from repro_torch.kernels._build import library
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    block_mask, s, variant, k, z, log2g = sbf._geometry(spec, rings[0], keys)
    if not rings.is_contiguous():
        raise ValueError("rings must be contiguous")
    G = rings.shape[0]
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    plan, cap, work = _card_plan(spec, G, n, keys.device,
                                 name == "ring_contains_vmem", path,
                                 bin_row_bits, cap)
    lib = library()
    salts = sbf._salts(keys.device).data_ptr()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        if plan["path"] == "one-pass":
            geo = contains_geometry(spec, theta)
            plan.update(theta=geo.theta, vec=geo.vec)
            err = lib.ring_contains(keys.data_ptr(), rings.data_ptr(),
                                    out.data_ptr(), salts, n, spec.n_words,
                                    G, block_mask, s, geo.theta, variant, k,
                                    z, log2g, stream)
        else:
            err = lib.ring_contains_binned(
                keys.data_ptr(), rings.data_ptr(), out.data_ptr(), salts,
                work.data_ptr(), n, spec.n_words, G, block_mask, s, variant,
                k, z, log2g, plan["bin_row_bits"], cap, plan["chunks"],
                stream)
    sbf._raise_on(err, name)
    LAUNCHES[name] += 1
    LAST_CONTAINS_PLAN.clear()
    LAST_CONTAINS_PLAN.update(plan)
    return out


def ring_contains_vmem(spec: FilterSpec, rings: torch.Tensor,
                       keys: torch.Tensor, *, path: Optional[str] = None,
                       bin_row_bits: Optional[int] = None,
                       cap: int = CONTAINS_KEY_CAP,
                       theta: Optional[int] = None) -> torch.Tensor:
    """Ring membership, L2-resident regime. (n,) bool.

    On the card the path is :func:`choose_contains_path`'s. The private
    arguments (tests and the smoke; ``ops`` never passes them): ``path``,
    ``bin_row_bits`` and ``cap`` (the binned path's bins and keys a batch)
    and ``theta`` (the one-pass Θ)."""
    if not _on_cuda(rings, keys):
        return ring_contains_ref(spec, rings, keys)
    return _launch("ring_contains_vmem", spec, rings, keys, path,
                   bin_row_bits, cap, theta)


def ring_contains_hbm(spec: FilterSpec, rings: torch.Tensor,
                      keys: torch.Tensor, depth: int = DEFAULT_DMA_DEPTH, *,
                      path: Optional[str] = None,
                      bin_row_bits: Optional[int] = None,
                      cap: int = CONTAINS_KEY_CAP,
                      theta: Optional[int] = None) -> torch.Tensor:
    """Ring membership, DRAM-resident regime. (n,) bool. The path and the
    private arguments as for :func:`ring_contains_vmem`; ``depth`` is
    validated as the JAX package does and taken by no schedule."""
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not _on_cuda(rings, keys):
        return ring_contains_ref(spec, rings, keys)
    return _launch("ring_contains_hbm", spec, rings, keys, path,
                   bin_row_bits, cap, theta)
