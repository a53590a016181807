"""Counting Bloom filter kernels (countingbf) for Hopper, and their plain
PyTorch versions.

Counterpart of ``repro.kernels.countingbf``. The seven wrappers keep the
JAX names, so each row of the kernel table maps one to one:

============== ================================== ===========================
wrapper        replaces (repro/kernels/           CUDA kernels
               countingbf.py)                     (csrc/counting.cu,
                                                  csrc/counting_contains.cu)
============== ================================== ===========================
update_vmem    update_vmem (L2 regime)            counting_update_kernel
                                                  (one-pass) or the binned
                                                  update: counting_bin_
                                                  count_kernel, bin_column_
                                                  kernel and bin_scan_kernel
                                                  (for at most
                                                  COLUMN_SCAN_BINS bins the
                                                  count kernel's last CTA
                                                  does both), counting_bin_
                                                  scatter_kernel,
                                                  counting_bin_
                                                  apply_kernel (and, where a
                                                  bin may pass SPLIT_SLOTS,
                                                  counting_bin_parts_kernel,
                                                  counting_bin_split_kernel)
contains_vmem  contains_vmem (L2 regime)          counting_contains_kernel,
                                                  DEPTH=1
update_hbm     update_hbm (DRAM regime)           as update_vmem
contains_hbm   contains_hbm (DRAM regime)         counting_contains_kernel,
                                                  DEPTH=depth
decay          decay                              counting_decay_kernel
bank_update_   bank_update_vmem                   as update_vmem, bank form
vmem
bank_contains_ bank_contains_vmem                 counting_contains_kernel,
vmem                                              bank form, DEPTH=depth
update_        update_partitioned                 counting_partitioned_
partitioned                                       grouped_kernel or
                                                  counting_partitioned_
                                                  global_kernel
============== ================================== ===========================

The updates have two paths on the card, which give the same counters. The
*one-pass* path gives a key min(4s, 32) lanes of a warp, a lane a counter
word of its row and a CAS loop on it where the key changes it: one
coalesced row request a key. The *binned* path groups a batch's keys by bin
(2^b consecutive counter rows; a bank's rows are its members' in order)
with a count, a scan and a scatter of 8-byte slots, then one CTA a bin of
at most ``SPLIT_SLOTS`` slots counting-sorts its keys by row in chunks and
updates each touched row once with the closed forms, plain stores, no
atomics on counters. A bin past ``SPLIT_SLOTS`` (skewed keys) is cut into
parts of ``PART_SLOTS`` that run at once where its rows' counts fit shared
memory: a part sums its chunks' counts per row there and applies them with
a CAS a counter word. :func:`choose_update_path`, a pure function of the
batch, the counters and the card's shared memory, picks the path; its
thresholds come from a sweep of both paths in turns on the H100
(``chip_smoke.py`` phase 4b; PERF.md). :func:`update_plan` gives a call's
plan and workspace, ``LAST_UPDATE_PLAN`` keeps the last card
call's, and :func:`update_binned_model` is the binned path's schedule in
plain PyTorch, for tests. The update wrappers take private ``path``,
``bin_row_bits`` and ``cap`` arguments (tests and the smoke; ``ops`` never
passes them). A binned call's workspace is allocated first; where that
fails, :func:`update_cap_for_memory` lowers the keys an internal batch
holds until it fits, and ``MemoryError`` is raised where none does.

``update_partitioned`` takes keys already bucketed by the counter segment
that owns their block, ``(n_segments, capacity, 2)`` with a valid mask, and
updates each valid slot's counters at ``start mod seg_cwords`` of its
segment. Two paths on the card give the same counters: ``"grouped"`` (one
CTA a segment counting-sorts chunks of its slots by row in shared memory
and updates each touched row once with the closed forms, no atomics on
counters) and ``"global"`` (a lane a counter word of a key's row, CAS
loops on global words). :func:`choose_partitioned_path`, a pure function
of the segment geometry and the card's shared memory, picks one; its
threshold comes from a sweep of both paths in turns on the H100
(``chip_smoke.py`` phase 4e; PERF.md). ``LAST_PARTITIONED_PLAN`` keeps the
last card call's plan (:func:`partitioned_plan`), and
:func:`update_partitioned_model` is the grouped path's schedule in plain
PyTorch, for tests.

The bank wrappers take a ``(B, storage_words)`` counter bank, flat keys
and ``member`` ``(n,)`` int32 ids in ``[0, B)`` (checked: a ``ValueError``
otherwise). One launch serves a bank in either regime; the JAX package
has only the VMEM kernels. A whole bank decays with one ``decay`` launch
over its flat counters.

Schedule axes. The contains is warp-cooperative, as the blocked contains:
``layout.theta`` is Θ, the lanes that own one key (clamped to s), each lane
owning 4s/Θ counter words of the key's row; ``layout.phi`` is the words a
lane loads at once (capped at 4, 128 bits); ``depth`` is the keys a group
keeps in flight, capped so that a lane holds at most 32 words
(:func:`contains_geometry`). ``contains_vmem`` runs the caller's layout,
and where it passes none, and always in ``contains_hbm`` and
``bank_contains_vmem``, which take none, :func:`card_layout` decides.
``LAST_GEOMETRY`` keeps each contains wrapper's last launch. Every other
axis is accepted and validated as the JAX package does it, and runs the
same kernels: the updates' ``layout``, ``tile``, ``probe="gather"`` and
``coop="subtile"`` (a warp's lanes own their keys' rows, and the binned
path sorts by row itself), and ``mix="cheap"`` (the kernels always share
the two hash streams' lane products, which gives the same hashes). No
axis changes a result.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]``,
counters ``(storage_words,)`` and ``valid`` ``(n,)`` uint8 or bool (or
``None``: every key valid). For CPU tensors a wrapper runs its plain version
(:func:`update_plain`, :func:`contains_plain`, :func:`decay_plain`); for
CUDA tensors it launches its kernels or raises. The update wrappers and
``decay`` change ``filt`` in place and return it. ``LAUNCHES`` counts
wrapper calls that launched kernels (one a call, whatever the path).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels import sbf
from repro_torch.kernels.cbf import free_device_bytes
from repro_torch.kernels.sbf import (DEFAULT_DMA_DEPTH, DEFAULT_TILE,
                                     DMA_DEPTHS, MAX_VEC,
                                     Layout,
                                     _check_axes, _on_cuda,
                                     _raise_on, _salts, check_bank,
                                     check_partitioned)

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"update_vmem": 0, "contains_vmem": 0, "update_hbm": 0,
            "contains_hbm": 0, "decay": 0, "bank_update_vmem": 0,
            "bank_contains_vmem": 0, "update_partitioned": 0}
# The geometry of each contains wrapper's last launch
LAST_GEOMETRY: dict = {}

UPDATE_PATHS = ("one-pass", "binned")
# Counter words a contains lane holds in flight (depth x 4s / Θ): 64 spilled
# and ran slower on the H100 (chip_smoke.py phase 4b; PERF.md)
MAX_CONTAINS_WORDS = 32
BINNED_CHUNK = 8192             # slots an apply CTA sorts at once
# A bin of more than SPLIT_SLOTS slots (skewed keys) is split into parts of
# PART_SLOTS that run at once, where its rows' counts fit shared memory
SPLIT_SLOTS = 4 * BINNED_CHUNK
PART_CHUNKS = 2
PART_SLOTS = PART_CHUNKS * BINNED_CHUNK
MAX_BINS = 8192                 # the count's and the scan's bins
COLUMN_SCAN_BINS = 1024         # bins the count kernel's last CTA scans
MAX_BIN_ROW_BITS = 13           # rows a bin: the apply's 32 KiB histogram
SCATTER_GROUP_BINS = 4096       # bins a scatter pass stages
SLOT_BYTES = 8                  # (row in bin << 32) | pattern hash
SECTOR_SLOTS = 4                # slots a 32-byte sector
FILL_SLOT = (1 << 64) - 1       # pads a run
# Keys an internal batch of the binned update holds: 2^26, a 512 MiB slot
# array (the DRAM cell's add is one batch). A larger cap only saves passes
# over the counters; a smaller one (lowered where the workspace does not
# fit the free memory) only adds internal batches.
UPDATE_KEY_CAP = 1 << 26
MAX_BATCH = 1 << 30             # the kernels' u32 slot offsets
# Device memory a binned call leaves free beside its workspace where the
# workspace at the cap did not fit
WORKSPACE_MARGIN = 1 << 28
# The update's path rule: by log2 of the counter bytes, the fewest and the
# most keys a call (None: no most) between which the binned update is no
# slower than one-pass; beyond 2^29 bytes the 2^29 entry holds, below 2^20
# bytes the one-pass path. Too few keys do not pay for the count, scan and
# scatter; too many keys a row (256 and more in filters of 2-16 MiB) leave
# a bin's apply summing hot rows serially. Fitted to a sweep of both paths
# in turns on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4b: B = 256,
# 2^20-2^29 counter bytes x 2^16-2^26 keys; PERF.md). Near 2^19 keys a
# binned call's time followed the host's speed while it made five to seven
# launches (binned lost by 12-22 % at 2^23 bytes on slow hosts); with four
# (the count kernel's last CTA scans and cuts parts, a kept workspace) its
# host time is ~24 us against ~69 us on the card, and binned took 0.062-
# 0.070 ms at 2^20-2^23 bytes against one-pass's 0.088-0.115, and 0.077
# against 0.085 at 2^24 bytes (so binned from 2^19 keys there too).
BINNED_KEYS = {20: (1 << 19, 1 << 21), 21: (1 << 19, 1 << 21),
               22: (1 << 19, 1 << 22), 23: (1 << 19, 1 << 23),
               24: (1 << 19, 1 << 24), 25: (1 << 20, 1 << 26),
               26: (1 << 21, None), 27: (1 << 21, None),
               28: (1 << 22, None), 29: (1 << 23, None)}

# The plans of the last update call on the card, by wrapper
LAST_UPDATE_PLAN: dict = {}

PARTITIONED_PATHS = ("global", "grouped")
_PATH_CODE = {"global": 0, "grouped": 1}
GROUPED_CHUNK = 4096            # slots a chunk of the grouped kernel
GROUPED_MAX_ROWS = 8192         # rows a segment: a 32 KiB histogram
GROUPED_STATIC_SMEM = 128       # the grouped kernel's scan sums
COUNT_CAP = 15                  # a per-nibble saturating count
# The path rule: the fewest segments and the most rows a segment at which
# the grouped kernel is the faster. One CTA a segment: with fewer segments
# too few CTAs fill the card; with more rows a segment each chunk zeroes,
# scans and walks a larger histogram. Fitted to a sweep of both paths in
# turns on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4e, the
# countingbf cells: global won at 64 segments of 4096 rows and at 512 of
# 8192, grouped at 128 of 2048 and at 1024 of 4096; PERF.md).
GROUPED_MIN_SEGMENTS = 128
GROUPED_RULE_ROWS = 4096

# The plan of the last update_partitioned call on the card
LAST_PARTITIONED_PLAN: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def counting_layout(spec: FilterSpec, layout: Layout, tile: int) -> Layout:
    """Validate a (Θ, Φ) layout against the expanded 4s-word counter row."""
    cs = spec.counter_row_words
    phi = min(layout.phi, cs)
    if phi < 1 or cs % phi:
        raise ValueError(f"phi={phi} must divide 4s={cs}")
    if layout.theta < 1 or tile % layout.theta:
        raise ValueError(f"theta={layout.theta} must divide tile={tile}")
    return Layout(layout.theta, phi)


def default_counting_layout(spec: FilterSpec, op: str) -> Layout:
    """Counting analogue of ``sbf.default_layout``: the same Θ rules, Φ
    scaled to the 4x-wider counter row."""
    cs = spec.counter_row_words
    if op == "contains":
        theta = min(max(1, spec.block_bits // 256), 8)
        return Layout(theta, max(1, min(8, cs // theta)))
    theta = min(spec.s, 8)
    return Layout(theta, max(1, min(cs // theta, 8)))


def card_layout(spec: FilterSpec) -> Layout:
    """The contains' (Θ, Φ) on the card where the caller passes no layout,
    in both regimes and for banks: Θ = s/2 lanes a key, a lane two logical
    words of the row (one 32-byte sector, two 16-byte loads, Φ = 4), so a
    key's row is one coalesced request; at 8 words a lane the tuner's depth
    8 runs as 4 (``MAX_CONTAINS_WORDS``). Fitted to a sweep of every Θ and
    depth in both countingbf cells (chip_smoke.py phase 4b; PERF.md)."""
    return Layout(max(1, spec.s // 2), MAX_VEC)


@dataclasses.dataclass(frozen=True)
class ContainsGeometry:
    """How the contains kernel runs (``csrc/counting_contains.cu``): a group
    of ``theta`` lanes owns a key, lane j the counter words ``[j * words,
    (j + 1) * words)`` of its row, loaded ``vec`` at a time; a group keeps
    ``depth`` keys in flight."""
    s: int
    theta: int
    vec: int
    depth: int

    @property
    def words(self) -> int:
        return 4 * self.s // self.theta


def _floor_pow2(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def contains_geometry(spec: FilterSpec, layout: Layout,
                      depth: int = 1) -> ContainsGeometry:
    """Resolve a layout and depth for the card: Θ clamped to s (and down to
    a power of two: the JAX layout allows Θ that divide the tile, and Θ
    never changes a result) and up to s/8, so that a lane owns at most
    ``MAX_CONTAINS_WORDS`` = 32 counter words; the load width Φ capped at
    4 words (a deeper schedule loads 4); the depth capped at 32 words a
    lane (``depth * 4s / Θ <= 32``). Raises ``ValueError`` for a depth not
    in ``DMA_DEPTHS``."""
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    theta = max(_floor_pow2(min(layout.theta, spec.s)),
                4 * spec.s // MAX_CONTAINS_WORDS, 1)
    words = 4 * spec.s // theta
    depth = min(depth, max(1, MAX_CONTAINS_WORDS // words))
    vec = MAX_VEC if depth > 1 else min(_floor_pow2(layout.phi), MAX_VEC)
    return ContainsGeometry(spec.s, theta, vec, depth)


def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op={op!r} not in {OPS}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def update_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """Plain version of ``update_vmem`` and ``update_hbm``: new
    (storage_words,) int32 counters (``filt`` is not modified), in memory
    proportional to the keys."""
    _check_op(op)
    if op == "add":
        return V.counting_add(spec, filt, keys, valid)
    return V.counting_remove(spec, filt, keys, valid)


def contains_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of ``contains_vmem`` and ``contains_hbm``: (n,) bool."""
    return V.counting_contains(spec, filt, keys)


def decay_plain(spec: FilterSpec, filt: torch.Tensor) -> torch.Tensor:
    """Plain version of ``decay``: new counters of ``filt``'s shape."""
    return V.counting_decay(spec, filt)


def bank_update_plain(spec: FilterSpec, bank: torch.Tensor,
                      keys: torch.Tensor, member: torch.Tensor,
                      valid: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """Plain version of ``bank_update_vmem``: new (B, storage_words) int32
    counters (``bank`` is not modified), in memory proportional to the
    keys."""
    _check_op(op)
    return V.bank_counting_update(spec, bank, keys, member, valid, op)


def update_partitioned_plain(spec: FilterSpec, filt: torch.Tensor,
                             keys_by_seg: torch.Tensor, valid: torch.Tensor,
                             op: str) -> torch.Tensor:
    """Plain version of ``update_partitioned``: new (storage_words,) int32
    counters (``filt`` is not modified)."""
    _check_op(op)
    return V.partitioned_counting_update(spec, filt, keys_by_seg, valid, op)


def grouped_rows(storage_words: int, n_segments: int, row_words: int
                 ) -> int:
    """Counter rows a segment holds, or 0 where a segment is not a whole
    number of rows."""
    if n_segments < 1 or storage_words % n_segments:
        return 0
    seg = storage_words // n_segments
    return seg // row_words if seg % row_words == 0 else 0


def grouped_smem_bytes(rows: int) -> int:
    """Shared memory a grouped CTA takes beyond the salts: the row
    histogram, the chunk's sorted patterns and the scan's sums."""
    return 4 * (rows + GROUPED_CHUNK) + GROUPED_STATIC_SMEM


def grouped_fits(storage_words: int, n_segments: int, row_words: int,
                 smem_bytes: int) -> bool:
    """Whether the grouped kernel takes these segments on a card with
    ``smem_bytes`` of shared memory a CTA (the salts' excluded)."""
    rows = grouped_rows(storage_words, n_segments, row_words)
    return (1 <= rows <= GROUPED_MAX_ROWS
            and grouped_smem_bytes(rows) <= smem_bytes)


def choose_partitioned_path(n_segments: int, storage_words: int,
                            row_words: int, smem_bytes: int) -> str:
    """The partitioned counting update's path on the card, a pure function
    of the segments (``n_segments`` of ``storage_words`` counter words, rows
    of ``row_words``) and the card's shared memory a CTA.

    Grouped where each segment's rows fit the grouped kernel's histogram
    and its CTA's shared memory, there are at least
    ``GROUPED_MIN_SEGMENTS`` segments (one CTA each) and a segment holds at
    most ``GROUPED_RULE_ROWS`` rows; else global. The path never changes a
    result."""
    if (n_segments >= GROUPED_MIN_SEGMENTS
            and grouped_rows(storage_words, n_segments,
                             row_words) <= GROUPED_RULE_ROWS
            and grouped_fits(storage_words, n_segments, row_words,
                             smem_bytes)):
        return "grouped"
    return "global"


def partitioned_plan(spec: FilterSpec, n_segments: int, capacity: int,
                     path: str) -> dict:
    """What a partitioned update runs: ``path``, ``n_segments``,
    ``capacity`` (slots a segment), ``rows`` (counter rows a segment),
    ``chunks`` (grouped: chunks a segment) and ``ctas``."""
    if path not in PARTITIONED_PATHS:
        raise ValueError(f"path must be one of {PARTITIONED_PATHS}, not "
                         f"{path!r}")
    rows = grouped_rows(spec.storage_words, n_segments,
                        spec.counter_row_words)
    if path == "grouped" and not 1 <= rows <= GROUPED_MAX_ROWS:
        raise ValueError(f"no grouped update of {spec} in {n_segments} "
                         f"segments ({rows} rows each; at most "
                         f"{GROUPED_MAX_ROWS})")
    chunks = -(-capacity // GROUPED_CHUNK) if path == "grouped" else 0
    ctas = (n_segments if path == "grouped"
            else -(-n_segments * capacity // 512))
    return {"path": path, "n_segments": n_segments, "capacity": capacity,
            "rows": rows, "chunks": chunks, "ctas": ctas}


def _nibbles(words: torch.Tensor) -> torch.Tensor:
    """(..., w) u32 words -> (..., w, 8) nibbles."""
    shifts = torch.arange(8, device=words.device) * V.COUNTER_BITS
    return (words[..., None] >> shifts) & V.COUNTER_MAX


def _closed_form(old: torch.Tensor, count: torch.Tensor, op: str
                 ) -> torch.Tensor:
    """Both updates' closed forms per nibble, from counts capped at 15."""
    if op == "add":
        return torch.clamp(old + count, max=V.COUNTER_MAX)
    return torch.where(old == V.COUNTER_MAX, old,
                       torch.clamp(old - count, min=0))


def update_partitioned_model(spec: FilterSpec, filt: torch.Tensor,
                             keys_by_seg: torch.Tensor, valid: torch.Tensor,
                             op: str, chunk: int = GROUPED_CHUNK
                             ) -> torch.Tensor:
    """The grouped kernel's schedule in plain PyTorch, for tests: new
    (storage_words,) int32 counters (``filt`` is not modified). Each
    segment's slots are walked in chunks of ``chunk``; a chunk's valid keys
    are grouped by their row in the segment, each touched row's per-nibble
    increments are summed (capped at 15, the kernel's saturating nibble
    counts: min(c, 15) gives both forms the same nibble) and applied once
    with the closed form, min(old + c, 15) for add, old == 15 ? 15 :
    max(old - c, 0) for remove. A small ``chunk`` makes rows span chunks,
    which the kernel runs in order."""
    _check_op(op)
    n_seg, cap = keys_by_seg.shape[0], keys_by_seg.shape[1]
    rw = spec.counter_row_words
    rows = grouped_rows(spec.storage_words, n_seg, rw)
    if rows < 1:
        raise ValueError(f"{spec}: {n_seg} segments are not whole rows")
    out = H.u32(filt).clone().reshape(n_seg, rows, rw)
    n_chunks = -(-cap // chunk)
    live_slots = torch.zeros((n_seg, n_chunks * chunk), dtype=torch.bool,
                             device=valid.device)
    live_slots[:, :cap] = valid != 0
    for seg, c in live_slots.reshape(n_seg, n_chunks, chunk).any(
            dim=2).nonzero().tolist():          # chunks with a valid slot
        c0 = c * chunk
        live = live_slots[seg, c0:c0 + chunk][: cap - c0]
        keys = keys_by_seg[seg, c0:c0 + chunk][live]
        h1, h2 = H.hash_keys(keys)
        row = (H.block_index(h2, spec.n_blocks) % rows).to(torch.int64)
        inc = _nibbles(V.expand_mask_words(V.block_patterns(spec, h1)))
        touched, inv = torch.unique(row, return_inverse=True)
        count = torch.zeros((touched.numel(), rw, 8), dtype=torch.int64,
                            device=inc.device).index_add_(0, inv, inc)
        count = count.clamp(max=COUNT_CAP)
        new = _closed_form(_nibbles(out[seg, touched]), count, op)
        shifts = torch.arange(8, device=new.device) * V.COUNTER_BITS
        out[seg, touched] = (new << shifts).sum(dim=-1)
    return H.to_i32(out.reshape(-1))


# ---------------------------------------------------------------------------
# The update's paths: the rule, the plan and the binned path's CPU model
# ---------------------------------------------------------------------------

def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def _check_path(path: Optional[str]) -> None:
    if path is not None and path not in UPDATE_PATHS:
        raise ValueError(f"path must be one of {UPDATE_PATHS}, not {path!r}")


def binned_bin_row_bits(total_rows: int, n: int) -> int:
    """Log2 of a bin's rows for a batch of ``n`` keys into ``total_rows``
    counter rows: the bin whose keys are about half an apply chunk
    (``BINNED_CHUNK``) at the batch's load, so that a touched row is read
    and written about once, within the kernels' limits (at most 2^13 rows a
    bin, at most ``MAX_BINS`` bins). Bins of half, twice and four times
    these rows were no faster in either cell (``chip_smoke.py`` phase 4b;
    PERF.md)."""
    top = min(MAX_BIN_ROW_BITS, _ceil_log2(total_rows))
    least = max(0, _ceil_log2(total_rows) - _ceil_log2(MAX_BINS))
    want = (BINNED_CHUNK // 2 * total_rows // max(n, 1)).bit_length() - 1
    return min(top, max(least, want))


def binned_smem_bytes(bin_row_bits: int) -> int:
    """Dynamic shared memory of an apply CTA: the bin's row histogram and a
    chunk's sorted patterns."""
    return 4 * ((1 << bin_row_bits) + BINNED_CHUNK)


def binned_fits(total_rows: int, bin_row_bits: int, smem: int) -> bool:
    """Whether the binned kernels take ``total_rows`` rows in bins of
    2^bin_row_bits rows on a card with ``smem`` bytes of shared memory a
    CTA (the salts' excluded)."""
    return (1 <= total_rows < 1 << 32
            and 0 <= bin_row_bits <= MAX_BIN_ROW_BITS
            and -(-total_rows // (1 << bin_row_bits)) <= MAX_BINS
            and binned_smem_bytes(bin_row_bits) <= smem)


def choose_update_path(n: int, storage_words: int, row_words: int,
                       smem: int) -> str:
    """The update's path on the card, a pure function of the batch (``n``
    keys), the counters (``storage_words`` words in rows of ``row_words``;
    a bank's whole ``(B, storage_words)``) and the card's shared memory a
    CTA.

    Binned where the counters' size has an entry in ``BINNED_KEYS``, the
    batch lies between its fewest and most keys, and the binned kernels
    take the geometry; else one-pass. The path never changes a result."""
    sizes = sorted(BINNED_KEYS)
    log2b = _ceil_log2(4 * storage_words)
    if log2b < sizes[0]:
        return "one-pass"
    least, most = BINNED_KEYS[min(log2b, sizes[-1])]
    total_rows = storage_words // row_words
    if (n < least or (most is not None and n > most)
            or not binned_fits(total_rows, binned_bin_row_bits(total_rows, n),
                               smem)):
        return "one-pass"
    return "binned"


def update_plan(spec: FilterSpec, n: int, path: str, members: int = 1,
                bin_row_bits: Optional[int] = None,
                cap: int = UPDATE_KEY_CAP, chunks: int = 1) -> dict:
    """What an update of ``n`` keys into ``members`` filters' counters
    runs: ``path``, ``total_rows`` (counter rows), ``bin_row_bits`` (log2
    of a bin's rows; :func:`binned_bin_row_bits` by default), ``n_bins``,
    ``batches`` (internal batches of at most ``cap`` keys),
    ``batch_keys``, ``chunks`` (the count and scatter CTAs, one a chunk of
    a batch's keys: the card's SMs), ``column_scan`` (``"fused"``: for at
    most ``COLUMN_SCAN_BINS`` bins the count kernel's last CTA does the
    column and the scan; else ``"two"``: their kernels), ``split_parts``
    (the most parts of ``PART_SLOTS`` slots a batch's bins past
    ``SPLIT_SLOTS`` can split into, 0 where a batch cannot fill such a bin:
    the split kernels run where it is not 0 and a bin's counts fit shared
    memory) and
    ``workspace_bytes`` (the device memory a call allocates: per-chunk
    counts, each bin's start, end and first part and the parts, u32,
    padded to 8 words, then a batch's 8-byte slots with each chunk's run in
    a bin padded to a 4-slot sector)."""
    if path not in UPDATE_PATHS:
        raise ValueError(f"path must be one of {UPDATE_PATHS}, not {path!r}")
    total_rows = members * spec.n_blocks
    if path == "one-pass":
        return {"path": path, "n": n, "members": members,
                "total_rows": total_rows, "bin_row_bits": None, "n_bins": 0,
                "batches": int(n > 0), "batch_keys": n, "chunks": 0,
                "column_scan": None, "split_parts": 0,
                "workspace_bytes": 0}
    if not 1 <= cap <= MAX_BATCH:
        raise ValueError(f"a batch must hold 1 .. 2^30 keys, not {cap}")
    batch_keys = min(n, cap)
    if bin_row_bits is None:
        bin_row_bits = binned_bin_row_bits(total_rows, batch_keys)
    if not binned_fits(total_rows, bin_row_bits, 1 << 62):
        raise ValueError(f"no binned update of {members} x {spec} in bins "
                         f"of 2^{bin_row_bits} rows")
    n_bins = -(-total_rows // (1 << bin_row_bits))
    slots = batch_keys + (SECTOR_SLOTS - 1) * chunks * n_bins
    return {"path": path, "n": n, "members": members,
            "total_rows": total_rows, "bin_row_bits": bin_row_bits,
            "n_bins": n_bins, "batches": -(-n // cap),
            "batch_keys": batch_keys, "chunks": chunks,
            "column_scan": ("fused" if n_bins <= COLUMN_SCAN_BINS
                            else "two"),
            "split_parts": (slots // PART_SLOTS if slots > SPLIT_SLOTS
                            else 0),
            "workspace_bytes": (4 * (-(-((chunks + 3) * n_bins + 1) // 8) * 8)
                                + SLOT_BYTES * slots)}


def update_cap_for_memory(spec: FilterSpec, n: int, members: int,
                          bin_row_bits: Optional[int], cap: int, chunks: int,
                          free_bytes: int) -> int:
    """The largest cap, ``cap`` halved as often as needed, whose binned
    plan has a workspace that fits ``free_bytes`` less
    ``WORKSPACE_MARGIN``. A smaller cap only adds internal batches, so the
    counters stay the same. Raises ``MemoryError`` where a batch of one key
    does not fit."""
    room = free_bytes - WORKSPACE_MARGIN
    while cap >= 1:
        if update_plan(spec, n, "binned", members, bin_row_bits, cap,
                       chunks)["workspace_bytes"] <= room:
            return cap
        cap //= 2
    raise MemoryError(f"no binned workspace for {n} keys fits {free_bytes} B "
                      f"of free device memory")


def update_binned_model(spec: FilterSpec, counters: torch.Tensor,
                        keys: torch.Tensor, valid: Optional[torch.Tensor],
                        op: str, bin_rows: int, chunk: int = BINNED_CHUNK,
                        member: Optional[torch.Tensor] = None,
                        cap: int = UPDATE_KEY_CAP,
                        part_chunks: int = PART_CHUNKS) -> torch.Tensor:
    """The binned update's schedule in plain PyTorch, for tests: new
    counters of ``counters``' shape (one filter's ``(storage_words,)`` or a
    ``(B, storage_words)`` bank with ``member`` ids; ``counters`` is not
    modified). Per internal batch of ``cap`` keys, each valid key's global
    row (a bank's member * n_blocks + block) falls in bin row // bin_rows;
    each bin's keys, in key order, are cut into chunks of ``chunk``; a
    chunk's keys are grouped by row, each touched row's per-nibble
    increments are summed and capped at 15 and applied once with the closed
    form. A bin of at most ``part_chunks`` chunks applies them in order; a
    larger bin's chunks form parts of ``part_chunks``, applied last part
    first (on the card the parts of a bin past ``SPLIT_SLOTS`` run at once,
    in any order, each summing its chunks' counts before it applies them:
    the forms compose). Small bins and chunks make rows span chunks and
    parts."""
    _check_op(op)
    rw = spec.counter_row_words
    out = H.u32(counters).clone().reshape(-1, rw)
    shifts = torch.arange(8, device=out.device) * V.COUNTER_BITS
    for first in range(0, keys.shape[0], cap):
        batch = keys[first:first + cap]
        live = (torch.ones(batch.shape[0], dtype=torch.bool,
                           device=batch.device) if valid is None
                else valid[first:first + cap] != 0)
        h1, h2 = H.hash_keys(batch[live])
        row = H.block_index(h2, spec.n_blocks).to(torch.int64)
        if member is not None:
            row = row + member[first:first + cap][live].to(
                torch.int64) * spec.n_blocks
        if row.numel() == 0:
            continue
        inc = _nibbles(V.expand_mask_words(V.block_patterns(spec, h1)))
        bins = row // bin_rows
        order = torch.argsort(bins, stable=True)
        counts = torch.bincount(bins, minlength=int(bins.max()) + 1)
        begin = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device) \
            - begin[bins[order]]
        c = rank // chunk
        parts = -(-counts[bins] // (chunk * part_chunks))
        step = torch.where(parts > 1, (parts - 1 - c // part_chunks)
                           * part_chunks + c % part_chunks, c)
        for t in range(int(step.max()) + 1):
            sel = step == t
            touched, inv = torch.unique(row[sel], return_inverse=True)
            count = torch.zeros((touched.numel(), rw, 8), dtype=torch.int64,
                                device=inc.device).index_add_(0, inv,
                                                              inc[sel])
            new = _closed_form(_nibbles(out[touched]),
                               count.clamp(max=COUNT_CAP), op)
            out[touched] = (new << shifts).sum(dim=-1)
    return H.to_i32(out.reshape(counters.shape))


def bank_contains_plain(spec: FilterSpec, bank: torch.Tensor,
                        keys: torch.Tensor, member: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of ``bank_contains_vmem``: (n,) bool."""
    return V.bank_counting_contains(spec, bank, keys, member)


# ---------------------------------------------------------------------------
# CUDA launch plumbing
# ---------------------------------------------------------------------------

def _check_counters(spec: FilterSpec, filt: torch.Tensor,
                    members: int = 1) -> None:
    if not spec.is_counting or spec.s > 32:
        raise ValueError(f"the CUDA counting kernels serve countingbf with "
                         f"s <= 32 words per block, not {spec}")
    if spec.storage_words >= 1 << 31:
        raise ValueError(f"{spec} has {spec.storage_words} counter words; "
                         f"counter-row starts must fit int32")
    if filt.numel() != members * spec.storage_words:
        raise ValueError(f"counters have {filt.numel()} words, spec "
                         f"{members} x {spec.storage_words}")
    if not filt.is_contiguous() or filt.data_ptr() % 16:
        raise ValueError("counter words must be contiguous and 16-byte "
                         "aligned")


def _check_keys(keys: torch.Tensor) -> None:
    if not keys.is_contiguous() or keys.data_ptr() % 8:
        raise ValueError("keys must be contiguous and 8-byte aligned")


def _valid_u8(valid: Optional[torch.Tensor], keys: torch.Tensor):
    if valid is None:
        return None
    if valid.shape != (keys.shape[0],):
        raise ValueError(f"valid must be ({keys.shape[0]},), got "
                         f"{tuple(valid.shape)}")
    if valid.device != keys.device:
        raise ValueError(f"valid on {valid.device}, keys on {keys.device}")
    if valid.dtype not in (torch.uint8, torch.bool):
        raise ValueError(f"valid must be uint8 or bool, got {valid.dtype}")
    return valid.contiguous().view(torch.uint8)


def _stream(device: torch.device) -> int:
    return sbf.raw_stream(device)


@functools.lru_cache(maxsize=None)
def _chunks_on(index: int, s: int, total_rows: int, bin_row_bits: int
               ) -> int:
    from repro_torch.kernels._build import library
    with torch.cuda.device(index):
        chunks = library().counting_binned_chunks(s, total_rows,
                                                  bin_row_bits)
    if chunks < 1:
        raise ValueError(f"no binned kernels for {total_rows} rows of s = "
                         f"{s} in bins of 2^{bin_row_bits} rows on "
                         f"cuda:{index}")
    return chunks


def binned_chunks(s: int, total_rows: int, bin_row_bits: int,
                  device: torch.device) -> int:
    """The binned kernels' chunks on a CUDA ``device`` (the scatter's CTAs
    that fill the card)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _chunks_on(index, s, total_rows, bin_row_bits)


# A binned call's workspace of at most KEPT_WORKSPACE_BYTES (a batch of up
# to ~2^19 keys, where a call's host time decides its speed) is taken from
# one kept per device and stream; the stream orders the calls' kernels.
KEPT_WORKSPACE_BYTES = 1 << 23
_kept_workspace: dict = {}


def _workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """A binned call's u32 workspace (a test substitutes a fake): a small
    one is the device and stream's kept workspace, a larger one is freed
    when the call returns (the caching allocator orders its reuse after the
    call's kernels on the same stream)."""
    if nbytes > KEPT_WORKSPACE_BYTES:
        return torch.empty(-(-nbytes // 4), dtype=torch.int32, device=device)
    key = (device.index, sbf.raw_stream(device))
    kept = _kept_workspace.get(key)
    if kept is None:
        kept = torch.empty(KEPT_WORKSPACE_BYTES // 4, dtype=torch.int32,
                           device=device)
        _kept_workspace[key] = kept
    return kept


@functools.lru_cache(maxsize=1024)
def _binned_plan(spec: FilterSpec, n: int, members: int, index: int,
                 bin_row_bits: Optional[int], cap: int, smem: int) -> dict:
    """The plan of a binned call of ``n`` keys at ``cap`` keys a batch on
    ``cuda:index``: the bins and the card's chunks. Kept by geometry, since
    working it out costs a small batch's host time again."""
    total_rows = members * spec.n_blocks
    if bin_row_bits is None:
        bin_row_bits = binned_bin_row_bits(total_rows, min(n, cap))
    if not binned_fits(total_rows, bin_row_bits, smem):
        raise ValueError(f"no binned update of {members} x {spec} in bins "
                         f"of 2^{bin_row_bits} rows on this card")
    chunks = _chunks_on(index, spec.s, total_rows, bin_row_bits)
    return update_plan(spec, n, "binned", members, bin_row_bits, cap, chunks)


def _binned_call(spec: FilterSpec, n: int, members: int,
                 device: torch.device, bin_row_bits: Optional[int],
                 cap: int, smem: int) -> tuple:
    """(plan, cap, workspace) of a binned call: the bins, the chunks of the
    card and the workspace, allocated. Free memory is asked for only where
    the allocation fails: then the cap drops to
    :func:`update_cap_for_memory`'s from half the cap that failed, until the
    workspace allocates; ``MemoryError`` where none does."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    plan = _binned_plan(spec, n, members, index, bin_row_bits, cap, smem)
    while True:
        try:
            return (dict(plan), cap,
                    _workspace(plan["workspace_bytes"], device))
        except torch.cuda.OutOfMemoryError:
            cap = update_cap_for_memory(spec, n, members,
                                        plan["bin_row_bits"], cap // 2,
                                        plan["chunks"],
                                        free_device_bytes(device))
            plan = _binned_plan(spec, n, members, index,
                                plan["bin_row_bits"], cap, smem)


def _launch_update(name: str, spec, filt, keys, valid, op: str,
                   member: Optional[torch.Tensor] = None, *,
                   path: Optional[str] = None,
                   bin_row_bits: Optional[int] = None,
                   cap: int = UPDATE_KEY_CAP) -> torch.Tensor:
    """One update call on the card, on the rule's path unless one is
    given."""
    from repro_torch.kernels._build import library
    members = 1 if member is None else filt.shape[0]
    _check_counters(spec, filt, members)
    _check_keys(keys)
    valid = _valid_u8(valid, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    device = keys.device
    smem = sbf.partition_smem_bytes(device)
    if path is None:
        path = choose_update_path(n, members * spec.storage_words,
                                  spec.counter_row_words, smem)
    ptrs = (keys.data_ptr(), None if member is None else member.data_ptr(),
            None if valid is None else valid.data_ptr(), filt.data_ptr(),
            _salts(device).data_ptr())
    lib = library()
    with sbf.device_scope(device):
        if path == "one-pass":
            plan = update_plan(spec, n, path, members)
            err = lib.counting_update(*ptrs, n, spec.storage_words,
                                      spec.n_blocks - 1, spec.s, spec.k,
                                      _OP_CODE[op], _stream(device))
        else:
            plan, cap, work = _binned_call(spec, n, members, device,
                                           bin_row_bits, cap, smem)
            err = lib.counting_update_binned(
                *ptrs, work.data_ptr(), n, plan["total_rows"],
                spec.n_blocks - 1, spec.s, spec.k, _OP_CODE[op],
                plan["bin_row_bits"], cap, plan["chunks"], _stream(device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    LAST_UPDATE_PLAN[name] = plan
    return filt


def _launch_contains(name: str, spec, filt, keys, geo: ContainsGeometry,
                     member: Optional[torch.Tensor] = None) -> torch.Tensor:
    from repro_torch.kernels._build import library
    _check_counters(spec, filt, 1 if member is None else filt.shape[0])
    _check_keys(keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with sbf.device_scope(keys.device):
        err = lib.counting_contains(
            keys.data_ptr(), None if member is None else member.data_ptr(),
            filt.data_ptr(), out.data_ptr(), _salts(keys.device).data_ptr(),
            n, spec.storage_words, spec.n_blocks - 1, spec.s, geo.theta,
            geo.vec, geo.depth, spec.k, _stream(keys.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    LAST_GEOMETRY[name] = geo
    return out


def _update_on_cuda(filt, keys, valid, op, path) -> bool:
    """Validate an update's inputs; True for CUDA tensors."""
    _check_op(op)
    _check_path(path)
    on_cuda = _on_cuda(filt, keys)
    _valid_u8(valid, keys)
    return on_cuda


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def update_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                valid: Optional[torch.Tensor], op: str,
                layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                probe: str = "loop", coop: str = "none",
                mix: str = "full", *, path: Optional[str] = None,
                bin_row_bits: Optional[int] = None,
                cap: int = UPDATE_KEY_CAP) -> torch.Tensor:
    """Bulk increment (``op="add"``) or guarded decrement (``"remove"``),
    L2-resident regime; updates ``filt`` in place.

    On the card the path is :func:`choose_update_path`'s. ``path``,
    ``bin_row_bits`` and ``cap`` are private (tests and the smoke; ``ops``
    never passes them): a forced path, the bins' rows and the keys an
    internal batch of the binned path holds."""
    _check_axes(probe, coop, mix)
    counting_layout(spec, layout or default_counting_layout(spec, op), tile)
    if not _update_on_cuda(filt, keys, valid, op, path):
        return filt.copy_(update_plain(spec, filt, keys, valid, op))
    return _launch_update("update_vmem", spec, filt, keys, valid, op,
                          path=path, bin_row_bits=bin_row_bits, cap=cap)


def contains_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                  probe: str = "loop", coop: str = "none",
                  mix: str = "full") -> torch.Tensor:
    """Bulk membership on counter occupancy, L2-resident regime, at the
    caller's layout (else :func:`card_layout`). (n,) bool."""
    _check_axes(probe, coop, mix)
    if layout is None:
        counting_layout(spec, default_counting_layout(spec, "contains"),
                        tile)
        run = card_layout(spec)
    else:
        run = counting_layout(spec, layout, tile)
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_vmem", spec, filt, keys,
                            contains_geometry(spec, run))


def update_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
               valid: Optional[torch.Tensor], op: str, coop: str = "none",
               mix: str = "full", *, path: Optional[str] = None,
               bin_row_bits: Optional[int] = None,
               cap: int = UPDATE_KEY_CAP) -> torch.Tensor:
    """Bulk update, DRAM-resident regime; updates ``filt`` in place. The
    path and the private arguments are :func:`update_vmem`'s."""
    _check_axes(coop=coop, mix=mix)
    if not _update_on_cuda(filt, keys, valid, op, path):
        return filt.copy_(update_plain(spec, filt, keys, valid, op))
    return _launch_update("update_hbm", spec, filt, keys, valid, op,
                          path=path, bin_row_bits=bin_row_bits, cap=cap)


def contains_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 depth: int = DEFAULT_DMA_DEPTH, coop: str = "none",
                 mix: str = "full") -> torch.Tensor:
    """Bulk membership, DRAM-resident regime, at :func:`card_layout` with
    ``depth`` keys a group in flight. (n,) bool."""
    _check_axes(coop=coop, mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_hbm", spec, filt, keys,
                            contains_geometry(spec, card_layout(spec), depth))


def decay(spec: FilterSpec, filt: torch.Tensor, tile_words: int = 4096
          ) -> torch.Tensor:
    """One aging step over the whole counter array (every nonzero counter
    -1); updates ``filt`` in place. ``filt`` is one filter's
    ``(storage_words,)`` counters or a bank's ``(B, storage_words)``: a
    bank decays whole in one launch."""
    nw = spec.storage_words
    tile_words = min(tile_words, nw)
    if tile_words < 1 or nw % tile_words:
        raise ValueError(f"tile_words={tile_words} must divide {nw}")
    if (filt.ndim not in (1, 2) or filt.dtype != torch.int32
            or filt.shape[-1] != nw):
        raise ValueError(f"counter words must be (storage_words,) or "
                         f"(B, storage_words) int32, got "
                         f"{tuple(filt.shape)} {filt.dtype}")
    if filt.device.type == "cpu":
        return filt.copy_(decay_plain(spec, filt))
    if filt.device.type != "cuda":
        raise ValueError(f"unsupported device {filt.device}")
    from repro_torch.kernels._build import library
    _check_counters(spec, filt, filt.numel() // nw)
    lib = library()
    with torch.cuda.device(filt.device):
        err = lib.counting_decay(filt.data_ptr(), filt.numel(),
                                 _stream(filt.device))
    _raise_on(err, "decay")
    LAUNCHES["decay"] += 1
    return filt


def update_partitioned(spec: FilterSpec, filt: torch.Tensor,
                       keys_by_seg: torch.Tensor, valid: torch.Tensor,
                       n_segments: int, op: str, mix: str = "full", *,
                       path: Optional[str] = None) -> torch.Tensor:
    """Increment (``op="add"``) or guarded decrement (``"remove"``) of the
    valid slots of ``keys_by_seg`` (n_segments, capacity, 2), each in the
    counter segment that owns it, one launch. Updates ``filt`` in place.

    On the card the path is :func:`choose_partitioned_path`'s; ``path`` is
    private (tests and the smoke; ``ops`` never passes it)."""
    _check_axes(mix=mix)
    _check_op(op)
    if path is not None and path not in PARTITIONED_PATHS:
        raise ValueError(f"path must be one of {PARTITIONED_PATHS}, not "
                         f"{path!r}")
    if not spec.is_counting:
        raise ValueError(f"{spec} is not a countingbf spec")
    if not check_partitioned(filt, keys_by_seg, valid, n_segments,
                             spec.storage_words):
        return filt.copy_(update_partitioned_plain(spec, filt, keys_by_seg,
                                                   valid, op))
    from repro_torch.kernels._build import library
    _check_counters(spec, filt)
    if path is None:
        path = choose_partitioned_path(
            n_segments, spec.storage_words, spec.counter_row_words,
            sbf.partition_smem_bytes(filt.device))
    plan = partitioned_plan(spec, n_segments, keys_by_seg.shape[1], path)
    _check_keys(keys_by_seg)
    valid = valid.contiguous().view(torch.uint8)
    lib = library()
    with torch.cuda.device(filt.device):
        err = lib.counting_update_partitioned(
            keys_by_seg.data_ptr(), valid.data_ptr(), filt.data_ptr(),
            _salts(filt.device).data_ptr(), n_segments,
            keys_by_seg.shape[1], spec.storage_words // n_segments,
            spec.n_blocks - 1, spec.s, spec.k, _OP_CODE[op],
            _PATH_CODE[path], _stream(filt.device))
    _raise_on(err, "update_partitioned")
    LAUNCHES["update_partitioned"] += 1
    LAST_PARTITIONED_PLAN.clear()
    LAST_PARTITIONED_PLAN.update(plan)
    return filt


def bank_update_vmem(spec: FilterSpec, bank: torch.Tensor,
                     keys: torch.Tensor, member: torch.Tensor,
                     valid: Optional[torch.Tensor], op: str,
                     layout: Optional[Layout] = None,
                     tile: int = DEFAULT_TILE, probe: str = "gather",
                     mix: str = "full", *, path: Optional[str] = None,
                     bin_row_bits: Optional[int] = None,
                     cap: int = UPDATE_KEY_CAP) -> torch.Tensor:
    """Flat routed increment (``op="add"``) or guarded decrement
    (``"remove"``) of a (B, storage_words) counter bank, one launch, both
    regimes; slots with ``valid`` 0 are skipped. Updates ``bank`` in
    place. The path (of the whole bank's counters) and the private
    arguments are :func:`update_vmem`'s."""
    _check_axes(probe=probe, mix=mix)
    _check_op(op)
    _check_path(path)
    counting_layout(spec, layout or default_counting_layout(spec, op), tile)
    if not check_bank(spec, bank, keys, member, valid,
                      width=spec.storage_words):
        return bank.copy_(bank_update_plain(spec, bank, keys, member, valid,
                                            op))
    return _launch_update("bank_update_vmem", spec, bank, keys, valid, op,
                          member, path=path, bin_row_bits=bin_row_bits,
                          cap=cap)


def bank_contains_vmem(spec: FilterSpec, bank: torch.Tensor,
                       keys: torch.Tensor, member: torch.Tensor,
                       mix: str = "full", depth: int = 1) -> torch.Tensor:
    """Flat routed occupancy membership against a counter bank, one
    launch at :func:`card_layout`; ``depth=1`` is the L2 regime, a larger
    ``depth`` the DRAM regime. The JAX wrapper's key ``tile`` exists for
    the plain path's padding (``ops``), so this one takes none. (n,)
    bool."""
    _check_axes(mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not check_bank(spec, bank, keys, member, width=spec.storage_words):
        return bank_contains_plain(spec, bank, keys, member)
    return _launch_contains("bank_contains_vmem", spec, bank, keys,
                            contains_geometry(spec, card_layout(spec), depth),
                            member)
