"""Counting Bloom filter kernels (countingbf) for Hopper, and their plain
PyTorch versions.

Counterpart of ``repro.kernels.countingbf``. The seven wrappers keep the
JAX names, so each row of the kernel table maps one to one:

============== ================================== ===========================
wrapper        replaces (repro/kernels/           CUDA kernel
               countingbf.py)                     (csrc/counting.cu)
============== ================================== ===========================
update_vmem    update_vmem (L2 regime)            counting_update_kernel
contains_vmem  contains_vmem (L2 regime)          counting_contains_kernel,
                                                  DEPTH=1, PHI=min(phi, 4)
update_hbm     update_hbm (DRAM regime)           counting_update_kernel
contains_hbm   contains_hbm (DRAM regime)         counting_contains_kernel,
                                                  DEPTH=depth, PHI=4
decay          decay                              counting_decay_kernel
bank_update_   bank_update_vmem                   counting_update_kernel,
vmem                                              bank form
bank_contains_ bank_contains_vmem                 counting_contains_kernel,
vmem                                              bank form, PHI=4,
                                                  DEPTH=depth
update_        update_partitioned                 counting_partitioned_
partitioned                                       grouped_kernel or
                                                  counting_partitioned_
                                                  global_kernel
============== ================================== ===========================

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
otherwise). One kernel serves a bank in L2 (``depth=1``) and one in DRAM
(``depth`` keys a thread); the JAX package has only the VMEM kernels. A
whole bank decays with one ``decay`` launch over its flat counters.

Schedule axes. The kernels act on ``layout.phi`` (the vector width of the
counter-row loads, capped at 4 words = 128 bits) in ``contains_vmem`` and on
``depth`` (keys per thread, their loads in flight together) in
``contains_hbm``; at most 64 mask words stay in registers per thread, so
``depth`` is capped at ``64 // s``. Every other axis is accepted and
validated as the JAX package does it, and runs the same kernel:
``layout.theta``, ``tile`` and ``tile_words`` (a CUDA thread owns its keys
or words), ``probe="gather"`` and ``coop="subtile"`` (per-thread atomic
updates need neither the sorted segment totals nor the per-word sort, and
the contains walk already stops at a key's first failing word), and
``mix="cheap"`` (the kernels always share the two hash streams' lane
products, which gives the same hashes). No axis changes a result.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]``,
counters ``(storage_words,)`` and ``valid`` ``(n,)`` uint8 or bool (or
``None``: every key valid). For CPU tensors a wrapper runs its plain version
(:func:`update_plain`, :func:`contains_plain`, :func:`decay_plain`); for
CUDA tensors it launches its kernel or raises. The update wrappers and
``decay`` change ``filt`` in place and return it. ``LAUNCHES`` counts
kernel launches per wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels import sbf
from repro_torch.kernels.sbf import (DEFAULT_DMA_DEPTH, DEFAULT_TILE,
                                     DMA_DEPTHS, MAX_WORDS_IN_FLIGHT, Layout,
                                     _check_axes, _on_cuda, _raise_on, _salts,
                                     check_bank, check_partitioned)

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"update_vmem": 0, "contains_vmem": 0, "update_hbm": 0,
            "contains_hbm": 0, "decay": 0, "bank_update_vmem": 0,
            "bank_contains_vmem": 0, "update_partitioned": 0}


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
        old = _nibbles(out[seg, touched])
        if op == "add":
            new = torch.clamp(old + count, max=V.COUNTER_MAX)
        else:
            new = torch.where(old == V.COUNTER_MAX, old,
                              torch.clamp(old - count, min=0))
        shifts = torch.arange(8, device=new.device) * V.COUNTER_BITS
        out[seg, touched] = (new << shifts).sum(dim=-1)
    return H.to_i32(out.reshape(-1))


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
    return torch.cuda.current_stream(device).cuda_stream


def _launch_update(name: str, spec, filt, keys, valid, op: str
                   ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    _check_counters(spec, filt)
    _check_keys(keys)
    valid = _valid_u8(valid, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.counting_update(
            keys.data_ptr(), None if valid is None else valid.data_ptr(),
            filt.data_ptr(), _salts(keys.device).data_ptr(), n,
            spec.n_blocks - 1, spec.s, spec.k, _OP_CODE[op],
            _stream(keys.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return filt


def _launch_contains(name: str, spec, filt, keys, phi: int, depth: int
                     ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    _check_counters(spec, filt)
    _check_keys(keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.counting_contains(
            keys.data_ptr(), filt.data_ptr(), out.data_ptr(),
            _salts(keys.device).data_ptr(), n, spec.n_blocks - 1, spec.s,
            phi, depth, spec.k, _stream(keys.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _launch_bank_update(spec, bank, keys, member, valid, op: str
                        ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    _check_counters(spec, bank, bank.shape[0])
    _check_keys(keys)
    valid = _valid_u8(valid, keys)
    n = keys.shape[0]
    if n == 0:
        return bank
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.counting_bank_update(
            keys.data_ptr(), member.data_ptr(),
            None if valid is None else valid.data_ptr(), bank.data_ptr(),
            _salts(keys.device).data_ptr(), n, spec.storage_words,
            spec.n_blocks - 1, spec.s, spec.k, _OP_CODE[op],
            _stream(keys.device))
    _raise_on(err, "bank_update_vmem")
    LAUNCHES["bank_update_vmem"] += 1
    return bank


def _launch_bank_contains(spec, bank, keys, member, depth: int
                          ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    _check_counters(spec, bank, bank.shape[0])
    _check_keys(keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.counting_bank_contains(
            keys.data_ptr(), member.data_ptr(), bank.data_ptr(),
            out.data_ptr(), _salts(keys.device).data_ptr(), n,
            spec.storage_words, spec.n_blocks - 1, spec.s, 4, depth, spec.k,
            _stream(keys.device))
    _raise_on(err, "bank_contains_vmem")
    LAUNCHES["bank_contains_vmem"] += 1
    return out


def _depth_in_flight(spec: FilterSpec, depth: int) -> int:
    return min(depth, max(1, MAX_WORDS_IN_FLIGHT // spec.s))


def _update_on_cuda(filt, keys, valid, op) -> bool:
    """Validate an update's inputs; True for CUDA tensors."""
    _check_op(op)
    on_cuda = _on_cuda(filt, keys)
    _valid_u8(valid, keys)
    return on_cuda


# ---------------------------------------------------------------------------
# The five wrappers
# ---------------------------------------------------------------------------

def update_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                valid: Optional[torch.Tensor], op: str,
                layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                probe: str = "loop", coop: str = "none",
                mix: str = "full") -> torch.Tensor:
    """Bulk increment (``op="add"``) or guarded decrement (``"remove"``),
    L2-resident regime; updates ``filt`` in place."""
    _check_axes(probe, coop, mix)
    counting_layout(spec, layout or default_counting_layout(spec, op), tile)
    if not _update_on_cuda(filt, keys, valid, op):
        return filt.copy_(update_plain(spec, filt, keys, valid, op))
    return _launch_update("update_vmem", spec, filt, keys, valid, op)


def contains_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                  probe: str = "loop", coop: str = "none",
                  mix: str = "full") -> torch.Tensor:
    """Bulk membership on counter occupancy, L2-resident regime. (n,) bool."""
    _check_axes(probe, coop, mix)
    layout = counting_layout(
        spec, layout or default_counting_layout(spec, "contains"), tile)
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_vmem", spec, filt, keys,
                            phi=min(layout.phi, 4), depth=1)


def update_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
               valid: Optional[torch.Tensor], op: str, coop: str = "none",
               mix: str = "full") -> torch.Tensor:
    """Bulk update, DRAM-resident regime; updates ``filt`` in place."""
    _check_axes(coop=coop, mix=mix)
    if not _update_on_cuda(filt, keys, valid, op):
        return filt.copy_(update_plain(spec, filt, keys, valid, op))
    return _launch_update("update_hbm", spec, filt, keys, valid, op)


def contains_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 depth: int = DEFAULT_DMA_DEPTH, coop: str = "none",
                 mix: str = "full") -> torch.Tensor:
    """Bulk membership, DRAM-resident regime. (n,) bool."""
    _check_axes(coop=coop, mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_hbm", spec, filt, keys, phi=4,
                            depth=_depth_in_flight(spec, depth))


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
                     mix: str = "full") -> torch.Tensor:
    """Flat routed increment (``op="add"``) or guarded decrement
    (``"remove"``) of a (B, storage_words) counter bank, one launch, both
    regimes; slots with ``valid`` 0 are skipped. Updates ``bank`` in
    place."""
    _check_axes(probe=probe, mix=mix)
    _check_op(op)
    counting_layout(spec, layout or default_counting_layout(spec, op), tile)
    if not check_bank(spec, bank, keys, member, valid,
                      width=spec.storage_words):
        return bank.copy_(bank_update_plain(spec, bank, keys, member, valid,
                                            op))
    return _launch_bank_update(spec, bank, keys, member, valid, op)


def bank_contains_vmem(spec: FilterSpec, bank: torch.Tensor,
                       keys: torch.Tensor, member: torch.Tensor,
                       mix: str = "full", depth: int = 1) -> torch.Tensor:
    """Flat routed occupancy membership against a counter bank, one
    launch; ``depth=1`` is the L2 regime, a larger ``depth`` the DRAM
    regime. The JAX wrapper's key ``tile`` exists for the plain path's
    padding (``ops``), so this one takes none. (n,) bool."""
    _check_axes(mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not check_bank(spec, bank, keys, member, width=spec.storage_words):
        return bank_contains_plain(spec, bank, keys, member)
    return _launch_bank_contains(spec, bank, keys, member,
                                 depth=_depth_in_flight(spec, depth))
