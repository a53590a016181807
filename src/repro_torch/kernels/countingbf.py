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
update_        update_partitioned                 counting_update_
partitioned                                       partitioned_kernel
============== ================================== ===========================

``update_partitioned`` takes keys already bucketed by the counter segment
that owns their block, ``(n_segments, capacity, 2)`` with a valid mask, and
updates each valid slot's counters at ``start mod seg_cwords`` of its
segment; as ``sbf.add_partitioned``, a segment that fits shared memory is
staged there by one CTA (no global atomics), a larger one takes the
global CAS loops.

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

from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import (DEFAULT_DMA_DEPTH, DEFAULT_TILE,
                                     DMA_DEPTHS, MAX_WORDS_IN_FLIGHT, Layout,
                                     _check_axes, _on_cuda, _raise_on, _salts,
                                     check_bank, check_partitioned,
                                     segment_fits)

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"update_vmem": 0, "contains_vmem": 0, "update_hbm": 0,
            "contains_hbm": 0, "decay": 0, "bank_update_vmem": 0,
            "bank_contains_vmem": 0, "update_partitioned": 0}


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
                       n_segments: int, op: str, mix: str = "full"
                       ) -> torch.Tensor:
    """Increment (``op="add"``) or guarded decrement (``"remove"``) of the
    valid slots of ``keys_by_seg`` (n_segments, capacity, 2), each in the
    counter segment that owns it, one launch (segments in shared memory
    where they fit). Updates ``filt`` in place."""
    _check_axes(mix=mix)
    _check_op(op)
    if not spec.is_counting:
        raise ValueError(f"{spec} is not a countingbf spec")
    if not check_partitioned(filt, keys_by_seg, valid, n_segments,
                             spec.storage_words):
        return filt.copy_(update_partitioned_plain(spec, filt, keys_by_seg,
                                                   valid, op))
    from repro_torch.kernels._build import library
    _check_counters(spec, filt)
    seg_cwords = spec.storage_words // n_segments
    sh = segment_fits(seg_cwords, filt.device)
    valid = valid.contiguous().view(torch.uint8)
    lib = library()
    with torch.cuda.device(filt.device):
        err = lib.counting_update_partitioned(
            keys_by_seg.data_ptr(), valid.data_ptr(), filt.data_ptr(),
            _salts(filt.device).data_ptr(), n_segments,
            keys_by_seg.shape[1], seg_cwords, spec.n_blocks - 1, spec.s,
            spec.k, _OP_CODE[op], int(sh), _stream(filt.device))
    _raise_on(err, "update_partitioned")
    LAUNCHES["update_partitioned"] += 1
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
