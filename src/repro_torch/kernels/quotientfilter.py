"""Counting quotient filter kernels for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.quotientfilter``; the wrappers keep the JAX
names, so each row of the kernel table maps one to one:

============= =================================== ==========================
wrapper       replaces (repro/kernels/            CUDA kernels
              quotientfilter.py)                  (csrc/quotient.cu)
============= =================================== ==========================
contains_vmem contains_vmem                       quotient_contains_kernel,
                                                  or the table pass
add_vmem      add_vmem (_update_vmem, op add)     quotient_update, add
remove_vmem   remove_vmem (_update_vmem, op       quotient_update, remove
              remove)
============= =================================== ==========================

The JAX package runs these kernels only on a table that fits VMEM and sends
a larger one to its jnp reference; here one kernel set serves every size,
as ``kernels.ops`` dispatches it. ``coop`` is validated and both values run
the same contains kernels: a batch of fewer than ``n_slots / 16`` keys
walks each key's cluster; for a larger one the card chooses between that
walk and the table pass (every run's start once a call, then a compare
along each key's own run) by the table's load (``quotient.cu``
``choose_kernel``). The tile-wide early exit has nothing to skip in
either. The update wrappers
take the JAX ``tile``: the table and flags are the same for every tile
(``core.quotient``), so the plain version chunks the batch by it and the
CUDA update rebuilds the table once a call whatever the tile.

``merge_vmem`` and ``resize_vmem`` are not ports of TPU kernels (the JAX
package computes merge and resize outside Pallas): on the card they decode
the stored fingerprints with the update's stages and add them, with the
update's kernels, into the other table or an empty one of the new
geometry; their plain versions are ``core.quotient``'s.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]``, the
table ``(n_words,)`` and ``valid`` ``(n,)`` uint8 or bool (or ``None``:
every key valid). For CPU tensors a wrapper runs its plain version; for
CUDA tensors it launches its kernels or raises. The update wrappers change
the table in place and return ``(table, flags)``. ``LAUNCHES`` counts
wrapper calls that launched their kernels (one a call, whose stream is
1, 7 or 9 contains kernels, 20-23 update kernels, or 30 for a merge or
resize).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quotient as Q
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import COOPS, _on_cuda, _raise_on

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}
SLOT_BITS = (8, 16, 32)        # lane widths with a kernel instance
MAX_Q_BITS = 29                # the update's scans index slots in int32
SCAN_TILE = 4096               # elements a scan block takes (quotient.cu)
PASS_SLOTS_PER_KEY = 16        # the pass is a choice from n_slots / 16 keys
CONTAINS_MODES = ("walk", "pass", "auto")

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0, "remove_vmem": 0,
            "merge_vmem": 0, "resize_vmem": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_supported(spec: FilterSpec) -> bool:
    """Quotient specs the CUDA kernels serve: u8/u16/u32 lanes and at most
    2^29 slots."""
    return (spec.is_quotient and spec.slot_bits in SLOT_BITS
            and spec.q_bits <= MAX_Q_BITS)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def contains_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                   coop: str = "none") -> torch.Tensor:
    """Plain version of ``contains_vmem``: (n,) bool."""
    if coop == "subtile":
        return Q.quotient_contains_coop(spec, table, keys)
    return Q.quotient_contains(spec, table, keys)


def update_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor], op: str,
                 tile: Optional[int] = None):
    """Plain version of ``add_vmem`` / ``remove_vmem``: (new table, flags
    (n,) bool); ``table`` is not modified."""
    _check_op(op)
    fn = Q.quotient_add if op == "add" else Q.quotient_remove
    return fn(spec, table, keys, valid=valid, tile=tile)


merge_plain = Q.quotient_merge         # plain version of merge_vmem
resize_plain = Q.quotient_resize       # plain version of resize_vmem


# ---------------------------------------------------------------------------
# Layout checks and launches
# ---------------------------------------------------------------------------

def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op={op!r} not in {OPS}")


def _check_layout(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  valid=None) -> bool:
    """Validate the tensors of a call: True for CUDA tensors, False for CPU
    tensors; ``ValueError`` otherwise."""
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    on_cuda = _on_cuda(table, keys)
    if table.numel() != spec.n_words:
        raise ValueError(f"table has {table.numel()} words, spec "
                         f"{spec.n_words}")
    if valid is not None:
        if valid.shape != (keys.shape[0],):
            raise ValueError(f"valid must be ({keys.shape[0]},), got "
                             f"{tuple(valid.shape)}")
        if valid.device != keys.device:
            raise ValueError(f"valid on {valid.device}, keys on "
                             f"{keys.device}")
        if valid.dtype not in (torch.uint8, torch.bool):
            raise ValueError(f"valid must be uint8 or bool, got "
                             f"{valid.dtype}")
    if not on_cuda:
        return False
    if not kernel_supported(spec):
        raise ValueError(f"the CUDA quotient kernels serve u8/u16/u32 lanes "
                         f"and at most 2^{MAX_Q_BITS} slots, not {spec}")
    if not (keys.is_contiguous() and table.is_contiguous()):
        raise ValueError("keys and table words must be contiguous")
    if keys.data_ptr() % 8 or table.data_ptr() % 4:
        raise ValueError("keys must be 8-byte and words 4-byte aligned")
    return True


def _geometry(spec: FilterSpec):
    return spec.q_bits, spec.r_bits, spec.slot_bits, Q.FP_SALT


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scratch(spec: FilterSpec, slot_arrays: int, n: int, device):
    """(per-slot int32 arrays, scan block sums, their count, scalars): the
    scratch of the kernels' decode and scans."""
    n_aggs = max(math.ceil(max(spec.n_slots, n) / SCAN_TILE), 1)
    return (torch.empty((slot_arrays * spec.n_slots,), dtype=torch.int32,
                        device=device),
            torch.empty((n_aggs,), dtype=torch.int64, device=device), n_aggs,
            torch.empty((8,), dtype=torch.int64, device=device))


def _launch_update(spec, table, keys, valid, op: str, fps=None):
    """The update kernels on ``keys`` (n, 2), or on fingerprints ``fps``
    (n,) int32 when given; ``table`` is rebuilt in place. Returns flags."""
    from repro_torch.kernels._build import library
    dev = table.device
    n = (keys if fps is None else fps).shape[0]
    flags = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return flags
    if valid is not None:
        valid = valid.contiguous().view(torch.uint8)
    ws_slots, aggs, n_aggs, scal = _scratch(spec, 5, n, dev)
    ws_keys = torch.empty((2 * n,), dtype=torch.int32, device=dev)
    new_table = torch.empty_like(table)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.quotient_update(
            None if keys is None else keys.data_ptr(),
            None if fps is None else fps.data_ptr(),
            None if valid is None else valid.data_ptr(),
            table.data_ptr(), new_table.data_ptr(), flags.data_ptr(), n,
            *_geometry(spec), _OP_CODE[op], ws_slots.data_ptr(),
            ws_keys.data_ptr(), aggs.data_ptr(), n_aggs, scal.data_ptr(),
            _stream(dev))
    _raise_on(err, f"quotient {op}")
    return flags


def _launch_contains(spec, table, keys, mode: str) -> torch.Tensor:
    """The contains kernels: the cluster walk, the table pass, or ("auto")
    the one the card chooses by the table's load."""
    from repro_torch.kernels._build import library
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    ws = (None, None, 0, None)
    if mode != "walk":
        ws = _scratch(spec, 3, 0, keys.device)
    ws_slots, aggs, n_aggs, scal = ws
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.quotient_contains(keys.data_ptr(), table.data_ptr(),
                                    out.data_ptr(), n, *_geometry(spec),
                                    CONTAINS_MODES.index(mode),
                                    ptr(ws_slots), ptr(aggs), n_aggs,
                                    ptr(scal), _stream(keys.device))
    _raise_on(err, "contains_vmem")
    return out


def _decode(spec: FilterSpec, table: torch.Tensor):
    """The stored fingerprints on the card: (fps (n_slots,) int32, valid
    (n_slots,) uint8), slot by slot."""
    from repro_torch.kernels._build import library
    dev = table.device
    fps = torch.empty((spec.n_slots,), dtype=torch.int32, device=dev)
    valid = torch.empty((spec.n_slots,), dtype=torch.uint8, device=dev)
    ws_slots, aggs, n_aggs, scal = _scratch(spec, 3, 0, dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.quotient_decode(table.data_ptr(), fps.data_ptr(),
                                  valid.data_ptr(), spec.q_bits, spec.r_bits,
                                  spec.slot_bits, ws_slots.data_ptr(),
                                  aggs.data_ptr(), n_aggs, scal.data_ptr(),
                                  _stream(dev))
    _raise_on(err, "quotient decode")
    return fps, valid


# ---------------------------------------------------------------------------
# The three wrappers
# ---------------------------------------------------------------------------

def contains_mode(spec: FilterSpec, n: int) -> str:
    """``"auto"`` (the card chooses the table pass or the walk) for a batch
    of at least ``n_slots / PASS_SLOTS_PER_KEY`` keys, else ``"walk"``."""
    return "auto" if n * PASS_SLOTS_PER_KEY >= spec.n_slots else "walk"


def contains_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  coop: str = "none") -> torch.Tensor:
    """Bulk run-scan membership. (n,) bool."""
    if coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS}")
    if not _check_layout(spec, table, keys):
        return contains_plain(spec, table, keys, coop)
    out = _launch_contains(spec, table, keys,
                           contains_mode(spec, keys.shape[0]))
    if keys.shape[0]:
        LAUNCHES["contains_vmem"] += 1
    return out


def _update(name: str, spec, table, keys, valid, op: str,
            tile: Optional[int]):
    if tile is not None and tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    if not _check_layout(spec, table, keys, valid):
        new, flags = update_plain(spec, table, keys, valid, op, tile)
        return table.copy_(new), flags
    flags = _launch_update(spec, table, keys, valid, op)
    if keys.shape[0]:
        LAUNCHES[name] += 1
    return table, flags


def add_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
             valid: Optional[torch.Tensor], tile: Optional[int] = None):
    """Bulk decode-and-rebuild insert; updates ``table`` in place. Returns
    (table, ok): ``ok[i]`` is False when the table had no room left for key
    i (the first ``n_slots - 1 - stored`` valid keys are admitted)."""
    return _update("add_vmem", spec, table, keys, valid, "add", tile)


def remove_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                valid: Optional[torch.Tensor], tile: Optional[int] = None):
    """Bulk delete, one fingerprint copy a key; updates ``table`` in place.
    Returns (table, found)."""
    return _update("remove_vmem", spec, table, keys, valid, "remove", tile)


def _check_tables(spec: FilterSpec, *tables: torch.Tensor) -> bool:
    """True for CUDA tables (each of ``spec``'s size, the spec one the
    kernels serve), False for CPU tables."""
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    devices = {t.device for t in tables}
    if len(devices) != 1:
        raise ValueError(f"tables on {sorted(map(str, devices))}")
    for t in tables:
        if t.ndim != 1 or t.dtype != torch.int32 or t.numel() != spec.n_words:
            raise ValueError(f"a table must be ({spec.n_words},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tables[0].device.type == "cpu":
        return False
    if tables[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tables[0].device}")
    if not kernel_supported(spec):
        raise ValueError(f"the CUDA quotient kernels serve u8/u16/u32 lanes "
                         f"and at most 2^{MAX_Q_BITS} slots, not {spec}")
    return True


def merge_vmem(spec: FilterSpec, table_a: torch.Tensor,
               table_b: torch.Tensor) -> torch.Tensor:
    """Union of two same-spec tables (a new table): b's fingerprints added
    to a copy of a. The caller checks the capacity."""
    if not _check_tables(spec, table_a, table_b):
        return merge_plain(spec, table_a, table_b)
    fps, valid = _decode(spec, table_b.contiguous())
    out = table_a.clone()
    _launch_update(spec, out, None, valid, "add", fps=fps)
    LAUNCHES["merge_vmem"] += 1
    return out


def resize_vmem(spec: FilterSpec, table: torch.Tensor,
                new_spec: FilterSpec) -> torch.Tensor:
    """The table re-slotted into ``new_spec`` (same p = q + r): its
    fingerprints added to an empty table of the new geometry. The caller
    checks a shrink's capacity."""
    if not (new_spec.is_quotient
            and new_spec.fingerprint_bits == spec.fingerprint_bits):
        raise ValueError(f"resize conserves p = q + r: {spec} -> {new_spec}")
    if not _check_tables(spec, table):
        return resize_plain(spec, table, new_spec)
    if not kernel_supported(new_spec):
        raise ValueError(f"the CUDA quotient kernels do not serve {new_spec}")
    fps, valid = _decode(spec, table.contiguous())
    out = Q.init(new_spec, table.device)
    _launch_update(new_spec, out, None, valid, "add", fps=fps)
    LAUNCHES["resize_vmem"] += 1
    return out
