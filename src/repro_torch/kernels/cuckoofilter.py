"""Cuckoo fingerprint filter kernels for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.cuckoofilter``; the wrappers keep the JAX
names, so each row of the kernel table maps one to one:

============= =================================== ==========================
wrapper       replaces (repro/kernels/            CUDA kernel
              cuckoofilter.py)                    (csrc/cuckoo.cu)
============= =================================== ==========================
contains_vmem contains_vmem                       cuckoo_contains_kernel
add_vmem      add_vmem (_update_vmem, op add)     cuckoo_update_kernel, add
remove_vmem   remove_vmem (_update_vmem, op       cuckoo_update_kernel,
              remove)                             remove
============= =================================== ==========================

The JAX package runs these kernels only on a table that fits VMEM and sends
a larger one to its jnp reference; here one kernel pair serves every size
(a table in L2 or in DRAM), as ``kernels.ops`` dispatches it. ``coop`` is
validated and both values run the same contains kernel, which loads a
key's alternate bucket only when its primary bucket misses (the result of
either value). The update wrappers take the update's ``tile``: the tiles
of ``tile`` keys over the batch, each stably sorted by primary bucket and
applied key by key, fix the words (``core.fingerprint``); the kernel keeps
that order and takes tiles of at most ``MAX_TILE`` keys.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]``, the
table ``(n_words,)`` and ``valid`` ``(n,)`` uint8 or bool (or ``None``:
every key valid). For CPU tensors a wrapper runs its plain version; for
CUDA tensors it launches its kernel or raises. The update wrappers change
the table in place and return ``(table, flags)``. ``LAUNCHES`` counts
kernel launches per wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fingerprint as F
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import COOPS, _on_cuda, _raise_on

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}
# (slot_bits, slots_per_bucket) pairs with a kernel instance
INSTANCES = ((8, 4), (8, 8), (8, 16), (16, 2), (16, 4), (16, 8), (16, 16))
MAX_TILE = 8192                # keys a tile of the update kernel holds

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0, "remove_vmem": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_supported(spec: FilterSpec) -> bool:
    """Cuckoo specs the CUDA kernels serve: a (slot_bits, slots_per_bucket)
    pair of ``INSTANCES`` and fewer than 2^31 table words."""
    return (spec.variant == "cuckoo"
            and (spec.slot_bits, spec.slots_per_bucket) in INSTANCES
            and spec.n_words < 1 << 31)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def contains_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                   coop: str = "none") -> torch.Tensor:
    """Plain version of ``contains_vmem``: (n,) bool."""
    if coop == "subtile":
        return F.cuckoo_contains_coop(spec, table, keys)
    return F.cuckoo_contains(spec, table, keys)


def update_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor], op: str,
                 tile: int = F.CUCKOO_ADD_TILE):
    """Plain version of ``add_vmem`` / ``remove_vmem``: (new table, flags
    (n,) bool); ``table`` is not modified. Sequential, on a host copy of
    the table."""
    _check_op(op)
    fn = F.cuckoo_add if op == "add" else F.cuckoo_remove
    return fn(spec, table, keys, valid=valid, tile=tile)


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
    if spec.variant != "cuckoo":
        raise ValueError(f"{spec} is not a cuckoo spec")
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
        raise ValueError(f"the CUDA cuckoo kernels serve (slot_bits, "
                         f"slots_per_bucket) in {INSTANCES}, not {spec}")
    if not (keys.is_contiguous() and table.is_contiguous()):
        raise ValueError("keys and table words must be contiguous")
    if keys.data_ptr() % 8 or table.data_ptr() % 16:
        raise ValueError("keys must be 8-byte and words 16-byte aligned")
    return True


def _geometry(spec: FilterSpec):
    return (spec.n_buckets - 1, V._log2i(spec.n_buckets), spec.slot_bits,
            spec.slots_per_bucket, F.FP_SALT, F.ALT_SALT)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_update(name: str, spec, table, keys, valid, op: str, tile: int):
    from repro_torch.kernels._build import library
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile={tile}: the update kernel takes tiles of 1 "
                         f"to {MAX_TILE} keys")
    n = keys.shape[0]
    flags = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return table, flags
    if valid is not None:
        valid = valid.contiguous().view(torch.uint8)
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.cuckoo_update(
            keys.data_ptr(), None if valid is None else valid.data_ptr(),
            table.data_ptr(), flags.data_ptr(), n, tile, *_geometry(spec),
            _OP_CODE[op], _stream(keys.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return table, flags


# ---------------------------------------------------------------------------
# The three wrappers
# ---------------------------------------------------------------------------

def contains_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  coop: str = "none") -> torch.Tensor:
    """Bulk two-bucket membership, one launch. (n,) bool."""
    if coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS}")
    if not _check_layout(spec, table, keys):
        return contains_plain(spec, table, keys, coop)
    from repro_torch.kernels._build import library
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.cuckoo_contains(keys.data_ptr(), table.data_ptr(),
                                  out.data_ptr(), n, *_geometry(spec),
                                  _stream(keys.device))
    _raise_on(err, "contains_vmem")
    LAUNCHES["contains_vmem"] += 1
    return out


def _update(name: str, spec, table, keys, valid, op: str, tile: int):
    if not _check_layout(spec, table, keys, valid):
        new, flags = update_plain(spec, table, keys, valid, op, tile)
        return table.copy_(new), flags
    return _launch_update(name, spec, table, keys, valid, op, tile)


def add_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
             valid: Optional[torch.Tensor], tile: int = F.CUCKOO_ADD_TILE):
    """Ordered bulk insert in tiles of ``tile`` keys; updates ``table`` in
    place. Returns (table, ok): ``ok[i]`` is False when key i's kick chain
    ran out."""
    return _update("add_vmem", spec, table, keys, valid, "add", tile)


def remove_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                valid: Optional[torch.Tensor],
                tile: int = F.CUCKOO_ADD_TILE):
    """Ordered bulk delete, one slot a key; updates ``table`` in place.
    Returns (table, found)."""
    return _update("remove_vmem", spec, table, keys, valid, "remove", tile)
