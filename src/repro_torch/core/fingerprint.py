"""Bucketed cuckoo fingerprint filter: the port's plain semantics.

Counterpart of ``repro.core.fingerprint``, function for function:

* the table is a flat ``(n_words,)`` int32 tensor of u32 words:
  ``n_buckets`` buckets of ``slots_per_bucket`` fingerprints of
  ``slot_bits`` (8 or 16) bits, packed little-endian into ``s`` words a
  bucket (a bucket is the "block" of the shared ``FilterSpec`` geometry);
* partial-key hashing: the block stream picks the primary bucket, the
  pattern stream the fingerprint (0 is remapped to 1: 0 marks an empty
  slot), and the alternate bucket is ``b XOR h(fp)``, an involution, so a
  kick never needs the key;
* an insert tries the primary bucket, then the alternate, then evicts a
  victim chosen by the key's own LCG stream, for at most
  ``CUCKOO_MAX_KICKS`` hops, and reports failure per key (``ok=False``);
  a remove clears the first matching slot, primary bucket first;
* bulk updates go in tiles of ``CUCKOO_ADD_TILE`` keys over the unpadded
  batch; each tile is stably sorted by primary bucket and applied one key
  after another. The words depend on that order, so the plain update here
  is the same sequential loop (on a host copy of the table's slots, in
  Python ints), and the CUDA update kernel (``kernels/csrc/cuckoo.cu``)
  keeps it.

Hashes, packing and contains are tensor code on any device; hash values
are u32 held in ``int64`` tensors (``core.hashing``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core import hashing as H
from repro_torch.core.variants import CUCKOO_SLOT_BITS, FilterSpec, _log2i

CUCKOO_MAX_KICKS = 64          # bounded eviction chain per insert
CUCKOO_ADD_TILE = 2048         # bulk-update chunk (sort + apply unit)
CUCKOO_MAX_LOAD = 0.95         # standard achievable load, 4-slot buckets

# fingerprint-stream salt (index 0) and alternate-bucket salt (index 1)
FP_SALT = int(H.SALTS[0])
ALT_SALT = int(H.SALTS[1])

LCG_MUL = 747796405            # PCG-style victim-slot stream
LCG_ADD = 2891336453
_M32 = 0xFFFFFFFF


def init(spec: FilterSpec, device=None) -> torch.Tensor:
    if not spec.is_fingerprint:
        raise ValueError(f"{spec} is not a fingerprint spec")
    return torch.zeros((spec.n_words,), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Hashing: partial-key scheme
# ---------------------------------------------------------------------------

def cuckoo_hashes(spec: FilterSpec, keys: torch.Tensor):
    """(primary bucket (n,), fingerprint (n,) in [1, 2^f), victim-stream
    seed (n,)), int64 tensors of u32 values."""
    h1, h2 = H.xxh32_u64x2_pair(keys)
    fp = H.mulshift(h1, FP_SALT, spec.slot_bits)
    fp = torch.where(fp == 0, torch.ones_like(fp), fp)
    b1 = H.block_index(h2, spec.n_buckets)
    rng = h1 ^ H.SEED_AUX
    return b1, fp, rng


def alt_bucket(spec: FilterSpec, b, fp):
    """The XOR-derived alternate bucket, ``alt(alt(b, fp), fp) == b``; on
    Python ints (the sequential loop) or tensors (bulk contains)."""
    lg = _log2i(spec.n_buckets)
    if lg == 0:
        return b
    if isinstance(b, int):
        return b ^ (((fp * ALT_SALT) & _M32) >> (32 - lg))
    return b ^ H.mulshift(fp, ALT_SALT, lg)


# ---------------------------------------------------------------------------
# Slot packing: u8/u16 fingerprints in u32 words
# ---------------------------------------------------------------------------

def unpack_slots(spec: FilterSpec, words: torch.Tensor) -> torch.Tensor:
    """(..., s) bucket words -> (..., slots_per_bucket) fingerprints (int64).
    Slot j lives in word ``j // slots_per_word``, lane ``j %
    slots_per_word`` (little-endian)."""
    sb, spw = spec.slot_bits, spec.slots_per_word
    words = H.u32(words)
    mask = (1 << sb) - 1
    lanes = [(words[..., j // spw] >> (sb * (j % spw))) & mask
             for j in range(spec.slots_per_bucket)]
    return torch.stack(lanes, dim=-1)


def pack_slots(spec: FilterSpec, slots: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_slots`: (..., spb) -> (..., s) int32 words."""
    sb, spw = spec.slot_bits, spec.slots_per_word
    slots = H.u32(slots)
    words = []
    for w in range(spec.s):
        acc = torch.zeros(slots.shape[:-1], dtype=torch.int64,
                          device=slots.device)
        for lane in range(spw):
            acc = acc | (slots[..., w * spw + lane] << (sb * lane))
        words.append(acc)
    return H.to_i32(torch.stack(words, dim=-1))


# ---------------------------------------------------------------------------
# contains: a gather of both candidate buckets and one fused compare
# ---------------------------------------------------------------------------

def _bucket_rows(spec: FilterSpec, table: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    col = torch.arange(spec.s, device=table.device)
    return table[b[:, None] * spec.s + col]                   # (n, s)


def _hit(spec: FilterSpec, table, b, fp) -> torch.Tensor:
    slots = unpack_slots(spec, _bucket_rows(spec, table, b))
    return (slots == fp[:, None]).any(dim=-1)


def cuckoo_contains(spec: FilterSpec, table: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
    """(n,) bool: the fingerprint is in the primary or alternate bucket."""
    b1, fp, _ = cuckoo_hashes(spec, keys)
    b2 = alt_bucket(spec, b1, fp)
    return _hit(spec, table, b1, fp) | _hit(spec, table, b2, fp)


def cuckoo_contains_coop(spec: FilterSpec, table: torch.Tensor,
                         keys: torch.Tensor) -> torch.Tensor:
    """Early exit: the alternate buckets are gathered only when some key
    missed its primary bucket. The same result as
    :func:`cuckoo_contains`."""
    b1, fp, _ = cuckoo_hashes(spec, keys)
    hit1 = _hit(spec, table, b1, fp)
    if bool(hit1.all()):
        return hit1
    return hit1 | _hit(spec, table, alt_bucket(spec, b1, fp), fp)


# ---------------------------------------------------------------------------
# Sequential updates on a host copy of the table: a flat list of its slot
# values (bucket b is slots [b * spb, (b + 1) * spb)), unpacked once before
# a bulk update and packed once after it
# ---------------------------------------------------------------------------

def _bucket_slots(spec: FilterSpec, table: List[int], b: int) -> List[int]:
    spb = spec.slots_per_bucket
    return table[b * spb:(b + 1) * spb]


def _store_bucket(spec: FilterSpec, table: List[int], b: int,
                  slots: List[int]) -> List[int]:
    spb = spec.slots_per_bucket
    table[b * spb:(b + 1) * spb] = slots
    return table


def _try_place(spec: FilterSpec, table: List[int], b: int, fp: int
               ) -> Tuple[List[int], bool]:
    """Put ``fp`` in the first free slot of bucket ``b``, if any."""
    slots = _bucket_slots(spec, table, b)
    for j, v in enumerate(slots):
        if v == 0:
            slots[j] = fp
            return _store_bucket(spec, table, b, slots), True
    return table, False


def _insert_one(spec: FilterSpec, table: List[int], b1: int, fp: int,
                rng: int, valid: bool) -> Tuple[List[int], bool]:
    """One key's insert: both candidate buckets, then the bounded kick
    chain. An invalid slot is a no-op reported as ok."""
    if not valid:
        return table, True
    table, placed = _try_place(spec, table, b1, fp)
    b = alt_bucket(spec, b1, fp)
    if not placed:
        table, placed = _try_place(spec, table, b, fp)
    lg_spb = _log2i(spec.slots_per_bucket)
    f, r, kicks = fp, rng, 0
    while not placed and kicks < CUCKOO_MAX_KICKS:
        slots = _bucket_slots(spec, table, b)
        v = 0 if lg_spb == 0 else r >> (32 - lg_spb)
        victim = slots[v]
        slots[v] = f
        _store_bucket(spec, table, b, slots)
        f = victim
        b = alt_bucket(spec, b, f)
        table, placed = _try_place(spec, table, b, f)
        r = (r * LCG_MUL + LCG_ADD) & _M32
        kicks += 1
    return table, placed


def _remove_one(spec: FilterSpec, table: List[int], b1: int, fp: int,
                rng: int, valid: bool) -> Tuple[List[int], bool]:
    """Clear the first slot holding ``fp`` in the primary bucket, else in
    the alternate. An invalid slot is a no-op reported as found."""
    if not valid:
        return table, True
    for b in (b1, alt_bucket(spec, b1, fp)):
        slots = _bucket_slots(spec, table, b)
        for j, v in enumerate(slots):
            if v == fp:
                slots[j] = 0
                return _store_bucket(spec, table, b, slots), True
    return table, False


def _tile_loop(spec: FilterSpec, table: List[int], b1, fp, rng, valid,
               one_fn) -> Tuple[List[int], List[bool]]:
    """Stably sort one tile by primary bucket, apply ``one_fn`` key by key
    in that order; the flags come back in the original order."""
    n = len(b1)
    flags = [True] * n
    for i in sorted(range(n), key=b1.__getitem__):        # stable
        table, flags[i] = one_fn(spec, table, b1[i], fp[i], rng[i],
                                 bool(valid[i]))
    return table, flags


def _lists(*tensors):
    return [t.cpu().tolist() for t in tensors]


def _table_list(spec: FilterSpec, table: torch.Tensor) -> List[int]:
    """The table's slot values, bucket after bucket, as a list of ints."""
    return unpack_slots(spec, table.cpu().reshape(spec.n_buckets, spec.s)
                        ).reshape(-1).tolist()


def _table_tensor(spec: FilterSpec, slots: List[int], like: torch.Tensor
                  ) -> torch.Tensor:
    """Inverse of :func:`_table_list`: the packed (n_words,) int32 words on
    ``like``'s device."""
    packed = pack_slots(spec, torch.tensor(slots, dtype=torch.int64).reshape(
        spec.n_buckets, spec.slots_per_bucket))
    return packed.reshape(-1).to(like.device)


def _tile_update(spec, table, b1, fp, rng, valid, one_fn):
    slots, flags = _tile_loop(spec, _table_list(spec, table),
                              *_lists(b1, fp, rng, valid.to(torch.bool)),
                              one_fn=one_fn)
    return (_table_tensor(spec, slots, table),
            torch.tensor(flags, dtype=torch.bool, device=table.device))


def cuckoo_insert_tile(spec: FilterSpec, table: torch.Tensor, b1, fp, rng,
                       valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile's bulk insert: (new table, ok (n,) bool)."""
    return _tile_update(spec, table, b1, fp, rng, valid, _insert_one)


def cuckoo_remove_tile(spec: FilterSpec, table: torch.Tensor, b1, fp, rng,
                       valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile's bulk remove: (new table, found (n,) bool)."""
    return _tile_update(spec, table, b1, fp, rng, valid, _remove_one)


def _as_valid(n: int, valid, device) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return torch.as_tensor(valid, device=device).to(torch.bool)


def _bulk(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor, valid,
          tile: Optional[int], one_fn):
    if not spec.is_fingerprint or spec.is_quotient:
        raise ValueError(f"{spec} is not a cuckoo spec")
    n = keys.shape[0]
    if n == 0:
        return table.clone(), torch.zeros((0,), dtype=torch.bool,
                                          device=table.device)
    b1, fp, rng = cuckoo_hashes(spec, keys)
    v = _as_valid(n, valid, keys.device)
    b1, fp, rng, v = _lists(b1, fp, rng, v)
    slots = _table_list(spec, table)
    T = tile or CUCKOO_ADD_TILE
    flags: List[bool] = []
    for c in range(0, n, T):
        sl = slice(c, min(c + T, n))
        slots, ok = _tile_loop(spec, slots, b1[sl], fp[sl], rng[sl], v[sl],
                               one_fn)
        flags.extend(ok)
    return (_table_tensor(spec, slots, table),
            torch.tensor(flags, dtype=torch.bool, device=table.device))


def cuckoo_add(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
               valid=None, tile: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk insert in tiles of ``tile`` (default ``CUCKOO_ADD_TILE``) keys
    over the unpadded batch: (new table, ok (n,) bool); ``ok[i]`` is False
    when key i's kick chain ran past ``CUCKOO_MAX_KICKS`` (one fingerprint,
    the chain's last victim, is then homeless, so ``occupied_slots ==
    sum(ok)`` holds). ``valid`` masks padding slots (inserts are not
    idempotent). ``table`` is not modified."""
    return _bulk(spec, table, keys, valid, tile, _insert_one)


def cuckoo_remove(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  valid=None, tile: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk delete, one slot per key, in the tiles of :func:`cuckoo_add`:
    (new table, found (n,) bool). Remove only keys that were inserted: a
    colliding key's fingerprint may be cleared otherwise."""
    return _bulk(spec, table, keys, valid, tile, _remove_one)


# ---------------------------------------------------------------------------
# Introspection, theory and sizing
# ---------------------------------------------------------------------------

def occupied_slots(spec: FilterSpec, table: torch.Tensor) -> torch.Tensor:
    """Nonzero fingerprint slots (int64), per member over the last axis for
    a bank-shaped table."""
    slots = unpack_slots(spec, table.reshape(*table.shape[:-1],
                                             spec.n_buckets, spec.s))
    return (slots != 0).sum(dim=(-1, -2))


def cuckoo_load_factor(spec: FilterSpec, table: torch.Tensor
                       ) -> torch.Tensor:
    """Occupied fraction of all slots (float32; per member for a bank)."""
    return occupied_slots(spec, table).to(torch.float32) / spec.n_slots


def fpr_cuckoo(slot_bits: int, slots_per_bucket: int, alpha: float) -> float:
    """Analytic FPR at load factor ``alpha``: a negative probe scans
    ``2 * slots_per_bucket`` slots, each occupied with probability alpha and
    matching with probability ``(2^f + 2) / 4^f``."""
    two_f = 2.0 ** slot_bits
    p_match = (two_f + 2.0) / (two_f * two_f)
    return 1.0 - (1.0 - p_match) ** (2.0 * slots_per_bucket * alpha)


def bits_per_key(spec: FilterSpec, n: Optional[int] = None) -> float:
    """Storage bits per stored key (at load n; default: the maximum load)."""
    n = n or int(spec.n_slots * CUCKOO_MAX_LOAD)
    return spec.m_bits / max(n, 1)


def slot_bits_for_fpr(target_fpr: float, slots_per_bucket: int = 4,
                      max_load: float = CUCKOO_MAX_LOAD) -> Optional[int]:
    """Smallest supported slot width meeting ``target_fpr`` at the maximum
    load (None if even u16 fingerprints cannot)."""
    for f in CUCKOO_SLOT_BITS:
        if fpr_cuckoo(f, slots_per_bucket, max_load) <= target_fpr:
            return f
    return None


def spec_for_n(n: int, target_fpr: Optional[float] = None,
               slot_bits: Optional[int] = None, slots_per_bucket: int = 4,
               max_load: float = CUCKOO_MAX_LOAD) -> FilterSpec:
    """A cuckoo spec for ~n keys at load <= ``max_load``: the slot width is
    the smallest meeting ``target_fpr`` (u8 without a target) unless pinned;
    the bucket count rounds up to a power of two."""
    if slot_bits is None:
        if target_fpr is None:
            slot_bits = 8
        else:
            slot_bits = slot_bits_for_fpr(target_fpr, slots_per_bucket,
                                          max_load)
            if slot_bits is None:
                raise ValueError(
                    f"no supported cuckoo slot width reaches fpr "
                    f"{target_fpr:g} at load {max_load}; use a Bloom "
                    f"variant or lower the load")
    need = max(int(math.ceil(n / (max_load * slots_per_bucket))), 1)
    n_buckets = 1 << max(int(math.ceil(math.log2(need))), 0)
    m_bits = n_buckets * slots_per_bucket * slot_bits
    return FilterSpec(variant="cuckoo", m_bits=m_bits, k=2,
                      slot_bits=slot_bits, slots_per_bucket=slots_per_bucket)
