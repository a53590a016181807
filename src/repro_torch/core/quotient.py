"""Counting quotient filter: the port's plain semantics.

Counterpart of ``repro.core.quotient``, function for function:

* the table is a flat ``(n_words,)`` int32 tensor of u32 words holding
  ``n_slots`` slot lanes of ``slot_bits`` (8, 16 or 32) bits, packed
  little-endian; the top three lane bits are the metadata (occupied,
  continuation, shifted), the low ``r_bits`` the remainder;
* a p-bit fingerprint (p = q + r <= 31) splits into the home slot ``fp >>
  r`` and the stored remainder ``fp & (2^r - 1)``; resize re-splits it;
* the layout is a function of the stored fingerprint multiset only: every
  bulk update decodes the table, admits (add) or matches (remove) the
  batch's fingerprints, and rebuilds the canonical layout (sort by rotated
  fingerprint, ``pos_j = j + cummax(rq_j - j)``, one scatter). The anchor
  of the rotation is the first argmin of ``cumsum(cnt - 1)`` (cycle lemma:
  that slot stays empty), so no cluster wraps in rotated coordinates and
  capacity is ``n_slots - 1``;
* an add admits the first ``room`` valid keys of the batch in batch order
  (``ok``); a remove is ``found`` when the key's rank among the batch's
  requests for its fingerprint, in batch order, is below the stored count.
  Neither depends on how the batch is cut into tiles, so ``tile=None``
  runs the batch as one chunk (JAX: chunks of ``QUOTIENT_ADD_TILE``) and
  an explicit ``tile`` gives the same table and flags;
* duplicates occupy one slot each (counting), so updates are not
  idempotent and take a ``valid`` mask for padding.

Hash and lane math runs in ``int64`` tensors holding u32 values
(``core.hashing``); words are stored as int32. The functions run on any
device; the CUDA kernels (``kernels/csrc/quotient.cu``) are held against
them on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import hashing as H
from repro_torch.core.variants import (QF_META_BITS, QUOTIENT_SLOT_BITS,
                                       FilterSpec, _log2i)

QUOTIENT_ADD_TILE = 2048       # JAX's bulk-update chunk (decode + rebuild)
QUOTIENT_MAX_LOAD = 0.90       # practical linear-probe load ceiling

# fingerprint-stream salt: the salt the cuckoo filter's fingerprint takes
FP_SALT = int(H.SALTS[0])

# empty-slot sentinel of sorted fingerprint streams: above any p <= 31-bit
# fingerprint
SENTINEL = 0xFFFFFFFF


def init(spec: FilterSpec, device=None) -> torch.Tensor:
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    return torch.zeros((spec.n_words,), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Hashing and slot packing
# ---------------------------------------------------------------------------

def quotient_hashes(spec: FilterSpec, keys: torch.Tensor) -> torch.Tensor:
    """(n,) p-bit fingerprints (int64): the top p bits of the pattern
    stream times ``FP_SALT``."""
    h1 = H.xxh32_u64x2(keys, H.SEED_PATTERN)
    return H.mulshift(h1, FP_SALT, spec.fingerprint_bits)


def split_fp(spec: FilterSpec, fp: torch.Tensor):
    """fingerprint -> (home slot (n,) int64, remainder (n,) int64)."""
    r = spec.r_bits
    return fp >> r, fp & ((1 << r) - 1)


def unpack_slots(spec: FilterSpec, words: torch.Tensor) -> torch.Tensor:
    """(..., n_words) words -> (..., n_slots) int64 lanes. Slot j lives in
    word ``j // slots_per_word``, lane ``j % slots_per_word``
    (little-endian)."""
    sb, spw = spec.slot_bits, spec.slots_per_word
    words = H.u32(words)
    if spw == 1:
        return words
    mask = (1 << sb) - 1
    lanes = [(words >> (sb * j)) & mask for j in range(spw)]
    return torch.stack(lanes, dim=-1).reshape(*words.shape[:-1], -1)


def pack_slots(spec: FilterSpec, lanes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_slots`: (..., n_slots) -> (..., n_words)
    int32 words."""
    sb, spw = spec.slot_bits, spec.slots_per_word
    lanes = H.u32(lanes)
    if spw == 1:
        return H.to_i32(lanes)
    x = lanes.reshape(*lanes.shape[:-1], -1, spw)
    acc = x[..., 0]
    for j in range(1, spw):
        acc = acc | (x[..., j] << (sb * j))
    return H.to_i32(acc)


def _meta_masks(spec: FilterSpec):
    sb = spec.slot_bits
    return (1 << (sb - 1), 1 << (sb - 2), 1 << (sb - 3),
            (1 << spec.r_bits) - 1)


def _fields(spec: FilterSpec, lanes: torch.Tensor):
    """(occupied, continuation, shifted, in_use, remainder) of each slot;
    a slot is in use when any metadata bit is set."""
    occ_m, cont_m, shift_m, rem_m = _meta_masks(spec)
    occ = (lanes & occ_m) != 0
    cont = (lanes & cont_m) != 0
    shifted = (lanes & shift_m) != 0
    return occ, cont, shifted, occ | cont | shifted, lanes & rem_m


# ---------------------------------------------------------------------------
# Decode: the stored fingerprint multiset from the layout
# ---------------------------------------------------------------------------

def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when there is none, as ``jnp.argmax``)."""
    return torch.argmax(mask.to(torch.int8))


def _rotated(anchor: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """``arr`` in scan coordinates that start just past ``anchor``."""
    n = arr.shape[0]
    idx = (torch.arange(n, device=arr.device) + anchor + 1) % n
    return arr[idx]


def _run_scan(spec: FilterSpec, lanes: torch.Tensor):
    """The metadata scan shared by decode and contains: (anchor (the first
    empty slot), occ, in_use_r, rem_r, runs_upto, occ_upto), the last four
    in rotated order."""
    occ, cont, _, in_use, rem = _fields(spec, lanes)
    anchor = _first(~in_use)
    occ_r, cont_r = _rotated(anchor, occ), _rotated(anchor, cont)
    in_use_r, rem_r = _rotated(anchor, in_use), _rotated(anchor, rem)
    runs_upto = torch.cumsum((in_use_r & ~cont_r).to(torch.int64), 0)
    occ_upto = torch.cumsum(occ_r.to(torch.int64), 0)
    return anchor, occ, in_use_r, rem_r, runs_upto, occ_upto


def _decode_rotated(spec: FilterSpec, lanes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fingerprints (n_slots,) int64, valid (n_slots,) bool) in rotated
    scan order (a multiset). Past the first empty slot no cluster wraps, so
    the i-th run start belongs to the i-th occupied slot; a search over the
    occupied prefix count inverts "i-th occupied"."""
    n = spec.n_slots
    anchor, _, in_use_r, rem_r, runs_upto, occ_upto = _run_scan(spec, lanes)
    q_rot = torch.searchsorted(occ_upto, runs_upto, right=False)
    q_abs = (q_rot + anchor + 1) % n
    return (q_abs << spec.r_bits) | rem_r, in_use_r


def decode_fingerprints(spec: FilterSpec, table: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted fingerprints (n_slots,) int64 with ``SENTINEL`` past the
    end, stored count () int64)."""
    fp, valid = _decode_rotated(spec, unpack_slots(spec, table))
    fps = torch.sort(torch.where(valid, fp, SENTINEL)).values
    return fps, valid.sum()


# ---------------------------------------------------------------------------
# Build: the canonical layout of a fingerprint multiset
# ---------------------------------------------------------------------------

def _layout(spec: FilterSpec, fp: torch.Tensor, valid: torch.Tensor
            ) -> torch.Tensor:
    """(n_slots,) int64 lanes of the canonical layout of ``fp[valid]`` (the
    caller keeps the valid count at most ``n_slots - 1``).

    The anchor is the first argmin of ``cumsum(cnt - 1)``, ``cnt[s]`` the
    fingerprints homed at s: it stays empty, so the scan from just past it
    never wraps. The j-th smallest rotated fingerprint lands at ``pos_j = j
    + cummax(rq_j - j)``; continuation means the predecessor has the same
    quotient, shifted that pos is not the home slot."""
    n, r = spec.n_slots, spec.r_bits
    occ_m, cont_m, shift_m, rem_m = _meta_masks(spec)
    dev = fp.device
    fp = fp.to(torch.int64)
    q = fp >> r
    cnt = torch.zeros((n,), dtype=torch.int64, device=dev)
    cnt.index_add_(0, q[valid], torch.ones_like(q[valid]))
    anchor = torch.argmin(torch.cumsum(cnt - 1, 0))
    rq = (q - anchor - 1) % n
    rfp = torch.where(valid, (rq << r) | (fp & rem_m), SENTINEL)
    rfp_s = torch.sort(rfp).values          # valid first, by (rq, remainder)
    valid_s = rfp_s != SENTINEL
    rq_s = rfp_s >> r
    j = torch.arange(rfp_s.shape[0], device=dev)
    pos = j + torch.cummax(rq_s - j, 0).values
    prev_rq = torch.roll(rq_s, 1)
    cont = valid_s & (j > 0) & (rq_s == prev_rq)
    shifted = valid_s & (pos != rq_s)
    lane = ((rfp_s & rem_m) | torch.where(cont, cont_m, 0)
            | torch.where(shifted, shift_m, 0))
    lanes = torch.zeros((n,), dtype=torch.int64, device=dev)
    tgt = (pos[valid_s] + anchor + 1) % n
    lanes[tgt] = lane[valid_s]
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    occ[q[valid]] = True
    return lanes | torch.where(occ, occ_m, 0)


# ---------------------------------------------------------------------------
# contains: a run scan, then a search per probe
# ---------------------------------------------------------------------------

def _hits(spec: FilterSpec, lanes: torch.Tensor, keys: torch.Tensor,
          home_occupied: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``home_occupied & any(in_use_r & runs_upto ==
    run_id & rem_r == pr)`` without its (probes x slots) hit matrix: in
    rotated order the key ``(runs_upto << r) | rem`` of the in-use slots of
    a canonical table never decreases (runs in order, remainders sorted in
    a run), so one search a probe and an equality test decide it."""
    n, r = spec.n_slots, spec.r_bits
    anchor, occ, in_use_r, rem_r, runs_upto, occ_upto = _run_scan(spec, lanes)
    q, pr = split_fp(spec, quotient_hashes(spec, keys))
    if home_occupied is None:
        home_occupied = occ[q]
    run_id = occ_upto[(q - anchor - 1) % n]
    stored = ((runs_upto << r) | rem_r)[in_use_r]
    want = (run_id << r) | pr
    if stored.numel() == 0:
        return torch.zeros_like(home_occupied)
    at = torch.searchsorted(stored, want).clamp_(max=stored.numel() - 1)
    return home_occupied & (stored[at] == want)


def quotient_contains(spec: FilterSpec, table: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
    """(n,) bool membership: the probe's remainder is in its home
    quotient's run."""
    return _hits(spec, unpack_slots(spec, table), keys)


def quotient_contains_coop(spec: FilterSpec, table: torch.Tensor,
                           keys: torch.Tensor) -> torch.Tensor:
    """Early exit: the run scan runs only when some probe's home slot is
    occupied (else every result is False). The same result as
    :func:`quotient_contains`."""
    lanes = unpack_slots(spec, table)
    occ = _fields(spec, lanes)[0]
    home_occupied = occ[split_fp(spec, quotient_hashes(spec, keys))[0]]
    if not bool(home_occupied.any()):
        return home_occupied
    return _hits(spec, lanes, keys, home_occupied)


# ---------------------------------------------------------------------------
# add / remove: decode, admit or match, rebuild
# ---------------------------------------------------------------------------

def quotient_insert_tile(spec: FilterSpec, table: torch.Tensor,
                         fp: torch.Tensor, valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's insert: (new words, ok (n,) bool). The first ``room =
    n_slots - 1 - stored`` valid fingerprints are admitted, in batch order;
    an invalid slot is a no-op reported as ok."""
    tab_fp, tab_valid = _decode_rotated(spec, unpack_slots(spec, table))
    room = spec.n_slots - 1 - tab_valid.sum()
    ok = valid & (torch.cumsum(valid.to(torch.int64), 0) <= room)
    lanes = _layout(spec, torch.cat([tab_fp, fp]),
                    torch.cat([tab_valid, ok]))
    return pack_slots(spec, lanes), ok | ~valid


def _count_in(sorted_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """How often each of ``x`` occurs in ``sorted_vals``."""
    return (torch.searchsorted(sorted_vals, x, right=True)
            - torch.searchsorted(sorted_vals, x, right=False))


def quotient_remove_tile(spec: FilterSpec, table: torch.Tensor,
                         fp: torch.Tensor, valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's delete: (new words, found (n,) bool). Each valid key
    takes one stored copy of its fingerprint, duplicates in batch order;
    an invalid slot is a no-op reported as found."""
    T = fp.shape[0]
    tab_fp, tab_valid = _decode_rotated(spec, unpack_slots(spec, table))
    tab_sorted = torch.sort(torch.where(tab_valid, tab_fp, SENTINEL)).values
    bfp = torch.where(valid, fp.to(torch.int64), SENTINEL)
    bs, order = torch.sort(bfp, stable=True)      # batch order within ties
    jt = torch.arange(T, device=fp.device)
    rank = jt - torch.searchsorted(bs, bs, right=False)
    found_s = (bs != SENTINEL) & (rank < _count_in(tab_sorted, bs))
    found = torch.zeros((T,), dtype=torch.bool, device=fp.device)
    found[order] = found_s
    # drop the first nrem stored copies of each fingerprint
    removed = torch.sort(torch.where(found_s, bs, SENTINEL)).values
    jn = torch.arange(spec.n_slots, device=fp.device)
    trank = jn - torch.searchsorted(tab_sorted, tab_sorted, right=False)
    keep = (tab_sorted != SENTINEL) & (trank >= _count_in(removed,
                                                           tab_sorted))
    return pack_slots(spec, _layout(spec, tab_sorted, keep)), found | ~valid


def _as_valid(n: int, valid, device) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return torch.as_tensor(valid, device=device).to(torch.bool)


def _bulk(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor, valid,
          tile: Optional[int], tile_fn):
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    n = keys.shape[0]
    if n == 0:
        return table.clone(), torch.zeros((0,), dtype=torch.bool,
                                          device=table.device)
    if tile is not None and tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    fp = quotient_hashes(spec, keys)
    v = _as_valid(n, valid, keys.device)
    T = tile or n
    flags = []
    for c in range(0, n, T):
        table, f = tile_fn(spec, table, fp[c:c + T], v[c:c + T])
        flags.append(f)
    return table, torch.cat(flags)


def quotient_add(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                 valid=None, tile: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk insert: (new words, ok (n,) bool); ``ok[i]`` is False when the
    table (capacity ``n_slots - 1``) had no room left for key i. Chunks of
    ``tile`` keys over the batch, or one chunk for ``tile=None``: the words
    and flags are the same for every tile. ``valid`` masks padding
    (inserts are not idempotent). ``table`` is not modified."""
    return _bulk(spec, table, keys, valid, tile, quotient_insert_tile)


def quotient_remove(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                    valid=None, tile: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk delete, one fingerprint copy a key: (new words, found (n,)
    bool), in the chunks of :func:`quotient_add`. Remove only keys that
    were inserted: a colliding key's fingerprint may be cleared
    otherwise."""
    return _bulk(spec, table, keys, valid, tile, quotient_remove_tile)


# ---------------------------------------------------------------------------
# merge / resize: the lossless structural ops
# ---------------------------------------------------------------------------

def quotient_merge(spec: FilterSpec, table_a: torch.Tensor,
                   table_b: torch.Tensor) -> torch.Tensor:
    """Union of two same-spec tables: decode both, rebuild. Equal to the
    table built from the concatenated key streams. The caller checks
    capacity (count_a + count_b <= n_slots - 1)."""
    fa, va = _decode_rotated(spec, unpack_slots(spec, table_a))
    fb, vb = _decode_rotated(spec, unpack_slots(spec, table_b))
    return pack_slots(spec, _layout(spec, torch.cat([fa, fb]),
                                    torch.cat([va, vb])))


def spec_for_resize(spec: FilterSpec, new_m_bits: int) -> FilterSpec:
    """The resized spec: same lane width, same fingerprint width p = q + r
    (each doubling moves one bit from remainder to quotient). Raises
    ``ValueError`` when r would leave [1, lane - 3]."""
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    new_slots = new_m_bits // spec.slot_bits
    _log2i(new_m_bits)
    new_q = _log2i(new_slots)
    new_r = spec.fingerprint_bits - new_q
    if not 1 <= new_r <= spec.slot_bits - QF_META_BITS:
        raise ValueError(
            f"cannot resize {spec} to m=2^{_log2i(new_m_bits)}b: the "
            f"conserved fingerprint width p={spec.fingerprint_bits} splits "
            f"as q={new_q}, r={new_r}, but r must stay in "
            f"[1, {spec.slot_bits - QF_META_BITS}] for u{spec.slot_bits} "
            f"slots")
    return dataclasses.replace(spec, m_bits=new_m_bits, r_bits=new_r)


def quotient_resize(spec: FilterSpec, table: torch.Tensor,
                    new_spec: FilterSpec) -> torch.Tensor:
    """Re-slot the stored fingerprints into ``new_spec``'s table: the
    fingerprint values are kept, only the q/r split moves. The caller
    checks a shrink's capacity."""
    if not (spec.is_quotient and new_spec.is_quotient
            and new_spec.fingerprint_bits == spec.fingerprint_bits):
        raise ValueError(f"resize conserves p = q + r: {spec} -> {new_spec}")
    fp, valid = _decode_rotated(spec, unpack_slots(spec, table))
    return pack_slots(new_spec, _layout(new_spec, fp, valid))


# ---------------------------------------------------------------------------
# Introspection, theory and sizing
# ---------------------------------------------------------------------------

def occupied_slots(spec: FilterSpec, table: torch.Tensor) -> torch.Tensor:
    """In-use slots, the stored fingerprints (int64; per member over the
    last axis for a bank-shaped table)."""
    meta = unpack_slots(spec, table) >> (spec.slot_bits - QF_META_BITS)
    return (meta != 0).sum(dim=-1)


def quotient_load_factor(spec: FilterSpec, table: torch.Tensor
                         ) -> torch.Tensor:
    """Occupied fraction of all slots (float32; per member for a bank)."""
    return occupied_slots(spec, table).to(torch.float32) / spec.n_slots


def fpr_quotient(q_bits: int, r_bits: int, alpha: float) -> float:
    """Analytic FPR at load ``alpha``: the probe's p-bit fingerprint
    collides with one of the ``alpha * 2^q`` stored ones, ``1 - (1 -
    2^-p)^n ~= alpha * 2^-r``."""
    n = alpha * (2.0 ** q_bits)
    return 1.0 - (1.0 - 2.0 ** -(q_bits + r_bits)) ** n


def bits_per_key(spec: FilterSpec, n: Optional[int] = None) -> float:
    """Storage bits per stored key (at load n; default: the maximum load)."""
    n = n or max(int(spec.n_slots * QUOTIENT_MAX_LOAD), 1)
    return spec.m_bits / max(n, 1)


def r_bits_for_fpr(target_fpr: float, q_bits: int,
                   alpha: float = QUOTIENT_MAX_LOAD) -> int:
    """Smallest remainder width meeting ``target_fpr`` at load ``alpha``."""
    r = max(int(math.ceil(math.log2(max(alpha, 1e-9) / target_fpr))), 1)
    while fpr_quotient(q_bits, r, alpha) > target_fpr and r < 29:
        r += 1
    return r


def spec_for_n(n: int, target_fpr: Optional[float] = None,
               slot_bits: Optional[int] = None,
               max_load: float = QUOTIENT_MAX_LOAD) -> FilterSpec:
    """A quotient spec for ~n keys at load <= ``max_load``: the slot count
    rounds up to a power of two, the remainder width meets ``target_fpr``
    at the realized load (5 bits without a target, or the pinned lane's
    width), and the lane is the smallest of u8/u16/u32 holding r + 3
    metadata bits unless ``slot_bits`` pins it."""
    q = max(int(math.ceil(math.log2(max(n, 1) / max_load))), 3)
    while (1 << q) - 1 < n:
        q += 1
    alpha = n / float(1 << q)
    if target_fpr is None:
        r = (slot_bits - QF_META_BITS) if slot_bits else 5
    else:
        r = r_bits_for_fpr(target_fpr, q, max(alpha, 1e-9))
    if slot_bits is None:
        for sb in QUOTIENT_SLOT_BITS:
            if r <= sb - QF_META_BITS:
                slot_bits = sb
                break
        else:
            raise ValueError(
                f"no supported quotient slot width holds r={r} remainder "
                f"bits (+{QF_META_BITS} metadata); relax target_fpr "
                f"{target_fpr!r}")
    elif r > slot_bits - QF_META_BITS:
        raise ValueError(
            f"u{slot_bits} slots hold at most {slot_bits - QF_META_BITS} "
            f"remainder bits; fpr {target_fpr!r} at load {max_load} "
            f"needs r={r}")
    if q + r > 31:
        raise ValueError(
            f"fingerprint q+r = {q}+{r} exceeds the uint32 budget (31 "
            f"bits); shard the keyspace or relax target_fpr")
    return FilterSpec(variant="quotient", m_bits=(1 << q) * slot_bits, k=1,
                      slot_bits=slot_bits, r_bits=r)
