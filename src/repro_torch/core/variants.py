"""Bloom filter variants (paper §2.1) — the port's plain oracle.

Counterpart of the bit-filter and counting halves of
``repro.core.variants``: the ``FilterSpec`` geometry, ``block_patterns``
for sbf/bbf/rbbf/csbf/countingbf, ``cbf_positions`` for the classical
filter, the ``contains``/``add`` references, the counting filter's nibble
helpers and ``counting_*`` references, and the FPR theory. These functions
run on any device; the tests hold them bit-exact against the JAX package,
and the CUDA kernels in ``repro_torch.kernels`` are held against them.

Storage: a filter is a flat ``(storage_words,)`` ``int32`` tensor holding
u32 words (``4 * n_words`` packed 4-bit counters for countingbf). Hash,
mask and nibble math runs in ``int64`` holding u32 values (see
``core.hashing``), so every shift is logical even where bit 31 is set.

Banks: a ``(B, n_words)`` stack of same-spec filters is one filter of
``B * n_blocks`` blocks in which key i's block id is offset by
``member[i] * n_blocks``; the ``bank_*`` helpers lift each bulk op to the
whole bank that way (offsets in ``int64``). The cuckoo filter's helpers
live in ``core.fingerprint``, the quotient filter's in ``core.quotient``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing as H

WORD_BITS = 32
_LOG2_WORD = 5

VARIANTS = ("cbf", "bbf", "rbbf", "sbf", "csbf", "countingbf", "cuckoo",
            "quotient")
BLOCKED = ("bbf", "rbbf", "sbf", "csbf")

CUCKOO_SLOT_BITS = (8, 16)
QUOTIENT_SLOT_BITS = (8, 16, 32)
QF_META_BITS = 3

COUNTER_BITS = 4
NIBBLES_PER_WORD = WORD_BITS // COUNTER_BITS          # 8
COUNTER_WORDS_PER_WORD = WORD_BITS // NIBBLES_PER_WORD  # 4
COUNTER_MAX = (1 << COUNTER_BITS) - 1                 # 15 (saturation value)
_NIB_LSB = 0x11111111                                 # LSB of every nibble


def _log2i(x: int) -> int:
    if not (x > 0 and (x & (x - 1)) == 0):
        raise ValueError(f"{x} must be a power of two")
    return x.bit_length() - 1


def _check(cond: bool, msg) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Static description of a Bloom filter instance (same fields, defaults
    and checks as ``repro.core.variants.FilterSpec``, so a spec dict written
    by the JAX package reads back here)."""

    variant: str                 # one of VARIANTS
    m_bits: int                  # total size in bits (power of two)
    k: int                       # fingerprint bits per key
    block_bits: int = 256        # B — block size in bits (blocked variants)
    z: int = 1                   # CSBF: number of sector groups
    slot_bits: int = 8           # CUCKOO/QUOTIENT: slot lane width
    slots_per_bucket: int = 4    # CUCKOO: slots per bucket (pow2)
    r_bits: int = 0              # QUOTIENT: remainder bits stored per slot

    def __post_init__(self):
        _check(self.variant in VARIANTS, self.variant)
        _log2i(self.m_bits)
        _check(1 <= self.k <= H.MAX_SALTS, f"k={self.k} not in [1, 96]")
        if self.variant == "cbf":
            object.__setattr__(self, "block_bits", self.m_bits)
        if self.variant == "rbbf":
            object.__setattr__(self, "block_bits", WORD_BITS)
        if self.variant == "quotient":
            _check(self.slot_bits in QUOTIENT_SLOT_BITS, self.slot_bits)
            _check(1 <= self.r_bits <= self.slot_bits - QF_META_BITS,
                   f"r_bits={self.r_bits} must leave {QF_META_BITS} "
                   f"metadata bits in a u{self.slot_bits} slot")
            q = _log2i(self.m_bits // self.slot_bits)
            _check(q + self.r_bits <= 31,
                   "fingerprint q+r must fit a uint32 below the empty sentinel")
            object.__setattr__(self, "k", 1)
            object.__setattr__(self, "block_bits", WORD_BITS)
        if self.variant == "cuckoo":
            _check(self.slot_bits in CUCKOO_SLOT_BITS, self.slot_bits)
            _log2i(self.slots_per_bucket)
            bucket_bits = self.slots_per_bucket * self.slot_bits
            _check(bucket_bits >= WORD_BITS,
                   "a bucket must fill at least one u32 word")
            object.__setattr__(self, "block_bits", bucket_bits)
        _log2i(self.block_bits)
        _check(WORD_BITS <= self.block_bits <= self.m_bits,
               f"block_bits={self.block_bits} must lie in [32, m_bits]")
        if self.variant == "csbf":
            _check(self.z >= 1 and self.s % self.z == 0, "z must divide s")
            _check(self.k % self.z == 0, "k must be a multiple of z")

    # -- derived geometry ---------------------------------------------------
    @property
    def n_words(self) -> int:
        return self.m_bits // WORD_BITS

    @property
    def is_counting(self) -> bool:
        return self.variant == "countingbf"

    @property
    def is_fingerprint(self) -> bool:
        return self.variant in ("cuckoo", "quotient")

    @property
    def is_quotient(self) -> bool:
        return self.variant == "quotient"

    @property
    def storage_words(self) -> int:
        return self.n_words * (COUNTER_WORDS_PER_WORD if self.is_counting
                               else 1)

    @property
    def s(self) -> int:
        """Words per block."""
        return self.block_bits // WORD_BITS

    @property
    def counter_row_words(self) -> int:
        """Counter words per block (countingbf): 4 per logical word."""
        return self.s * COUNTER_WORDS_PER_WORD

    @property
    def n_blocks(self) -> int:
        return self.m_bits // self.block_bits

    @property
    def g(self) -> int:
        """CSBF: words per group."""
        return self.s // self.z

    # -- fingerprint geometry (is_fingerprint specs only) -------------------
    @property
    def slots_per_word(self) -> int:
        return WORD_BITS // self.slot_bits

    @property
    def n_buckets(self) -> int:
        return self.n_blocks

    @property
    def n_slots(self) -> int:
        """Total fingerprint slots: the capacity at load factor 1.0."""
        if self.is_quotient:
            return self.m_bits // self.slot_bits
        return self.n_buckets * self.slots_per_bucket

    @property
    def q_bits(self) -> int:
        """QUOTIENT: quotient bits, log2 of the slot count."""
        return _log2i(self.n_slots)

    @property
    def fingerprint_bits(self) -> int:
        """QUOTIENT: the fingerprint width p = q + r, kept by a resize."""
        return self.q_bits + self.r_bits

    def bits_per_element(self, n: int) -> float:
        return self.m_bits / max(n, 1)

    def __str__(self):
        if self.variant == "quotient":
            q = _log2i(self.m_bits // self.slot_bits)
            return (f"quotient(m=2^{_log2i(self.m_bits)}b, "
                    f"q{q}+r{self.r_bits}, "
                    f"u{self.slot_bits}[occ|cont|shift])")
        if self.variant == "cuckoo":
            return (f"cuckoo(m=2^{_log2i(self.m_bits)}b, "
                    f"{self.slots_per_bucket}xu{self.slot_bits})")
        return (f"{self.variant}(m=2^{_log2i(self.m_bits)}b, B={self.block_bits}, "
                f"k={self.k}" + (f", z={self.z}" if self.variant == "csbf" else "") + ")")


def _require_blocked(spec: FilterSpec) -> None:
    if spec.variant == "cbf":
        raise ValueError(f"{spec} has no blocks: its bits come from "
                         f"cbf_positions")
    if spec.is_counting:
        raise ValueError(f"{spec} holds counters: use the counting_* "
                         f"functions")
    if spec.variant == "cuckoo":
        raise ValueError(f"{spec} holds fingerprint slots: use the "
                         f"core.fingerprint functions")
    if spec.is_quotient:
        raise ValueError(f"{spec} holds fingerprint slots: use the "
                         f"core.quotient functions")


def init(spec: FilterSpec, device=None) -> torch.Tensor:
    return torch.zeros((spec.storage_words,), dtype=torch.int32,
                       device=device)


# ---------------------------------------------------------------------------
# Pattern generation (paper §4.2)
# ---------------------------------------------------------------------------

def block_patterns(spec: FilterSpec, h_pattern: torch.Tensor,
                   batched: bool = True) -> torch.Tensor:
    """Per-key word masks for blocked variants.

    ``h_pattern``: (n,) u32 base hashes. Returns (n, s) int64 masks of u32
    values; OR-ing mask[j] into word j of the key's block is an add, and
    ``(word & mask) == mask`` for all j is a membership test. ``batched``
    picks between the two sbf formulations of the JAX package, which give
    the same masks."""
    h_pattern = H.u32(h_pattern)
    n = h_pattern.shape[0]
    s = spec.s
    dev = h_pattern.device

    if spec.variant in ("sbf", "countingbf"):   # identical bit placement
        if spec.k % s == 0 and batched:
            salts = torch.as_tensor(H.SALTS[: spec.k].astype(np.int64),
                                    device=dev)
            bits = H._mul32(h_pattern[:, None], salts[None, :]) >> (
                32 - _LOG2_WORD)                              # (n, k)
            layers = (torch.ones_like(bits) << bits).reshape(n, spec.k // s, s)
            masks = layers[:, 0]
            for j in range(1, spec.k // s):
                masks = masks | layers[:, j]
            return masks
        cols = [torch.zeros_like(h_pattern) for _ in range(s)]
        for i in range(spec.k):
            bit = H.mulshift(h_pattern, H.SALTS[i], _LOG2_WORD)
            cols[i % s] = cols[i % s] | (1 << bit)
        return torch.stack(cols, dim=1)

    masks = torch.zeros((n, s), dtype=torch.int64, device=dev)
    cols = torch.arange(s, dtype=torch.int64, device=dev)[None, :]
    if spec.variant in ("bbf", "rbbf"):
        log2s = _log2i(s)
        for i in range(spec.k):
            bitval = (1 << H.mulshift(h_pattern, H.SALTS[i], _LOG2_WORD))[:, None]
            if log2s == 0:
                masks = masks | bitval
            else:
                w = H.mulshift(h_pattern, H.WORD_SALTS[i], log2s)[:, None]
                masks = masks | torch.where(cols == w, bitval, 0)
        return masks

    if spec.variant == "csbf":
        g, z, kz = spec.g, spec.z, spec.k // spec.z
        log2g = _log2i(g)
        for j in range(z):
            # the word within group j that receives this key's bits
            w = j * g + H.mulshift(h_pattern, H.GROUP_SALTS[j], log2g)
            gmask = torch.zeros_like(h_pattern)
            for t in range(kz):
                gmask = gmask | (1 << H.mulshift(h_pattern, H.SALTS[j * kz + t],
                                                 _LOG2_WORD))
            masks = masks | torch.where(cols == w[:, None], gmask[:, None], 0)
        return masks

    raise ValueError(f"block_patterns undefined for variant {spec.variant}")


# ---------------------------------------------------------------------------
# The classical filter (cbf): k single-bit probes anywhere in m bits
# ---------------------------------------------------------------------------

def cbf_positions(spec: FilterSpec, h_pattern: torch.Tensor,
                  h_block: torch.Tensor) -> torch.Tensor:
    """(n, k) int64 global bit positions for the classical filter.

    Kirsch-Mitzenmacher double hashing ``h1 + i*h2`` (mod 2^32), re-mixed
    per index by ``mulshift(., SALTS[i], min(log2 m, 32))`` and masked to
    ``m - 1``. At m = 2^32 the shift is 0 and the mask keeps all 32 bits."""
    _check(spec.m_bits <= 1 << 32,
           f"cbf positions are u32: m_bits={spec.m_bits} exceeds 2^32")
    bits = min(_log2i(spec.m_bits), 32)
    h1, h2 = H.u32(h_pattern), H.u32(h_block)
    cols = [H.mulshift((h1 + H._mul32(h2, i)) & H.M32, H.SALTS[i], bits)
            & (spec.m_bits - 1) for i in range(spec.k)]
    return torch.stack(cols, dim=-1)


def _cbf_words_and_bits(spec: FilterSpec, keys: torch.Tensor):
    """(word index (n, k), bit value (n, k)) of each key's k positions."""
    h1, h2 = H.hash_keys(keys)
    pos = cbf_positions(spec, h1, h2)
    return pos >> _LOG2_WORD, torch.ones_like(pos) << (pos & (WORD_BITS - 1))


def or_positions(filt: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """New words: ``filt`` with the global bit positions ``pos`` set.

    The unique positions' bits ``1 << (pos & 31)`` are summed per word with
    ``index_add_`` (distinct bits of one word sum to their OR) and ORed
    into the touched words: memory in proportion to ``pos``, not to the
    filter."""
    out = filt.clone()
    if pos.numel() == 0:
        return out
    pos = torch.unique(pos)                                  # sorted
    words, inv = torch.unique_consecutive(pos >> _LOG2_WORD,
                                          return_inverse=True)
    acc = torch.zeros_like(words).index_add_(
        0, inv, torch.ones_like(pos) << (pos & (WORD_BITS - 1)))
    out[words] = H.to_i32(H.u32(filt[words]) | acc)
    return out


# ---------------------------------------------------------------------------
# contains / add — vectorized references
# ---------------------------------------------------------------------------

def _blocks_and_masks(spec: FilterSpec, keys: torch.Tensor):
    _require_blocked(spec)
    h1, h2 = H.hash_keys(keys)
    return H.block_index(h2, spec.n_blocks), block_patterns(spec, h1)


def contains(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
             ) -> torch.Tensor:
    """Vectorized bulk membership test: one row gather per key. (n,) bool."""
    if spec.is_counting:
        return counting_contains(spec, filt, keys)
    if spec.variant == "cbf":
        widx, bits = _cbf_words_and_bits(spec, keys)            # (n, k)
        return ((H.u32(filt[widx]) & bits) != 0).all(dim=-1)
    blk, masks = _blocks_and_masks(spec, keys)
    rows = H.u32(filt.reshape(spec.n_blocks, spec.s)[blk])      # (n, s)
    return ((rows & masks) == masks).all(dim=-1)


def add_loop(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
             ) -> torch.Tensor:
    """Sequential insert — one read-modify-write per key, in key order. The
    ownership-ordered reference (k single-word updates a key for cbf);
    slow, meant for small inputs."""
    if spec.variant == "cbf":
        widx, bits = _cbf_words_and_bits(spec, keys)
        out = H.u32(filt).tolist()
        for w_row, b_row in zip(widx.tolist(), bits.tolist()):
            for w, b in zip(w_row, b_row):
                out[w] |= b
        return H.to_i32(torch.tensor(out, dtype=torch.int64,
                                     device=filt.device))
    blk, masks = _blocks_and_masks(spec, keys)
    s = spec.s
    out = H.u32(filt).clone()
    for b, m in zip(blk.tolist(), masks):
        out[b * s:(b + 1) * s] |= m
    return H.to_i32(out)


def segment_totals(sorted_ids: torch.Tensor, vals: torch.Tensor,
                   combine) -> torch.Tensor:
    """Per-row full-segment reduction of ``vals`` grouped by ``sorted_ids``.

    ``sorted_ids``: (n,) nondecreasing; ``vals``: (n, w); ``combine``: an
    associative elementwise op (``torch.bitwise_or``). Returns (n, w) where
    every row holds the reduction of its whole segment. A Hillis-Steele
    segmented inclusive scan (log2 n steps) followed by a gather from each
    segment's last row — the same function as the JAX associative scan."""
    n = sorted_ids.shape[0]
    if n == 0:
        return vals
    flag = torch.ones(n, dtype=torch.bool, device=vals.device)
    flag[1:] = sorted_ids[1:] != sorted_ids[:-1]
    acc, f = vals, flag
    d = 1
    while d < n:
        # (m1, f1) (+) (m2, f2) = (f2 ? m2 : m1 . m2, f1 | f2)
        m_prev, f_prev = acc[:-d], f[:-d]
        m_cur, f_cur = acc[d:], f[d:]
        merged = torch.where(f_cur[:, None], m_cur, combine(m_prev, m_cur))
        acc = torch.cat([acc[:d], merged])
        f = torch.cat([f[:d], f_prev | f_cur])
        d *= 2
    end_idx = torch.searchsorted(sorted_ids, sorted_ids, right=True) - 1
    return acc[end_idx]


def or_rows(spec: FilterSpec, filt: torch.Tensor, blk: torch.Tensor,
            masks: torch.Tensor, n_rows: Optional[int] = None) -> torch.Tensor:
    """Whole-batch OR of per-key ``masks`` into their blocks: sort by block,
    segment-OR same-block masks, then one row gather and one row scatter
    (duplicate indices carry identical rows, so the scatter is exact)."""
    order = torch.argsort(blk, stable=True)
    sb = blk[order]
    or_full = segment_totals(sb, masks[order], torch.bitwise_or)   # (n, s)
    filt2d = H.u32(filt).reshape(n_rows or spec.n_blocks, spec.s).clone()
    filt2d[sb] = filt2d[sb] | or_full
    return H.to_i32(filt2d.reshape(-1))


def add_rows(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
             ) -> torch.Tensor:
    """Sorted segmented-OR bulk insert (the JAX ``jnp`` engine's add); the
    classical filter, which has no rows, goes to :func:`add_scatter`."""
    if spec.variant == "cbf":
        return add_scatter(spec, filt, keys)
    blk, masks = _blocks_and_masks(spec, keys)
    return or_rows(spec, filt, blk, masks)


def add_scatter(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
                ) -> torch.Tensor:
    """Bulk insert through the batch's unique global bit positions: k a key
    for cbf, every set mask bit (``blk * B + 32 j + b``) for the blocked
    variants (:func:`or_positions`). The JAX package scatters 32 bit planes
    of the whole filter instead; the words are the same."""
    if spec.variant == "cbf":
        h1, h2 = H.hash_keys(keys)
        return or_positions(filt, cbf_positions(spec, h1, h2).reshape(-1))
    blk, masks = _blocks_and_masks(spec, keys)
    parts = []
    for b in range(WORD_BITS):
        row, col = (((masks >> b) & 1) != 0).nonzero(as_tuple=True)
        parts.append(blk[row] * spec.block_bits + col * WORD_BITS + b)
    return or_positions(filt, torch.cat(parts))


def add(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
        method: str = "rows") -> torch.Tensor:
    if spec.is_counting:
        return counting_add(spec, filt, keys)
    if method == "loop":
        return add_loop(spec, filt, keys)
    if method == "rows":
        return add_rows(spec, filt, keys)
    if method == "scatter":
        return add_scatter(spec, filt, keys)
    raise ValueError(method)


def fill_fraction(filt: torch.Tensor) -> float:
    """Fraction of set bits. Shape-agnostic."""
    w = H.u32(filt.reshape(-1))
    pop = torch.zeros_like(w)
    for b in range(WORD_BITS):
        pop += (w >> b) & 1
    return float(pop.sum().item()) / (filt.numel() * WORD_BITS)


# ---------------------------------------------------------------------------
# Counting filter (countingbf): packed 4-bit saturating counters
# ---------------------------------------------------------------------------
# Nibble-parallel bit tricks on all 8 counters of a word at once, as in the
# JAX package. Each helper takes int32 or int64 tensors and returns int64
# tensors of u32 values: the words are widened first (``hashing.u32``), so
# ``>>`` is logical even for a counter in bits 28-31, where int32 holds the
# sign bit and its ``>>`` would be arithmetic.
#
# Update semantics (order-independent within one bulk op, which is what
# lets unordered atomic updates match the sequential reference bit for bit):
#   increment: saturate at 15; a saturated counter sticks for good.
#   remove:    decrement counters in (0, 15); 0 is an underflow guard, 15
#              is sticky.
#   decay:     decrement EVERY nonzero counter, saturated ones included.

_NIB_EVEN = 0x0F0F0F0F     # even-nibble byte lanes
_BYTE_BIT4 = 0x10101010    # bit 4 of every byte (carry/borrow flag)


def nib_saturated(w) -> torch.Tensor:
    """1 at the LSB of each nibble that equals 15 (saturated)."""
    w = H.u32(w)
    return w & (w >> 1) & (w >> 2) & (w >> 3) & _NIB_LSB


def nib_nonzero(w) -> torch.Tensor:
    """1 at the LSB of each nibble that is nonzero."""
    w = H.u32(w)
    return (w | (w >> 1) | (w >> 2) | (w >> 3)) & _NIB_LSB


def sat_inc_word(w, inc) -> torch.Tensor:
    """Saturating +1 on the nibbles flagged (value 1) in ``inc``."""
    w = H.u32(w)
    return w + (H.u32(inc) & ~nib_saturated(w))


def guard_dec_word(w, dec) -> torch.Tensor:
    """Guarded -1 on flagged nibbles: skips 0 (underflow) and 15 (sticky)."""
    w = H.u32(w)
    return w - (H.u32(dec) & nib_nonzero(w) & ~nib_saturated(w))


def decay_word(w) -> torch.Tensor:
    """-1 on every nonzero nibble (aging step; saturated counters too)."""
    w = H.u32(w)
    return w - nib_nonzero(w)


def _halves(w: torch.Tensor):
    """Even/odd nibbles in byte lanes (carry-free per-byte +/-)."""
    return w & _NIB_EVEN, (w >> 4) & _NIB_EVEN


def nib_sat_add_words(a, b) -> torch.Tensor:
    """Nibble-wise saturating add of two packed counter words: min(a+b, 15).
    Associative and commutative (the counting analogue of OR)."""
    def half(x, y):
        s = x + y                               # per-byte sums <= 30
        ov = s & _BYTE_BIT4                     # set iff the byte is >= 16
        return (s | (ov - (ov >> 4))) & _NIB_EVEN
    ae, ao = _halves(H.u32(a))
    be, bo = _halves(H.u32(b))
    return half(ae, be) | (half(ao, bo) << 4)


def nib_guard_sub_words(w, c) -> torch.Tensor:
    """Nibble-wise guarded multi-decrement: where(w == 15, 15, max(w-c, 0)),
    the batched form of ``c`` applications of :func:`guard_dec_word`."""
    def half(x, y):
        d = (x | _BYTE_BIT4) - y                # bias: per-byte in [1, 31]
        ok = d & _BYTE_BIT4                     # set iff x >= y (no borrow)
        return d & (ok - (ok >> 4)) & _NIB_EVEN
    w = H.u32(w)
    we, wo = _halves(w)
    ce, co = _halves(H.u32(c))
    sub = half(we, ce) | (half(wo, co) << 4)
    return sub | (nib_saturated(w) * COUNTER_MAX)         # 15 sticks


def expand_mask_words(masks) -> torch.Tensor:
    """Logical bit masks -> nibble-increment words, (..., s) -> (..., 4s).
    Byte c of logical word j maps to counter word 4j+c; bit b of that byte
    becomes nibble b (value 1)."""
    masks = H.u32(masks)
    cols = []
    for c in range(COUNTER_WORDS_PER_WORD):
        byte = (masks >> (8 * c)) & 0xFF
        inc = torch.zeros_like(masks)
        for b in range(NIBBLES_PER_WORD):
            inc = inc | (((byte >> b) & 1) << (COUNTER_BITS * b))
        cols.append(inc)
    out = torch.stack(cols, dim=-1)
    return out.reshape(*masks.shape[:-1],
                       masks.shape[-1] * COUNTER_WORDS_PER_WORD)


def collapse_counter_words(cwords) -> torch.Tensor:
    """Occupancy view: counter words -> logical bit words, (..., 4s) ->
    (..., s). Bit i is set iff the counter of logical bit i is nonzero."""
    nzb = nib_nonzero(cwords)                 # bit 4b <-> nibble b nonzero
    byte = torch.zeros_like(nzb)
    for b in range(NIBBLES_PER_WORD):
        byte = byte | (((nzb >> (COUNTER_BITS * b)) & 1) << b)
    b4 = byte.reshape(*nzb.shape[:-1],
                      nzb.shape[-1] // COUNTER_WORDS_PER_WORD,
                      COUNTER_WORDS_PER_WORD)
    return (b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16)
            | (b4[..., 3] << 24))


def counting_to_bloom(spec: FilterSpec, counters: torch.Tensor
                      ) -> torch.Tensor:
    """Collapse a counting filter (or bank, leading dims kept) to the
    equivalent (..., n_words) int32 bit filter."""
    _check(spec.is_counting, f"{spec} is not a counting spec")
    return H.to_i32(collapse_counter_words(counters))


def counting_from_bloom(spec: FilterSpec, bits: torch.Tensor) -> torch.Tensor:
    """Bit filter -> (..., storage_words) int32 counters with every set
    bit's counter at 1: membership-preserving, count-lossy."""
    _check(spec.is_counting, f"{spec} is not a counting spec")
    return H.to_i32(expand_mask_words(bits))


def _counting_layout(spec: FilterSpec, keys: torch.Tensor):
    _check(spec.is_counting, f"{spec} is not a counting spec")
    h1, h2 = H.hash_keys(keys)
    return H.block_index(h2, spec.n_blocks), block_patterns(spec, h1)


def _valid_masks(masks: torch.Tensor, valid) -> torch.Tensor:
    """Zero the mask rows of invalid (padding) keys."""
    if valid is None:
        return masks
    return masks * (valid.to(masks.device) != 0).to(masks.dtype)[:, None]


def _counting_update(spec: FilterSpec, counters: torch.Tensor,
                     keys: torch.Tensor, valid, op: str,
                     member: Optional[torch.Tensor] = None,
                     segments=None) -> torch.Tensor:
    """Sort-and-count bulk update, in memory proportional to the keys.

    The flat index of logical bit ``i`` is also the flat index of its
    nibble (``blk * B + 32 j + b``). Every set bit of every valid key's mask
    is listed, the list is counted per nibble (``torch.unique``), and each
    touched nibble becomes min(old + count, 15) (add) or, unless it is 15,
    max(old - count, 0) (remove): the result of any sequential order. The
    per-nibble changes are summed per word and applied with one gather and
    one scatter of the touched words. ``member`` (n,) offsets each key's
    block by ``member * n_blocks`` in a flat bank of counters;
    ``segments = (seg (n,), n_segments)`` places it in the segment that owns
    its slot (:func:`partitioned_blocks`)."""
    blk, masks = _counting_layout(spec, keys)
    if member is not None:
        blk = member.to(torch.int64) * spec.n_blocks + blk
    if segments is not None:
        blk = partitioned_blocks(spec, blk, *segments)
    masks = _valid_masks(masks, valid)
    parts = []
    for b in range(WORD_BITS):
        row, col = (((masks >> b) & 1) != 0).nonzero(as_tuple=True)
        parts.append(blk[row] * spec.block_bits + col * WORD_BITS + b)
    out = counters.clone()
    pos = torch.cat(parts)
    if pos.numel() == 0:
        return out
    nib, count = torch.unique(pos, sorted=True, return_counts=True)
    word = nib >> 3
    shift = (nib & (NIBBLES_PER_WORD - 1)) * COUNTER_BITS
    old = (H.u32(counters[word]) >> shift) & COUNTER_MAX
    if op == "add":
        new = torch.clamp(old + count, max=COUNTER_MAX)
    else:
        new = torch.where(old == COUNTER_MAX, old,
                          torch.clamp(old - count, min=0))
    words, inv = torch.unique_consecutive(word, return_inverse=True)
    delta = torch.zeros_like(words).index_add_(
        0, inv, (new - old) * (torch.ones_like(shift) << shift))
    out[words] = H.to_i32(H.u32(counters[words]) + delta)
    return out


def counting_add(spec: FilterSpec, counters: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bulk saturating increment: new (storage_words,) int32 counters with
    every counter at min(old + count, 15). ``valid`` (n,) masks padded
    slots: counting updates are not idempotent, so a repeated padding key
    would count twice."""
    return _counting_update(spec, counters, keys, valid, "add")


def counting_remove(spec: FilterSpec, counters: torch.Tensor,
                    keys: torch.Tensor, valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Bulk guarded decrement (0 floors, 15 is sticky)."""
    return _counting_update(spec, counters, keys, valid, "remove")


def _counter_rows(spec: FilterSpec, counters: torch.Tensor, blk):
    return counters.reshape(spec.n_blocks, spec.counter_row_words)[blk]


def counting_contains(spec: FilterSpec, counters: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
    """(n,) bool: all k counters of the key nonzero (one row gather/key)."""
    blk, masks = _counting_layout(spec, keys)
    logical = collapse_counter_words(_counter_rows(spec, counters, blk))
    return ((logical & masks) == masks).all(dim=-1)


def counting_count(spec: FilterSpec, counters: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """(n,) int64 min-counter estimate of each key's multiplicity
    (count-min style upper bound; 15 means 'at least 15')."""
    blk, masks = _counting_layout(spec, keys)
    rows = H.u32(_counter_rows(spec, counters, blk))             # (n, 4s)
    nib = torch.stack([(rows >> (COUNTER_BITS * b)) & COUNTER_MAX
                       for b in range(NIBBLES_PER_WORD)], dim=-1)
    nib = nib.reshape(rows.shape[0], spec.s, WORD_BITS)          # (n, s, 32)
    bit = (masks[:, :, None] >> torch.arange(
        WORD_BITS, device=masks.device)[None, None, :]) & 1
    sel = torch.where(bit == 1, nib, COUNTER_MAX + 1)
    return sel.reshape(rows.shape[0], -1).min(dim=-1).values


def counting_decay(spec: FilterSpec, counters: torch.Tensor) -> torch.Tensor:
    """One aging step: every nonzero counter loses 1 (elementwise)."""
    _check(spec.is_counting, f"{spec} is not a counting spec")
    return H.to_i32(decay_word(counters))


def counting_update_loop(spec: FilterSpec, counters: torch.Tensor,
                         keys: torch.Tensor, valid: Optional[torch.Tensor],
                         op: str) -> torch.Tensor:
    """Sequential oracle: one read-modify-write of the key's 4s-word
    counter row per key, in key order. Slow, meant for small inputs."""
    _check(op in ("add", "remove"), f"op={op!r}")
    blk, masks = _counting_layout(spec, keys)
    cmasks = expand_mask_words(_valid_masks(masks, valid))      # (n, 4s)
    cs = spec.counter_row_words
    update = sat_inc_word if op == "add" else guard_dec_word
    out = H.u32(counters).clone()
    for b, m in zip(blk.tolist(), cmasks):
        out[b * cs:(b + 1) * cs] = update(out[b * cs:(b + 1) * cs], m)
    return H.to_i32(out)


# ---------------------------------------------------------------------------
# Bank references: B same-spec filters as one super-filter
# ---------------------------------------------------------------------------
# A (B, n_words) stack of blocked filters is bit-identical to one filter of
# B * n_blocks blocks in which key i's block id is offset by
# member[i] * n_blocks, so every bulk op lifts to the whole bank as one op
# over flat routed keys (keys (N, 2), member (N,)). The CUDA bank kernels
# (kernels/sbf.py, kernels/countingbf.py) are held against these.


def bank_block_ids(spec: FilterSpec, keys: torch.Tensor,
                   member: torch.Tensor):
    """(member-offset block ids (N,) int64, masks (N, s)) for flat routed
    keys; ``member`` indexes the bank's leading axis."""
    h1, h2 = H.hash_keys(keys)
    blk = H.block_index(h2, spec.n_blocks)
    return (member.to(torch.int64) * spec.n_blocks + blk,
            block_patterns(spec, h1))


def bank_contains_rows(spec: FilterSpec, words: torch.Tensor,
                       keys: torch.Tensor, member: torch.Tensor
                       ) -> torch.Tensor:
    """(N,) bool membership of flat routed keys against a (B, n_words)
    bank: one row gather over the B * n_blocks super-filter."""
    _require_blocked(spec)
    blk, masks = bank_block_ids(spec, keys, member)
    rows = H.u32(words.reshape(-1, spec.s)[blk])
    return ((rows & masks) == masks).all(dim=-1)


def bank_add_rows(spec: FilterSpec, words: torch.Tensor, keys: torch.Tensor,
                  member: torch.Tensor, valid: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Bulk OR of flat routed keys into a (B, n_words) bank: one sorted
    segmented OR and one row scatter over the super-filter. ``valid`` zeroes
    the masks of padding slots (an OR no-op). Returns new words."""
    _require_blocked(spec)
    blk, masks = bank_block_ids(spec, keys, member)
    flat = or_rows(spec, words.reshape(-1), blk, _valid_masks(masks, valid),
                   n_rows=words.shape[0] * spec.n_blocks)
    return flat.reshape(words.shape)


def bank_counting_update(spec: FilterSpec, counters: torch.Tensor,
                         keys: torch.Tensor, member: torch.Tensor,
                         valid: Optional[torch.Tensor], op: str
                         ) -> torch.Tensor:
    """Bulk saturating increment (``op="add"``) or guarded decrement
    (``"remove"``) of flat routed keys into a (B, 4 n_words) counter bank:
    the sort-and-count update of :func:`counting_add` with each nibble
    index offset by the member's counters, in memory proportional to the
    keys. Returns new counters."""
    _check(op in ("add", "remove"), f"op={op!r}")
    flat = _counting_update(spec, counters.reshape(-1), keys, valid, op,
                            member=member)
    return flat.reshape(counters.shape)


def bank_counting_contains(spec: FilterSpec, counters: torch.Tensor,
                           keys: torch.Tensor, member: torch.Tensor
                           ) -> torch.Tensor:
    """(N,) bool occupancy membership against a (B, 4 n_words) counter
    bank (one counter-row gather per key)."""
    blk, masks = _counting_layout(spec, keys)
    rows = counters.reshape(-1, spec.counter_row_words)[
        member.to(torch.int64) * spec.n_blocks + blk]
    logical = collapse_counter_words(rows)
    return ((logical & masks) == masks).all(dim=-1)


# ---------------------------------------------------------------------------
# Partitioned updates: keys pre-bucketed by the filter segment that owns
# them, (n_segments, capacity) slots with a valid mask; the kernels
# (kernels/sbf.py add_partitioned, kernels/countingbf.py
# update_partitioned) are held against these.
# ---------------------------------------------------------------------------

def partitioned_blocks(spec: FilterSpec, blk: torch.Tensor, seg: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """The block a slot's key updates: its block modulo the blocks of a
    segment, inside the segment ``seg`` that owns the slot (the word offset
    ``start mod seg_words`` of the partitioned kernels). For a key in its
    own segment this is its block."""
    bps = spec.n_blocks // n_segments
    return seg.to(torch.int64) * bps + blk % bps


def _slots(keys_by_seg: torch.Tensor, valid: torch.Tensor):
    n_seg, cap = keys_by_seg.shape[0], keys_by_seg.shape[1]
    seg = torch.arange(n_seg, device=keys_by_seg.device).repeat_interleave(cap)
    return keys_by_seg.reshape(-1, 2), valid.reshape(-1), seg, n_seg


def partitioned_add(spec: FilterSpec, filt: torch.Tensor,
                    keys_by_seg: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """OR the valid slots of ``keys_by_seg`` (n_segments, capacity, 2) into
    the blocked filter, each in its segment. Returns new words."""
    keys, valid, seg, n_seg = _slots(keys_by_seg, valid)
    blk, masks = _blocks_and_masks(spec, keys)
    return or_rows(spec, filt, partitioned_blocks(spec, blk, seg, n_seg),
                   _valid_masks(masks, valid))


def partitioned_counting_update(spec: FilterSpec, counters: torch.Tensor,
                                keys_by_seg: torch.Tensor,
                                valid: torch.Tensor, op: str) -> torch.Tensor:
    """Saturating increment (``op="add"``) or guarded decrement of the
    valid slots' counters, each in its segment. Returns new counters."""
    _check(op in ("add", "remove"), f"op={op!r}")
    keys, valid, seg, n_seg = _slots(keys_by_seg, valid)
    return _counting_update(spec, counters, keys, valid, op,
                            segments=(seg, n_seg))


# ---------------------------------------------------------------------------
# FPR theory (paper Eq. 1-3 + blocked/sectorized extensions)
# ---------------------------------------------------------------------------

def fpr_cbf(m: int, n: int, k: int) -> float:
    """Paper Eq. (1)."""
    return float((1.0 - math.exp(-k * n / m)) ** k)


def optimal_k(c: float) -> float:
    """Paper Eq. (2): k* = c ln 2."""
    return c * math.log(2.0)


def fpr_min(c: float) -> float:
    """Paper Eq. (3)."""
    return 0.5 ** (c * math.log(2.0))


def _poisson_pmf(lam: float, i: np.ndarray) -> np.ndarray:
    logp = i * math.log(max(lam, 1e-300)) - lam - np.array(
        [math.lgamma(x + 1) for x in i])
    return np.exp(logp)


def _poisson_support(lam: float):
    hi = int(lam + 10 * math.sqrt(lam) + 16)
    return np.arange(0, hi + 1)


def fpr_bbf(B: int, c: float, k: int) -> float:
    """Blocked filter FPR: Poisson mixture over per-block load (Putze et al.)."""
    lam = B / c
    i = _poisson_support(lam)
    p = _poisson_pmf(lam, i)
    f = np.array([fpr_cbf(B, int(x), k) if x > 0 else 0.0 for x in i])
    return float(np.sum(p * f))


def fpr_sbf(B: int, S: int, c: float, k: int) -> float:
    """Sectorized filter FPR: each word receives k/s of the key's bits."""
    s = B // S
    kw = max(k // s, 1)
    lam = B / c
    i = _poisson_support(lam)
    p = _poisson_pmf(lam, i)
    f_word = (1.0 - (1.0 - 1.0 / S) ** (i * kw)) ** kw
    return float(np.sum(p * f_word ** s))


def fpr_csbf(B: int, S: int, c: float, k: int, z: int) -> float:
    """Cache-sectorized FPR: z groups, one word of g=s/z selected per group."""
    s = B // S
    g = s // z
    kz = k // z
    lam = (B / c) / g
    i = _poisson_support(lam)
    p = _poisson_pmf(lam, i)
    f_word = (1.0 - (1.0 - 1.0 / S) ** (i * kz)) ** kz
    return float(np.sum(p * f_word) ** z)


def fpr_theory(spec: FilterSpec, n: int) -> float:
    if spec.is_quotient:
        from repro_torch.core import quotient as Q      # import cycle
        return Q.fpr_quotient(spec.q_bits, spec.r_bits,
                              min(n / spec.n_slots, 1.0))
    if spec.is_fingerprint:
        from repro_torch.core import fingerprint as F   # import cycle
        return F.fpr_cuckoo(spec.slot_bits, spec.slots_per_bucket,
                            min(n / spec.n_slots, 1.0))
    c = spec.bits_per_element(n)
    if spec.variant == "cbf":
        return fpr_cbf(spec.m_bits, n, spec.k)
    if spec.variant in ("bbf", "rbbf"):
        return fpr_bbf(spec.block_bits, c, spec.k)
    if spec.variant in ("sbf", "countingbf"):
        return fpr_sbf(spec.block_bits, WORD_BITS, c, spec.k)
    if spec.variant == "csbf":
        return fpr_csbf(spec.block_bits, WORD_BITS, c, spec.k, spec.z)
    raise ValueError(spec.variant)


def snap_k(variant: str, c: float, block_bits: int = 256, z: int = 1) -> int:
    """k near the space-optimal k* = c ln 2, snapped to the variant's
    constraints (k = 0 mod s for SBF placement, mod z for CSBF), capped at 32."""
    k = max(int(round(optimal_k(c))), 1)
    if variant == "csbf":
        k = max(z, (k // z) * z)
    if variant in ("sbf", "countingbf"):
        s = block_bits // WORD_BITS
        k = max(s, (k // s) * s) if k >= s else k
    return min(k, 32)


def space_optimal_c(variant: str, block_bits: int, z: int, n: int,
                    target_fpr: float, max_log2_m: int = 40) -> float:
    """Smallest bits/key c = m/n (m a power of two, k snapped) whose analytic
    FPR meets ``target_fpr`` at load n."""
    _check(0.0 < target_fpr < 1.0, f"target_fpr={target_fpr}")
    start = max(10, int(math.ceil(math.log2(max(n, 2)))))
    for log2m in range(start, max_log2_m):
        m = 1 << log2m
        k = snap_k(variant, m / n, block_bits, z)
        spec = FilterSpec(variant=variant, m_bits=m, k=k,
                          block_bits=block_bits, z=z)
        if fpr_theory(spec, n) <= target_fpr:
            return m / n
    raise ValueError(f"no m <= 2^{max_log2_m} reaches fpr {target_fpr:g} "
                     f"for {variant} at n={n}")


def space_optimal_n(spec: FilterSpec, target_fpr: float = None) -> int:
    """Load n for the spec (paper §5.1): without ``target_fpr`` the load at
    which k equals k* = c ln 2; with it, the largest n whose analytic FPR
    stays at or below the target (0 if even n = 1 exceeds it)."""
    if target_fpr is None:
        if spec.is_quotient:
            # linear probing stays practical to ~0.9 load, and one slot is
            # the scan anchor
            return max(min(int(spec.n_slots * 0.90), spec.n_slots - 1), 1)
        if spec.is_fingerprint:
            # cuckoo capacity is structural: the standard achievable load
            # of 4-slot buckets is ~0.95
            return max(int(spec.n_slots * 0.95), 1)
        c = spec.k / math.log(2.0)
        return max(int(spec.m_bits / c), 1)
    if fpr_theory(spec, 1) > target_fpr:
        return 0
    # a quotient filter stores at most n_slots - 1 fingerprints
    lo = 1
    hi = max(spec.n_slots - 1, 1) if spec.is_quotient else spec.m_bits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fpr_theory(spec, mid) <= target_fpr:
            lo = mid
        else:
            hi = mid - 1
    return lo
