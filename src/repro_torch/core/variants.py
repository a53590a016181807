"""Blocked Bloom filter variants (paper §2.1) — the port's plain oracle.

Counterpart of the bit-filter half of ``repro.core.variants``: the
``FilterSpec`` geometry, ``block_patterns`` for sbf/bbf/rbbf/csbf, the
``contains``/``add`` references and the FPR theory. These functions run on
any device; the tests hold them bit-exact against the JAX package, and the
CUDA kernels in ``repro_torch.kernels`` are held against them.

Storage: a filter is a flat ``(n_words,)`` ``int32`` tensor holding u32
words. Hash and mask math runs in ``int64`` holding u32 values (see
``core.hashing``). The classical ``cbf`` variant and the counting, bank and
fingerprint helpers are not ported yet (ROADMAP queue 1 items 4-10).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import not_ported
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
    def n_blocks(self) -> int:
        return self.m_bits // self.block_bits

    @property
    def g(self) -> int:
        """CSBF: words per group."""
        return self.s // self.z

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
        raise not_ported("the classical filter (cbf)", "queue 1 item 4")
    if spec.is_counting:
        raise not_ported("the counting filter (countingbf)", "queue 1 item 5")
    if spec.variant == "cuckoo":
        raise not_ported("the cuckoo filter", "queue 1 item 9")
    if spec.is_quotient:
        raise not_ported("the quotient filter", "queue 1 item 10")


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
# contains / add — vectorized references
# ---------------------------------------------------------------------------

def _blocks_and_masks(spec: FilterSpec, keys: torch.Tensor):
    _require_blocked(spec)
    h1, h2 = H.hash_keys(keys)
    return H.block_index(h2, spec.n_blocks), block_patterns(spec, h1)


def contains(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
             ) -> torch.Tensor:
    """Vectorized bulk membership test: one row gather per key. (n,) bool."""
    blk, masks = _blocks_and_masks(spec, keys)
    rows = H.u32(filt.reshape(spec.n_blocks, spec.s)[blk])      # (n, s)
    return ((rows & masks) == masks).all(dim=-1)


def add_loop(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
             ) -> torch.Tensor:
    """Sequential insert — one read-modify-write per key, in key order. The
    ownership-ordered reference; slow, meant for small inputs."""
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
    """Sorted segmented-OR bulk insert (the JAX ``jnp`` engine's add)."""
    blk, masks = _blocks_and_masks(spec, keys)
    return or_rows(spec, filt, blk, masks)


def add(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
        method: str = "rows") -> torch.Tensor:
    if method == "loop":
        return add_loop(spec, filt, keys)
    if method == "rows":
        return add_rows(spec, filt, keys)
    if method == "scatter":
        raise not_ported("add(method='scatter')", "queue 1 item 4")
    raise ValueError(method)


def fill_fraction(filt: torch.Tensor) -> float:
    """Fraction of set bits. Shape-agnostic."""
    w = H.u32(filt.reshape(-1))
    pop = torch.zeros_like(w)
    for b in range(WORD_BITS):
        pop += (w >> b) & 1
    return float(pop.sum().item()) / (filt.numel() * WORD_BITS)


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
        raise not_ported("quotient FPR theory", "queue 1 item 10")
    if spec.is_fingerprint:
        raise not_ported("cuckoo FPR theory", "queue 1 item 9")
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
    if spec.is_fingerprint:
        raise not_ported("fingerprint sizing", "queue 1 items 9-10")
    if target_fpr is None:
        c = spec.k / math.log(2.0)
        return max(int(spec.m_bits / c), 1)
    if fpr_theory(spec, 1) > target_fpr:
        return 0
    lo, hi = 1, spec.m_bits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fpr_theory(spec, mid) <= target_fpr:
            lo = mid
        else:
            hi = mid - 1
    return lo
