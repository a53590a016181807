"""Key hashing and multiplicative pattern generation (paper §4.2), in torch.

Counterpart of ``repro.core.hashing``. Keys are carried in ``u64x2`` format:
shape ``(..., 2)`` holding the ``[hi, lo]`` u32 words of a 64-bit key. The
port stores them as ``int32`` tensors; the bits are the same.

``torch.uint32`` has no ``+``, ``<<`` or ``>>`` on the CPU, so the hash math
here runs in ``int64`` holding values in ``[0, 2^32)``. Every product is
taken through :func:`_mul32`, which splits the constant into 16-bit halves
so no intermediate leaves the int64 range. Functions return ``int64``
tensors of u32 values; the CUDA kernels compute the same values in native
u32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# xxHash32 constants
_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393

# Independent hash streams (seeds) for block selection vs. pattern generation.
SEED_PATTERN = 0xCAFEBABE
SEED_BLOCK = 0xDEADBEEF
SEED_AUX = 0x9E3779B9

MAX_SALTS = 96


def _make_salts(n: int, seed: int = 0xB100F) -> np.ndarray:
    rng = np.random.RandomState(seed)
    salts = rng.randint(0, 2**31, size=n, dtype=np.int64).astype(np.uint64)
    salts = (salts * 2 + 1).astype(np.uint32)  # force odd
    # make sure high bits are well mixed: xor-fold a second stream
    salts ^= rng.randint(0, 2**31, size=n, dtype=np.int64).astype(np.uint32) << np.uint32(1)
    return salts | np.uint32(1)


SALTS = _make_salts(MAX_SALTS)                      # fingerprint bit salts
WORD_SALTS = _make_salts(MAX_SALTS, seed=0x5EC70)   # BBF word-selection salts
GROUP_SALTS = _make_salts(MAX_SALTS, seed=0x6709)   # CSBF group->word salts


def u32(x) -> torch.Tensor:
    """Any integer tensor or array as ``int64`` holding its u32 bit pattern."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64))
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`u32`: int64 u32 values -> ``int32`` bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for u32 values held in int64 (``b`` a tensor or an
    int). Each partial product stays below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate-left on u32 values (r is a Python int)."""
    r = int(r) % 32
    if r == 0:
        return x
    x = u32(x)
    return ((x << r) & M32) | (x >> (32 - r))


def _avalanche(acc: torch.Tensor) -> torch.Tensor:
    acc = acc ^ (acc >> 15)
    acc = _mul32(acc, _P2)
    acc = acc ^ (acc >> 13)
    acc = _mul32(acc, _P3)
    return acc ^ (acc >> 16)


def xxh32_u64x2(keys, seed: int = SEED_PATTERN) -> torch.Tensor:
    """Exact xxHash32 of an 8-byte key held as ``[hi, lo]`` words.

    ``keys``: (..., 2). Returns (...,) u32 values in int64. The accumulator
    starts at ``seed + PRIME5 + 8`` and consumes the low word first (the
    little-endian byte order of the u64), then the final avalanche."""
    keys = u32(keys)
    hi, lo = keys[..., 0], keys[..., 1]
    acc = torch.full_like(hi, (int(seed) + _P5 + 8) & M32)
    for lane in (lo, hi):  # little-endian order: low word first
        acc = (acc + _mul32(lane, _P3)) & M32
        acc = _mul32(rotl32(acc, 17), _P4)
    return _avalanche(acc)


def xxh32_u64x2_pair(keys):
    """Both hash streams ``(pattern, block)`` from one shared lane mix.

    Bit-identical to two :func:`xxh32_u64x2` calls: the seed enters only
    through the accumulator's start, so the lane products are shared."""
    keys = u32(keys)
    hi, lo = keys[..., 0], keys[..., 1]
    plo, phi = _mul32(lo, _P3), _mul32(hi, _P3)
    outs = []
    for seed in (SEED_PATTERN, SEED_BLOCK):
        acc = torch.full_like(hi, (seed + _P5 + 8) & M32)
        for lanep in (plo, phi):
            acc = _mul32(rotl32((acc + lanep) & M32, 17), _P4)
        outs.append(_avalanche(acc))
    return outs[0], outs[1]


def xxh32_u32(keys, seed: int = SEED_PATTERN) -> torch.Tensor:
    """Exact xxHash32 of a 4-byte key (single u32 lane)."""
    keys = u32(keys)
    acc = torch.full_like(keys, (int(seed) + _P5 + 4) & M32)
    acc = (acc + _mul32(keys, _P3)) & M32
    acc = _mul32(rotl32(acc, 17), _P4)
    return _avalanche(acc)


def mulshift(h: torch.Tensor, salt, bits: int) -> torch.Tensor:
    """Multiplicative hash: top ``bits`` bits of ``h * salt`` mod 2^32."""
    h = u32(h)
    if bits == 0:
        return torch.zeros_like(h)
    return _mul32(h, int(salt)) >> (32 - bits)


def block_index(h_block: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Map the block-stream hash to ``[0, n_blocks)``; n_blocks must be pow2."""
    if n_blocks & (n_blocks - 1):
        raise ValueError(f"n_blocks={n_blocks} must be a power of two")
    return u32(h_block) & (n_blocks - 1)


def hash_keys(keys):
    """Return the (pattern, block) hash-stream pair for u64x2 or u32 keys."""
    if keys.ndim >= 1 and keys.shape[-1] == 2:
        return (xxh32_u64x2(keys, SEED_PATTERN), xxh32_u64x2(keys, SEED_BLOCK))
    return (xxh32_u32(keys, SEED_PATTERN), xxh32_u32(keys, SEED_BLOCK))


def mix_rows(mat) -> torch.Tensor:
    """Hash rows of u32 tokens to u64x2 keys. ``mat``: (..., w); returns
    (..., 2) u32 values in int64 (FNV / Fibonacci-style mixing)."""
    mat = u32(mat)
    h1 = torch.full(mat.shape[:-1], 0x811C9DC5, dtype=torch.int64,
                    device=mat.device)
    h2 = torch.full(mat.shape[:-1], 0x9E3779B9, dtype=torch.int64,
                    device=mat.device)
    for j in range(mat.shape[-1]):
        c = mat[..., j]
        h1 = _mul32(h1 ^ c, 16777619)
        h2 = _mul32((h2 + c) & M32, 2246822519)
        h2 = h2 ^ (h2 >> 13)
    h1 = h1 ^ (h1 >> 16)
    return torch.stack([h1, h2], dim=-1)


# ---------------------------------------------------------------------------
# Host-side numpy helpers (key generation, cross-checks)
# ---------------------------------------------------------------------------

def xxh32_u64_numpy(keys_u64: np.ndarray, seed: int = SEED_PATTERN) -> np.ndarray:
    keys_u64 = keys_u64.astype(np.uint64)
    lo = (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    p2, p3, p4 = np.uint32(_P2), np.uint32(_P3), np.uint32(_P4)
    with np.errstate(over="ignore"):
        acc = np.uint32(seed) + np.uint32(_P5) + np.uint32(8)
        for lane in (lo, hi):
            acc = acc + lane * p3
            acc = ((acc << np.uint32(17)) | (acc >> np.uint32(15))) * p4
        acc = acc ^ (acc >> np.uint32(15))
        acc = acc * p2
        acc = acc ^ (acc >> np.uint32(13))
        acc = acc * p3
        acc = acc ^ (acc >> np.uint32(16))
    return acc


def u64x2_from_u64(keys_u64: np.ndarray) -> np.ndarray:
    """Pack np.uint64 keys into (n, 2) uint32 [hi, lo]."""
    keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    lo = (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def random_u64x2(n: int, seed: int = 0) -> np.ndarray:
    """n random u64 keys in u64x2 format from the *insert* keyspace (top bit
    clear); the top-bit-set range is reserved for :func:`probe_u64x2`."""
    rng = np.random.RandomState(seed)
    lo = rng.randint(0, 2**32, size=n, dtype=np.uint64)
    hi = rng.randint(0, 2**31, size=n, dtype=np.uint64)  # top bit reserved
    return u64x2_from_u64((hi << np.uint64(32)) | lo)


def probe_u64x2(n: int, seed: int = 0) -> np.ndarray:
    """n random u64 probe keys from the reserved range (top bit set),
    disjoint by construction from every :func:`random_u64x2` draw."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    lo = rng.randint(0, 2**32, size=n, dtype=np.uint64)
    hi = rng.randint(0, 2**31, size=n, dtype=np.uint64) | np.uint64(1 << 31)
    return u64x2_from_u64((hi << np.uint64(32)) | lo)
