"""The port's hashing (``repro_torch.core.hashing``) against the JAX package's.

Inputs are made with numpy from a seed and fed to both; outputs are compared
exactly as u32 values (tolerance 0).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashing as JH
from repro_torch.core import hashing as TH

EDGE_KEYS = np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0, 0xFFFFFFFF],
                      [0xFFFFFFFF, 0], [0x80000000, 1]], np.uint32)
KEYS = np.concatenate([JH.random_u64x2(4096, seed=7),
                       JH.probe_u64x2(1024, seed=7), EDGE_KEYS])
SEEDS = [int(JH.SEED_PATTERN), int(JH.SEED_BLOCK), int(JH.SEED_AUX), 0,
         0xFFFFFFFF]


def _np(t: torch.Tensor) -> np.ndarray:
    """Port output (int64 holding u32 values) as np.uint32, range-checked."""
    a = t.numpy()
    assert a.min(initial=0) >= 0 and a.max(initial=0) < 1 << 32
    return a.astype(np.uint32)


def _tk(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(keys.view(np.int32).copy())


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh32_u64x2_matches(seed):
    want = np.asarray(JH.xxh32_u64x2(jnp.asarray(KEYS), np.uint32(seed)))
    np.testing.assert_array_equal(_np(TH.xxh32_u64x2(_tk(KEYS), seed)), want)


def test_xxh32_u64x2_pair_matches():
    want = JH.xxh32_u64x2_pair(jnp.asarray(KEYS))
    got = TH.xxh32_u64x2_pair(_tk(KEYS))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh32_u32_matches(seed):
    words = KEYS.reshape(-1)
    want = np.asarray(JH.xxh32_u32(jnp.asarray(words), np.uint32(seed)))
    got = TH.xxh32_u32(torch.from_numpy(words.view(np.int32).copy()), seed)
    np.testing.assert_array_equal(_np(got), want)


def test_xxh32_u64_numpy_matches():
    u64 = (KEYS[:, 0].astype(np.uint64) << np.uint64(32)) | KEYS[:, 1]
    for seed in SEEDS:
        np.testing.assert_array_equal(TH.xxh32_u64_numpy(u64, seed),
                                      JH.xxh32_u64_numpy(u64, seed))


@pytest.mark.parametrize("name", ["SALTS", "WORD_SALTS", "GROUP_SALTS"])
def test_salt_tables_match(name):
    got, want = getattr(TH, name), getattr(JH, name)
    assert got.dtype == np.uint32 and got.shape == (TH.MAX_SALTS,)
    np.testing.assert_array_equal(got, want)


def test_mulshift_edge_values():
    h = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                  0xDEADBEEF], np.uint32)
    th = torch.from_numpy(h.astype(np.int64))
    for salt in (1, 3, 0xFFFFFFFF, 0x80000001, int(JH.SALTS[0]),
                 int(JH.WORD_SALTS[95])):
        for bits in (0, 1, 5, 16, 31, 32):
            want = np.asarray(JH.mulshift(jnp.asarray(h), np.uint32(salt),
                                          bits))
            got = _np(TH.mulshift(th, salt, bits))
            np.testing.assert_array_equal(got, want, err_msg=f"{salt} {bits}")


@pytest.mark.parametrize("r", [0, 1, 17, 31, 32, 45])
def test_rotl32_matches(r):
    x = KEYS[:, 1]
    want = np.asarray(JH.rotl32(jnp.asarray(x), r))
    np.testing.assert_array_equal(
        _np(TH.rotl32(torch.from_numpy(x.astype(np.int64)), r)), want)


def test_block_index_matches():
    h = np.asarray(JH.xxh32_u64x2(jnp.asarray(KEYS), JH.SEED_BLOCK))
    th = torch.from_numpy(h.astype(np.int64))
    for nb in (1, 2, 1 << 11, 1 << 31):
        np.testing.assert_array_equal(
            _np(TH.block_index(th, nb)), np.asarray(JH.block_index(h, nb)))
    with pytest.raises(ValueError):
        TH.block_index(th, 3)


def test_hash_keys_matches_both_key_forms():
    for keys in (KEYS, KEYS[:, 1]):                # u64x2 and u32 keys
        want = JH.hash_keys(jnp.asarray(keys))
        got = TH.hash_keys(torch.from_numpy(keys.view(np.int32).copy()))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_mix_rows_matches():
    rng = np.random.RandomState(3)
    mat = rng.randint(0, 2**32, size=(7, 33, 5), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(JH.mix_rows(jnp.asarray(mat)))
    got = TH.mix_rows(torch.from_numpy(mat.view(np.int32).copy()))
    np.testing.assert_array_equal(_np(got), want)


def test_key_generators_match():
    for n, seed in ((0, 0), (1, 5), (1000, 123)):
        np.testing.assert_array_equal(TH.random_u64x2(n, seed),
                                      JH.random_u64x2(n, seed))
        np.testing.assert_array_equal(TH.probe_u64x2(n, seed),
                                      JH.probe_u64x2(n, seed))
    u64 = np.array([0, 1, 2**63, 2**64 - 1, 0x0123456789ABCDEF], np.uint64)
    np.testing.assert_array_equal(TH.u64x2_from_u64(u64),
                                  JH.u64x2_from_u64(u64))


def test_u32_and_to_i32_roundtrip_bits():
    words = KEYS.reshape(-1)
    t = TH.u32(words)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(_np(t), words)
    back = TH.to_i32(t)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(
        _np(TH.u32(torch.from_numpy(words.copy()))), words)   # torch.uint32
