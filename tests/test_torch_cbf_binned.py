"""The classical filter's binned add (``cbf.add_binned_model``, the CPU model
of the card's four binned kernels) against ``repro``.

The JAX side is ``repro.core.variants.add_scatter``, as in
``tests/test_torch_cbf.py``: under jax 0.9 the Pallas cbf kernels no
longer trace (``pl.load`` is gone), and no kernel changes a result. Keys
come from numpy with a seed; words are compared as np.uint32, exactly. The
model covers filters smaller and larger than a bin, internal batches of
one, two and many, empty, single, duplicate and repeated keys. The path
rule (``cbf.choose_path``) is checked as a pure function of (n, m, k,
shared memory). The CUDA kernels are held against the plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import cbf

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

N = 2000
H100_SMEM = 231296          # the H100's opt-in shared memory less the salts


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_words(log2m: int, k: int, seed: int, n: int = N) -> np.ndarray:
    keys = JH.random_u64x2(n, seed=seed)
    js = JV.FilterSpec("cbf", 1 << log2m, k)
    return np.asarray(JV.add_scatter(js, JV.init(js), jnp.asarray(keys)))


def _model(log2m, k, keys, bin_bits, cap=cbf.POSITION_CAP, chunks=132):
    ts = TV.FilterSpec("cbf", 1 << log2m, k)
    return cbf.add_binned_model(ts, TV.init(ts), keys, bin_bits, cap, chunks)


@pytest.mark.parametrize("bin_bits", [5, 9, 19])
@pytest.mark.parametrize("k", [1, 11, 32])
@pytest.mark.parametrize("log2m", [5, 12, 16, 18])
def test_binned_model_matches_jax(log2m, k, bin_bits):
    """One internal batch; bins below, at and above the filter's size; as
    many chunks as the H100 has SMs (most chunks' runs are one sector)."""
    seed = 7 * log2m + k
    words, plan = _model(log2m, k, as_keys(JH.random_u64x2(N, seed=seed)),
                         bin_bits)
    np.testing.assert_array_equal(_u32(words), _jax_words(log2m, k, seed))
    assert plan["path"] == "binned" and plan["bin_bits"] == bin_bits
    assert plan["n_bins"] == 1 << max(0, log2m - bin_bits)
    assert plan["batches"] == 1 and plan["positions"] == N * k


@pytest.mark.parametrize("chunks", [1, 3, 7, N + 5])
def test_binned_model_chunks(chunks):
    """Chunk counts that leave runs long, ragged, and chunks with no keys."""
    words, plan = _model(16, 11, as_keys(JH.random_u64x2(N, seed=3)), 12,
                         chunks=chunks)
    np.testing.assert_array_equal(_u32(words), _jax_words(16, 11, 3))
    assert plan["chunks"] == chunks
    assert plan["workspace_bytes"] == 4 * (
        -(-(chunks + 2) * 16 // 8) * 8 + -(-(N * 11 + 7 * chunks * 16) // 8)
        * 8)


@pytest.mark.parametrize("n, batches", [(N, 1), (N, 2), (N, 3), (N, 50),
                                        (100, 100)])
def test_binned_model_internal_batches(n, batches):
    """A cap that splits the call into 1, 2, 3, many and one-key batches:
    each batch ORs its bins into the words the last one left."""
    k, log2m = 11, 16
    batch = -(-n // batches)
    words, plan = _model(log2m, k, as_keys(JH.random_u64x2(n, seed=3)), 12,
                         cap=k * batch)
    np.testing.assert_array_equal(_u32(words), _jax_words(log2m, k, 3, n))
    assert plan["batches"] == batches and plan["batch_keys"] == batch
    assert plan["chunks"] == 132


@pytest.mark.parametrize("n", [0, 1, 2])
def test_binned_model_tiny_batches(n):
    k, log2m = 7, 12
    words, plan = _model(log2m, k, as_keys(JH.random_u64x2(n, seed=5)), 9)
    if n == 0:
        assert not words.any() and plan["batches"] == 0
    else:
        np.testing.assert_array_equal(_u32(words),
                                      _jax_words(log2m, k, 5, n))
    assert int(words.view(torch.int32).ne(0).sum()) <= n * k


def test_binned_model_duplicates_and_one_repeated_key():
    """Duplicate keys, and a batch of one key repeated: the same positions
    land in one bin's slice many times; OR keeps one bit each."""
    k, log2m = 11, 16
    keys = JH.random_u64x2(300, seed=11)
    dup = np.concatenate([keys, keys[::-1], keys[:7]])
    js = JV.FilterSpec("cbf", 1 << log2m, k)
    for batch in (dup, np.repeat(keys[:1], 1024, axis=0)):
        want = np.asarray(JV.add_scatter(js, JV.init(js), jnp.asarray(batch)))
        for bin_bits, cap in ((19, cbf.POSITION_CAP), (5, 100 * k)):
            words, _ = _model(log2m, k, as_keys(batch), bin_bits, cap)
            np.testing.assert_array_equal(_u32(words), want)


def test_binned_model_updates_existing_words():
    """A second batch ORed into a filled filter; the input is not modified."""
    k, log2m = 7, 16
    ts = TV.FilterSpec("cbf", 1 << log2m, k)
    js = JV.FilterSpec("cbf", 1 << log2m, k)
    a, b = JH.random_u64x2(N, seed=21), JH.random_u64x2(N, seed=22)
    first, _ = cbf.add_binned_model(ts, TV.init(ts), as_keys(a), 10, 50 * k)
    before = first.clone()
    both, _ = cbf.add_binned_model(ts, first, as_keys(b), 10, 333 * k)
    assert torch.equal(first, before)
    want = JV.add_scatter(js, JV.add_scatter(js, JV.init(js), jnp.asarray(a)),
                          jnp.asarray(b))
    np.testing.assert_array_equal(_u32(both), np.asarray(want))
    np.testing.assert_array_equal(
        _u32(cbf.add_plain(ts, before, as_keys(b))), np.asarray(want))


def test_add_plan_and_geometry():
    assert cbf.bin_geometry(1 << 32, 19) == (19, 8192)
    assert cbf.bin_geometry(1 << 5, 19) == (5, 1)
    assert cbf.bin_bits_for(H100_SMEM) == cbf.BIN_BITS == 19
    assert cbf.bin_bits_for(48 * 1024) == 18
    plan = cbf.add_plan(1 << 28, 1 << 32, 11, "binned")
    assert plan["n_bins"] == 8192 and plan["batches"] == 6
    assert plan["batch_keys"] == cbf.POSITION_CAP // 11
    slots = (cbf.POSITION_CAP // 11) * 11 + 7 * 8192
    assert plan["chunks"] == 1 and plan["workspace_bytes"] == 4 * (
        3 * 8192 + -(-slots // 8) * 8)
    assert cbf.add_plan(5, 1 << 20, 7, "one-pass") == {
        "path": "one-pass", "bin_bits": None, "n_bins": 0, "batches": 1,
        "positions": 35, "batch_keys": 5, "chunks": 0, "workspace_bytes": 0}
    with pytest.raises(ValueError, match="path"):
        cbf.add_plan(5, 1 << 20, 7, "sorted")
    with pytest.raises(ValueError, match="binned add"):
        cbf.add_plan(5, 1 << 32, 7, "binned", bin_bits=12)   # 2^20 bins
    with pytest.raises(ValueError, match="batch"):
        cbf.add_plan(5, 1 << 20, 7, "binned", cap=6)
    with pytest.raises(ValueError, match="classical"):
        cbf.add_binned_model(TV.FilterSpec("sbf", 1 << 16, 8, block_bits=256),
                             torch.zeros(2048, dtype=torch.int32),
                             as_keys(JH.random_u64x2(4, seed=1)))


def test_path_rule_is_pure_and_keeps_small_calls_one_pass():
    """A function of (n, m, k, shared memory) alone: the same arguments give
    the same path, on no device. The generic cbf bank's members (2^16 bits,
    a few thousand keys) and the L2-resident sizes take the one-pass path;
    the DRAM cell (2^28 keys into 2^32 bits, k = 11) the binned one; a card
    whose shared memory cannot hold a bin of the largest filters, one-pass."""
    args = [(n, m, k, s) for n in (0, 1, 1 << 12, 1 << 20, 1 << 28)
            for m in (1 << 16, 1 << 27, 1 << 32) for k in (1, 7, 11, 32)
            for s in (H100_SMEM, 4096)]
    first = [cbf.choose_path(*a) for a in args]
    assert first == [cbf.choose_path(*a) for a in args]
    assert set(first) <= set(cbf.PATHS)
    for n in (1, 1000, 4096):
        for k in (7, 11):
            assert cbf.choose_path(n, 1 << 16, k, H100_SMEM) == "one-pass"
    assert cbf.choose_path(1 << 28, 1 << 32, 11, H100_SMEM) == "binned"
    assert cbf.choose_path(1 << 23, 1 << 27, 11, H100_SMEM) == "one-pass"
    assert cbf.choose_path(1 << 12, 1 << 32, 11, H100_SMEM) == "one-pass"
    assert cbf.choose_path(1 << 28, 1 << 32, 11, 16) == "one-pass"
    for log2m, least in cbf.BINNED_MIN_POSITIONS.items():
        assert cbf.choose_path(least, 1 << log2m, 1, H100_SMEM) == "binned"
        assert cbf.choose_path(least - 1, 1 << log2m, 1,
                               H100_SMEM) == "one-pass"


def test_cpu_add_vmem_runs_plain_on_every_path():
    """On CPU tensors the wrapper runs the plain version whatever private
    path it is given, and launches nothing."""
    k, log2m = 11, 16
    ts = TV.FilterSpec("cbf", 1 << log2m, k)
    keys = as_keys(JH.random_u64x2(N, seed=3))
    cbf.reset_launches()
    for path in (None, "one-pass", "binned"):
        words = TV.init(ts)
        assert cbf.add_vmem(ts, words, keys, path=path, cap=k) is words
        np.testing.assert_array_equal(_u32(words), _jax_words(log2m, k, 3))
    assert cbf.LAUNCHES["add_vmem"] == 0
