"""The classical filter's binned contains (``cbf.contains_binned_model``, the
CPU model of the card's binned contains kernels) against ``repro``, its
path rule, its plan and the workspace bound by free memory.

The JAX side is ``repro.core.variants.contains`` on words built by
``repro.core.variants.add_scatter``, as in ``tests/test_torch_cbf.py``:
under jax 0.9 the Pallas cbf kernels no longer trace (``pl.load`` is gone),
and no kernel changes a result. Keys come from numpy with a seed; results
are compared exactly. The model covers log2 m of 5, 12 and 18, k of 1, 11
and 32, bins of 2^5 and 2^9 bits, several internal batches, repeated keys
and n of 0, 1 and 2. The path rule (``cbf.choose_contains_path``) is
checked as a pure function of (n, m, k, shared memory), and
``cbf.cap_for_memory`` with a given free size. The CUDA kernels are held
against the plain version on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
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

N = 1500
H100_SMEM = 231296          # the H100's opt-in shared memory less the salts
ADDED = JH.random_u64x2(N, seed=41)
# members, keys never added, and one member 200 times
QUERIES = np.concatenate([ADDED[:700], JH.probe_u64x2(700, seed=42),
                          np.repeat(ADDED[:1], 200, axis=0)])


@functools.lru_cache(maxsize=None)
def _jax(log2m: int, k: int) -> tuple:
    """(words, results of QUERIES) of the JAX package."""
    js = JV.FilterSpec("cbf", 1 << log2m, k)
    words = JV.add_scatter(js, JV.init(js), jnp.asarray(ADDED))
    hits = JV.contains(js, words, jnp.asarray(QUERIES))
    return np.asarray(words), np.asarray(hits)


def _words(log2m, k):
    return torch.from_numpy(_jax(log2m, k)[0].view(np.int32).copy())


def _model(log2m, k, keys, bin_bits, cap=cbf.POSITION_CAP, chunks=132):
    ts = TV.FilterSpec("cbf", 1 << log2m, k)
    return cbf.contains_binned_model(ts, _words(log2m, k), as_keys(keys),
                                     bin_bits, cap, chunks)


@pytest.mark.parametrize("bin_bits", [5, 9])
@pytest.mark.parametrize("k", [1, 11, 32])
@pytest.mark.parametrize("log2m", [5, 12, 18])
def test_binned_contains_model_matches_jax(log2m, k, bin_bits):
    """One internal batch; bins at, below and above the filter's size; as
    many chunks as the H100 has SMs; results equal to JAX's."""
    got, plan = _model(log2m, k, QUERIES, bin_bits)
    np.testing.assert_array_equal(got.numpy(), _jax(log2m, k)[1])
    assert got[:700].all()                             # no false negatives
    assert plan["path"] == "binned" and plan["batches"] == 1
    assert plan["n_bins"] == 1 << max(0, log2m - bin_bits)


@pytest.mark.parametrize("batches, chunks", [(2, 1), (3, 7), (40, 132),
                                             (320, 3)])
def test_binned_contains_model_internal_batches(batches, chunks):
    """A cap that splits the call into 2, 3, many and five-key batches,
    each batch's results stored at its own keys."""
    k, log2m, n = 11, 12, QUERIES.shape[0]
    batch = -(-n // batches)
    got, plan = _model(log2m, k, QUERIES, 5, cap=k * batch, chunks=chunks)
    np.testing.assert_array_equal(got.numpy(), _jax(log2m, k)[1])
    assert plan["batches"] == batches and plan["batch_keys"] == batch


@pytest.mark.parametrize("n", [0, 1, 2])
def test_binned_contains_model_tiny_batches(n):
    k, log2m = 11, 18
    got, plan = _model(log2m, k, QUERIES[:n], 9)
    np.testing.assert_array_equal(got.numpy(), _jax(log2m, k)[1][:n])
    assert got.shape == (n,) and plan["batches"] == int(n > 0)


def test_binned_contains_model_repeated_keys():
    """A batch of one key many times, present and absent: every copy of
    its k probes lands in the same slices and each copy gets the result."""
    k, log2m = 11, 12
    ts = TV.FilterSpec("cbf", 1 << log2m, k)
    for key in (ADDED[:1], JH.probe_u64x2(1, seed=43)):
        batch = as_keys(np.repeat(key, 333, axis=0))
        want = cbf.contains_plain(ts, _words(log2m, k), batch)
        for bin_bits, cap in ((9, cbf.POSITION_CAP), (5, 100 * k)):
            got, _ = cbf.contains_binned_model(ts, _words(log2m, k), batch,
                                               bin_bits, cap, 5)
            assert torch.equal(got, want)
            assert bool(got.all()) == bool(want[0])


def test_contains_plan_and_geometry():
    plan = cbf.contains_plan(1 << 28, 1 << 32, 11, "binned")
    assert plan["bin_bits"] == cbf.BIN_BITS == 19
    batch = cbf.CONTAINS_POSITION_CAP // 11
    assert plan["n_bins"] == 8192 and plan["batches"] == -(-(1 << 28) // batch)
    slots = batch * 11 + 3 * 8192                         # u64, 4 a sector
    assert plan["workspace_bytes"] == 4 * 3 * 8192 + 8 * (-(-slots // 4) * 4)
    add = cbf.add_plan(1 << 28, 1 << 32, 11, "binned")
    add_slots = (cbf.POSITION_CAP // 11) * 11 + 7 * 8192  # u32, 8 a sector
    assert add["workspace_bytes"] == 4 * 3 * 8192 + 4 * (
        -(-add_slots // 8) * 8)
    assert cbf.contains_plan(5, 1 << 20, 7, "one-pass")["workspace_bytes"] == 0
    with pytest.raises(ValueError, match="path"):
        cbf.contains_plan(5, 1 << 20, 7, "sorted")
    with pytest.raises(ValueError, match="binned"):
        cbf.contains_plan(5, 1 << 32, 7, "binned", bin_bits=12)
    with pytest.raises(ValueError, match="classical"):
        cbf.contains_binned_model(
            TV.FilterSpec("sbf", 1 << 16, 8, block_bits=256),
            torch.zeros(2048, dtype=torch.int32),
            as_keys(JH.random_u64x2(4, seed=1)))


def test_contains_path_rule_is_pure_and_keeps_small_calls_one_pass():
    """A function of (n, m, k, shared memory) alone. The L2 cell (2^23 keys,
    2^27 bits), small batches, the DRAM cell's 2^22 probes and filters of
    2^31 bits or fewer stay one-pass; the DRAM cell (2^28 keys into 2^32
    bits, k = 11) is binned; a card whose shared memory holds no bin of the
    largest filters, one-pass."""
    args = [(n, m, k, s) for n in (0, 1, 1 << 12, 1 << 20, 1 << 28)
            for m in (1 << 16, 1 << 27, 1 << 30, 1 << 32) for k in (1, 11, 32)
            for s in (H100_SMEM, 4096)]
    first = [cbf.choose_contains_path(*a) for a in args]
    assert first == [cbf.choose_contains_path(*a) for a in args]
    assert set(first) <= set(cbf.PATHS)
    assert cbf.choose_contains_path(1 << 23, 1 << 27, 11,
                                    H100_SMEM) == "one-pass"
    for log2m in (29, 30, 31):
        assert cbf.choose_contains_path(1 << 28, 1 << log2m, 11,
                                        H100_SMEM) == "one-pass"
    assert cbf.choose_contains_path(1 << 22, 1 << 32, 11,
                                    H100_SMEM) == "one-pass"
    assert cbf.choose_contains_path(1 << 28, 1 << 32, 11,
                                    H100_SMEM) == "binned"
    assert cbf.choose_contains_path(1 << 12, 1 << 32, 11,
                                    H100_SMEM) == "one-pass"
    assert cbf.choose_contains_path(1 << 28, 1 << 32, 11, 16) == "one-pass"
    for log2m, least in cbf.CONTAINS_BINNED_MIN_POSITIONS.items():
        assert cbf.choose_contains_path(least, 1 << log2m, 1,
                                        H100_SMEM) == "binned"
        assert cbf.choose_contains_path(least - 1, 1 << log2m, 1,
                                        H100_SMEM) == "one-pass"


@pytest.mark.parametrize("planner", [cbf.add_plan, cbf.contains_plan])
def test_cap_for_memory_lowers_the_cap_until_the_plan_fits(planner):
    """The cap halves until the workspace fits the free memory less the
    margin; a smaller cap only adds batches; where even a batch of one key
    does not fit, MemoryError."""
    n, m, k, b, chunks = 1 << 28, 1 << 32, 11, 19, 132
    full = planner(n, m, k, "binned", b, cbf.POSITION_CAP, chunks)
    plenty = full["workspace_bytes"] + cbf.WORKSPACE_MARGIN
    assert cbf.cap_for_memory(planner, n, m, k, b, cbf.POSITION_CAP, chunks,
                              plenty) == cbf.POSITION_CAP
    free = full["workspace_bytes"] // 3 + cbf.WORKSPACE_MARGIN
    cap = cbf.cap_for_memory(planner, n, m, k, b, cbf.POSITION_CAP, chunks,
                             free)
    assert cap == cbf.POSITION_CAP // 4
    plan = planner(n, m, k, "binned", b, cap, chunks)
    assert plan["workspace_bytes"] <= free - cbf.WORKSPACE_MARGIN
    assert plan["batches"] > full["batches"]
    assert plan["positions"] == full["positions"]
    with pytest.raises(MemoryError):
        cbf.cap_for_memory(planner, n, m, k, b, cbf.POSITION_CAP, chunks,
                           cbf.WORKSPACE_MARGIN + 1000)


def test_cpu_contains_vmem_runs_plain_on_every_path():
    """On CPU tensors the wrapper runs the plain version whatever private
    path it is given, and launches nothing."""
    k, log2m = 11, 12
    ts = TV.FilterSpec("cbf", 1 << log2m, k)
    cbf.reset_launches()
    for path in (None, "one-pass", "binned"):
        got = cbf.contains_vmem(ts, _words(log2m, k), as_keys(QUERIES),
                                path=path, cap=k, bin_bits=5)
        np.testing.assert_array_equal(got.numpy(), _jax(log2m, k)[1])
    assert cbf.LAUNCHES["contains_vmem"] == 0
    with pytest.raises(ValueError, match="path"):
        cbf.contains_vmem(ts, _words(log2m, k), as_keys(QUERIES[:4]),
                          path="sorted")
