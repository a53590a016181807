"""Filter banks of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy keys, tenants and validity masks go through the JAX
package (``repro.api.make_filter_bank``, its ``V.bank_*`` references, its
``route``/``route_by_id``, and its bank kernels in Pallas interpret mode
with ``probe="gather"``, the schedule that traces under jax 0.9) and
through ``repro_torch`` with ``device="cpu``, where every wrapper runs its
plain version. Words, results, heads and states must be equal bit for bit
(tolerance 0). The CUDA bank kernels are held against the plain versions
on the card by ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import hashing as JH
from repro.core import partition as JP
from repro.core import variants as JV
from repro.kernels import ops as JO
import repro_torch.api as api
from repro_torch import interop
from repro_torch.api import registry
from repro_torch.api.filter import as_keys
from repro_torch.core import partition as TP
from repro_torch.core import variants as TV
from repro_torch.kernels import countingbf as TC
from repro_torch.kernels import ops, sbf

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

M = 1 << 14
N = 777                       # not a multiple of any tile: padded writes
BIT_SPECS = {"sbf": dict(k=8), "bbf": dict(k=8), "rbbf": dict(k=4),
             "csbf": dict(k=8, block_bits=512, z=2)}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _eq(port, jax_value) -> None:
    got = (_u32(port) if port.dtype == torch.int32
           else port.cpu().numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_value))


def _traffic(B: int, n: int, seed: int, mix: str = "uniform"):
    """(keys (n, 2) u32, tenants (n,) int32, valid (n,) uint8 with about a
    quarter zeros); ``mix="skewed"`` puts half the keys on member 0."""
    rng = np.random.RandomState(seed)
    tenants = rng.randint(0, B, size=n).astype(np.int32)
    if mix == "skewed":
        tenants[rng.rand(n) < 0.5] = 0
    valid = (rng.rand(n) > 0.25).astype(np.uint8)
    return JH.random_u64x2(n, seed=seed), tenants, valid


def _pair(variant: str, B, **kw):
    kw = {**BIT_SPECS.get(variant, {}), **kw}
    plain = variant != "countingbf" and "generations" not in kw
    j = japi.make_filter_bank(B, variant, m_bits=M,
                              backend="jnp" if plain else "auto", **kw)
    t = api.make_filter_bank(B, variant, m_bits=M, device="cpu", **kw)
    return j, t


# ---------------------------------------------------------------------------
# Bit banks: routed and batched, against make_filter_bank(backend="jnp")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, mix", [(1, "uniform"), (3, "uniform"),
                                    (3, "skewed"), (8, "uniform"),
                                    (8, "skewed")])
@pytest.mark.parametrize("variant", sorted(BIT_SPECS))
def test_bit_bank_routed_and_batched(variant, B, mix):
    j, t = _pair(variant, B)
    assert t.backend == "torch" and t.bank_shape == (B,) and t.bank_size == B
    keys, tenants, valid = _traffic(B, N, seed=B, mix=mix)
    j1 = j.add(keys, tenants=tenants, valid=valid)
    t1 = t.add(keys, tenants=tenants, valid=valid)
    _eq(t1.words, j1.words)
    queries = np.concatenate([keys, JH.probe_u64x2(N, seed=B)])
    q_ten = np.concatenate([tenants, tenants[::-1]])
    _eq(t1.contains(queries, tenants=q_ten),
        j1.contains(queries, tenants=q_ten))
    # per-member batches, valid-masked
    kb = np.stack([JH.random_u64x2(100, seed=50 + b) for b in range(B)])
    vb = (np.random.RandomState(B).rand(B, 100) > 0.25).astype(np.uint8)
    j2, t2 = j1.add(kb, valid=vb), t1.add(kb, valid=vb)
    _eq(t2.words, j2.words)
    _eq(t2.contains(kb), j2.contains(kb))
    _eq(t2.dense_words(), j2.dense_words())
    assert t2.contains(kb).shape == (B, 100)
    # the empty batches return the filter itself / empty results
    assert t1.add(keys[:0], tenants=tenants[:0]) is t1
    assert t1.add(kb[:, :0]) is t1
    assert t1.contains(keys[:0], tenants=tenants[:0]).shape == (0,)
    assert t1.contains(kb[:, :0]).shape == (B, 0)


@pytest.mark.parametrize("variant", ["sbf", "csbf"])
def test_two_dimensional_bank_shape(variant):
    j, t = _pair(variant, (2, 3))
    assert t.bank_shape == (2, 3) and t.bank_size == 6
    kb = np.stack([np.stack([JH.random_u64x2(64, seed=10 * a + b)
                             for b in range(3)]) for a in range(2)])
    vb = (np.random.RandomState(1).rand(2, 3, 64) > 0.25).astype(np.uint8)
    j1, t1 = j.add(kb, valid=vb), t.add(kb, valid=vb)
    _eq(t1.words, j1.words)
    _eq(t1.contains(kb), j1.contains(kb))
    _eq(t1.select(1).words, j1.select(1).words)
    _eq(t1.select((1, 2)).words, j1.select((1, 2)).words)
    assert t1.select((1, 2)).bank_shape == ()
    with pytest.raises(ValueError, match="1-D bank"):
        t1.add(kb[0, 0], tenants=np.zeros(64, np.int32))
    assert "bank=(2, 3)" in repr(t1) and t1.nbytes == 6 * M // 8


def test_bank_matches_independent_scalar_filters():
    B = 4
    _, t = _pair("sbf", B)
    keys, tenants, _ = _traffic(B, N, seed=7)
    t1 = t.add(keys, tenants=tenants)
    for b in range(B):
        one = api.make_filter("sbf", m_bits=M, k=8, device="cpu").add(
            keys[tenants == b])
        np.testing.assert_array_equal(_u32(t1.select(b).words),
                                      _u32(one.words))


# ---------------------------------------------------------------------------
# The wrappers and ops.*_bank_* against V.bank_* and the JAX bank kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sbf", "bbf"])
def test_bit_bank_ops_match_jax_kernels_and_references(variant):
    B = 4
    jspec = JV.FilterSpec(variant, M, **BIT_SPECS[variant])
    tspec = TV.FilterSpec(variant, M, **BIT_SPECS[variant])
    keys, tenants, valid = _traffic(B, 200, seed=3, mix="skewed")
    jbank = jnp.zeros((B, jspec.n_words), jnp.uint32)
    want = JO.bloom_bank_add(jspec, jbank, jnp.asarray(keys),
                             jnp.asarray(tenants), valid=jnp.asarray(valid),
                             probe="gather")
    ref = JV.bank_add_rows(jspec, jbank, jnp.asarray(keys),
                           jnp.asarray(tenants), valid=jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(ref))
    tk, tm = as_keys(keys), torch.from_numpy(tenants)
    tv = torch.from_numpy(valid)
    tbank = TV.init(tspec).expand(B, -1).contiguous()
    got = ops.bloom_bank_add(tspec, tbank, tk, tm, valid=tv)
    _eq(got, want)
    _eq(TV.bank_add_rows(tspec, tbank, tk, tm, tv), want)
    assert not tbank.any()                       # inplace=False clones
    hits = JO.bloom_bank_contains(jspec, want, jnp.asarray(keys),
                                  jnp.asarray(tenants), probe="gather")
    for regime in ("vmem", "hbm"):
        _eq(ops.bloom_bank_contains(tspec, got, tk, tm, regime=regime), hits)
    _eq(TV.bank_contains_rows(tspec, got, tk, tm), hits)


def test_counting_bank_ops_match_jax_kernels_and_references():
    B = 3
    jspec = JV.FilterSpec("countingbf", M, 8)
    tspec = TV.FilterSpec("countingbf", M, 8)
    keys, tenants, valid = _traffic(B, 160, seed=4, mix="skewed")
    keys = np.concatenate([keys, keys[:40]])            # counts of 2
    tenants = np.concatenate([tenants, tenants[:40]])
    valid = np.concatenate([valid, valid[:40]])
    jbank = jnp.zeros((B, jspec.storage_words), jnp.uint32)
    jk, jm, jv = (jnp.asarray(keys), jnp.asarray(tenants),
                  jnp.asarray(valid))
    want = JO.counting_bank_update(jspec, jbank, jk, jm, "add", valid=jv,
                                   probe="gather")
    ref = JV.bank_counting_update(jspec, jbank, jk, jm, jv, "add")
    np.testing.assert_array_equal(np.asarray(want), np.asarray(ref))
    want_rm = JO.counting_bank_update(jspec, want, jk[:100], jm[:100],
                                      "remove", probe="gather")
    tk, tm, tv = (as_keys(keys), torch.from_numpy(tenants),
                  torch.from_numpy(valid))
    tbank = torch.zeros((B, tspec.storage_words), dtype=torch.int32)
    got = ops.counting_bank_update(tspec, tbank, tk, tm, "add", valid=tv)
    _eq(got, want)
    got_rm = ops.counting_bank_update(tspec, got, tk[:100], tm[:100],
                                      "remove")
    _eq(got_rm, want_rm)
    _eq(TV.bank_counting_update(tspec, got, tk[:100], tm[:100], None,
                                "remove"), want_rm)
    hits = JO.counting_bank_contains(jspec, want_rm, jk, jm)
    for regime in ("vmem", "hbm"):
        _eq(ops.counting_bank_contains(tspec, got_rm, tk, tm, regime=regime),
            hits)
    _eq(TV.bank_counting_contains(tspec, got_rm, tk, tm), hits)


@pytest.mark.parametrize("n", [1, 7, 255, 257])
def test_padded_writes_touch_no_member_zero_block(n):
    """Write padding is the zero key on member 0, a real key: the padded
    slots must not set or count anything (the batch is not a tile
    multiple)."""
    B = 3
    tspec = TV.FilterSpec("sbf", M, 8)
    cspec = TV.FilterSpec("countingbf", M, 8)
    keys, tenants, _ = _traffic(B, n, seed=n)
    tk, tm = as_keys(keys), torch.from_numpy(tenants)
    bits = ops.bloom_bank_add(tspec, torch.zeros((B, tspec.n_words),
                                                 dtype=torch.int32), tk, tm)
    _eq(bits, _u32(TV.bank_add_rows(tspec, torch.zeros_like(bits), tk, tm)))
    # had the padding been applied, member 0 would hold the zero key
    zero = torch.zeros((1, 2), dtype=torch.int32)
    member0 = torch.zeros((1,), dtype=torch.int32)
    assert not bool(TV.bank_contains_rows(tspec, bits, zero, member0)[0])
    counters = ops.counting_bank_update(
        cspec, torch.zeros((B, cspec.storage_words), dtype=torch.int32),
        tk, tm, "add")
    _eq(counters, _u32(TV.bank_counting_update(
        cspec, torch.zeros_like(counters), tk, tm, None, "add")))
    tile = ops._clamp_tile(n, sbf.DEFAULT_TILE)
    pk, pm, pv = ops._pad_flat_valid(tk, tm, None, tile)
    assert pk.shape[0] % tile == 0 and int(pv.sum()) == n
    assert not pk[n:].any() and not pm[n:].any()
    rk, rm = ops._pad_flat(tk, tm, tile)
    assert (rk[n:] == tk[-1]).all() and (rm[n:] == tm[-1]).all()


# ---------------------------------------------------------------------------
# Counting banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 8])
def test_counting_bank_add_remove_contains_decay_merge(B):
    j, t = _pair("countingbf", B, k=8)
    assert t.backend == "counting" and j.backend == "counting"
    keys, tenants, valid = _traffic(B, N, seed=20 + B, mix="skewed")
    keys = np.concatenate([keys, keys[:50]])
    tenants = np.concatenate([tenants, tenants[:50]])
    valid = np.concatenate([valid, np.ones(50, np.uint8)])
    j1 = j.add(keys, tenants=tenants, valid=valid)
    t1 = t.add(keys, tenants=tenants, valid=valid)
    _eq(t1.words, j1.words)
    j2 = j1.remove(keys[:300], tenants=tenants[:300], valid=valid[:300])
    t2 = t1.remove(keys[:300], tenants=tenants[:300], valid=valid[:300])
    _eq(t2.words, j2.words)
    _eq(t2.contains(keys, tenants=tenants), j2.contains(keys, tenants=tenants))
    kb = np.stack([JH.random_u64x2(64, seed=80 + b) for b in range(B)])
    j3, t3 = j2.add(kb).remove(kb[:, :16]), t2.add(kb).remove(kb[:, :16])
    _eq(t3.words, j3.words)
    _eq(t3.contains(kb), j3.contains(kb))
    _eq(t3.decay(1).words, j3.decay(1).words)
    _eq(t3.decay(2).words, j3.decay(2).words)
    _eq(t3.bank_merge(t1).words, j3.bank_merge(j1).words)   # saturating add
    _eq(t3.merge(t1).words, j3.merge(j1).words)
    _eq(t3.dense_words(), j3.dense_words())


# ---------------------------------------------------------------------------
# The generic path: cbf and windowed banks, one scalar op per member
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3])
def test_cbf_bank_takes_the_generic_path(B):
    j = japi.make_filter_bank(B, "cbf", m_bits=M, k=7, backend="jnp")
    t = api.make_filter_bank(B, "cbf", m_bits=M, k=7, device="cpu")
    assert t.backend == "torch"
    keys, tenants, valid = _traffic(B, 300, seed=30 + B, mix="skewed")
    j1 = j.add(keys, tenants=tenants, valid=valid)
    t1 = t.add(keys, tenants=tenants, valid=valid)
    _eq(t1.words, j1.words)
    queries = np.concatenate([keys, JH.probe_u64x2(300, seed=B)])
    q_ten = np.concatenate([tenants, tenants])
    _eq(t1.contains(queries, tenants=q_ten),
        j1.contains(queries, tenants=q_ten))
    kb = np.stack([JH.random_u64x2(40, seed=90 + b) for b in range(B)])
    vb = (np.random.RandomState(2).rand(B, 40) > 0.25).astype(np.uint8)
    _eq(t1.add(kb, valid=vb).words, j1.add(kb, valid=vb).words)
    _eq(t1.contains(kb), j1.contains(kb))


@pytest.mark.parametrize("variant", ["sbf", "csbf"])
def test_windowed_bank_lockstep_and_heads_apart(variant):
    B, G = 3, 3
    kw = BIT_SPECS[variant]
    j = japi.make_filter_bank(B, variant, m_bits=M, generations=G, **kw)
    t = api.make_filter_bank(B, variant, m_bits=M, generations=G,
                             device="cpu", **kw)
    assert t.backend == j.backend == "windowed"
    assert t.bank_shape == (B,) and t.words.shape == (B, G, M // 32)
    assert t.head == (0,) * B
    steps = []
    for i in range(4):
        keys, tenants, valid = _traffic(B, 200, seed=40 + i)
        j = j.add(keys, tenants=tenants, valid=valid).advance()
        t = t.add(keys, tenants=tenants, valid=valid).advance()
        steps.append((keys, tenants))
        _eq(t.words, j.words)
        assert t.head == tuple(np.asarray(j.head).tolist())
    # lockstep: every member advanced 4 times
    assert t.head == (4 % G,) * B
    # heads apart: member 1 advances alone, then the bank advances
    j = j.scatter_update(1, j.select(1).advance())
    t = t.scatter_update(1, t.select(1).advance())
    assert t.head == tuple(np.asarray(j.head).tolist()) and len(set(t.head)) == 2
    j, t = j.advance(), t.advance()
    assert t.head == tuple(np.asarray(j.head).tolist())
    keys, tenants, _ = _traffic(B, 200, seed=49)
    j, t = j.add(keys, tenants=tenants), t.add(keys, tenants=tenants)
    _eq(t.words, j.words)
    for keys, tenants in steps + [(keys, tenants)]:
        _eq(t.contains(keys, tenants=tenants),
            j.contains(keys, tenants=tenants))
    kb = np.stack([JH.random_u64x2(50, seed=60 + b) for b in range(B)])
    _eq(t.add(kb).words, j.add(kb).words)
    _eq(t.contains(kb), j.contains(kb))
    # windowed bank_merge lands the other union in each member's head
    other_j = japi.make_filter_bank(B, variant, m_bits=M, generations=G,
                                    **kw).add(kb)
    other_t = api.make_filter_bank(B, variant, m_bits=M, generations=G,
                                   device="cpu", **kw).add(kb)
    _eq(t.bank_merge(other_t).words, j.bank_merge(other_j).words)
    _eq(t.merge(other_t).words, j.merge(other_j).words)
    _eq(t.dense_words(), j.dense_words())


# ---------------------------------------------------------------------------
# select / scatter_update, route, state, raw words, errors, launches
# ---------------------------------------------------------------------------

def test_select_and_scatter_update():
    B = 4
    j, t = _pair("sbf", B)
    keys, tenants, _ = _traffic(B, N, seed=5)
    j, t = j.add(keys, tenants=tenants), t.add(keys, tenants=tenants)
    _eq(t.select(2).words, j.select(2).words)
    assert t.select(2).bank_shape == () and t.select(2).contains(
        keys[tenants == 2]).all()
    idx = np.array([3, 0])
    _eq(t.select(idx).words, j.select(jnp.asarray(idx)).words)
    _eq(t.select(torch.tensor([3, 0])).words, j.select(jnp.asarray(idx)).words)
    _eq(t.select(slice(1, 3)).words, j.select(slice(1, 3)).words)
    fresh_j = japi.make_filter("sbf", m_bits=M, k=8, backend="jnp").add(
        keys[:10])
    fresh_t = api.make_filter("sbf", m_bits=M, k=8, device="cpu").add(
        keys[:10])
    _eq(t.scatter_update(1, fresh_t).words, j.scatter_update(1, fresh_j).words)
    _eq(t.scatter_update(slice(0, 2), t.select(slice(2, 4))).words,
        j.scatter_update(slice(0, 2), j.select(slice(2, 4))).words)
    for call in (lambda: fresh_t.select(0),
                 lambda: fresh_t.scatter_update(0, fresh_t),
                 lambda: t.scatter_update(0, api.make_filter(
                     "sbf", m_bits=M, k=4, device="cpu")),
                 lambda: fresh_t.bank_merge(fresh_t),
                 lambda: t.bank_merge(t.select(slice(0, 2))),
                 lambda: t.merge(fresh_t)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("capacity", [None, 4, 200])
def test_route_matches_the_jax_package(capacity):
    B = 5
    keys, tenants, _ = _traffic(B, 300, seed=6, mix="skewed")
    cap = capacity or 300
    want = JP.route_by_id(jnp.asarray(keys), jnp.asarray(tenants), B, cap)
    got = TP.route_by_id(as_keys(keys), torch.from_numpy(tenants), B, cap)
    _eq(got.keys_by_seg, want.keys_by_seg)
    _eq(got.valid, want.valid)
    _eq(got.keep, want.keep)
    _eq(got.rank, want.rank)
    assert int(got.overflow) == int(want.overflow)
    assert (int(got.overflow) > 0) == (capacity == 4)
    kj, vj = japi.route(keys, tenants, B, capacity=capacity)
    kt, vt = api.route(keys, tenants, B, capacity=capacity)
    _eq(kt, kj)
    _eq(vt, vj)
    assert int(vt.sum()) + int(got.overflow) == 300


def test_bank_state_both_ways():
    B = 3
    keys, tenants, _ = _traffic(B, N, seed=8)
    for variant, kw in (("sbf", {}), ("countingbf", {"k": 8}),
                        ("sbf", {"generations": 3})):
        j, t = _pair(variant, B, **kw)
        j, t = j.add(keys, tenants=tenants), t.add(keys, tenants=tenants)
        # JAX state -> port
        js = j.to_state()
        back = interop.from_jax_state(js, device="cpu")
        assert back.bank_shape == (B,) and back.backend == t.backend
        _eq(back.dense_words(), j.dense_words())
        _eq(back.contains(keys, tenants=tenants),
            j.contains(keys, tenants=tenants))
        # port state -> JAX
        ts = interop.to_jax_state(t)
        assert ts["bank_shape"] == [B]
        jb = japi.Filter.from_state(ts)
        assert jb.bank_shape == (B,) and jb.backend == j.backend
        np.testing.assert_array_equal(np.asarray(jb.dense_words()),
                                      np.asarray(j.dense_words()))
        if "generations" in kw:
            assert back.head == (0,) * B
            assert back.options.generations == 3


def test_raw_bank_words_with_bank_shape():
    B = 3
    keys, tenants, _ = _traffic(B, N, seed=9)
    cases = (("sbf", {}), ("countingbf", {"k": 8}),
             ("sbf", {"generations": 3}))
    for variant, kw in cases:
        j, _ = _pair(variant, B, **kw)
        j = j.add(keys, tenants=tenants)
        if "generations" in kw:
            j = j.scatter_update(0, j.select(0).advance())
        fields = dataclasses.asdict(j.spec)
        heads = None if j.head is None else np.asarray(j.head)
        t = interop.from_jax_words(fields, np.asarray(j.words),
                                   device="cpu", head=heads,
                                   bank_shape=(B,))
        assert t.bank_shape == (B,) and t.backend == (
            "windowed" if "generations" in kw else
            "counting" if variant == "countingbf" else "torch")
        _eq(t.words, j.words)
        _eq(t.contains(keys, tenants=tenants),
            j.contains(keys, tenants=tenants))
        f2, w2, h2, shape = interop.to_jax_words(t)
        assert f2 == fields and shape == (B,)
        np.testing.assert_array_equal(w2, np.asarray(j.words))
        if heads is None:
            assert h2 is None
        else:
            np.testing.assert_array_equal(h2, heads)
            assert t.head == (1, 0, 0)
    # a 2-D array without bank_shape is still read as a scalar ring
    ring = interop.from_jax_words(fields, np.zeros((3, M // 32), np.uint32),
                                  device="cpu", head=2)
    assert ring.backend == "windowed" and ring.head == 2
    with pytest.raises(ValueError):
        interop.from_jax_words(fields, np.zeros((3, M // 32), np.uint32),
                               device="cpu", bank_shape=(4,))


def test_routed_fallback_refuses_huge_scatters():
    t = api.make_filter_bank(1024, "cbf", m_bits=1 << 10, k=3, device="cpu")
    keys = JH.random_u64x2(4097, seed=0)
    tenants = np.zeros(4097, np.int32)
    assert registry.Backend._ROUTE_FALLBACK_MAX_SLOTS == 1 << 22
    for call in (lambda: t.add(keys, tenants=tenants),
                 lambda: t.contains(keys, tenants=tenants)):
        with pytest.raises(ValueError, match="routed fallback"):
            call()
    assert t.add(keys[:4096], tenants=tenants[:4096]).select(0).contains(
        keys[:4096]).all()


def test_out_of_range_tenants_raise_value_error():
    B = 3
    spec = TV.FilterSpec("sbf", M, 8)
    cspec = TV.FilterSpec("countingbf", M, 8)
    keys = JH.random_u64x2(8, seed=0)
    tk = as_keys(keys)
    for bad in (np.array([0, 1, 2, 3, 0, 0, 0, 0], np.int32),
                np.array([0, -1, 0, 0, 0, 0, 0, 0], np.int32),
                np.array([0, 1 << 32, 0, 0, 0, 0, 0, 0], np.int64)):
        for variant in ("sbf", "countingbf", "cbf"):
            t = api.make_filter_bank(B, variant, m_bits=M, k=8, device="cpu")
            for call in (lambda: t.add(keys, tenants=bad),
                         lambda: t.contains(keys, tenants=bad),
                         lambda: t.add(keys, tenants=torch.from_numpy(bad))):
                with pytest.raises(ValueError, match=r"\[0, 3\)"):
                    call()
        tm = torch.from_numpy(bad)
        bank = torch.zeros((B, spec.n_words), dtype=torch.int32)
        cbank = torch.zeros((B, cspec.storage_words), dtype=torch.int32)
        lay = sbf.default_layout(spec, "add")
        for call in (
                lambda: sbf.bank_add_vmem(spec, bank, tk, tm, None, lay),
                lambda: sbf.bank_contains_vmem(spec, bank, tk, tm, lay),
                lambda: TC.bank_update_vmem(cspec, cbank, tk, tm, None,
                                            "add"),
                lambda: TC.bank_contains_vmem(cspec, cbank, tk, tm),
                lambda: api.route(keys, bad, B)):
            with pytest.raises(ValueError):
                call()
    with pytest.raises(ValueError, match="tenants must be"):
        t.add(keys, tenants=np.zeros(7, np.int32))


def test_bank_wrappers_refuse_bad_inputs():
    spec = TV.FilterSpec("sbf", M, 8)
    keys = as_keys(JH.random_u64x2(8, seed=0))
    member = torch.zeros(8, dtype=torch.int32)
    bank = torch.zeros((2, spec.n_words), dtype=torch.int32)
    lay = sbf.default_layout(spec, "contains")
    for call in (
            lambda: sbf.bank_contains_vmem(spec, bank[0], keys, member, lay),
            lambda: sbf.bank_contains_vmem(spec, bank, keys,
                                           member.long(), lay),
            lambda: sbf.bank_contains_vmem(spec, bank, keys, member[:4], lay),
            lambda: sbf.bank_contains_vmem(spec, bank, keys, member, lay,
                                           depth=3),
            lambda: sbf.bank_add_vmem(spec, bank, keys, member,
                                      torch.ones(8, dtype=torch.int32), lay),
            lambda: TC.bank_update_vmem(TV.FilterSpec("countingbf", M, 8),
                                        bank, keys, member, None, "add"),
            lambda: TC.bank_update_vmem(TV.FilterSpec("countingbf", M, 8),
                                        torch.zeros((2, M // 8),
                                                    dtype=torch.int32),
                                        keys, member, None, "scale"),
            lambda: ops.bloom_bank_add(TV.FilterSpec("cbf", M, 3),
                                       bank, keys, member)):
        with pytest.raises(ValueError):
            call()


def test_routed_ops_are_one_wrapper_call_and_no_cpu_launch(monkeypatch):
    """Every routed bank op reaches its wrapper once (one launch on the
    card, ``tests/test_torch_gpu.py``); on the CPU the plain versions run
    and the launch counters stay at 0."""
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)
    for name in ("bank_add_vmem", "bank_contains_vmem"):
        spy(sbf, name)
    spy(TC, "bank_update_vmem")
    sbf.reset_launches()
    TC.reset_launches()
    B = 4
    spec, cspec = TV.FilterSpec("sbf", M, 8), TV.FilterSpec("countingbf", M, 8)
    keys, tenants, valid = _traffic(B, 600, seed=11)
    tk, tm, tv = (as_keys(keys), torch.from_numpy(tenants),
                  torch.from_numpy(valid))
    bank = ops.bloom_bank_add(spec, torch.zeros((B, spec.n_words),
                                                dtype=torch.int32),
                              tk, tm, valid=tv)
    ops.bloom_bank_contains(spec, bank, tk, tm)
    counters = ops.counting_bank_update(
        cspec, torch.zeros((B, cspec.storage_words), dtype=torch.int32),
        tk, tm, "add", valid=tv)
    ops.counting_bank_update(cspec, counters, tk, tm, "remove")
    assert calls == {"bank_add_vmem": 1, "bank_contains_vmem": 1,
                     "bank_update_vmem": 2}
    assert not any(sbf.LAUNCHES.values()) and not any(TC.LAUNCHES.values())
    # a counting bank decays whole: the decay wrapper takes (B, words)
    decayed = TC.decay(cspec, counters.clone())
    _eq(decayed, _u32(TV.counting_decay(cspec, counters)))
    assert TC.LAUNCHES["decay"] == 0


def test_bank_engine_selection():
    cpu = torch.device("cpu")
    small = TV.FilterSpec("sbf", 1 << 17, 8)
    big = 2 * ops.L2_FILTER_BYTES // (small.storage_words * 4)   # 2x the L2
    for B, want_gpu in ((64, "cuda-l2"), (big, "cuda-dram")):
        gpu = registry.SelectionContext(device=torch.device("cuda"), bank=B)
        assert registry.select(small, "auto", gpu).name == want_gpu
        assert ops.bank_l2_resident(small, B) == (want_gpu == "cuda-l2")
        assert registry.select(small, "auto", registry.SelectionContext(
            device=cpu, bank=B)).name == "torch"
    assert not registry.get("cuda-l2").supports(
        small, registry.SelectionContext(device=torch.device("cuda"),
                                         bank=big))
    cspec = TV.FilterSpec("countingbf", 1 << 16, 8)
    gpu = registry.SelectionContext(device=torch.device("cuda"), bank=1024)
    assert registry.select(cspec, "auto", gpu).name == "counting"
    for name in ("torch", "cuda-l2", "cuda-dram", "counting"):
        assert registry.get(name).supports_bank
    assert not registry.get("windowed").supports_bank
    b = api.filter_for_n_items(1 << 13, bits_per_key=16, bank=8,
                               device="cpu")
    j = japi.filter_for_n_items(1 << 13, bits_per_key=16, bank=8)
    assert b.spec.m_bits == j.spec.m_bits and b.spec.k == j.spec.k
    assert b.words.shape == (8, b.spec.n_words)
    fpr = b.add(np.stack([JH.random_u64x2(1 << 13, seed=b_)
                          for b_ in range(8)])).measure_fpr(1 << 12)
    assert 0.0 < fpr < 0.02
    with pytest.raises(ValueError):
        api.make_filter_bank(0, device="cpu")
    with pytest.raises(ValueError):
        api.make_filter_bank((), device="cpu")
