"""The quotient filter of the PyTorch port against the JAX package, on the CPU:
``repro_torch.core.quotient`` and the wrappers of
``repro_torch.kernels.quotientfilter`` / ``ops.quotient_*``.

The same seeded numpy keys and validity masks go through the JAX package
(``repro.core.quotient`` (``JQ``), its jnp reference, and
``repro.kernels.ops.quotient_*``, its Pallas kernels in interpret mode,
which trace under jax 0.9) and through ``repro_torch`` with CPU tensors,
where every wrapper runs its plain version. Hashes, packing, decode,
layout, contains (both ``coop`` values), add and remove words and
``ok``/``found`` flags, merge and resize must be equal bit for bit
(tolerance 0): u8, u16 and u32 lanes over several remainder widths, loads
0.5 and 0.9 and a batch past capacity, duplicates, valid masks, removes of
absent keys, a table whose clusters wrap past the last slot, and the tiles
256, 2048 and the whole batch. The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_gpu.py``.

Sizes stay small (at most 2^12 slots, a few thousand keys): the JAX jnp
update compiles each of its 2048-key tiles.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import quotient as JQ
from repro.core import variants as JV
from repro.kernels import ops as JO
from repro_torch.api.filter import as_keys
from repro_torch.core import quotient as TQ
from repro_torch.core import variants as TV
from repro_torch.kernels import ops
from repro_torch.kernels import quotientfilter as TK

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

# (slot_bits, r_bits, q_bits)
GEOMETRIES = [(8, 5, 10), (16, 9, 9), (32, 20, 8), (8, 2, 9)]
IDS = [f"u{sb}-r{r}-q{q}" for sb, r, q in GEOMETRIES]


def _specs(slot_bits, r_bits, q_bits):
    kw = dict(m_bits=(1 << q_bits) * slot_bits, k=1, slot_bits=slot_bits,
              r_bits=r_bits)
    return JV.FilterSpec("quotient", **kw), TV.FilterSpec("quotient", **kw)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _eq_words(port, jax_words):
    np.testing.assert_array_equal(_u32(port), np.asarray(jax_words))


def _eq(port, jax_value):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(jax_value))


def _batch(n, seed, dup=0.05, invalid=0.2):
    """n keys with about ``dup`` of them repeated (some three times), and a
    valid mask with about ``invalid`` zeros."""
    rng = np.random.RandomState(seed)
    keys = JH.random_u64x2(n, seed=seed)
    d = int(n * dup)
    keys = np.concatenate([keys, keys[rng.randint(0, n, size=d)],
                           keys[:3], keys[:3]])
    keys = keys[rng.permutation(len(keys))]
    valid = (rng.rand(len(keys)) > invalid).astype(np.uint8)
    return keys, valid


def _filled(ts, load, seed):
    """A port table holding ``load`` of the slots (and the keys)."""
    keys = JH.random_u64x2(int(ts.n_slots * load), seed=seed)
    table, ok = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys))
    assert bool(ok.all())
    return table, keys


def _wrapping_keys(ts, n, seed):
    """n keys whose home slots lie in the top eighth of the table, so the
    clusters they build run past the last slot into slot 0."""
    out, s = [], seed
    while sum(len(k) for k in out) < n:
        cand = JH.random_u64x2(4 * n, seed=s)
        q = TQ.split_fp(ts, TQ.quotient_hashes(ts, as_keys(cand)))[0]
        out.append(cand[(q >= ts.n_slots * 7 // 8).numpy()])
        s += 1
    return np.concatenate(out)[:n]


# ---------------------------------------------------------------------------
# Hashing, packing, decode, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_hashes_split_and_packing_match_jax(geom):
    js, ts = _specs(*geom)
    keys = JH.random_u64x2(3000, seed=1)
    jfp = JQ.quotient_hashes(js, jnp.asarray(keys))
    tfp = TQ.quotient_hashes(ts, as_keys(keys))
    _eq(tfp, jfp)
    assert int(tfp.max()) < 1 << ts.fingerprint_bits
    jq, jr = JQ.split_fp(js, jfp)
    tq, tr = TQ.split_fp(ts, tfp)
    _eq(tq, jq)
    _eq(tr, jr)
    words = np.random.RandomState(2).randint(0, 2**32, size=ts.n_words,
                                             dtype=np.uint64).astype(np.uint32)
    jl = JQ.unpack_slots(js, jnp.asarray(words))
    tl = TQ.unpack_slots(ts, torch.from_numpy(words.view(np.int32)))
    _eq(tl, jl)
    _eq_words(TQ.pack_slots(ts, tl), JQ.pack_slots(js, jl))
    for got, want in zip(TQ._fields(ts, tl), JQ._fields(js, jl)):
        _eq(got, want)


@pytest.mark.parametrize("geom", GEOMETRIES[:3], ids=IDS[:3])
def test_decode_and_layout_match_jax(geom):
    js, ts = _specs(*geom)
    rng = np.random.RandomState(3)
    n = int(ts.n_slots * 0.8)
    fp = rng.randint(0, 1 << ts.fingerprint_bits, size=n).astype(np.uint32)
    k = n // 8
    fp[:k] = fp[k:2 * k]                               # duplicates
    fp[n // 4: n // 3] |= np.uint32((ts.n_slots - 1) << ts.r_bits)  # wrap
    valid = rng.rand(n) > 0.1
    jl = JQ._layout(js, jnp.asarray(fp), jnp.asarray(valid))
    tl = TQ._layout(ts, torch.from_numpy(fp.astype(np.int64)),
                    torch.from_numpy(valid))
    _eq(tl, jl)
    words = TQ.pack_slots(ts, tl)
    jfps, jcount = JQ.decode_fingerprints(js, JQ.pack_slots(js, jl))
    tfps, tcount = TQ.decode_fingerprints(ts, words)
    _eq(tfps, jfps)
    assert int(tcount) == int(jcount) == int(valid.sum())
    # the decoded multiset is the one that was laid out
    np.testing.assert_array_equal(tfps[: int(tcount)].numpy(),
                                  np.sort(fp[valid]).astype(np.int64))


# ---------------------------------------------------------------------------
# contains, add, remove against the jnp reference and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_contains_matches_jax_both_coops(geom):
    js, ts = _specs(*geom)
    table, keys = _filled(ts, 0.9, 4)
    probes = np.concatenate([keys, JH.probe_u64x2(1000, seed=4)])
    jt = jnp.asarray(_u32(table))
    want = JQ.quotient_contains(js, jt, jnp.asarray(probes))
    assert bool(np.asarray(want)[: len(keys)].all())      # no false negative
    for coop in ("none", "subtile"):
        _eq(TK.contains_plain(ts, table, as_keys(probes), coop), want)
        _eq(ops.quotient_contains(ts, table, as_keys(probes), coop=coop),
            JO.quotient_contains(js, jt, jnp.asarray(probes), coop=coop))
    empty = TQ.init(ts)
    assert not bool(TQ.quotient_contains_coop(ts, empty,
                                              as_keys(probes)).any())


@pytest.mark.parametrize("geom,load", [(GEOMETRIES[0], 0.5),
                                       (GEOMETRIES[0], 1.3),
                                       (GEOMETRIES[1], 0.9),
                                       (GEOMETRIES[2], 1.3),
                                       (GEOMETRIES[3], 0.9)],
                         ids=["u8-0.5", "u8-1.3", "u16-0.9", "u32-1.3",
                              "u8r2-0.9"])
def test_add_and_remove_match_jax(geom, load):
    js, ts = _specs(*geom)
    keys, valid = _batch(int(ts.n_slots * load), seed=int(load * 10),
                         invalid=0.1)
    jw, jok = JQ.quotient_add(js, JQ.init(js), jnp.asarray(keys),
                              valid=jnp.asarray(valid))
    tw, tok = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys),
                              valid=torch.from_numpy(valid))
    _eq_words(tw, jw)
    _eq(tok, jok)
    if load > 1:
        assert not bool(tok.all())                      # past capacity
        assert int(TQ.occupied_slots(ts, tw)) == ts.n_slots - 1
    assert int(TQ.occupied_slots(ts, tw)) == int(
        (tok & torch.from_numpy(valid).bool()).sum())
    # removes: half the keys, repeats of stored ones, never-added keys
    gone = np.concatenate([keys[: len(keys) // 2], keys[:40], keys[:40],
                           JH.probe_u64x2(60, seed=7)])
    gv = (np.random.RandomState(8).rand(len(gone)) > 0.1).astype(np.uint8)
    jr, jf = JQ.quotient_remove(js, jw, jnp.asarray(gone),
                                valid=jnp.asarray(gv))
    tr, tf = TQ.quotient_remove(ts, tw, as_keys(gone),
                                valid=torch.from_numpy(gv))
    _eq_words(tr, jr)
    _eq(tf, jf)
    assert not bool(tf.all())                           # absent keys


@pytest.mark.parametrize("geom", [GEOMETRIES[0], GEOMETRIES[2]],
                         ids=[IDS[0], IDS[2]])
def test_ops_and_tiles_match_the_jax_kernels(geom):
    """``ops.quotient_*`` against the JAX dispatch (Pallas, interpret) with
    its default tile, and the port at tiles 256, 2048 and the whole batch:
    the words and flags do not depend on the tile."""
    js, ts = _specs(*geom)
    keys, valid = _batch(int(ts.n_slots * 1.1), seed=11)
    jv = jnp.asarray(valid.astype(bool))
    jw, jok = JO.quotient_add(js, JQ.init(js), jnp.asarray(keys), valid=jv)
    gone = keys[::3]
    jr, jf = JO.quotient_remove(js, jw, jnp.asarray(gone))
    for tile in (256, 2048, None):
        tw, tok = ops.quotient_add(ts, TQ.init(ts), as_keys(keys),
                                   valid=torch.from_numpy(valid), tile=tile)
        _eq_words(tw, jw)
        _eq(tok, jok)
        pw, pok = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys),
                                  valid=torch.from_numpy(valid), tile=tile)
        assert torch.equal(pw, tw) and torch.equal(pok, tok)
        tr, tf = ops.quotient_remove(ts, tw, as_keys(gone), tile=tile)
        _eq_words(tr, jr)
        _eq(tf, jf)


def test_clusters_that_wrap_past_the_last_slot():
    js, ts = _specs(*GEOMETRIES[0])
    keys = _wrapping_keys(ts, int(ts.n_slots * 0.2), seed=20)
    jw, jok = JQ.quotient_add(js, JQ.init(js), jnp.asarray(keys))
    tw, tok = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys))
    _eq_words(tw, jw)
    _eq(tok, jok)
    lanes = TQ.unpack_slots(ts, tw)
    # slot 0 holds a fingerprint homed in the top eighth: a wrapped cluster
    assert int(lanes[0]) >> (ts.slot_bits - 3) & 1            # shifted
    probes = np.concatenate([keys, JH.probe_u64x2(500, seed=21)])
    hit = TQ.quotient_contains(ts, tw, as_keys(probes))
    assert bool(hit[: len(keys)].all())
    _eq(hit, JQ.quotient_contains(js, jw, jnp.asarray(probes)))
    jr, jf = JQ.quotient_remove(js, jw, jnp.asarray(keys[::2]))
    tr, tf = TQ.quotient_remove(ts, tw, as_keys(keys[::2]))
    _eq_words(tr, jr)
    _eq(tf, jf)


def test_empty_batches_empty_and_full_tables():
    js, ts = _specs(*GEOMETRIES[3])
    empty = TQ.init(ts)
    none = as_keys(np.zeros((0, 2), np.uint32))
    for fn in (TQ.quotient_add, TQ.quotient_remove):
        w, f = fn(ts, empty, none)
        assert torch.equal(w, empty) and f.shape == (0,)
    for fn in (ops.quotient_add, ops.quotient_remove):
        w, f = fn(ts, empty, none)
        assert torch.equal(w, empty) and f.shape == (0,)
    assert ops.quotient_contains(ts, empty, none).shape == (0,)
    # exactly n_slots - 1 keys fit; the next is refused
    keys = JH.random_u64x2(ts.n_slots, seed=30)
    tw, tok = TQ.quotient_add(ts, empty, as_keys(keys))
    assert tok.tolist() == [True] * (ts.n_slots - 1) + [False]
    jw, jok = JQ.quotient_add(js, JQ.init(js), jnp.asarray(keys))
    _eq_words(tw, jw)
    _eq(tok, jok)
    assert bool(TQ.quotient_contains(ts, tw, as_keys(keys[:-1])).all())
    # removing every stored key leaves the empty table
    gone, found = TQ.quotient_remove(ts, tw, as_keys(keys[:-1]))
    assert bool(found.all()) and not bool(gone.any())
    # removes from an empty table find nothing
    _, found = TQ.quotient_remove(ts, empty, as_keys(keys[:10]))
    assert not bool(found.any())


# ---------------------------------------------------------------------------
# merge and resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES[:3], ids=IDS[:3])
def test_merge_and_resize_match_jax(geom):
    js, ts = _specs(*geom)
    keys = JH.random_u64x2(int(ts.n_slots * 0.8), seed=40)
    half = len(keys) // 2
    a, _ = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys[:half]))
    b, _ = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys[half:]))
    both, _ = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys))
    merged = TQ.quotient_merge(ts, a, b)
    assert torch.equal(merged, both)          # the concatenated stream
    _eq_words(merged, JQ.quotient_merge(js, jnp.asarray(_u32(a)),
                                        jnp.asarray(_u32(b))))
    grown_t = TQ.spec_for_resize(ts, 2 * ts.m_bits)
    grown_j = JQ.spec_for_resize(js, 2 * js.m_bits)
    assert dataclasses.asdict(grown_t) == dataclasses.asdict(grown_j)
    grown = TQ.quotient_resize(ts, both, grown_t)
    _eq_words(grown, JQ.quotient_resize(js, jnp.asarray(_u32(both)),
                                        grown_j))
    # a grown table is the table built in the grown geometry
    rebuilt, _ = TQ.quotient_add(grown_t, TQ.init(grown_t), as_keys(keys))
    assert torch.equal(grown, rebuilt)
    assert bool(TQ.quotient_contains(grown_t, grown, as_keys(keys)).all())
    back = TQ.quotient_resize(grown_t, grown, ts)
    assert torch.equal(back, both)
    with pytest.raises(ValueError):
        TQ.quotient_resize(ts, both, TV.FilterSpec(
            "quotient", ts.m_bits, 1, slot_bits=ts.slot_bits,
            r_bits=ts.r_bits - 1 if ts.r_bits > 1 else 2))


def test_spec_for_resize_refuses_what_jax_refuses():
    for geom in GEOMETRIES:
        js, ts = _specs(*geom)
        for factor in (4, 2, 0.5, 0.25, 1 / 64):
            m = int(ts.m_bits * factor)
            try:
                want = dataclasses.asdict(JQ.spec_for_resize(js, m))
            except ValueError:
                with pytest.raises(ValueError):
                    TQ.spec_for_resize(ts, m)
            else:
                assert dataclasses.asdict(TQ.spec_for_resize(ts, m)) == want
    with pytest.raises(ValueError):
        TQ.spec_for_resize(TV.FilterSpec("cuckoo", 1 << 12, 2), 1 << 13)


# ---------------------------------------------------------------------------
# Wrappers, introspection, sizing
# ---------------------------------------------------------------------------

def test_wrappers_run_the_plain_versions_on_the_cpu():
    js, ts = _specs(*GEOMETRIES[0])
    keys, valid = _batch(700, seed=50)
    tk, tv = as_keys(keys), torch.from_numpy(valid)
    TK.reset_launches()
    table = TQ.init(ts)
    out, ok = TK.add_vmem(ts, table, tk, tv, tile=256)
    want, want_ok = TK.update_plain(ts, TQ.init(ts), tk, tv, "add")
    assert out is table and torch.equal(table, want)      # in place
    assert torch.equal(ok, want_ok)
    hit = TK.contains_vmem(ts, table, tk, coop="subtile")
    assert torch.equal(hit, TK.contains_plain(ts, table, tk))
    gone, found = TK.remove_vmem(ts, table.clone(), tk[:100], None)
    want, want_found = TK.update_plain(ts, table, tk[:100], None, "remove")
    assert torch.equal(gone, want) and torch.equal(found, want_found)
    other, _ = TK.update_plain(ts, TQ.init(ts), tk[100:300], None, "add")
    assert torch.equal(TK.merge_vmem(ts, table, other),
                       TQ.quotient_merge(ts, table, other))
    grown = TQ.spec_for_resize(ts, 2 * ts.m_bits)
    assert torch.equal(TK.resize_vmem(ts, table, grown),
                       TQ.quotient_resize(ts, table, grown))
    assert set(TK.LAUNCHES.values()) == {0}
    assert set(TK.LAUNCHES) == {"contains_vmem", "add_vmem", "remove_vmem",
                                "merge_vmem", "resize_vmem"}
    # the contains' rule: the walk below LOAD_MIN_KEYS keys, then by the
    # table's load
    assert TK.contains_mode(ts, TK.LOAD_MIN_KEYS - 1, 0.9) == "walk"
    assert TK.contains_mode(ts, TK.LOAD_MIN_KEYS, 0.9) == "binned"
    assert TK.contains_mode(ts, TK.LOAD_MIN_KEYS, 0.5) == "walk"
    for bad in (lambda: TK.contains_vmem(ts, table, tk, coop="warp"),
                lambda: TK.update_plain(ts, table, tk, None, "decay"),
                lambda: TK.add_vmem(ts, table, tk, tv[:5]),
                lambda: TK.add_vmem(ts, table, tk, tv.to(torch.int32)),
                lambda: TK.add_vmem(ts, table, tk, None, tile=0),
                lambda: TK.add_vmem(ts, table[:-1], tk, None),
                lambda: TK.contains_vmem(TV.FilterSpec("cuckoo", 1 << 13, 2),
                                         table, tk),
                lambda: ops.quotient_add(TV.FilterSpec("sbf", 1 << 13, 8),
                                         table, tk),
                lambda: ops.quotient_contains(ts, table, tk, coop="x"),
                lambda: TK.merge_vmem(ts, table, table[:-1]),
                lambda: TK.merge_vmem(ts, table, table.to(torch.int64)),
                lambda: TK.resize_vmem(ts, table, TV.FilterSpec(
                    "quotient", ts.m_bits, 1, slot_bits=8, r_bits=4))):
        with pytest.raises(ValueError):
            bad()
    assert TK.kernel_supported(ts)
    assert ops.quotient_kernel_supported(TV.FilterSpec(
        "quotient", (1 << 29) * 8, 1, slot_bits=8, r_bits=2))
    assert not ops.quotient_kernel_supported(TV.FilterSpec(
        "quotient", (1 << 30) * 8, 1, slot_bits=8, r_bits=1))
    assert not ops.quotient_kernel_supported(TV.FilterSpec("cuckoo",
                                                           1 << 13, 2))


def test_occupancy_and_sizing_match_jax():
    js, ts = _specs(*GEOMETRIES[1])
    table, keys = _filled(ts, 0.7, 60)
    bank = torch.stack([table, TQ.init(ts), table])
    jbank = jnp.asarray(_u32(bank))
    _eq(TQ.occupied_slots(ts, bank), JQ.occupied_slots(js, jbank))
    _eq(TQ.quotient_load_factor(ts, bank), JQ.quotient_load_factor(js, jbank))
    assert int(TQ.occupied_slots(ts, table)) == len(keys)
    # the generic init gives the quotient table JAX's quotient init gives
    _eq_words(TV.init(ts), JQ.init(js))
    assert torch.equal(TV.init(ts), TQ.init(ts))
    for q, r, a in ((10, 5, 0.9), (20, 8, 0.5), (26, 5, 0.9), (4, 1, 0.1)):
        assert TQ.fpr_quotient(q, r, a) == JQ.fpr_quotient(q, r, a)
    for eps in (0.1, 1e-3, 1e-6):
        assert TQ.r_bits_for_fpr(eps, 20) == JQ.r_bits_for_fpr(eps, 20)
    assert TQ.bits_per_key(ts) == JQ.bits_per_key(js)
    assert TQ.bits_per_key(ts, 100) == JQ.bits_per_key(js, 100)
    raised = 0
    for n, eps, sb in ((1000, None, None), (3000, 1e-3, None),
                       (3000, None, 16), (10 ** 6, 1e-5, None),
                       (1 << 22, None, None), (1 << 25, None, None),
                       (100, 1e-8, None), (100, None, 32), (1000, 1e-9, 8),
                       (1 << 26, None, None), (5000, 1e-4, 16)):
        try:
            want = dataclasses.asdict(JQ.spec_for_n(n, eps, sb))
        except ValueError:
            raised += 1
            with pytest.raises(ValueError):
                TQ.spec_for_n(n, eps, sb)
        else:
            assert dataclasses.asdict(TQ.spec_for_n(n, eps, sb)) == want
    assert 3 <= raised <= 5
    big = TQ.spec_for_n(1 << 25)
    assert (big.q_bits, big.r_bits, big.slot_bits, big.m_bits) == (
        26, 5, 8, 1 << 29)
