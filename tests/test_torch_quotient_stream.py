"""The sorted-stream quotient update's schedule against the JAX package, on
the CPU: ``repro_torch.kernels.quotientfilter.update_stream_model`` (and
``merge_stream_model`` / ``resize_stream_model``), which runs the CUDA
update's stages (table tiles and their carries, the decode's walk of the
occupied bits, admission, bins, merge tiles, the anchor, the positions'
carried max and the tile-start tables, the write) in plain PyTorch.

The same seeded numpy keys and validity masks go through
``repro.core.quotient`` (``JQ``, its jnp reference) and through the model;
words and flags must be equal bit for bit (tolerance 0): u8, u16 and u32
lanes with r = 2 and the widest r, clusters that wrap past the last slot
and span several lowered tiles, one bin and more bins than slots, a full
table and a batch past capacity, a key repeated more often than a bin
holds (the device-memory sort), removes of absent keys and of more copies
than are stored, valid masks, batches of 0, 1 and 2 keys, a merge to load
0.9 and a resize up and back. The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_gpu.py``.

Sizes stay at or below 2^12 slots and a few thousand keys: the JAX jnp
update compiles each of its 2048-key tiles, so it runs under ``jax.jit``
(one compile a shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import quotient as JQ
from repro.core import variants as JV
from repro_torch.api.filter import as_keys
from repro_torch.core import quotient as TQ
from repro_torch.core import variants as TV
from repro_torch.kernels import quotientfilter as TK

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

# (slot_bits, r_bits, q_bits): r = 2 and the widest r of each lane
GEOMETRIES = [(8, 2, 10), (8, 5, 10), (16, 2, 9), (16, 13, 9), (32, 2, 8),
              (32, 27, 4)]
IDS = [f"u{sb}-r{r}-q{q}" for sb, r, q in GEOMETRIES]
# lowered knobs: clusters span several 32-slot tiles, 5-element merge
# tiles, 8 bins of at most 4 keys in shared memory
LOW = dict(tile_slots=32, merge_tile=5, bin_bits=3, bin_cap=4)
# the JAX reference, one compile a shape (the spec is static)
J_ADD = jax.jit(JQ.quotient_add, static_argnums=0)
J_REMOVE = jax.jit(JQ.quotient_remove, static_argnums=0)
J_MERGE = jax.jit(JQ.quotient_merge, static_argnums=0)
J_RESIZE = jax.jit(JQ.quotient_resize, static_argnums=(0, 2))


def _specs(slot_bits, r_bits, q_bits):
    kw = dict(m_bits=(1 << q_bits) * slot_bits, k=1, slot_bits=slot_bits,
              r_bits=r_bits)
    return JV.FilterSpec("quotient", **kw), TV.FilterSpec("quotient", **kw)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _batch(n, seed, dup=0.05, invalid=0.2):
    """n keys with about ``dup`` of them repeated (some three times), and a
    valid mask with about ``invalid`` zeros."""
    rng = np.random.RandomState(seed)
    keys = JH.random_u64x2(n, seed=seed)
    keys = np.concatenate([keys, keys[rng.randint(0, n, size=int(n * dup))],
                           keys[:3], keys[:3]])
    keys = keys[rng.permutation(len(keys))]
    return keys, (rng.rand(len(keys)) > invalid).astype(np.uint8)


def _update(js, ts, jw, tw, keys, valid, op, **knobs):
    """One add or remove through JQ and the model from equal tables; words
    and flags must be equal. Returns the new (JAX, port) tables."""
    jfn = J_ADD if op == "add" else J_REMOVE
    jv = None if valid is None else jnp.asarray(valid)
    jw2, jf = jfn(js, jw, jnp.asarray(keys), valid=jv)
    tv = None if valid is None else torch.from_numpy(valid)
    tw2, tf = TK.update_stream_model(ts, tw, as_keys(keys), tv, op, **knobs)
    np.testing.assert_array_equal(_u32(tw2), np.asarray(jw2))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    return jw2, tw2


def _wrapping_keys(ts, n, seed):
    """n keys homed in the top eighth of the slots (clusters run past the
    last slot into slot 0)."""
    out, s = [], seed
    while sum(len(k) for k in out) < n:
        cand = JH.random_u64x2(4 * n, seed=s)
        q = TQ.split_fp(ts, TQ.quotient_hashes(ts, as_keys(cand)))[0]
        out.append(cand[(q >= ts.n_slots * 7 // 8).numpy()])
        s += 1
    return np.concatenate(out)[:n]


def _longest_cluster(ts, table) -> int:
    in_use = TQ._fields(ts, TQ.unpack_slots(ts, table))[3].numpy()
    run = best = 0
    for u in np.concatenate([in_use, in_use]):        # clusters may wrap
        run = run + 1 if u else 0
        best = max(best, run)
    return min(best, ts.n_slots)


# ---------------------------------------------------------------------------
# add and remove against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [{}, LOW], ids=["default", "lowered"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_stream_update_matches_jax(geom, knobs):
    """Add to load 0.9 with duplicates and a mask, a second add past
    capacity, removes of half the keys, of repeats beyond the stored copies
    and of absent keys (masked and not)."""
    js, ts = _specs(*geom)
    keys, valid = _batch(int(ts.n_slots * 0.85), seed=geom[2] + geom[1])
    jw, tw = _update(js, ts, JQ.init(js), TQ.init(ts), keys, valid, "add",
                     **knobs)
    more = JH.random_u64x2(ts.n_slots // 2, seed=7)
    jw, tw = _update(js, ts, jw, tw, more, None, "add", **knobs)
    assert int(TQ.occupied_slots(ts, tw)) == ts.n_slots - 1   # past capacity
    gone = np.concatenate([keys[: len(keys) // 2], keys[:40], keys[:40],
                           JH.probe_u64x2(60, seed=8)])
    gv = (np.random.RandomState(9).rand(len(gone)) > 0.1).astype(np.uint8)
    _update(js, ts, jw, tw, gone, gv, "remove", **knobs)
    _update(js, ts, jw, tw, gone, None, "remove", **knobs)


def test_wrapping_clusters_longer_than_a_tile():
    js, ts = _specs(8, 5, 10)
    keys = _wrapping_keys(ts, int(ts.n_slots * 0.2), seed=20)
    jw, tw = _update(js, ts, JQ.init(js), TQ.init(ts), keys, None, "add",
                     **LOW)
    lanes = TQ.unpack_slots(ts, tw)
    assert int(lanes[0]) >> (ts.slot_bits - 3) & 1            # slot 0 shifted
    assert _longest_cluster(ts, tw) > 4 * LOW["tile_slots"]
    # a second batch into the wrapped table, then removes from it
    more = _wrapping_keys(ts, 64, seed=40)
    jw, tw = _update(js, ts, jw, tw, more, None, "add", **LOW)
    _update(js, ts, jw, tw, keys[::2], None, "remove", **LOW)


@pytest.mark.parametrize("bins", [0, 12], ids=["one-bin", "more-than-slots"])
def test_one_bin_and_more_bins_than_slots(bins):
    js, ts = _specs(32, 20, 8)              # 256 slots, p = 28
    keys, valid = _batch(200, seed=31)
    knobs = dict(bin_bits=bins, tile_slots=64, merge_tile=64)
    jw, tw = _update(js, ts, JQ.init(js), TQ.init(ts), keys, valid, "add",
                     **knobs)
    _update(js, ts, jw, tw, keys[::2], None, "remove", **knobs)


def test_a_key_repeated_past_a_bin():
    """One key 300 times (a bin of 300 > bin_cap: the device-memory sort):
    one run longer than several tiles, then removes of 200 and of 400."""
    js, ts = _specs(16, 9, 9)
    keys = np.concatenate([np.repeat(JH.random_u64x2(1, seed=50), 300,
                                     axis=0), JH.random_u64x2(100, seed=51)])
    keys = keys[np.random.RandomState(52).permutation(len(keys))]
    stats = {}
    knobs = dict(tile_slots=32, merge_tile=64, bin_bits=2, bin_cap=64)
    jw, tw = _update(js, ts, JQ.init(js), TQ.init(ts), keys, None, "add",
                     **knobs)
    TK.update_stream_model(ts, TQ.init(ts), as_keys(keys), None, "add",
                           stats=stats, **knobs)
    assert stats["big_bins"] >= 1
    assert _longest_cluster(ts, tw) >= 300
    one = np.repeat(JH.random_u64x2(1, seed=50), 400, axis=0)
    _update(js, ts, jw, tw, one[:200], None, "remove", **knobs)
    _update(js, ts, jw, tw, one, None, "remove", **knobs)


def test_full_table_and_tiny_batches():
    js, ts = _specs(8, 2, 9)
    jw, tw = JQ.init(js), TQ.init(ts)
    for n in (0, 1, 2):                      # n = 0, 1, 2 keys
        keys = JH.random_u64x2(n, seed=60 + n) if n else np.zeros(
            (0, 2), np.uint32)
        for op in ("add", "remove"):
            tw2, tf = TK.update_stream_model(ts, tw, as_keys(keys), None, op,
                                             **LOW)
            if n == 0:
                assert torch.equal(tw2, tw) and tf.shape == (0,)
            else:
                _update(js, ts, jw, tw, keys, None, op, **LOW)
    keys = JH.random_u64x2(ts.n_slots, seed=63)
    jw, tw = _update(js, ts, jw, tw, keys, None, "add", **LOW)
    assert int(TQ.occupied_slots(ts, tw)) == ts.n_slots - 1   # full
    # room 0: every valid key refused, masked keys reported ok
    extra, valid = _batch(50, seed=64)
    _, tf = TK.update_stream_model(ts, tw, as_keys(extra),
                                   torch.from_numpy(valid), "add", **LOW)
    assert tf.numpy().tolist() == (valid == 0).tolist()
    _update(js, ts, jw, tw, extra, valid, "add", **LOW)
    _update(js, ts, jw, tw, keys[:-1], None, "remove", **LOW)


# ---------------------------------------------------------------------------
# merge and resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [{}, dict(tile_slots=32, merge_tile=7)],
                         ids=["default", "lowered"])
@pytest.mark.parametrize("geom", [GEOMETRIES[1], GEOMETRIES[3],
                                  GEOMETRIES[4]],
                         ids=[IDS[1], IDS[3], IDS[4]])
def test_stream_merge_and_resize_match_jax(geom, knobs):
    js, ts = _specs(*geom)
    keys = JH.random_u64x2(int(ts.n_slots * 0.9), seed=70)
    third = len(keys) // 3
    a, _ = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys[:third]))
    b, _ = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys[third:]))
    merged = TK.merge_stream_model(ts, a, b, **knobs)
    np.testing.assert_array_equal(
        _u32(merged), np.asarray(J_MERGE(
            js, jnp.asarray(_u32(a)), jnp.asarray(_u32(b)))))
    assert torch.equal(merged, TQ.quotient_add(ts, TQ.init(ts),
                                               as_keys(keys))[0])
    grown_t = TQ.spec_for_resize(ts, 2 * ts.m_bits)
    grown = TK.resize_stream_model(ts, merged, grown_t, **knobs)
    np.testing.assert_array_equal(
        _u32(grown), np.asarray(J_RESIZE(
            js, jnp.asarray(_u32(merged)),
            JQ.spec_for_resize(js, 2 * js.m_bits))))
    assert torch.equal(TK.resize_stream_model(grown_t, grown, ts, **knobs),
                       merged)


# ---------------------------------------------------------------------------
# The model at several bin and tile sizes, and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(bin_bits=0), dict(bin_bits=1, bin_cap=1), dict(bin_bits=6),
    dict(tile_slots=32, merge_tile=1), dict(tile_slots=64, merge_tile=3),
    dict(tile_slots=128, merge_tile=4096, bin_bits=12, bin_cap=2)],
    ids=["b0", "b1-cap1", "b6", "t32-m1", "t64-m3", "t128-b12"])
def test_stream_model_equals_the_plain_update(knobs):
    ts = TV.FilterSpec("quotient", (1 << 9) * 16, 1, slot_bits=16, r_bits=9)
    keys = as_keys(np.concatenate([JH.random_u64x2(420, seed=80)] * 2))
    valid = torch.from_numpy(
        (np.random.RandomState(81).rand(keys.shape[0]) > 0.3).astype(
            np.uint8))
    want, ok = TQ.quotient_add(ts, TQ.init(ts), keys, valid=valid)
    got, got_ok = TK.update_stream_model(ts, TQ.init(ts), keys, valid, "add",
                                         **knobs)
    assert torch.equal(got, want) and torch.equal(got_ok, ok)
    gone = torch.cat([keys[::3], keys[:20]])
    want_rm, found = TQ.quotient_remove(ts, want, gone)
    got_rm, got_found = TK.update_stream_model(ts, want, gone, None,
                                               "remove", **knobs)
    assert torch.equal(got_rm, want_rm) and torch.equal(got_found, found)


def test_update_plan_sizes_the_workspace_by_element_and_tile():
    spec = TQ.spec_for_n(1 << 25)                    # q26 + r5, u8, 64 MiB
    assert (spec.q_bits, spec.slot_bits) == (26, 8)
    plan = TK.update_plan(spec, 1 << 24, "add")
    assert plan["bin_bits"] == 12 and plan["n_bins"] == 4096
    assert plan["passes"] == 1 and plan["table_tiles"] == 1 << 14
    # two element streams of the capacity, the sorted pairs, small arrays
    streams = 2 * 4 * (spec.n_slots - 1) + 8 * (1 << 24)
    assert streams < plan["workspace_bytes"] < streams + (8 << 20)
    assert plan["workspace_bytes"] < 0.75 * (1 << 30)   # was ~1.45 GiB
    rm = TK.update_plan(spec, 1 << 24, "remove")
    assert rm["workspace_bytes"] == plan["workspace_bytes"]
    merge = TK.update_plan(spec, 0, "merge")
    assert merge["bin_bits"] is None and merge["n_bins"] == 0
    assert merge["workspace_bytes"] > 3 * 4 * (spec.n_slots - 1)
    grown = TQ.spec_for_resize(spec, 2 * spec.m_bits)
    resize = TK.update_plan(spec, 0, "resize", new_spec=grown)
    assert resize["table_tiles"] == grown.n_slots // TK.TILE_SLOTS
    big = TK.update_plan(spec, 3 * TK.KEY_BATCH + 1, "add")
    assert big["passes"] == 4 and big["pass_keys"] == TK.KEY_BATCH
    assert TK.bin_bits_for(0, 31) == 0
    assert TK.bin_bits_for(TK.BIN_KEYS, 31) == 0
    assert TK.bin_bits_for(TK.BIN_KEYS + 1, 31) == 1
    assert TK.bin_bits_for(1 << 30, 31) == TK.MAX_BIN_BITS
    assert TK.bin_bits_for(1 << 30, 5) == 5
    for bad in (dict(tile_slots=48), dict(tile_slots=16),
                dict(tile_slots=8192), dict(merge_tile=0),
                dict(merge_tile=4097), dict(bin_cap=0),
                dict(bin_cap=TK.BIN_CAP + 1), dict(bin_bits=13)):
        with pytest.raises(ValueError):
            TK.update_plan(spec, 100, "add", **bad)
    with pytest.raises(ValueError):
        TK.update_plan(spec, 100, "decay")
