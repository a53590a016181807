"""The windowed schedule of the port's cuckoo update, modelled on the CPU.

The CUDA update (``kernels/csrc/cuckoo.cu``) applies the sequential order
(tiles of ``tile`` keys, each stably sorted by primary bucket, key by key)
in windows: every key of a window speculates its chain against the
committed table, the window commits up to the first key that read an
earlier key's write or ran past a cap, a capped key that is first
finishes alone, and the window halves after a round with a capped key
(so the keys' overlays grow) and doubles after a round committed whole.
``cuckoofilter.update_windowed`` is the plain model of that schedule,
round for round; here it is held against the port's plain update
(``fingerprint.cuckoo_add`` / ``cuckoo_remove``), words and flags equal
bit for bit (tolerance 0), over every slot geometry the kernels serve,
windows of 1, 2, 7, 32 and 256 keys, a fresh table, load 0.9 and past
capacity (kick failures), 512 copies of one key, keys that share one
bucket pair, valid masks, tiles of 1, 8 and 2048 and a step cap of 1. The
plain update is held against the JAX package by ``test_torch_cuckoo.py``;
one case here compares the model with the JAX reference directly. The
kernel itself, and its counters against the model's, are held on the card
by ``tests/test_torch_gpu.py``.

Sizes stay small (at most 2^12 buckets and 4096 keys) and the model runs
with ``counters=False`` (a round speculates only up to the key that ends
it) except where the counters are the point.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fingerprint as JF
from repro.core import hashing as JH
from repro.core import variants as JV
from repro_torch.api.filter import as_keys
from repro_torch.core import fingerprint as TF
from repro_torch.core import variants as TV
from repro_torch.kernels import cuckoofilter as TK

# (slot bits, slots a bucket), each with 512 slots
GEOMS = list(TK.INSTANCES)
GEOM_IDS = [f"u{sb}x{spb}" for sb, spb in GEOMS]
WINDOWS = (1, 2, 7, 32, 256)


def _spec(slot_bits, spb, n_buckets):
    return TV.FilterSpec("cuckoo", n_buckets * spb * slot_bits, 2,
                         slot_bits=slot_bits, slots_per_bucket=spb)


def _keys(n, seed):
    return as_keys(JH.random_u64x2(n, seed=seed))


def _valid(n, seed, invalid=0.25):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(n) > invalid).astype(np.uint8))


def _check(spec, table, keys, valid, op, tile, **kw):
    """The model against the plain update: equal words and flags; returns
    the new table, flags and the model's counters."""
    plain = TF.cuckoo_add if op == "add" else TF.cuckoo_remove
    want, flags = plain(spec, table, keys, valid=valid, tile=tile)
    kw.setdefault("counters", False)
    got, got_flags, st = TK.update_windowed(spec, table, keys, valid, op,
                                            tile, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got_flags.numpy(), flags.numpy())
    assert st["rounds"] >= -(-keys.shape[0] // kw.get("window", TK.WINDOW))
    return got, flags, st


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_model_matches_plain_update(geom, window):
    """Fresh to load 0.5, on to 0.9 (masked), past capacity (kick
    failures), then removes of half the keys and of absent ones, in
    256-key tiles."""
    sb, spb = geom
    spec = _spec(sb, spb, 512 // spb)
    keys = _keys(int(spec.n_slots * 1.2), seed=sb * 31 + spb)
    keys = torch.cat([keys, keys[:40]])               # duplicates
    cut = (int(spec.n_slots * 0.5), int(spec.n_slots * 0.9))
    table = TF.init(spec)
    fails = 0
    for part, valid in ((keys[:cut[0]], None),
                        (keys[cut[0]:cut[1]], _valid(cut[1] - cut[0], sb)),
                        (keys[cut[1]:], None)):
        table, ok, _ = _check(spec, table, part, valid, "add", 256,
                              window=window)
        fails += int((~ok).sum())
    assert fails > 0                                  # past capacity
    gone = torch.cat([keys[: keys.shape[0] // 2],
                      as_keys(JH.probe_u64x2(64, seed=77))])
    _, found, _ = _check(spec, table, gone, None, "remove", 256,
                         window=window)
    assert not bool(found.all())


@pytest.mark.parametrize("window", (1, 32, 1024))
def test_copies_of_one_key(window):
    """512 copies of one key among others: each copy reads the bucket the
    copy before it wrote, so the copies commit one a round."""
    spec = _spec(16, 4, 1 << 10)
    keys = _keys(1024, seed=3)
    keys = torch.cat([keys[:256], keys[5:6].expand(512, 2), keys[256:]])
    keys = keys.contiguous()
    table, ok, st = _check(spec, TF.init(spec), keys, None, "add", 2048,
                           window=window)
    assert int((~ok).sum()) > 0                       # 8 slots, 512 copies
    assert st["rounds"] >= 500
    _check(spec, table, keys[200:600], None, "remove", 2048, window=window)


def _pair_keys(spec, n, seed):
    """n keys whose primary and alternate buckets are one pair {x, y}."""
    keys = _keys(1 << 15, seed)
    b1, fp, _ = TF.cuckoo_hashes(spec, keys)
    alt = TF.alt_bucket(spec, b1, fp)
    i = int(torch.nonzero(b1 != alt)[0])
    x, y = int(b1[i]), int(alt[i])
    pick = ((b1 == x) & (alt == y)) | ((b1 == y) & (alt == x))
    out = keys[pick][:n]
    assert out.shape[0] == n
    return out.contiguous()


@pytest.mark.parametrize("window", (1, 7, 256))
def test_keys_in_one_bucket_pair(window):
    """Keys that all map to one bucket pair fill its 8 slots, then every
    insert kicks round the pair until its chain runs out."""
    spec = _spec(8, 4, 16)
    keys = _pair_keys(spec, 40, seed=11)
    table, ok, _ = _check(spec, TF.init(spec), keys, None, "add", 16,
                          window=window)
    assert int(ok.sum()) == 8 and int(TF.occupied_slots(spec, table)) == 8
    _check(spec, table, keys, None, "remove", 16, window=window)


@pytest.mark.parametrize("tile", (1, 8, 2048))
def test_tiles_over_a_multi_tile_batch(tile):
    spec = _spec(16, 4, 1 << 10)
    keys = _keys(int(spec.n_slots * 0.9), seed=tile)
    valid = _valid(keys.shape[0], tile)
    table, _, _ = _check(spec, TF.init(spec), keys, valid, "add", tile,
                         window=32)
    _check(spec, table, keys[::2], valid[::2], "remove", tile, window=32)


def test_masks_all_invalid_and_mixed():
    spec = _spec(8, 8, 1 << 7)
    keys = _keys(900, seed=21)
    none = torch.zeros(900, dtype=torch.uint8)
    table, ok, st = _check(spec, TF.init(spec), keys, none, "add", 8,
                           window=7)
    assert not table.any() and bool(ok.all())
    assert st["conflict_rounds"] == st["capped_rounds"] == 0
    _check(spec, TF.init(spec), keys, _valid(900, 2, invalid=0.6), "add",
           8, window=7)


@pytest.mark.parametrize("window", (32, 256))
def test_step_cap_of_one_forces_the_alone_path(window):
    """With one read a round a key that misses its primary bucket is
    capped; it finishes alone once the keys before it are committed, and
    the window goes on past it."""
    spec = _spec(16, 2, 1 << 9)
    keys = _keys(int(spec.n_slots * 0.95), seed=window)
    table, _, st = _check(spec, TF.init(spec), keys, None, "add", 2048,
                          window=window, step_cap=1)
    assert st["alone_keys"] > st["rounds"]
    _, _, st = _check(spec, table, keys[::3], None, "remove", 2048,
                      window=window, step_cap=1)
    assert st["alone_keys"] > 0


def test_counters():
    """The counters with every key speculated equal the lazy model's where
    both have them, and add up: one round a key at W = 1."""
    spec = _spec(16, 4, 1 << 8)
    keys = _keys(int(spec.n_slots * 0.95), seed=31)
    for window, cap in ((1, 16), (32, 16), (256, 2)):
        _, _, full = _check(spec, TF.init(spec), keys, None, "add", 512,
                            window=window, step_cap=cap, counters=True)
        _, _, lazy = _check(spec, TF.init(spec), keys, None, "add", 512,
                            window=window, step_cap=cap)
        assert {k: full[k] for k in lazy} == lazy
        assert full["min_committed"] >= 1
        assert full["max_committed"] <= window + 1
        assert full["chain_reads"] <= full["reads"]
        assert full["mean_committed"] == keys.shape[0] / full["rounds"]
        if window == 1:
            assert full["rounds"] == keys.shape[0]
            assert full["conflict_rounds"] == full["capped_rounds"] == 0
            assert full["chain_reads"] == full["reads"]


def test_model_matches_the_jax_reference():
    """One case straight against ``repro.core.fingerprint``: tiles of 128
    keys, masked, past capacity, then a remove."""
    kw = dict(m_bits=(1 << 6) * 4 * 8, k=2, slot_bits=8, slots_per_bucket=4)
    js, ts = JV.FilterSpec("cuckoo", **kw), TV.FilterSpec("cuckoo", **kw)
    keys = JH.random_u64x2(384, seed=41)
    valid = (np.random.RandomState(41).rand(384) > 0.2).astype(np.uint8)
    jt, jok = JF.cuckoo_add(js, JF.init(js), jnp.asarray(keys),
                            valid=jnp.asarray(valid), tile=128)
    tt, tok, _ = TK.update_windowed(ts, TF.init(ts), as_keys(keys),
                                    torch.from_numpy(valid), "add", 128,
                                    window=32, counters=False)
    np.testing.assert_array_equal(tt.numpy().view(np.uint32),
                                  np.asarray(jt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not bool(tok.all())
    jr, jf = JF.cuckoo_remove(js, jt, jnp.asarray(keys[:256]), tile=128)
    tr, tf, _ = TK.update_windowed(ts, tt, as_keys(keys[:256]), None,
                                   "remove", 128, window=7, step_cap=1,
                                   counters=False)
    np.testing.assert_array_equal(tr.numpy().view(np.uint32),
                                  np.asarray(jr))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_wrapper_schedule_arguments():
    """The wrappers take the schedule as private arguments and check them;
    on CPU tensors they run the plain update whatever the window."""
    spec = _spec(16, 4, 1 << 6)
    keys = _keys(200, seed=51)
    want, ok = TF.cuckoo_add(spec, TF.init(spec), keys, tile=64)
    for kw in ({}, {"window": 1}, {"window": 7, "step_cap": 1}):
        got, got_ok = TK.add_vmem(spec, TF.init(spec), keys, None, 64, **kw)
        assert torch.equal(got, want) and torch.equal(got_ok, ok)
    for bad in ({"window": 0}, {"window": TK.WINDOW + 1}, {"step_cap": 0}):
        with pytest.raises(ValueError):
            TK.remove_vmem(spec, want, keys, None, 64, **bad)
        with pytest.raises(ValueError):
            TK.update_windowed(spec, want, keys, None, "remove", 64, **bad)
    with pytest.raises(ValueError):
        TK.update_windowed(spec, want, keys, None, "add", TK.MAX_TILE + 1)
    assert TK.LAUNCHES == dict.fromkeys(TK.LAUNCHES, 0)   # CPU: none
