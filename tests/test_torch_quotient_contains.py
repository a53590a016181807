"""The quotient contains' binned path, in its CPU model, against the JAX
package, and the rule, plan and workspace cap that drive the paths.

``quotientfilter.contains_binned_model`` is the binned kernels' stages in
plain PyTorch: the tile pass (run starts and occupied slots a tile, D, W),
keys counted by (bin of quotients, chunk) into runs of 4 eight-byte slots,
and each touched bin's runs found by rank from its first slot. It is held
against ``repro.core.quotient.quotient_contains`` and
``quotient_contains_coop`` (results exact) on tables built from seeded
numpy keys: u8, u16 and u32 lanes; loads 0, 0.5, 0.9 and 0.95 and a table
with one empty slot; clusters that wrap past the last slot; bins of one
quotient and of the whole table; windows lowered to 4 words, so that runs
cross bin edges and scans and compares read past the window; several
internal batches and chunks; batches of 0, 1 and 2 keys.
``choose_contains_path`` is a pure function; ``table_load`` keeps a load
until the table changes; ``contains_plan``,
``cap_for_memory`` and the wrapper's plan on the card (driven here with the
card's queries stubbed) bound the workspace. The CUDA kernels are held
against the plain version on the card by ``tests/test_torch_gpu.py``.
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

SMEM = 231296                  # the H100's shared memory a CTA, less salts
# (slot_bits, r_bits, q_bits)
GEOMETRIES = [(8, 5, 10), (16, 9, 9), (32, 20, 8)]
IDS = [f"u{sb}-r{r}-q{q}" for sb, r, q in GEOMETRIES]
N_QUERIES = 640                # one JAX compile a geometry
J_CONTAINS = jax.jit(JQ.quotient_contains, static_argnums=0)
J_COOP = jax.jit(JQ.quotient_contains_coop, static_argnums=0)


def _specs(slot_bits, r_bits, q_bits):
    kw = dict(m_bits=(1 << q_bits) * slot_bits, k=1, slot_bits=slot_bits,
              r_bits=r_bits)
    return JV.FilterSpec("quotient", **kw), TV.FilterSpec("quotient", **kw)


def _wrapping(ts, n, seed):
    """n keys homed in the top eighth of the slots: clusters run past the
    last slot into slot 0."""
    cand = JH.random_u64x2(ts.n_slots * 16, seed=seed)
    q = TQ.split_fp(ts, TQ.quotient_hashes(ts, as_keys(cand)))[0].numpy()
    return cand[q >= ts.n_slots * 7 // 8][:n]


def _tables(ts, seed):
    """(label, keys stored, table) at loads 0, 0.5, 0.9 and 0.95, one empty
    slot, and a wrapping cluster."""
    out = []
    for label, load in (("load 0", 0.0), ("load 0.5", 0.5),
                        ("load 0.9", 0.9), ("load 0.95", 0.95),
                        ("one empty slot", None)):
        n = ts.n_slots - 1 if load is None else int(ts.n_slots * load)
        keys = JH.random_u64x2(max(n, 1), seed=seed)[:n]
        table, ok = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys))
        assert bool(ok.all())
        out.append((label, keys, table))
    keys = _wrapping(ts, ts.n_slots // 4, seed + 1)
    table, _ = TQ.quotient_add(ts, TQ.init(ts), as_keys(keys))
    lanes = TQ.unpack_slots(ts, table)
    assert int(lanes[0]) >> (ts.slot_bits - 3) & 1      # slot 0 is shifted
    out.append(("wrapping", keys, table))
    return out


def _queries(stored, seed):
    """N_QUERIES keys: stored ones (members), probes, a member repeated."""
    probes = JH.probe_u64x2(N_QUERIES, seed=seed)
    m = min(len(stored), N_QUERIES // 2)
    q = np.concatenate([stored[:m], stored[:1].repeat(3 * (m > 0), 0),
                        probes])
    return q[:N_QUERIES]


def _u32(t):
    return jnp.asarray(t.numpy().view(np.uint32))


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_binned_model_matches_jax(geom):
    js, ts = _specs(*geom)
    q_bits = geom[2]
    knobs = [dict(),                                   # the card's defaults
             dict(bin_bits=0, window=4, cap=97, chunks=3),  # a quotient a bin
             dict(bin_bits=3, window=4, cap=1000, chunks=7),
             dict(bin_bits=q_bits, chunks=2)]          # one bin, whole table
    spills = 0
    for i, (label, stored, table) in enumerate(_tables(ts, 40 + q_bits)):
        q = _queries(stored, 500 + i)
        want = np.asarray(J_CONTAINS(js, _u32(table), jnp.asarray(q)))
        np.testing.assert_array_equal(
            np.asarray(J_COOP(js, _u32(table), jnp.asarray(q))), want)
        m = min(len(stored), N_QUERIES // 2)
        assert want[:m].all(), label                   # no false negative
        np.testing.assert_array_equal(
            TK.contains_plain(ts, table, as_keys(q)).numpy(), want)
        for kw in knobs[:2] if i % 2 else knobs:
            got, plan, stats = TK.contains_binned_model(ts, table,
                                                        as_keys(q), **kw)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{label} {kw}")
            assert plan["path"] == "binned"
            assert plan["n_bins"] << plan["bin_bits"] == ts.n_slots
            assert plan["batches"] == -(-len(q) // kw.get(
                "cap", TK.CONTAINS_KEY_CAP))
            if kw.get("window") == 4:
                spills += stats["scan_spills"] + stats["compare_spills"]
    assert spills > 0                  # lowered windows read past them


def test_binned_model_tiny_batches():
    js, ts = _specs(8, 5, 10)
    _, stored, table = _tables(ts, 50)[2]
    q = _queries(stored, 9)
    want = TK.contains_plain(ts, table, as_keys(q)).numpy()
    for n in (0, 1, 2):
        got, plan, _ = TK.contains_binned_model(ts, table, as_keys(q[:n]),
                                                bin_bits=2, cap=1, chunks=2)
        np.testing.assert_array_equal(got.numpy(), want[:n])
        assert plan["batches"] == n


def test_choose_contains_path_is_a_pure_rule():
    # the sweep's grid (8-bit slots, q23 ... q27, 2^16 ... 2^26 keys): at
    # load 0.5 the walk everywhere; at load 0.9 binned from the smallest
    # batch on q23 and q24, from 2^20 keys on q25 and q26, from 2^22 on q27
    binned_from = {23: 16, 24: 16, 25: 20, 26: 20, 27: 22}
    for q, lo in binned_from.items():
        for log2n in range(16, 27, 2):
            n = 1 << log2n
            assert TK.choose_contains_path(n, q, 8, SMEM, 0.5) == "walk"
            assert TK.choose_contains_path(n, q, 8, SMEM, 0.9) == (
                "binned" if log2n >= lo else "walk"), (q, log2n)
    # the cells at load 0.9, every key and 2^22 probes: binned
    for q, n in ((23, int(0.9 * (1 << 23))), (26, int(0.9 * (1 << 26))),
                 (26, 1 << 22)):
        assert TK.choose_contains_path(n, q, 8, SMEM, 0.9) == "binned"
    # no load, a small batch, a card without the shared memory for a bin,
    # and a table of fewer than 4 words: the walk
    assert TK.choose_contains_path(1 << 26, 23, 8, SMEM, None) == "walk"
    assert TK.choose_contains_path(TK.LOAD_MIN_KEYS - 1, 23, 8, SMEM,
                                   0.99) == "walk"
    assert TK.choose_contains_path(1 << 26, 26, 8, 1024, 0.9) == "walk"
    assert TK.choose_contains_path(1 << 20, 3, 8, SMEM, 0.9,
                                   r_bits=2) == "walk"
    # monotone: binned from some batch on at a load, and from some load on
    # at a batch; a full table does not divide by zero
    for q in (10, 23, 26, 29):
        for load in (0.0, 0.5, 0.8, 0.9, 0.95, 1.0):
            paths = [TK.choose_contains_path(1 << log2n, q, 8, SMEM, load)
                     for log2n in range(0, 31)]
            assert paths == sorted(paths, key=("walk", "binned").index)
        for log2n in (16, 20, 26):
            paths = [TK.choose_contains_path(1 << log2n, q, 8, SMEM, x / 20)
                     for x in range(21)]
            assert paths == sorted(paths, key=("walk", "binned").index)
    # contains_mode is the rule for a spec
    ts = _specs(8, 5, 23)[1]
    assert TK.contains_mode(ts, 1 << 20, 0.9) == TK.choose_contains_path(
        1 << 20, 23, 8, 227 * 1024, 0.9, 5) == "binned"


def test_table_load_is_kept_until_the_table_changes(monkeypatch):
    """The load sample runs once a table state: kept on the tensor by its
    version counter, asked again after an in-place write, per tensor."""
    ts = _specs(8, 5, 12)[1]
    calls = []

    def sample(spec, table):
        calls.append(spec)
        return 900, 1000
    monkeypatch.setattr(TK, "_sample_load", sample)
    monkeypatch.setattr(TK, "partition_smem_bytes", lambda dev: SMEM)
    table = TQ.init(ts)
    assert TK.table_load(ts, table) == 0.9 and len(calls) == 1
    assert TK.table_load(ts, table) == 0.9 and len(calls) == 1
    table[0] = 7                                  # an in-place write
    assert TK.table_load(ts, table) == 0.9 and len(calls) == 2
    torch.autograd.graph.increment_version(table)  # as the update wrappers
    TK.table_load(ts, table)
    other = table.clone()
    TK.table_load(ts, other)
    assert len(calls) == 4
    with torch.inference_mode():                 # no version counter
        frozen = TQ.init(ts)
    TK.table_load(ts, frozen)
    TK.table_load(ts, frozen)
    assert len(calls) == 6
    # the rule's first binned batch, kept beside the load
    assert TK._table_rule(ts, table) == (0.9, TK.binned_from(ts, 0.9, SMEM))


def test_binned_from_is_the_rules_boundary():
    for q in (12, 23, 25, 27):
        r = min(5, 31 - q)
        ts = _specs(8, r, q)[1]
        for load in (0.0, 0.5, 0.7, 0.9, 0.95):
            first = TK.binned_from(ts, load, SMEM)
            rule = [TK.choose_contains_path(n, q, 8, SMEM, load, r)
                    for n in (TK.LOAD_MIN_KEYS, 1 << 20, 1 << 30)]
            if first is None:
                assert rule == ["walk"] * 3
                continue
            assert TK.choose_contains_path(first, q, 8, SMEM, load,
                                           r) == "binned"
            if first > TK.LOAD_MIN_KEYS:
                assert TK.choose_contains_path(first - 1, q, 8, SMEM, load,
                                               r) == "walk"
    assert TK.binned_from(_specs(8, 5, 23)[1], 0.5, SMEM) is None
    assert TK.binned_from(_specs(8, 4, 27)[1], 0.9, SMEM) > 1 << 20


def test_contains_plan_and_cap():
    ts = _specs(8, 5, 26)[1]
    walk = TK.contains_plan(ts, 1000, "walk")
    assert walk["workspace_bytes"] == 0 and walk["batches"] == 1
    p = TK.contains_plan(ts, 60_000_000, "binned", chunks=132)
    assert p["bin_bits"] == 14 and p["n_bins"] == 4096
    assert p["tile_slots"] == 1 << 14 and p["table_tiles"] == 4096
    assert p["batches"] == -(-60_000_000 // TK.CONTAINS_KEY_CAP)
    assert p["batch_keys"] == TK.CONTAINS_KEY_CAP
    slots = 8 * (TK.CONTAINS_KEY_CAP + 3 * 132 * 4096)
    assert p["workspace_bytes"] >= slots + 4 * 132 * 4096
    assert p["workspace_bytes"] % 256 == 0
    assert p["test_smem"] == 4 * (p["window_words"] + 2 * 513 + 16384)
    assert p["test_smem"] <= SMEM
    # q23: bins of 2^12 quotients (2048 bins, one scatter pass); q27: 2^15
    # (4096); q28: 2^15 (8192: a bin of 2^16 passes MAX_TEST_SMEM); q29:
    # 2^16, which no card's shared memory holds
    assert TK.contains_bin_bits(23) == 12 and TK.contains_bin_bits(27) == 15
    assert TK.contains_bin_bits(28) == 15 and TK.contains_bin_bits(29) == 16
    assert TK.choose_contains_path(1 << 28, 29, 8, SMEM, 0.9) == "walk"
    assert TK.contains_bin_bits(5) == 5
    for bad in (dict(path="pass"), dict(path="binned", bin_bits=12),
                dict(path="binned", window=6), dict(path="binned", cap=0)):
        with pytest.raises(ValueError):
            TK.contains_plan(ts, 10, **bad)
    # the cap halves until the workspace fits, and a batch's results stay
    ww, bb = p["window_words"], p["bin_bits"]
    room = TK.contains_plan(ts, 1 << 26, "binned", bb, 1 << 22, 132,
                            ww)["workspace_bytes"] + TK.WORKSPACE_MARGIN
    assert TK.cap_for_memory(ts, 1 << 26, bb, 1 << 25, 132, ww,
                             room) == 1 << 22
    with pytest.raises(MemoryError):
        TK.cap_for_memory(ts, 1 << 26, bb, 1 << 25, 132, ww, 1 << 20)


def test_card_plan_halves_the_cap(monkeypatch):
    """The wrapper's plan on the card, with the card's queries stubbed:
    the rule's path at the sampled load, the chunks, and the cap halved
    while the workspace fails to allocate; no sample below LOAD_MIN_KEYS
    keys."""
    ts = _specs(8, 5, 24)[1]
    table = TQ.init(ts)
    loads = []
    monkeypatch.setattr(TK, "binned_chunks", lambda spec, bb, dev: 132)
    monkeypatch.setattr(TK, "partition_smem_bytes", lambda dev: SMEM)
    monkeypatch.setattr(TK, "free_device_bytes", lambda dev: 1 << 31)
    monkeypatch.setattr(TK, "_table_rule", lambda spec, t: loads.append(t)
                        or (0.9, TK.binned_from(spec, 0.9, SMEM)))
    tried = []

    def workspace(nbytes, device):
        tried.append(nbytes)
        if nbytes > 1 << 28:
            raise torch.cuda.OutOfMemoryError("stub")
        return torch.empty((0,), dtype=torch.uint8)
    monkeypatch.setattr(TK, "_contains_workspace", workspace)
    plan, cap, _ = TK._card_contains_plan(ts, table, 1 << 26, "cpu", None,
                                          None, TK.CONTAINS_KEY_CAP, None)
    assert plan["path"] == "binned" and plan["chunks"] == 132
    assert plan["load"] == 0.9 and loads == [table]
    assert cap < TK.CONTAINS_KEY_CAP and tried[-1] <= 1 << 28
    assert plan["batches"] == -(-(1 << 26) // cap)
    plan, _, work = TK._card_contains_plan(ts, table, 1 << 10, "cpu", None,
                                           None, TK.CONTAINS_KEY_CAP, None)
    assert plan["path"] == "walk" and work is None and len(loads) == 1
    plan, _, work = TK._card_contains_plan(ts, table, 1 << 26, "cpu",
                                           "walk", None, TK.CONTAINS_KEY_CAP,
                                           None)
    assert plan["path"] == "walk" and plan["load"] is None
