"""The windowed ring contains' binned path, in its CPU model, against the
JAX package, and the rule, plan and workspace cap that drive both paths.

``ring.contains_binned_model`` is the binned kernels' stages in plain
PyTorch: keys counted by (bin of block rows, chunk), runs padded to
32-byte sectors of two 16-byte slots, each touched bin's rows ORed over
the G generations, each slot's mask tested against its row. It is held
against ``repro.kernels.ring.ring_contains_ref`` (the jnp oracle of both
Pallas ring kernels) on rings built from seeded numpy keys, at G = 1, 2, 4
and 9 and s of 1, 8 and 32 words, over several bin sizes and internal
batches, with repeated keys and n of 0, 1 and 2; results compared exactly.
``choose_contains_path`` is a pure function; ``contains_plan``,
``cap_for_memory`` and the wrapper's plan on the card (driven here with
the card's queries stubbed) bound the workspace. The CUDA kernels are
held against the plain version on the card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro.kernels import ring as JR
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import ring

SMEM = 231296                  # the H100's shared memory a CTA, less salts
SPECS = {1: ("rbbf", 1 << 12, dict(k=4)),
         8: ("sbf", 1 << 14, dict(k=8, block_bits=256)),
         32: ("sbf", 1 << 15, dict(k=16, block_bits=1024))}


def _specs(s):
    variant, m, kw = SPECS[s]
    return JV.FilterSpec(variant, m, **kw), TV.FilterSpec(variant, m, **kw)


def _ring(ts, G):
    return torch.stack([TV.add_rows(ts, TV.init(ts), as_keys(
        JH.random_u64x2(40, seed=300 + g))) for g in range(G)])


def _queries():
    inserted = np.concatenate([JH.random_u64x2(40, seed=300 + g)
                               for g in range(3)])
    probes = JH.probe_u64x2(150, seed=7)
    # repeated keys: a member and a probe several times over
    return np.concatenate([inserted, probes, inserted[:5].repeat(4, 0),
                           probes[:3].repeat(3, 0)])


@pytest.mark.parametrize("s", sorted(SPECS))
@pytest.mark.parametrize("G", [1, 2, 4, 9])
def test_binned_model_matches_jax(s, G):
    js, ts = _specs(s)
    rings = _ring(ts, G)
    q = _queries()
    want = np.asarray(JR.ring_contains_ref(
        js, jnp.asarray(rings.numpy().view(np.uint32)), jnp.asarray(q)))
    assert want[:min(G, 3) * 40].all()
    n_blocks = ts.n_blocks
    for bin_row_bits, cap, chunks in ((ring.BIN_WORD_BITS - 3, 1 << 24, 132),
                                      (2, 97, 3), (0, 1000, 7),
                                      (5, 1, 2)):
        if (n_blocks.bit_length() - 1) - bin_row_bits > ring.LOG2_MAX_BINS:
            continue
        got, plan = ring.contains_binned_model(ts, rings, as_keys(q),
                                               bin_row_bits, cap, chunks)
        np.testing.assert_array_equal(got.numpy(), want)
        assert plan["path"] == "binned"
        assert plan["batches"] == -(-len(q) // cap)
        assert plan["n_bins"] * (1 << plan["bin_row_bits"]) == n_blocks
    for n in (0, 1, 2):
        got, plan = ring.contains_binned_model(ts, rings, as_keys(q[:n]),
                                               1, 1, 2)
        np.testing.assert_array_equal(got.numpy(), want[:n])
        assert plan["batches"] == n
    # the plain version of both wrappers on the CPU
    np.testing.assert_array_equal(
        ring.ring_contains_hbm(ts, rings, as_keys(q), depth=8).numpy(), want)


def test_choose_contains_path_is_a_pure_rule():
    words = 1 << 25                               # 128 MiB a generation
    # small calls stay one-pass, at any ring size
    for G in (2, 4, 8):
        for log2n in (0, 10, 16):
            assert ring.choose_contains_path(1 << log2n, words, G, 8,
                                             SMEM, False) == "one-pass"
    # the L2 wrapper stays one-pass at any batch and ring, and so does a
    # ring of 2 or 3 generations
    for G, w in ((4, 1 << 21), (8, 1 << 20), (4, words), (8, words)):
        assert ring.choose_contains_path(1 << 26, w, G, 8, SMEM,
                                         True) == "one-pass"
    for G in (2, 3):
        assert ring.choose_contains_path(1 << 26, words, G, 8, SMEM,
                                         False) == "one-pass"
    # rows of another width than the swept one stay one-pass
    for s in (1, 2, 4, 16, 32):
        assert s != ring.SWEPT_ROW_WORDS
        assert ring.choose_contains_path(1 << 26, words, 8, s, SMEM,
                                         False) == "one-pass"
    # the DRAM cell's batches (2^26 live keys, 2^24 retired) are binned
    assert ring.choose_contains_path(1 << 26, words, 4, 8, SMEM,
                                     False) == "binned"
    assert ring.choose_contains_path(1 << 24, words, 4, 8, SMEM,
                                     False) == "binned"
    assert ring.choose_contains_path(1 << 22, words, 4, 8, SMEM,
                                     False) == "one-pass"
    # the swept thresholds, and the rows a size between them takes
    assert ring.binned_min_keys(1 << 22, 8) == 1 << 20          # 128 MiB
    assert ring.binned_min_keys(1 << 24, 8) == 1 << 22          # 512 MiB
    assert ring.binned_min_keys(1 << 23, 8) == 1 << 22          # 256 MiB
    assert ring.binned_min_keys(1 << 25, 9) == 1 << 22          # 1.1 GiB
    assert ring.binned_min_keys(1 << 23, 6) == 1 << 24
    assert ring.binned_min_keys(words, 3) is None
    # monotone in n, and more generations never make binned later
    last = None
    for G in range(4, 10):
        paths = [ring.choose_contains_path(1 << e, 1 << 24, G, 8, SMEM,
                                           False) for e in range(8, 27)]
        first = paths.index("binned")
        assert set(paths[first:]) == {"binned"}
        assert last is None or first <= last
        last = first
    # no bin fits: one-pass
    assert ring.choose_contains_path(1 << 26, words, 4, 8, 16,
                                     False) == "one-pass"


def test_contains_geometry_takes_card_layouts_theta():
    _, ts = _specs(8)
    geo = ring.contains_geometry(ts)
    assert (geo.theta, geo.vec, geo.depth) == (2, 4, 1)     # card_layout
    assert ring.contains_geometry(ts, theta=1).vec == 4
    assert ring.contains_geometry(ts, theta=32).theta == 8   # clamped to s
    _, one = _specs(1)
    assert ring.contains_geometry(one).vec == 1
    _, big = _specs(32)                         # csbf-like Θ = 1 at s = 32
    assert ring.contains_geometry(big, theta=1).theta == 2
    with pytest.raises(ValueError):
        ring.contains_geometry(ts, theta=3)
    # the JAX package's depths are accepted and validated
    rings = _ring(ts, 2)
    q = as_keys(JH.random_u64x2(8, seed=2))
    for depth in (1, 2, 4, 8):
        ring.ring_contains_hbm(ts, rings, q, depth=depth)
    with pytest.raises(ValueError):
        ring.ring_contains_hbm(ts, rings, q, depth=3)


def test_plan_and_workspace_cap():
    words, G, s, chunks = 1 << 25, 4, 8, 264
    plan = ring.contains_plan(1 << 26, words, G, s, "binned", 11, 1 << 24,
                              chunks)
    n_bins = (words // s) >> 11
    assert plan == {"path": "binned", "bin_row_bits": 11, "n_bins": n_bins,
                    "batches": 4, "batch_keys": 1 << 24, "chunks": chunks,
                    "workspace_bytes": 4 * ((chunks + 2) * n_bins)
                    + 16 * ((1 << 24) + chunks * n_bins)}
    assert ring.contains_plan(5, words, G, s, "one-pass")[
        "workspace_bytes"] == 0
    with pytest.raises(ValueError):
        ring.contains_plan(5, words, G, s, "other")
    with pytest.raises(ValueError):
        ring.contains_plan(5, words, G, s, "binned", 0)      # 2^22 bins
    # the cap halves until the workspace fits the free memory
    free = ring.WORKSPACE_MARGIN + plan["workspace_bytes"] // 3
    cap = ring.cap_for_memory(1 << 26, words, G, s, 11, 1 << 24, chunks,
                              free)
    assert cap in (1 << 22, 1 << 21)
    assert ring.contains_plan(1 << 26, words, G, s, "binned", 11, cap,
                              chunks)["workspace_bytes"] <= free - (
                                  ring.WORKSPACE_MARGIN)
    with pytest.raises(MemoryError):
        ring.cap_for_memory(1 << 26, words, G, s, 11, 1 << 24, chunks,
                            ring.WORKSPACE_MARGIN)


def test_card_plan_halves_the_cap_then_raises(monkeypatch):
    """The wrapper's plan on the card, with the card's queries stubbed: a
    workspace that does not allocate drops the cap to what the free memory
    holds; where none allocates, MemoryError."""
    _, ts = _specs(8)
    big = TV.FilterSpec("sbf", 1 << 30, 8, block_bits=256)
    monkeypatch.setattr(ring.sbf, "partition_smem_bytes", lambda d: SMEM)
    monkeypatch.setattr(ring, "binned_chunks", lambda spec, b, d: 264)
    limit = {"bytes": 80 << 20}

    def workspace(nbytes, device):
        if nbytes > limit["bytes"]:
            raise torch.cuda.OutOfMemoryError("stub")
        return torch.empty(nbytes // 4, dtype=torch.int32)

    monkeypatch.setattr(ring, "_workspace", workspace)
    monkeypatch.setattr(ring, "free_device_bytes",
                        lambda device: limit["bytes"]
                        + ring.WORKSPACE_MARGIN)
    plan, cap, work = ring._card_plan(big, 4, 1 << 26, "cpu", False, None,
                                      None, ring.CONTAINS_KEY_CAP)
    assert plan["path"] == "binned" and cap < ring.CONTAINS_KEY_CAP
    assert plan["workspace_bytes"] <= limit["bytes"]
    assert work.numel() * 4 == plan["workspace_bytes"]
    assert plan["batches"] == -(-(1 << 26) // cap)
    plan, _, work = ring._card_plan(big, 4, 1000, "cpu", False, None,
                                    None, ring.CONTAINS_KEY_CAP)
    assert plan["path"] == "one-pass" and work is None
    plan, _, work = ring._card_plan(big, 4, 1 << 26, "cpu", True, None,
                                    None, ring.CONTAINS_KEY_CAP)
    assert plan["path"] == "one-pass" and work is None
    limit["bytes"] = 0
    with pytest.raises(MemoryError):
        ring._card_plan(big, 4, 1 << 26, "cpu", False, "binned", None,
                        ring.CONTAINS_KEY_CAP)
    assert ts.n_words < big.n_words
