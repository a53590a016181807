"""The warp-cooperative launch geometry of the blocked-filter kernels, on
the CPU.

``sbf.launch_geometry`` resolves a (Θ, Φ) layout and a depth into what the
CUDA kernels of ``csrc/bloom.cu`` run: Θ lanes a key, s/Θ words a lane, Φ
words a load, the keys a group keeps in flight, the keys a CTA and the
grid. These tests hold the helper to the kernels' invariants (a group's
lanes cover each block word exactly once in aligned loads of at most 16
bytes, a group never straddles a warp, at most 64 words in flight a lane,
the grid covers the keys), ``card_layout`` to its rule, and the
``ValueError`` of a layout or depth the kernels do not take.

On CPU tensors the wrappers run their plain versions, so the last tests
hold the port's ``ops.bloom_add`` / ``bloom_contains`` at every accepted
layout (and at none) against the JAX package for the four blocked
variants: words as u32 and results as bool, exactly. The JAX side runs
``repro.kernels.ops`` with ``probe="gather"`` in the VMEM regime and
``repro.kernels.ref``: with jax 0.9 the ``probe="loop"`` and HBM Pallas
kernels do not trace, and no schedule changes a result. The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro.core import variants as JV
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.api.filter import as_keys
from repro_torch.core import variants as TV
from repro_torch.kernels import ops, sbf

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

M = 1 << 16
SPEC_ARGS = [("sbf", 1, 2, 32), ("sbf", 2, 2, 64), ("sbf", 4, 3, 128),
             ("sbf", 8, 8, 256), ("sbf", 16, 16, 512),
             ("sbf", 32, 32, 1024), ("bbf", 8, 8, 256), ("rbbf", 1, 4, 32),
             ("csbf", 16, 8, 512), ("csbf", 32, 16, 1024)]
SPECS = {f"{v}-s{s}-k{k}": TV.FilterSpec(v, M, k, block_bits=b,
                                         z=(2 if v == "csbf" else 1))
         for v, s, k, b in SPEC_ARGS}
THETAS = (1, 2, 4, 8, 16, 32, 64)
PHIS = (1, 2, 4, 8, 16, 32)


def _geometries(spec):
    for theta in THETAS:
        for phi in PHIS:
            for depth in sbf.DMA_DEPTHS:
                yield sbf.launch_geometry(spec, "contains",
                                          sbf.Layout(theta, phi), depth)
        yield sbf.launch_geometry(spec, "add", sbf.Layout(theta, 1))


@pytest.mark.parametrize("name", SPECS)
def test_lanes_cover_each_block_word_once(name):
    spec = SPECS[name]
    for geo in _geometries(spec):
        assert geo.theta <= spec.s and geo.theta * geo.words == spec.s
        for lane in range(sbf.WARP):
            group = geo.group(lane)
            covered = sorted(w + t for member in group
                             for w in geo.loads(member)
                             for t in range(geo.vec))
            assert covered == list(range(spec.s)), (geo, lane)


@pytest.mark.parametrize("name", SPECS)
def test_loads_are_aligned_vectors(name):
    spec = SPECS[name]
    for geo in _geometries(spec):
        assert geo.vec in (1, 2, 4) and geo.words % geo.vec == 0
        for lane in range(sbf.WARP):
            for first in geo.loads(lane):
                # a block starts at a multiple of s words; the wrappers
                # require the words 16-byte aligned
                assert (first * 4) % (geo.vec * 4) == 0
                assert spec.s % geo.vec == 0


@pytest.mark.parametrize("name", SPECS)
def test_groups_never_straddle_a_warp(name):
    spec = SPECS[name]
    for geo in _geometries(spec):
        assert sbf.WARP % geo.theta == 0
        for lane in range(2 * sbf.WARP):
            group = geo.group(lane)
            assert lane in group and len(group) == geo.theta
            assert len({m // sbf.WARP for m in group}) == 1


@pytest.mark.parametrize("name", SPECS)
def test_words_in_flight_cap(name):
    spec = SPECS[name]
    for theta in THETAS:
        for depth in sbf.DMA_DEPTHS:
            geo = sbf.launch_geometry(spec, "contains", sbf.Layout(theta, 1),
                                      depth)
            assert geo.words_in_flight <= sbf.MAX_WORDS_IN_FLIGHT
            assert geo.depth <= depth and geo.depth in sbf.DMA_DEPTHS
            # the cap binds only where a lane's words would exceed it
            assert geo.depth == depth or \
                2 * geo.depth * geo.words > sbf.MAX_WORDS_IN_FLIGHT
            if geo.depth > 1:          # deeper schedules load the widest
                assert geo.vec == min(geo.words, sbf.MAX_VEC)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 255, 256, 257, 65537])
@pytest.mark.parametrize("depth", sbf.DMA_DEPTHS)
def test_grid_covers_the_keys(n, depth):
    spec = SPECS["sbf-s8-k8"]
    for theta in (1, 2, 4, 8):
        geo = sbf.launch_geometry(spec, "contains", sbf.Layout(theta, 4),
                                  depth)
        assert geo.keys_per_cta == sbf.THREADS * max(1, geo.depth // theta)
        assert geo.grid(n) * geo.keys_per_cta >= n
        assert n == 0 or (geo.grid(n) - 1) * geo.keys_per_cta < n


@pytest.mark.parametrize("name", SPECS)
def test_card_layout_rule(name):
    spec = SPECS[name]
    add = sbf.launch_geometry(spec, "add", sbf.card_layout(spec, "add"))
    con = sbf.launch_geometry(spec, "contains",
                              sbf.card_layout(spec, "contains"))
    if spec.variant == "csbf":
        assert (add.theta, con.theta) == (1, 1)
    elif spec.variant == "bbf":
        assert (add.theta, con.theta) == (min(spec.s, 8), 1)
    else:
        assert (add.theta, add.words) == (spec.s, 1)
        assert con.theta == max(1, spec.s // 4)
    assert con.vec == min(con.words, 4)
    with pytest.raises(ValueError):
        sbf.card_layout(spec, "remove")


@pytest.mark.parametrize("kw", [
    dict(layout=sbf.Layout(3, 4)), dict(layout=sbf.Layout(0, 4)),
    dict(layout=sbf.Layout(12, 1)), dict(layout=sbf.Layout(-2, 1)),
    dict(layout=sbf.Layout(2, 3)), dict(layout=sbf.Layout(2, 0)),
    dict(depth=3), dict(depth=16), dict(op="add", depth=2),
    dict(op="remove"), dict(spec=TV.FilterSpec("sbf", M, 8,
                                               block_bits=2048))])
def test_geometry_refuses_what_the_kernels_do_not_take(kw):
    spec = kw.pop("spec", SPECS["sbf-s8-k8"])
    args = dict(op="contains", layout=sbf.Layout(2, 4), depth=1)
    args.update(kw)
    with pytest.raises(ValueError):
        sbf.launch_geometry(spec, args["op"], args["layout"], args["depth"])


# ---------------------------------------------------------------------------
# Every accepted layout against the JAX package (the plain path on the CPU)
# ---------------------------------------------------------------------------

PARITY = [("sbf", 8, 256, 1), ("bbf", 8, 256, 1), ("rbbf", 4, 32, 1),
          ("csbf", 8, 512, 2)]
N = 1000


@functools.lru_cache(maxsize=None)
def _jax(args):
    """The JAX package's words and results: the VMEM gather kernels
    (interpret mode), checked against its ``ref``."""
    v, k, b, z = args
    js = JV.FilterSpec(v, M, k, block_bits=b, z=z)
    keys = jnp.asarray(JH.random_u64x2(N, seed=k))
    queries = jnp.asarray(np.concatenate([JH.random_u64x2(N, seed=k),
                                          JH.probe_u64x2(N, seed=k + 1)]))
    kw = dict(regime="vmem", probe="gather", coop="none", mix="full")
    words = JO.bloom_add(js, JV.init(js), keys, **kw)
    hits = JO.bloom_contains(js, words, queries, **kw)
    np.testing.assert_array_equal(
        np.asarray(words), np.asarray(JR.bloom_add_ref(js, JV.init(js),
                                                       keys)))
    np.testing.assert_array_equal(
        np.asarray(hits), np.asarray(JR.bloom_contains_ref(js, words,
                                                           queries)))
    return (np.asarray(words), np.asarray(hits), np.asarray(keys),
            np.asarray(queries))


def _layouts(spec):
    yield None
    for theta in THETAS:
        for phi in PHIS:
            try:
                yield sbf.Layout(theta, phi).validate(spec, 256)
            except ValueError:
                continue


@pytest.mark.parametrize("args", PARITY, ids=[a[0] for a in PARITY])
@pytest.mark.parametrize("regime", ["vmem", "hbm"])
def test_every_accepted_layout_matches_jax(args, regime):
    v, k, b, z = args
    ts = TV.FilterSpec(v, M, k, block_bits=b, z=z)
    want_words, want_hits, keys, queries = _jax(args)
    keys, queries = as_keys(keys), as_keys(queries)
    seen = 0
    for layout in _layouts(ts):
        words = ops.bloom_add(ts, TV.init(ts), keys, layout=layout,
                              regime=regime)
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      want_words)
        hits = ops.bloom_contains(ts, words, queries, layout=layout,
                                  regime=regime)
        np.testing.assert_array_equal(hits.numpy(), want_hits)
        seen += 1
    assert seen > 1


@pytest.mark.parametrize("args", PARITY, ids=[a[0] for a in PARITY])
def test_bank_layouts_match_plain_members(args):
    """The bank dispatch at every accepted layout gives each member the
    words and results of the JAX package's single filter."""
    v, k, b, z = args
    ts = TV.FilterSpec(v, M, k, block_bits=b, z=z)
    want_words, want_hits, keys, queries = _jax(args)
    keys, queries = as_keys(keys), as_keys(queries)
    B = 3
    bank = TV.init(ts).repeat(B, 1)
    member = torch.arange(B * N, dtype=torch.int32) // N
    flat = torch.cat([keys] * B)
    for layout in _layouts(ts):
        words = ops.bloom_bank_add(ts, bank, flat, member, layout=layout)
        for m in range(B):
            np.testing.assert_array_equal(words[m].numpy().view(np.uint32),
                                          want_words)
        for m in range(B):
            hits = ops.bloom_bank_contains(
                ts, words, queries, torch.full((2 * N,), m,
                                               dtype=torch.int32),
                layout=layout)
            np.testing.assert_array_equal(hits.numpy(), want_hits)
