"""The port's dense decoder (``repro_torch.models``) against the JAX
package's, on the CPU.

* ``layers`` and ``attention``: each function on the same numpy inputs,
  at f32 within the JAX package's own model tolerance (``TOL``/``RTOL``,
  as ``tests/test_models_consistency.py``), the bf16 casts at
  ``BF16_TOL``.
* ``Model``: ``loss``, ``train``, ``prefill`` and ``decode`` on the same
  weights (the JAX tree carried over by ``interop.params_from_jax``) for
  mistral-nemo-12b, qwen2-72b (qkv bias), nemotron-4-15b (relu2,
  layernorm), internvl2-26b (the vision prefix) and a custom
  ``("attn", "local_attn")`` pattern with a head layer, a tail layer, tied
  embeddings and a ring that wraps; at ``compute_dtype=float32`` within
  ``TOL``/``RTOL`` and at bf16 within ``BF16_TOL`` (absolute: XLA and
  PyTorch may round a bf16 product differently).
* The port's own prefill-then-decode consistency, the families still to
  port raising, ``param_count``, and the weight map's layer order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, smoke_config as jsmoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.model import build_model as jbuild
from repro.models.transformer import lm_forward as jforward
from repro_torch import interop
from repro_torch.configs import get_config as tget, smoke_config as tsmoke
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import lm_forward as tforward

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

TOL, RTOL = 5e-5, 1e-4   # the JAX package's f32 model tolerance
BF16_TOL = 0.0625        # |port - JAX| of a bf16 logit (2^-4: 4 ulps at 2-4)

ARCHS = ["mistral-nemo-12b", "qwen2-72b", "nemotron-4-15b", "internvl2-26b",
         "custom"]
DEFERRED = ["recurrentgemma-2b", "rwkv6-3b", "deepseek-moe-16b",
            "llama4-scout-17b-a16e", "seamless-m4t-medium"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch):
    """(JAX config, port config): the smoke reduction, or the custom
    pattern: head, two groups of (attn, local_attn), tail; window 8."""
    if arch == "custom":
        kw = dict(n_layers=6, n_dense_head=1, block_pattern=("attn",
                  "local_attn"), window=8, tie_embeddings=True)
        return (dataclasses.replace(jsmoke(jget("mistral-nemo-12b")), **kw),
                dataclasses.replace(tsmoke(tget("mistral-nemo-12b")), **kw))
    return jsmoke(jget(arch)), tsmoke(tget(arch))


def random_tree(shapes, seed):
    """Numpy leaves for a JAX shape tree, every leaf distinct: dense
    weights N(0, 1/fan_in), norm scales near 1, biases near 0."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        last = path[-1].key
        if last == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if last in ("bias", "bq", "bk", "bv"):
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = s.shape[-2]
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(arch, seed=0):
    jc, tc = _cfgs(arch)
    jm, tm = jbuild(jc), tbuild(tc)
    tree = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    return (jc, jm, jax.tree.map(jnp.asarray, tree), tc, tm,
            interop.params_from_jax(tree, tc, device="cpu"), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                                   rtol=0)



# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _hold(cases, jin, tin, dtype):
    """Each case (name, JAX fn, port fn) of the inputs ``jin`` / ``tin``:
    the JAX side compiled as one program (op by op, JAX compiles every
    primitive on its own), each output held to ``dtype``'s tolerance."""
    want = jax.jit(lambda d: {n: jf(d) for n, jf, _ in cases})(jin)
    for name, _, tf in cases:
        got = tf(tin)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want[name])):
            assert tuple(g.shape) == w.shape, name
            if dtype == "f32" or w.dtype == jnp.float32:
                assert g.dtype == torch.float32, name
            else:
                assert g.dtype == torch.bfloat16, name
            _close(g, w, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layers_match_jax(dtype):
    rng = np.random.RandomState(0)
    B, S, D, F, V = 2, 6, 32, 48, 40
    jd, td = DTYPES[dtype]
    f32 = dict(
        scale=(1 + 0.1 * rng.randn(D)).astype(np.float32),
        bias=(0.1 * rng.randn(D)).astype(np.float32),
        table=rng.randn(V, D).astype(np.float32) / np.sqrt(D),
        w=rng.randn(D, V).astype(np.float32) / np.sqrt(D),
        logits=rng.randn(B, S, V).astype(np.float32) * 3,
        mask=(rng.rand(B, S) > 0.3).astype(np.float32))
    for kind in ("swiglu", "geglu", "relu2", "gelu"):
        shapes = jax.eval_shape(lambda: JL.mlp_init(jax.random.PRNGKey(0),
                                                    D, F, kind))
        f32[kind] = random_tree(shapes, 1)
    ints = dict(pos=rng.randint(0, 4096, (B, S)).astype(np.int32),
                ids=rng.randint(0, V, (B, S)))
    act = dict(x=rng.randn(B, S, D).astype(np.float32),
               h=rng.randn(B, S, 3, 16).astype(np.float32))
    jin = {**jax.tree.map(jnp.asarray, {**f32, **ints}),
           **{k: jnp.asarray(v).astype(jd) for k, v in act.items()}}
    tin = {**jax.tree.map(torch.from_numpy, {**f32, **ints}),
           **{k: torch.from_numpy(v).to(td) for k, v in act.items()}}
    cases = []
    for kind in ("rmsnorm", "layernorm"):
        cases.append((kind, lambda d, k=kind: JL.make_norm(k)[1](d, d["x"]),
                      lambda d, k=kind: TL.make_norm(k)[1](d, d["x"])))
    # RoPE, in f32 and cast back
    cases.append(("rope",
                  lambda d: JL.apply_rope(d["h"], *JL.rope_table(
                      d["pos"], 16, 1e6)),
                  lambda d: TL.apply_rope(d["h"], *TL.rope_table(
                      d["pos"], 16, 1e6))))
    cases.append(("rope_table", lambda d: JL.rope_table(d["pos"], 16, 1e6),
                  lambda d: TL.rope_table(d["pos"], 16, 1e6)))
    # the four MLP kinds, weights f32 at rest and cast at use
    for kind in ("swiglu", "geglu", "relu2", "gelu"):
        cases.append((kind, lambda d, k=kind: JL.mlp_apply(d[k], d["x"], k),
                      lambda d, k=kind: TL.mlp_apply(d[k], d["x"], k)))
    # embedding, untied and tied logits
    cases += [
        ("embed", lambda d: JL.embed_lookup(d, d["ids"], jd),
         lambda d: TL.embed_lookup(d, d["ids"], td)),
        ("untied", lambda d: JL.logits_from(d, d["x"]),
         lambda d: TL.logits_from(d, d["x"])),
        ("tied", lambda d: JL.logits_from(None, d["x"], d),
         lambda d: TL.logits_from(None, d["x"], d))]
    # cross entropy in f32, with a mask and label smoothing
    for m in (None, "mask"):
        for ls in (0.0, 0.1):
            cases.append((f"xent-{m}-{ls}",
                          lambda d, m=m, ls=ls: JL.cross_entropy(
                              d["logits"], d["ids"], m and d[m],
                              label_smoothing=ls),
                          lambda d, m=m, ls=ls: TL.cross_entropy(
                              d["logits"], d["ids"], m and d[m],
                              label_smoothing=ls)))
    _hold(cases, jin, tin, dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_matches_jax(dtype):
    rng = np.random.RandomState(2)
    B, S, H, KV, hd, D = 2, 16, 4, 2, 8, 24
    jd, td = DTYPES[dtype]
    # projections with the qkv bias
    shapes = jax.eval_shape(lambda: JA.attn_init(
        jax.random.PRNGKey(0), D, H, KV, hd, qkv_bias=True))
    proj = random_tree(shapes, 3)
    act = dict(x=rng.randn(B, S, D).astype(np.float32),
               q=rng.randn(B, S, H, hd).astype(np.float32),
               k=rng.randn(B, S, KV, hd).astype(np.float32),
               v=rng.randn(B, S, KV, hd).astype(np.float32))
    rpos = np.array([12, 7, 8, -1, 10, 11], np.int32)
    jin = dict(proj=jax.tree.map(jnp.asarray, proj), rpos=jnp.asarray(rpos),
               **{k: jnp.asarray(v).astype(jd) for k, v in act.items()})
    tin = dict(proj=jax.tree.map(torch.from_numpy, proj),
               rpos=torch.from_numpy(rpos),
               **{k: torch.from_numpy(v).to(td) for k, v in act.items()})
    cases = [("qkv", lambda d: JA.qkv_project(d["proj"], d["x"], H, KV, hd),
              lambda d: TA.qkv_project(d["proj"], d["x"], H, KV, hd))]
    # full attention: several q chunks, both schedules, causal or not,
    # continuing at an offset
    for causal, sched, off in ((True, "scan", 0), (True, "unrolled", 0),
                               (True, "scan", 5), (False, "unrolled", 0)):
        kw = dict(causal=causal, q_offset=off, q_chunk=4, schedule=sched)
        cases.append((f"sdpa-{causal}-{sched}-{off}",
                      lambda d, kw=kw: JA.sdpa(d["q"], d["k"], d["v"],
                                               kv_chunk=16, **kw),
                      lambda d, kw=kw: TA.sdpa(d["q"], d["k"], d["v"],
                                               kv_chunk=16, **kw)))
    # sliding window, the window shorter and longer than a q chunk
    for window, qc in ((6, 4), (5, 16)):
        cases.append((f"local-{window}-{qc}",
                      lambda d, w=window, c=qc: JA.sdpa_local(
                          d["q"], d["k"], d["v"], window=w, q_chunk=c),
                      lambda d, w=window, c=qc: TA.sdpa_local(
                          d["q"], d["k"], d["v"], window=w, q_chunk=c)))
    # decode against the full cache and the ring
    for L in (1, 7, S):
        cases.append((f"decode-{L}",
                      lambda d, L=L: JA.sdpa_decode(d["q"][:, :1], d["k"],
                                                    d["v"], L),
                      lambda d, L=L: TA.sdpa_decode(d["q"][:, :1], d["k"],
                                                    d["v"], L)))
    W = len(rpos)
    for cur in (11, 12, 13):
        cases.append((f"ring-{cur}",
                      lambda d, c=cur: JA.sdpa_decode_ring(
                          d["q"][:, :1], d["k"][:, :W], d["v"][:, :W],
                          d["rpos"], c, W),
                      lambda d, c=cur: TA.sdpa_decode_ring(
                          d["q"][:, :1], d["k"][:, :W], d["v"][:, :W],
                          d["rpos"], c, W)))
    _hold(cases, jin, tin, dtype)
    with pytest.raises(ValueError):
        TA.sdpa(tin["q"], tin["k"], tin["v"], schedule="flash")


@pytest.mark.parametrize("causal,schedule,sq,q_offset,kv_chunk", [
    (True, "scan", 24, 0, 8), (True, "unrolled", 24, 0, 6),
    (True, "scan", 8, 16, 8), (False, "unrolled", 24, 0, 8)])
def test_sdpa_online_softmax_over_kv_chunks(causal, schedule, sq, q_offset,
                                            kv_chunk, monkeypatch):
    """More keys than ``kv_chunk``: the online softmax over KV chunks
    against JAX's at f32 within ``TOL``/``RTOL``, no score block larger
    than ``q_chunk`` x ``kv_chunk``."""
    rng = np.random.RandomState(5)
    B, Skv, H, KV, hd, qc = 2, 24, 4, 2, 8, 8
    q = rng.randn(B, sq, H, hd).astype(np.float32)
    k, v = (rng.randn(B, Skv, KV, hd).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, q_chunk=qc,
              kv_chunk=kv_chunk, schedule=schedule)
    want = JA.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    blocks = []
    einsum = torch.einsum

    def spy(eq, *ops):
        out = einsum(eq, *ops)
        if eq.endswith("->...qk"):
            blocks.append(tuple(out.shape[-2:]))
        return out
    monkeypatch.setattr(torch, "einsum", spy)
    got = TA.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=RTOL)
    assert blocks and max(a * b for a, b in blocks) <= qc * kv_chunk
    # causal: the chunks wholly above the diagonal are skipped
    assert len(blocks) == (sum(min(Skv // kv_chunk, -(-(q_offset + i + qc)
                                                      // kv_chunk))
                               for i in range(0, sq, qc)) if causal else
                           (sq // qc) * (Skv // kv_chunk))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(1, cfg.vocab, (B, S)).astype(
        np.int32)


def _prefix(cfg, B, seed):
    if cfg.frontend != "vision":
        return None
    return np.random.RandomState(seed).randn(
        B, cfg.prefix_len, cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch, dtype):
    jc, jm, jp, tc, tm, tp, _ = _pair(arch)
    jd, td = DTYPES[dtype]
    B, S, half = 2, 16, 12
    tok = _tokens(tc, B, S, 1)
    pre = _prefix(tc, B, 2)
    P = 0 if pre is None else pre.shape[1]
    jb = {"tokens": jnp.asarray(tok)}
    tb = {"tokens": torch.from_numpy(tok)}
    if pre is not None:
        jb["prefix"], tb["prefix"] = jnp.asarray(pre), torch.from_numpy(pre)
    jbh = dict(jb, tokens=jb["tokens"][:, :half])
    tbh = dict(tb, tokens=tb["tokens"][:, :half])
    max_len = S + P + 4
    # each JAX oracle compiled once (the decode position is traced)
    jtrain = jax.jit(lambda p, b: (jforward(
        p, jc, b["tokens"], prefix=b.get("prefix"), compute_dtype=jd,
        remat="none")[0], jm.loss(p, b, compute_dtype=jd)[0]))
    jpre = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len,
                                           compute_dtype=jd))
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos,
                                                       compute_dtype=jd))
    with torch.inference_mode():
        # train mode, and the loss over it
        jl, jloss = jtrain(jp, jb)
        tl = tforward(tp, tc, tb["tokens"], prefix=tb.get("prefix"),
                      compute_dtype=td)
        assert tl.dtype == td and tuple(tl.shape) == jl.shape
        _close(tl, jl, dtype)
        tloss, tmet = tm.loss(tp, tb, compute_dtype=td)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   atol=TOL if dtype == "f32" else 2e-2,
                                   rtol=RTOL)
        assert float(tmet["nll"]) == float(tloss)
        # prefill, then decode the rest through the caches
        jlast, jcache = jpre(jp, jbh)
        tlast, tcache = tm.prefill(tp, tbh, max_len=max_len, compute_dtype=td)
        _close(tlast, jlast, dtype)
        for t in range(half, S):
            jlast, jcache = jdec(jp, jcache, jb["tokens"][:, t:t + 1], t + P)
            tlast, tcache2 = tm.decode_step(tp, tcache,
                                            tb["tokens"][:, t:t + 1], t + P,
                                            compute_dtype=td)
            assert tcache2 is tcache          # updated in place
            _close(tlast, jlast, dtype)


def test_prefill_then_decode_matches_train():
    """The port's own consistency, at f32, on the custom pattern (a ring
    that wraps) and on the prefix model, from a fresh decode cache too."""
    for arch in ("custom", "internvl2-26b"):
        _, _, _, tc, tm, tp, _ = _pair(arch, seed=4)
        B, S, half = 2, 24, 10
        tok = torch.from_numpy(_tokens(tc, B, S, 5))
        pre = _prefix(tc, B, 6)
        pre = None if pre is None else torch.from_numpy(pre)
        P = 0 if pre is None else pre.shape[1]
        with torch.inference_mode():
            full = tforward(tp, tc, tok, prefix=pre,
                            compute_dtype=torch.float32)[:, P:]
            batch = {"tokens": tok[:, :half]}
            if pre is not None:
                batch["prefix"] = pre
            last, cache = tm.prefill(tp, batch, max_len=S + P,
                                     compute_dtype=torch.float32)
            np.testing.assert_allclose(last.numpy(), full[:, half - 1].numpy(),
                                       atol=TOL, rtol=RTOL)
            for t in range(half, S):
                last, cache = tm.decode_step(tp, cache, tok[:, t:t + 1],
                                             t + P,
                                             compute_dtype=torch.float32)
                np.testing.assert_allclose(last.numpy(), full[:, t].numpy(),
                                           atol=TOL, rtol=RTOL)
    # from an empty cache, token by token (no prefix)
    _, _, _, tc, tm, tp, _ = _pair("custom", seed=4)
    tok = torch.from_numpy(_tokens(tc, 2, 12, 7))
    with torch.inference_mode():
        full = tforward(tp, tc, tok, compute_dtype=torch.float32)
        cache = tm.init_cache(2, 12, dtype=torch.float32, device="cpu")
        for t in range(12):
            last, cache = tm.decode_step(tp, cache, tok[:, t:t + 1], t,
                                         compute_dtype=torch.float32)
            np.testing.assert_allclose(last.numpy(), full[:, t].numpy(),
                                       atol=TOL, rtol=RTOL)


@pytest.mark.parametrize("arch", DEFERRED)
def test_families_still_to_port_raise(arch):
    cfg = tsmoke(tget(arch))
    m = tbuild(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.init_cache(1, 8, device="cpu")


def test_param_count_and_init_match_jax():
    # at full width from shapes alone (nothing allocated), and at smoke size
    for cfg_j, cfg_t in ((jget("mistral-nemo-12b"), tget("mistral-nemo-12b")),
                         *(_cfgs(a) for a in ARCHS)):
        assert tbuild(cfg_t).param_count() == jbuild(cfg_j).param_count()
    assert tbuild(tget("mistral-nemo-12b")).param_count() > 12e9
    jc, tc = _cfgs("custom")
    p = tbuild(tc).init(torch.Generator().manual_seed(0), device="cpu")
    tree = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
    want = interop.params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree), tc, device="cpu")
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda t: 0, p)) == jax.tree_util.tree_structure(
        jax.tree.map(lambda t: 0, want))
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == torch.float32
    # norms start at one, weights are N(0, 1/fan_in)
    assert torch.all(p["layers"][0]["norm1"]["scale"] == 1)
    w = p["layers"][2]["mlp"]["w_up"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.1


def test_weight_map_follows_the_jax_layer_order():
    """head, then for each group g every block of the pattern (slice g of
    the stacked leaves), then tail: checked leaf by leaf, and a map in
    another order gives logits far from JAX's."""
    jc, jm, jp, tc, tm, tp, tree = _pair("custom", seed=8)
    types = ["attn"] + ["attn", "local_attn"] * 2 + ["attn"]
    assert len(tp["layers"]) == len(types) == jc.n_layers
    np.testing.assert_array_equal(tp["layers"][0]["attn"]["wq"].numpy(),
                                  tree["head"][0]["attn"]["wq"])
    for g in range(2):
        for i in range(2):
            np.testing.assert_array_equal(
                tp["layers"][1 + 2 * g + i]["mlp"]["w_up"].numpy(),
                tree["groups"][str(i)]["mlp"]["w_up"][g])
    np.testing.assert_array_equal(tp["layers"][5]["norm2"]["scale"].numpy(),
                                  tree["tail"][0]["norm2"]["scale"])
    tok = _tokens(tc, 2, 12, 9)
    jl, _ = jax.jit(lambda p, t: jforward(p, jc, t, remat="none",
                                          compute_dtype=jnp.float32))(
        jp, jnp.asarray(tok))
    with torch.inference_mode():
        good = tforward(tp, tc, torch.from_numpy(tok),
                        compute_dtype=torch.float32)
        np.testing.assert_allclose(good.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=RTOL)
        # group-major is right; pattern-major (all of block 0, then all of
        # block 1) keeps each layer's type where it was only by accident,
        # so swap the two groups' attn layers instead: same types, wrong
        # weights
        bad = dict(tp, layers=list(tp["layers"]))
        bad["layers"][1], bad["layers"][3] = bad["layers"][3], bad["layers"][1]
        wrong = tforward(bad, tc, torch.from_numpy(tok),
                         compute_dtype=torch.float32)
    assert np.abs(wrong.numpy() - np.asarray(jl)).max() > 100 * TOL
    with pytest.raises(ValueError):
        interop.params_from_jax(dict(tree, tail=[]), tc, device="cpu")
