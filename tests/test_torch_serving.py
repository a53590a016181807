"""The port's serving side against the JAX package's, on the CPU.

* The n-gram guard (``repro_torch.serving.ngram_guard``) bit for bit
  against the JAX guard, in both modes (the blocked bank, and the counting
  bank with its decay cadence), from the same numpy tokens and logits (f32
  and bf16, with tied logits): penalized logits, bank words after every
  observe (through ``interop.to_jax_words``) and stats. Tolerance 0.
* The JAX package's guard tests, mirrored on the port.
* ``Engine`` against the JAX ``Engine`` on the same weights (carried over
  by ``interop.params_from_jax``) and prompts, in bf16, the engines'
  compute dtype. XLA and PyTorch may round a bf16 product differently, so
  logits are held to ``BF16_TOL`` (absolute) and tokens are compared
  where they are decided: the port runs under teacher forcing (its
  sampler returns the JAX token), its own greedy token must equal JAX's
  at every step whose top-two margin in JAX exceeds ``2 * BF16_TOL``, the
  guard's words after every observe must be equal, and its penalties
  equal wherever the two top-K candidate sets are (they must be where
  JAX's K-th and (K+1)-th logits differ by more than ``2 * BF16_TOL``).
  A free-running port engine must emit JAX's tokens up to the first step
  whose margin is smaller.
* ``launch.serve.main`` on ``--device cpu`` at smoke size, both guards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as JE
import repro.serving.ngram_guard as JG
from repro.configs import get_config as jget, smoke_config as jsmoke
from repro.models.model import build_model as jbuild
from repro_torch import interop
from repro_torch.configs import get_config as tget, smoke_config as tsmoke
from repro_torch.models.model import build_model as tbuild
import repro_torch.serving.engine as TE
import repro_torch.serving.ngram_guard as TG

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

BF16_TOL = 0.0625    # |port - JAX| of a bf16 logit (2^-4: 4 ulps at 2-4)

MODES = {"sbf": {}, "decay": {"decay_every": 3}}


def _jax_guard(**kw):
    # the JAX blocked bank on its jnp engine; the counting bank on its own
    if "decay_every" not in kw:
        kw["backend"] = "jnp"
    return JG.NGramGuard(**kw)


def _words(g):
    return np.asarray(g.filt.words).view(np.uint32)


def _port_words(g):
    return interop.to_jax_words(g.filt)[1]


def _bits(x, dtype):
    if dtype == "bf16":
        return np.asarray(x).view(np.uint16)
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_guard_matches_jax_bit_for_bit(mode, dtype):
    B, V, K = 3, 16, 8
    kw = dict(batch=B, n=3, m_bits=1 << 14, top_k=K, **MODES[mode])
    jg, tg = _jax_guard(**kw), TG.NGramGuard(device="cpu", **kw)
    assert tg.filt.backend == ("counting" if mode == "decay" else "torch")
    rng = np.random.RandomState(7)
    for step in range(14):
        # halves: many exact ties, which the top-K must order by index
        logits = np.round(rng.randn(B, V) * 2).astype(np.float32) / 2
        if dtype == "bf16":
            jl, tl = (jnp.asarray(logits, jnp.bfloat16),
                      torch.from_numpy(logits).to(torch.bfloat16))
        else:
            jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
        jo, to = jg.penalize(jl), tg.penalize(tl)
        assert to.dtype == tl.dtype
        got = (to.view(torch.int16) if dtype == "bf16" else to).numpy()
        np.testing.assert_array_equal(_bits(got, dtype), _bits(jo, dtype))
        toks = rng.randint(0, 5, B)
        toks[0] = step % 3                  # sequence 0 loops
        jg.observe(toks)
        tg.observe(toks)
        np.testing.assert_array_equal(_port_words(tg), _words(jg))
        np.testing.assert_array_equal(tg.hist.numpy(), np.asarray(jg.hist))
    assert tg.stats == TG.GuardStats(**dataclasses.asdict(jg.stats))
    assert tg.stats.penalized > 0
    assert tg.stats.decays == (4 if mode == "decay" else 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_top_k_orders_ties_by_index_like_jax(dtype):
    logits = np.array([[0, 1, 1, -0.0, 1, 0, -0.0, 1, -np.inf, np.nan, -2]],
                      np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if dtype == "bf16":                  # the same bits on both sides
        jl = jl.astype(jnp.bfloat16)
        tl = torch.from_numpy(np.asarray(jl).view(np.int16)).view(
            torch.bfloat16)
    want = np.asarray(jax.lax.top_k(jl, 11)[1])
    got = TG.top_k_indices(tl, 11).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The JAX package's guard tests, on the port
# ---------------------------------------------------------------------------

def test_ngram_guard_blocks_repetition():
    B, V, n = 2, 100, 3
    g = TG.NGramGuard(batch=B, n=n, m_bits=1 << 14, top_k=8, device="cpu")
    for t in [5, 6, 7, 5, 6]:      # after (5,6,7), candidate 7 after (5,6)
        g.observe(np.full((B,), t))
    out = g.penalize(torch.zeros((B, V)))
    assert float(out[0, 7]) < -1e8          # would complete seen (5,6,7)
    assert float(out[0, 9]) == 0.0          # unseen candidate untouched


def test_ngram_guard_no_false_negative_loop():
    rng = np.random.RandomState(0)
    g = TG.NGramGuard(batch=1, n=4, top_k=50, device="cpu")
    toks = rng.randint(0, 50, 40)
    for t in toks:
        g.observe(np.array([t]))
    # replay a window that definitely occurred (all-zero logits tie)
    g.hist = torch.as_tensor(toks[None, 17:20], dtype=torch.int32)
    out = g.penalize(torch.zeros((1, 50)))
    assert float(out[0, toks[20]]) < -1e8


def test_ngram_guard_is_bank_native_and_loopless():
    B = 4
    g = TG.NGramGuard(batch=B, n=3, m_bits=1 << 16, top_k=8, device="cpu")
    assert g.filt.bank_shape == (B,)       # one member per sequence
    rng = np.random.RandomState(1)
    for step in range(12):
        toks = rng.randint(0, 50, B)
        toks[0] = step % 3                 # sequence 0 loops
        g.penalize(torch.from_numpy(rng.randn(B, 50).astype(np.float32)))
        g.observe(toks)
    out = g.penalize(torch.zeros((B, 50))).numpy()
    assert out[0].min() < -1e8             # the loop continuation is caught
    assert isinstance(g._observed, torch.Tensor)   # counters stay tensors


# ---------------------------------------------------------------------------
# Engine against the JAX Engine
# ---------------------------------------------------------------------------

def _random_tree(shapes, seed):
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


def _engine_pair(seed=0):
    sc = jsmoke(jget("mistral-nemo-12b"))
    tc = tsmoke(tget("mistral-nemo-12b"))
    jm, tm = jbuild(sc), tbuild(tc)
    tree = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = interop.params_from_jax(tree, tc, device="cpu")
    return sc, jm, jparams, tm, tparams


def _record(guard, log, words):
    """Record each penalize's input and output and the words after each
    observe of ``guard`` (an instance wrapper)."""
    penalize, observe = guard.penalize, guard.observe

    def pen(logits):
        out = penalize(logits)
        log.append((_f32(logits), _f32(out)))
        return out

    def obs(tokens):
        observe(tokens)
        words.append(_port_words(guard) if isinstance(guard, TG.NGramGuard)
                     else _words(guard))
    guard.penalize, guard.observe = pen, obs


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _top2_margin(row):
    top = np.sort(row)[::-1]
    return top[0] - top[1]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(mode):
    B, K = 2, 16
    sc, jm, jparams, tm, tparams = _engine_pair()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, sc.vocab, n).astype(np.int32) for n in (8, 6)]
    new = 8
    kw = dict(batch=B, n=3, m_bits=1 << 14, top_k=K, **MODES[mode])

    jguard, jlog, jwords, jtoks = _jax_guard(**kw), [], [], []
    _record(jguard, jlog, jwords)

    def jsample(logits):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        return tok
    jeng = JE.Engine(jm, jparams, batch=B, max_len=32, guard=jguard,
                     sample=jsample)
    jout = jeng.generate([JE.Request(p, new) for p in prompts])

    # the port under teacher forcing: its sampler returns JAX's token
    tguard, tlog, twords, own = TG.NGramGuard(device="cpu", **kw), [], [], []
    _record(tguard, tlog, twords)

    def tsample(logits):
        own.append(TE.greedy_sample(logits).numpy())
        return torch.from_numpy(jtoks[len(own) - 1].copy())
    teng = TE.Engine(tm, tparams, batch=B, max_len=32, guard=tguard,
                     sample=tsample)
    tout = teng.generate([TE.Request(p, new) for p in prompts])
    assert tout == jout and len(own) == len(jtoks) == new

    decided = 0
    for step, ((jin, jpen), (tin, tpen)) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(tin, jin, atol=BF16_TOL, rtol=0)
        np.testing.assert_array_equal(twords[step], jwords[step])
        for b in range(B):
            jset = set(np.argsort(-jin[b], kind="stable")[:K])
            tset = set(np.argsort(-tin[b], kind="stable")[:K])
            kth = np.sort(jin[b])[::-1]
            if kth[K - 1] - kth[K] > 2 * BF16_TOL:
                assert jset == tset, (step, b)
            both = sorted(jset & tset)
            np.testing.assert_array_equal(tpen[b, both] < -1e8,
                                          jpen[b, both] < -1e8)
            keep = jpen[b] > -1e8
            np.testing.assert_allclose(tpen[b, keep], jpen[b, keep],
                                       atol=BF16_TOL, rtol=0)
            if _top2_margin(jpen[b]) > 2 * BF16_TOL:
                assert own[step][b] == jtoks[step][b], (step, b)
                decided += 1
    assert decided >= B * new // 2
    assert tguard.stats == TG.GuardStats(**dataclasses.asdict(jguard.stats))
    assert jeng.stats() == pytest.approx(teng.stats())

    # free running, the port emits JAX's tokens up to the first close call
    free = TE.Engine(tm, tparams, batch=B, max_len=32,
                     guard=TG.NGramGuard(device="cpu", **kw))
    fout = free.generate([TE.Request(p, new) for p in prompts])
    for step in range(new):
        if any(_top2_margin(jlog[step][1][b]) <= 2 * BF16_TOL
               for b in range(B)):
            break
        assert [o[step] for o in fout] == [o[step] for o in jout], step


def test_engine_short_last_wave_fails_as_in_jax():
    sc, jm, jparams, tm, tparams = _engine_pair()
    prompt = np.arange(2, 8, dtype=np.int32)
    eng = TE.Engine(tm, tparams, batch=2, max_len=16,
                    guard=TG.NGramGuard(batch=2, n=3, device="cpu"))
    with pytest.raises(RuntimeError):
        eng.generate([TE.Request(prompt, 2)])


def test_engine_stats_legacy_is_deprecated():
    sc, jm, jparams, tm, tparams = _engine_pair()
    eng = TE.Engine(tm, tparams, batch=2, max_len=16,
                    guard=TG.NGramGuard(batch=2, n=3, device="cpu"))
    eng.generate([TE.Request(np.arange(2, 8, dtype=np.int32), 3)] * 2)
    with pytest.warns(DeprecationWarning):
        legacy = eng.stats_legacy()
    assert legacy["guard_observed"] == 2.0 and "guard_fill" in legacy


@pytest.mark.parametrize("flags", [["--guard"], ["--guard-decay-every", "4"]])
def test_serve_main_cli_smoke(flags, capsys):
    from repro_torch.launch.serve import main
    rc = main(["--arch", "mistral-nemo-12b", "--requests", "2", "--batch",
               "2", "--prompt-len", "8", "--new-tokens", "4",
               "--device", "cpu"] + flags)
    assert rc == 0
    out = capsys.readouterr().out
    engine = "counting" if "--guard-decay-every" in flags else "torch"
    assert f"(engine {engine!r})" in out and "8 tokens" in out
