"""The port's checkpoints and fault-tolerant driver against the JAX
package's, on the CPU.

Checkpoints cross the packages both ways: a nest of arrays (bfloat16 and
float8 leaves included) written by either package restores in the other
with the same leaf names (JAX's ``tree_flatten_with_path`` names) and the
same bits; ``save_filter`` of either package restores in the other for
every engine family (the JAX reader told the port engine's JAX name by
``interop.JAX_ENGINE``), failure counts included; a ``Filter`` saved
inline by ``save`` (its raw words and state) restores in the other
package's filter. The scenarios of ``tests/test_fault_tolerance_filter.py``
run through both packages' ``TrainingDriver`` and give the same words and
the same event log. Banks of 4 members, m <= 2^13 bits.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.checkpoint import checkpoint as J
from repro.runtime import fault_tolerance as JFT
import repro_torch.api as tapi
from repro_torch import interop
from repro_torch.checkpoint import checkpoint as C
from repro_torch.runtime import fault_tolerance as TFT

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

T = 4


def _tree_np():
    rng = np.random.RandomState(0)
    return {"params": {"w": rng.randn(3, 5).astype(np.float32),
                       "b16": rng.randn(4).astype(ml_dtypes.bfloat16),
                       "e4": rng.randn(6).astype(ml_dtypes.float8_e4m3fn),
                       "e5": rng.randn(2, 2).astype(ml_dtypes.float8_e5m2)},
            "opt": [np.arange(4, dtype=np.int32),
                    (np.uint32(7) * np.ones(3, np.uint32), None)],
            "step": np.asarray(12, np.int32)}


def _torch_tree(tree):
    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        name = str(x.dtype)
        if name in C._EXTENDED:
            bits = C._EXTENDED[name][1]
            return torch.from_numpy(x.view(bits).view(
                np.int16 if bits == np.uint16 else np.uint8).copy()).view(
                    C._LOGICAL_TORCH[name])
        return torch.from_numpy(np.array(x))
    return conv(tree)


def _host(t):
    if t.dtype in C._TORCH_EXTENDED:
        name = C._TORCH_EXTENDED[t.dtype]
        bits = C._EXTENDED[name][1]
        return t.view(torch.int16 if bits == np.uint16 else torch.uint8
                      ).numpy().view(bits).view(C._EXTENDED[name][0])
    return t.numpy()


def _bytes(a):
    return np.asarray(a).reshape(-1).view(np.uint8)


def test_leaf_names_and_order_match_jax():
    tree = _tree_np()
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path))
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    keys, leaves = C._flatten(_torch_tree(tree))
    assert keys == want
    keys_np, _ = C._flatten(tree)
    assert keys_np == want and len(leaves) == len(want)


@pytest.mark.parametrize("sync", [True, False])
def test_pytree_checkpoints_cross_both_ways(tmp_path, sync):
    tree = _tree_np()
    # the port writes (async: snapshotted before the thread starts)
    ttree = _torch_tree(tree)
    t = C.save(str(tmp_path / "p"), 3, ttree, sync=sync, extra={"a": 1})
    if t is not None:
        ttree["params"]["w"].add_(1.0)       # after the snapshot: not saved
        t.join()
    step, back = J.restore(str(tmp_path / "p"), jax.tree.map(jnp.asarray,
                                                             tree))
    assert step == 3 and J.manifest_extra(str(tmp_path / "p")) == {"a": 1}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert np.asarray(b).dtype == a.dtype
        np.testing.assert_array_equal(_bytes(b), _bytes(a))
    # the JAX package writes, the port reads onto the template's device
    J.save(str(tmp_path / "j"), 5, jax.tree.map(jnp.asarray, tree))
    with open(tmp_path / "j" / "step_00000005" / "manifest.json") as f:
        jman = json.load(f)["leaves"]
    with open(tmp_path / "p" / "step_00000003" / "manifest.json") as f:
        pman = json.load(f)["leaves"]
    assert jman == pman                      # names, files, shapes, dtypes
    step, got = C.restore(str(tmp_path / "j"), _torch_tree(tree))
    assert step == 5 and C.latest_step(str(tmp_path / "j")) == 5
    _, got_leaves = C._flatten(got)
    for a, b in zip(jax.tree.leaves(tree), got_leaves):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(_bytes(_host(b)), _bytes(a))
    with pytest.raises(KeyError):
        C.restore(str(tmp_path / "j"), {"missing": torch.zeros(1)})
    with pytest.raises(ValueError):
        C.restore(str(tmp_path / "j"), {"step": torch.zeros(2)})


def test_keep_and_atomicity_like_jax(tmp_path):
    for mod, d in ((J, tmp_path / "j"), (C, tmp_path / "p")):
        for s in range(5):
            mod.save(str(d), s, {"x": np.full(3, s, np.int32)}, keep=2)
        os.makedirs(d / "step_00000009.tmp")          # a crashed write
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                         "step_00000009.tmp"]
        assert mod.latest_step(str(d)) == 4
    with pytest.raises(FileNotFoundError):
        C.manifest_extra(str(tmp_path / "none"))


FAMILIES = [("sbf", {"m_bits": 1 << 13}), ("cbf", {"m_bits": 1 << 12,
                                                  "k": 5}),
            ("countingbf", {"m_bits": 1 << 12}),
            ("windowed", {"m_bits": 1 << 12, "generations": 3}),
            ("cuckoo", {"m_bits": 1 << 9}), ("quotient", {"m_bits": 1 << 8,
                                                        "r_bits": 5})]


def _pair(variant, kw, bank):
    kw = dict(kw)
    if variant != "windowed":
        kw["variant"] = variant
    if bank:
        return (japi.make_filter_bank(T, **kw),
                tapi.make_filter_bank(T, device="cpu", **kw))
    return japi.make_filter(**kw), tapi.make_filter(device="cpu", **kw)


def _fill(jf, tf, bank):
    rng = np.random.RandomState(1)
    keys = rng.randint(0, 2 ** 31, (700, 2)).astype(np.uint32)
    if bank:
        ten = rng.randint(0, T, 700)
        return (jf.add(jnp.asarray(keys), tenants=jnp.asarray(ten)),
                tf.add(keys, tenants=ten))
    return jf.add(jnp.asarray(keys)), tf.add(keys)


# every family as a bank; a scalar filter for a stateless and a stateful
# engine (a scalar's state has no bank dims)
SAVE_CASES = [(v, kw, True) for v, kw in FAMILIES] + [
    (v, kw, False) for v, kw in FAMILIES if v in ("sbf", "cuckoo")]


@pytest.mark.parametrize("variant,kw,bank", SAVE_CASES,
                         ids=[f"{v}-{'bank' if b else 'filter'}"
                              for v, _, b in SAVE_CASES])
def test_save_filter_crosses_both_ways(tmp_path, variant, kw, bank):
    jf, tf = _fill(*_pair(variant, kw, bank), bank)
    J.save_filter(str(tmp_path / "j"), 1, jf, extra={"cursor": 7})
    C.save_filter(str(tmp_path / "p"), 2, tf, extra={"cursor": 7})
    assert C.manifest_extra(str(tmp_path / "p"))["cursor"] == 7
    _, a = C.restore_filter(str(tmp_path / "j"), device="cpu")
    _, b = J.restore_filter(str(tmp_path / "p"),
                            backend=interop.JAX_ENGINE[tf.backend])
    _, c = C.restore_filter(str(tmp_path / "p"), device="cpu")
    jback = J.restore_filter(str(tmp_path / "j"))[1]
    for port in (a, c):
        assert port.backend == tf.backend and port.spec == tf.spec
        np.testing.assert_array_equal(port.words.numpy().view(np.uint32),
                                      np.asarray(jback.words))
        if port.engine.stateful_ops:
            np.testing.assert_array_equal(port.state.numpy(),
                                          np.asarray(jf.state))
    np.testing.assert_array_equal(np.asarray(b.words),
                                  np.asarray(jback.words))
    assert dataclasses.asdict(b.spec) == dataclasses.asdict(jf.spec)
    if tf.engine.stateful_ops:
        np.testing.assert_array_equal(np.asarray(b.state),
                                      np.asarray(jf.state))


@pytest.mark.parametrize("variant,kw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_inline_filters_cross_both_ways(tmp_path, variant, kw):
    """``save`` of a state holding a filter bank: raw words and state
    (counters, ring and heads, failure counts) restore losslessly into
    the other package's filter template."""
    jf, tf = _fill(*_pair(variant, kw, True), True)
    if variant == "windowed":
        jf, tf = jf.advance(), tf.advance()
    J.save(str(tmp_path / "j"), 1, {"filter": jf, "n": np.int32(3)})
    C.save(str(tmp_path / "p"), 1, {"filter": tf, "n": np.int32(3)})
    empty_j, empty_t = _pair(variant, kw, True)
    _, got = C.restore(str(tmp_path / "j"), {
        "filter": empty_t, "n": torch.zeros((), dtype=torch.int32)})
    _, jgot = J.restore(str(tmp_path / "p"), {"filter": empty_j,
                                              "n": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(got["filter"].words.numpy().view(np.uint32),
                                  np.asarray(jf.words))
    np.testing.assert_array_equal(np.asarray(jgot["filter"].words),
                                  np.asarray(jf.words))
    assert np.asarray(jgot["filter"].words).dtype == np.uint32
    if jf.state is not None:
        np.testing.assert_array_equal(
            np.asarray(got["filter"].state, np.int64).reshape(-1),
            np.asarray(jf.state, np.int64).reshape(-1))
        np.testing.assert_array_equal(np.asarray(jgot["filter"].state),
                                      np.asarray(jf.state))
        assert np.asarray(jgot["filter"].state).dtype == \
            np.asarray(jf.state).dtype
    assert int(got["n"]) == 3 and int(jgot["n"]) == 3


def test_restore_needs_a_card_by_default(tmp_path):
    tf = tapi.make_filter(m_bits=1 << 10, device="cpu")
    C.save_filter(str(tmp_path), 1, tf)
    C.save(str(tmp_path / "t"), 1, {"x": np.zeros(2, np.int32)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            C.restore_filter(str(tmp_path))
        with pytest.raises(RuntimeError):        # a non-tensor template leaf
            C.restore(str(tmp_path / "t"), {"x": np.zeros(2, np.int32)})


# -- the fault-tolerant driver (tests/test_fault_tolerance_filter.py) ---------

STEPS = 12


def _batch_fn(step):
    rng = np.random.RandomState(31337 + step)
    return {"keys": rng.randint(0, 2 ** 32, (16, 2)).astype(np.uint32),
            "tenants": rng.randint(0, T, 16)}


def _run(pkg, tmpdir, fail_at=None, variant="sbf"):
    kw = {"m_bits": 1 << 13} if variant == "sbf" else {
        "variant": variant, "m_bits": 1 << 9}
    if pkg == "jax":
        filt, FT = japi.make_filter_bank(T, **kw), JFT

        def step_fn(f, batch):
            out = f.add(jnp.asarray(batch["keys"]),
                        tenants=jnp.asarray(batch["tenants"]))
            return out, {"fill": out.fill_fraction()}
    else:
        filt, FT = tapi.make_filter_bank(T, device="cpu", **kw), TFT

        def step_fn(f, batch):
            out = f.add(batch["keys"], tenants=batch["tenants"])
            return out, {"fill": out.fill_fraction()}
    fired = []

    def hook(step):
        if fail_at is not None and step == fail_at and not fired:
            fired.append(step)
            raise FT.SimulatedFailure(f"node loss at {step}")

    drv = FT.TrainingDriver(step_fn, filt, _batch_fn,
                            FT.DriverConfig(ckpt_dir=str(tmpdir),
                                            ckpt_every=4, async_ckpt=False),
                            failure_hook=hook)
    return drv.run(STEPS), drv


def _words(f):
    w = f.words
    return w.numpy().view(np.uint32) if isinstance(w, torch.Tensor) \
        else np.asarray(w)


@pytest.mark.parametrize("variant", ["sbf", "cuckoo"])
def test_training_driver_survives_failure_like_jax(variant, tmp_path):
    jclean, _ = _run("jax", tmp_path / "j", variant=variant)
    runs = [_run("port", tmp_path / name, fail_at=fail, variant=variant)
            for name, fail in (("clean", None), ("failed", 10))]
    for final, _ in runs:
        np.testing.assert_array_equal(_words(final), _words(jclean))
        if final.state is not None:
            np.testing.assert_array_equal(final.state.numpy(),
                                          np.asarray(jclean.state))
    kinds = [e["kind"] for e in runs[1][1].events]
    assert "failure" in kinds and "restore" in kinds
    restore = next(e for e in runs[1][1].events if e["kind"] == "restore")
    assert restore["step"] == 8


class _Clock:
    """A scripted ``time`` for the drivers' straggler watch: every step
    takes 1 s, but the step run ``slow``-th (counted from 0, replays
    included) takes 10 s."""

    def __init__(self, slow: int):
        self.now, self.calls, self.slow = 0.0, 0, slow

    def perf_counter(self) -> float:
        if self.calls % 2:                    # the end of a step
            self.now += 10.0 if self.calls // 2 == self.slow else 1.0
        self.calls += 1
        return self.now


def test_training_driver_replays_like_jax(tmp_path, monkeypatch):
    # steps 0-5, the failure at 6, the replay of 4 and 5, then step 6 on:
    # the 11th step run is step 8, the slow one
    monkeypatch.setattr(JFT, "time", _Clock(slow=10))
    jfinal, jdrv = _run("jax", tmp_path / "j", fail_at=6)
    monkeypatch.setattr(TFT, "time", _Clock(slow=10))
    final, drv = _run("port", tmp_path / "p", fail_at=6)
    replayed = [m["step"] for m in drv.metrics_log]
    assert replayed == [m["step"] for m in jdrv.metrics_log]
    assert replayed.count(4) == 2 and replayed.count(5) == 2
    assert [m["fill"] for m in drv.metrics_log] == \
        [m["fill"] for m in jdrv.metrics_log]
    assert ([(e["kind"], e["step"]) for e in drv.events]
            == [(e["kind"], e["step"]) for e in jdrv.events])
    slow = [(e["step"], e["dt"], e["ewma"]) for e in drv.events
            if e["kind"] == "straggler"]
    assert slow == [(e["step"], e["dt"], e["ewma"]) for e in jdrv.events
                    if e["kind"] == "straggler"]
    assert [s for s, _, _ in slow] == [8]
    ref = tapi.make_filter_bank(T, m_bits=1 << 13, device="cpu")
    for step in range(STEPS):
        b = _batch_fn(step)
        ref = ref.add(b["keys"], tenants=b["tenants"])
    np.testing.assert_array_equal(_words(ref), _words(final))
    np.testing.assert_array_equal(_words(final), _words(jfinal))
    assert TFT._first_tensor({"b": [final], "a": None}) is final.words
