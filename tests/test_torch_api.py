"""The port's ``Filter`` API and state interop against ``repro.api``.

All port filters here live on the CPU (``device="cpu"``), so they run the
plain PyTorch versions; the JAX filters run on the CPU too. Words are
compared as np.uint32 and results as bool, exactly.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import hashing as JH
import repro_torch
import repro_torch.api as api
from repro_torch import interop
from repro_torch.api import registry
from repro_torch.api.filter import as_keys

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
M = 1 << 16
GEOMETRIES = [dict(variant="sbf", k=16, block_bits=256),
              dict(variant="bbf", k=8, block_bits=256),
              dict(variant="rbbf", k=4),
              dict(variant="csbf", k=8, block_bits=512, z=2)]
GEO_IDS = [g["variant"] for g in GEOMETRIES]


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_make_filter_matches_jax_jnp_engine(geo):
    keys = JH.random_u64x2(2000, seed=1)
    queries = np.concatenate([keys, JH.probe_u64x2(2000, seed=1)])
    jf = japi.make_filter(m_bits=M, backend="jnp", **geo).add(keys)
    tf = api.make_filter(m_bits=M, device="cpu", **geo)
    assert tf.backend == "torch" and tf.device.type == "cpu"
    tf = tf.add(keys)
    np.testing.assert_array_equal(_u32(tf.dense_words()),
                                  np.asarray(jf.dense_words()))
    np.testing.assert_array_equal(tf.contains(queries).numpy(),
                                  np.asarray(jf.contains(queries)))


def test_make_filter_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert repro_torch.default_device() == torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_filter()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.filter_for_n_items(1000)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.keys_to_torch(JH.random_u64x2(4))


@pytest.mark.parametrize("engine", ["jnp", "pallas-vmem"])
def test_jax_state_roundtrip(engine):
    keys = JH.random_u64x2(1500, seed=2)
    queries = np.concatenate([keys, JH.probe_u64x2(1500, seed=2)])
    jf = japi.make_filter("sbf", m_bits=M, k=8, backend=engine).add(keys)
    state = {k: (np.asarray(v) if k == "words" else v)
             for k, v in jf.to_state().items()}
    tf = interop.from_jax_state(state, device="cpu")
    assert tf.backend == "torch"
    np.testing.assert_array_equal(_u32(tf.dense_words()),
                                  np.asarray(jf.dense_words()))
    np.testing.assert_array_equal(tf.contains(queries).numpy(),
                                  np.asarray(jf.contains(queries)))
    # the reverse trip, grown by more keys on the port side
    more = JH.random_u64x2(500, seed=3)
    back = japi.Filter.from_state(interop.to_jax_state(tf.add(more)))
    assert back.backend == "jnp"
    np.testing.assert_array_equal(np.asarray(back.dense_words()),
                                  np.asarray(jf.add(more).dense_words()))


def test_measure_fpr_matches_jax():
    keys = JH.random_u64x2(4000, seed=6)
    jf = japi.make_filter("sbf", m_bits=M, k=8, backend="jnp").add(keys)
    tf = api.make_filter("sbf", m_bits=M, k=8, device="cpu").add(keys)
    for n_probe, seed in ((1 << 14, 1234), (5000, 7)):
        assert tf.measure_fpr(n_probe, seed) == jf.measure_fpr(n_probe, seed)
    assert tf.fpr_theory(4000) == jf.fpr_theory(4000)
    assert tf.fill_fraction() == pytest.approx(jf.fill_fraction(), rel=1e-6)
    assert tf.approx_count() == pytest.approx(jf.approx_count(), rel=1e-5)
    assert tf.nbytes == jf.nbytes == M // 8


@pytest.mark.parametrize("n,bits,variant,kw", [
    (1000, 16.0, "sbf", {}), (123456, 10.0, "sbf", {"block_bits": 512}),
    (5000, 12.0, "bbf", {}), (70000, 16.0, "csbf", {"block_bits": 512, "z": 2}),
    (5000, 8.0, "rbbf", {})])
def test_filter_for_n_items_sizes_like_jax(n, bits, variant, kw):
    jf = japi.filter_for_n_items(n, bits_per_key=bits, variant=variant,
                                 backend="jnp", **kw)
    tf = api.filter_for_n_items(n, bits_per_key=bits, variant=variant,
                                device="cpu", **kw)
    assert dataclasses.asdict(tf.spec) == dataclasses.asdict(jf.spec)
    jt = japi.filter_for_n_items(n, variant=variant, target_fpr=1e-3,
                                 backend="jnp", **kw)
    tt = api.filter_for_n_items(n, variant=variant, target_fpr=1e-3,
                                device="cpu", **kw)
    assert dataclasses.asdict(tt.spec) == dataclasses.asdict(jt.spec)


def test_filter_is_immutable_and_merges():
    a = api.make_filter("sbf", m_bits=M, k=8, device="cpu")
    ka, kb = JH.random_u64x2(800, seed=8), JH.random_u64x2(800, seed=9)
    a1 = a.add(ka)
    assert not a.dense_words().any() and a1.dense_words().any()
    assert a1.add(ka[:0]) is a1
    b1 = api.make_filter("sbf", m_bits=M, k=8, device="cpu").add(kb)
    u = api.union(a1, b1)
    both = a.add(np.concatenate([ka, kb]))
    np.testing.assert_array_equal(_u32(u.dense_words()),
                                  _u32(both.dense_words()))
    np.testing.assert_array_equal(_u32((a1 | b1).dense_words()),
                                  _u32(both.dense_words()))
    with pytest.raises(ValueError):
        a1.merge(api.make_filter("sbf", m_bits=M, k=16, device="cpu"))
    with pytest.raises(ValueError):
        api.union()


def test_unported_operations_name_the_roadmap_item():
    f = api.make_filter("sbf", m_bits=M, k=8, device="cpu")
    keys = JH.random_u64x2(4, seed=0)
    # remove, decay and advance are ported: on a bit engine they raise the
    # JAX package's capability error, which names the engine that has them
    for call in (lambda: f.remove(keys), lambda: f.decay()):
        with pytest.raises(NotImplementedError, match="'counting'"):
            call()
    with pytest.raises(NotImplementedError, match="'windowed'"):
        f.advance()
    with pytest.raises(ValueError, match="valid="):
        f.add(keys, valid=np.ones(4, np.uint8))
    # banks are ported: routed keys on a scalar filter raise the JAX
    # package's ValueError, and filter_for_n_items(bank=) builds a bank
    for call in (lambda: f.add(keys, tenants=np.zeros(4, np.int32)),
                 lambda: f.contains(keys, tenants=np.zeros(4, np.int32))):
        with pytest.raises(ValueError, match="need a bank"):
            call()
    assert api.filter_for_n_items(100, bank=4, device="cpu").bank_shape == (4,)
    # the fingerprint filters are ported: each builds its engine, and the
    # quotient engine's resize raises the capability error elsewhere
    assert api.filter_for_n_items(100, variant="cuckoo",
                                  device="cpu").backend == "cuckoo"
    assert api.filter_for_n_items(100, variant="quotient",
                                  device="cpu").backend == "quotient"
    with pytest.raises(ValueError, match="'quotient'"):
        f.resize(2 * M)


def test_engine_selection_by_device():
    small = api.FilterSpec("sbf", M, 8)
    large = api.FilterSpec("sbf", 1 << 30, 8)
    wide = api.FilterSpec("sbf", M, 64, block_bits=2048)
    cbf = api.FilterSpec("cbf", M, 8)
    cpu = registry.SelectionContext(device=torch.device("cpu"))
    gpu = registry.SelectionContext(device=torch.device("cuda"))
    for name in ("auto", "torch", "jnp", "pallas", "pallas-vmem",
                 "pallas-hbm"):
        assert registry.select(small, name, cpu).name == "torch"
        assert registry.select(cbf, name, cpu).name == "torch"
    assert registry.select(cbf, "auto", gpu).name == "cuda-l2"
    for name, spec, want in (("auto", small, "cuda-l2"),
                             ("auto", large, "cuda-dram"),
                             ("jnp", small, "cuda-l2"),
                             ("jnp", large, "cuda-dram"),
                             ("pallas", large, "cuda-dram"),
                             ("pallas-vmem", small, "cuda-l2"),
                             ("pallas-hbm", small, "cuda-dram")):
        assert registry.select(spec, name, gpu).name == want, (name, spec)
    for name, spec, ctx in (("torch", small, gpu), ("cuda-l2", small, cpu),
                            ("pallas-vmem", large, gpu), ("auto", wide, gpu),
                            ("torch", cbf, gpu), ("cuda-l2", cbf, cpu)):
        with pytest.raises(ValueError):
            registry.select(spec, name, ctx)
    counting = api.FilterSpec("countingbf", M, 8)
    for ctx in (cpu, gpu):
        assert registry.select(counting, "auto", ctx).name == "counting"
        for name in ("torch", "cuda-l2", "cuda-dram"):
            with pytest.raises(ValueError):
                registry.select(counting, name, ctx)
    assert api.backends() == ("counting", "cuckoo", "cuda-dram", "cuda-l2",
                              "quotient", "torch", "windowed")
    assert {d["name"] for d in api.describe_backends()} == set(api.backends())
    assert api.get_backend("torch").name == "torch"


def test_as_keys_accepts_every_key_form():
    keys = JH.random_u64x2(50, seed=4)
    u64 = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1]
    want = keys.view(np.int32)
    forms = [keys, u64, torch.from_numpy(keys.copy()),
             torch.from_numpy(keys.view(np.int32).copy()),
             torch.from_numpy(keys.astype(np.int64)), keys.astype(np.int64)]
    for form in forms:
        got = as_keys(form)
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        as_keys(np.zeros((4, 3), np.uint32))


def test_from_state_rejects_state_of_unported_engines():
    f = api.make_filter("sbf", m_bits=M, k=8, device="cpu")
    state = interop.to_jax_state(f)
    # engine state is ported (a fingerprint engine's failure count); a bit
    # engine has none and ignores it, as the JAX package does, and a
    # quotient state comes back with its failure count
    assert api.Filter.from_state({**state, "engine_state": 0},
                                 device="cpu").state is None
    qspec = dict(state["spec"], variant="quotient", k=1, slot_bits=8,
                 r_bits=4, block_bits=32)
    q = api.Filter.from_state({**state, "spec": qspec, "backend": "quotient",
                               "engine_state": 3}, device="cpu")
    assert q.backend == "quotient" and int(q.insert_failures) == 3
    # a bank state is ported: its words must carry the bank dims
    with pytest.raises(ValueError):
        api.Filter.from_state({**state, "bank_shape": [2]}, device="cpu")
    bank = api.Filter.from_state(
        {**state, "bank_shape": [2],
         "words": np.stack([state["words"]] * 2)}, device="cpu")
    assert bank.bank_shape == (2,) and bank.words.shape == (2, M // 32)
    # a windowed state is ported: it comes back as a ring, the union in
    # generation 0 and the head at 0
    ring = api.Filter.from_state({**state, "backend": "windowed",
                                  "options": {"generations": 3}},
                                 device="cpu")
    assert ring.backend == "windowed" and ring.head == 0
    assert ring.words.shape == (3, M // 32)
    with pytest.raises(ValueError):
        api.Filter.from_state({**state, "words": state["words"][:-1]},
                              device="cpu")
    # a counting filter's state holds its dense (n_words,) occupancy words
    c = api.make_filter("countingbf", m_bits=M, k=8, device="cpu")
    cstate = interop.to_jax_state(c.add(JH.random_u64x2(100, seed=1)))
    assert cstate["words"].shape == (M // 32,)
    back = api.Filter.from_state(cstate, device="cpu")
    assert back.words.shape == (c.spec.storage_words,)
    with pytest.raises(ValueError):
        api.Filter.from_state({**cstate, "words": np.zeros(
            c.spec.storage_words, np.uint32)}, device="cpu")


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.api, "
            "repro_torch.kernels.ops, repro_torch.kernels.countingbf, "
            "repro_torch.kernels.cbf, repro_torch.kernels.ring, "
            "repro_torch.kernels._build, repro_torch.interop, "
            "repro_torch.core.partition, repro_torch.core.fingerprint, "
            "repro_torch.kernels.cuckoofilter, repro_torch.core.quotient, "
            "repro_torch.kernels.quotientfilter, "
            "repro_torch.window, repro_torch.window.ring, "
            "repro_torch.service, repro_torch.telemetry, "
            "repro_torch.checkpoint.checkpoint, "
            "repro_torch.runtime.fault_tolerance; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.M)
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {p.relative_to(ROOT / "src").as_posix() for p in sources}
    assert {"repro_torch/window/ring.py", "repro_torch/window/__init__.py",
            "repro_torch/kernels/cbf.py", "repro_torch/kernels/ring.py",
            "repro_torch/core/partition.py", "repro_torch/core/fingerprint.py",
            "repro_torch/kernels/cuckoofilter.py",
            "repro_torch/core/quotient.py",
            "repro_torch/kernels/quotientfilter.py",
            "repro_torch/checkpoint/checkpoint.py",
            "repro_torch/runtime/fault_tolerance.py"} | {
                f"repro_torch/telemetry/{m}.py" for m in (
                    "__init__", "metrics", "tracing", "export", "drift",
                    "hub")} | {
                f"repro_torch/service/{m}.py" for m in (
                    "__init__", "admission", "frontend", "maintenance",
                    "resharding", "driver")} <= names
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path
