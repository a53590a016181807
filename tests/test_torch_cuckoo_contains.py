"""The cuckoo contains' wrapper on the CPU (its plain version) against the
JAX package, over every instance the kernels serve and over the share of
queried keys that are members.

``cuckoofilter.contains_vmem`` on CPU tensors runs ``contains_plain``; it
is held against ``repro.core.fingerprint.cuckoo_contains`` and
``cuckoo_contains_coop`` (results exact) on tables built from seeded
numpy keys at load 0.9, with none, half or all of the queried keys
members (a member found in its primary bucket needs one bucket, the
others two), and on batches of 0, 1 and 2 keys. The CUDA kernel is held
against the plain version on the card by ``tests/test_torch_gpu.py``.
"""
import jax
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

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

GEOMS = list(TK.INSTANCES)
GEOM_IDS = [f"u{sb}x{spb}" for sb, spb in GEOMS]
N_QUERIES = 600
SHARES = (0.0, 0.5, 1.0)
J_CONTAINS = jax.jit(JF.cuckoo_contains, static_argnums=0)
J_COOP = jax.jit(JF.cuckoo_contains_coop, static_argnums=0)


def _specs(slot_bits, spb, n_buckets):
    kw = dict(m_bits=n_buckets * spb * slot_bits, k=2, slot_bits=slot_bits,
              slots_per_bucket=spb)
    return JV.FilterSpec("cuckoo", **kw), TV.FilterSpec("cuckoo", **kw)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_contains_matches_jax_at_member_shares(geom):
    sb, spb = geom
    n_buckets = 2048 // spb                    # 2048 slots
    js, ts = _specs(sb, spb, n_buckets)
    stored = JH.random_u64x2(int(0.9 * 2048), seed=60 + sb + spb)
    table, ok = TF.cuckoo_add(ts, TF.init(ts), as_keys(stored))
    jtable = jnp.asarray(table.numpy().view(np.uint32))
    probes = JH.probe_u64x2(N_QUERIES, seed=70 + spb)
    for share in SHARES:
        m = int(share * N_QUERIES)
        q = np.concatenate([stored[:m], probes[:N_QUERIES - m]])
        want = np.asarray(J_CONTAINS(js, jtable, jnp.asarray(q)))
        np.testing.assert_array_equal(
            np.asarray(J_COOP(js, jtable, jnp.asarray(q))), want)
        for coop in TK.COOPS:
            np.testing.assert_array_equal(
                TK.contains_vmem(ts, table, as_keys(q), coop).numpy(), want,
                err_msg=f"share {share} coop {coop}")
        # no false negative but one a failed insert (its victim)
        assert int((~want[:m]).sum()) <= int((~ok).sum())


def test_contains_tiny_batches():
    js, ts = _specs(16, 4, 512)
    stored = JH.random_u64x2(1500, seed=5)
    table, _ = TF.cuckoo_add(ts, TF.init(ts), as_keys(stored))
    q = np.concatenate([stored[:1], JH.probe_u64x2(1, seed=6)])
    want = np.asarray(J_CONTAINS(js, jnp.asarray(
        table.numpy().view(np.uint32)), jnp.asarray(q)))
    for n in (0, 1, 2):
        got = TK.contains_vmem(ts, table, as_keys(q[:n]))
        assert got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want[:n])
