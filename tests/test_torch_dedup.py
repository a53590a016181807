"""The port's dedup stages and data pipeline against the JAX package's, on
the CPU.

The same seeded synthetic corpus (``repro.data.pipeline.synthetic_corpus``)
goes through each stage of both packages: ``DedupFilter``, both engines of
``StreamingDedupFilter`` (the generation ring and the cuckoo filter with
per-key removes), ``TenantDedupFilter`` on its three engines and
``deduped_batches``. The kept documents, the stats and the filters' words
(through ``interop.to_jax_words``) must be equal: tolerance 0. The JAX side
runs the engines that trace under jax 0.9 (``jnp`` for the blocked
filters, ``windowed``, ``cuckoo`` and ``counting``), as the earlier port
tests do; on the CPU the port runs its plain versions. The stages on the
card are held against the plain engine there by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import dedup as JD
from repro.data import pipeline as JP
from repro_torch import interop
from repro_torch.data import dedup as TD
from repro_torch.data import pipeline as TP

# xdist runs several workers on one host: one intra-op thread each
torch.set_num_threads(1)

CORPUS = JP.CorpusConfig(n_docs=320, dup_fraction=0.3, doc_len_min=8,
                         doc_len_max=64, seed=5)


def _docs(cfg=CORPUS):
    return list(JP.synthetic_corpus(cfg))


def _same_docs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _stats(f):
    return dataclasses.asdict(f.stats)


def _u32(x):
    return np.asarray(x).view(np.uint32)


def test_signatures_match_jax():
    docs = _docs()[:40] + [np.zeros(0, np.int32), np.arange(3)]
    np.testing.assert_array_equal(TD.doc_signatures_batch(docs),
                                  JD.doc_signatures_batch(docs))
    for d in docs[:5]:
        np.testing.assert_array_equal(TD.doc_signature(d),
                                      JD.doc_signature(d))
        np.testing.assert_array_equal(TD.ngram_signatures(d, 8, 4),
                                      JD.ngram_signatures(d, 8, 4))
    short = np.arange(5)
    np.testing.assert_array_equal(TD.ngram_signatures(short),
                                  JD.ngram_signatures(short))
    assert TD.DedupStats(seen=8, dropped=2).drop_rate == 0.25
    assert TD.DedupStats().drop_rate == 0.0


def test_dedup_filter_matches_jax():
    docs = _docs()
    jf = JD.DedupFilter(expected_docs=2048, batch_docs=64, backend="jnp")
    tf = TD.DedupFilter(expected_docs=2048, batch_docs=64, device="cpu")
    assert tf.filt.backend == "torch"
    jkept = list(jf.filter_stream(iter(docs)))
    tkept = list(tf.filter_stream(iter(docs)))
    _same_docs(tkept, jkept)
    assert _stats(tf) == _stats(jf) and tf.stats.dropped > 0
    np.testing.assert_array_equal(interop.to_jax_words(tf.filt)[1],
                                  _u32(jf.filt.words))
    # no exact duplicate survives
    sigs = TD.doc_signatures_batch(tkept)
    assert len(np.unique(sigs, axis=0)) == len(tkept)


@pytest.mark.parametrize("engine", ["window", "cuckoo"])
def test_streaming_dedup_matches_jax(engine):
    docs = _docs()
    kw = dict(window_docs=96, generations=3, batch_docs=32, engine=engine)
    jf = JD.StreamingDedupFilter(**kw)
    tf = TD.StreamingDedupFilter(device="cpu", **kw)
    jkept = list(jf.filter_stream(iter(docs)))
    tkept = list(tf.filter_stream(iter(docs)))
    _same_docs(tkept, jkept)
    assert _stats(tf) == _stats(jf) and tf.stats.advances >= 3
    if engine == "window":
        np.testing.assert_array_equal(_u32(tf.window.rings.numpy()),
                                      _u32(jf.window.rings))
        assert tf.window.head == int(jf.window.head)
    else:
        assert tf.filt.backend == "cuckoo"
        _, words, fails = interop.to_jax_words(tf.filt)
        np.testing.assert_array_equal(words, _u32(jf.filt.words))
        np.testing.assert_array_equal(fails, _u32(jf.filt.state))
        assert len(tf._gens) == len(jf._gens)


@pytest.mark.parametrize("engine", [None, "cuckoo", "counting"])
def test_tenant_dedup_matches_jax(engine):
    docs = _docs()
    T = 4
    pairs = [(d, (i * 7) % T) for i, d in enumerate(docs)]
    kw = dict(expected_docs_per_tenant=256, batch_docs=48, engine=engine)
    jf = JD.TenantDedupFilter(T, backend="jnp" if engine is None else "auto",
                              **kw)
    tf = TD.TenantDedupFilter(T, device="cpu", **kw)
    assert tf.filt.bank_shape == (T,)
    jkept = list(jf.filter_stream(iter(pairs)))
    tkept = list(tf.filter_stream(iter(pairs)))
    assert [t for _, t in tkept] == [t for _, t in jkept]
    _same_docs([d for d, _ in tkept], [d for d, _ in jkept])
    assert _stats(tf) == _stats(jf) and tf.stats.dropped > 0
    np.testing.assert_array_equal(interop.to_jax_words(tf.filt)[1],
                                  _u32(jf.filt.words))
    # a short batch (padded to the capacity) keeps the same indices
    extra = [d for d, _ in pairs[:5]] + [np.arange(2, 30, dtype=np.int32)]
    ten = [0, 1, 0, 2, 3, 3]
    assert tf.dedupe_batch(extra, ten) == jf.dedupe_batch(extra, ten)


def test_deduped_batches_match_jax():
    cfg = JP.CorpusConfig(n_docs=200, dup_fraction=0.3, doc_len_min=8,
                          doc_len_max=48, seed=9)
    tcfg = TP.CorpusConfig(n_docs=200, dup_fraction=0.3, doc_len_min=8,
                           doc_len_max=48, seed=9)
    want = list(JP.deduped_batches(cfg, batch_size=4, seq_len=32,
                                   backend="jnp"))
    got = list(TP.deduped_batches(tcfg, batch_size=4, seq_len=32,
                                  device="cpu"))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (4, 32)
        np.testing.assert_array_equal(g, w)
    # the pipeline's pieces on their own
    _same_docs(list(TP.synthetic_corpus(tcfg, shard=1, num_shards=2)),
               list(JP.synthetic_corpus(cfg, shard=1, num_shards=2)))
    docs = _docs()[:30]
    for g, w in zip(TP.batches(iter(docs), 3, 40),
                    JP.batches(iter(docs), 3, 40)):
        np.testing.assert_array_equal(g, w)
