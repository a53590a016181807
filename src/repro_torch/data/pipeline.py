"""Data pipeline: synthetic corpus -> dedup -> packing -> global batches.

Counterpart of ``repro.data.pipeline``. Host-side (numpy) by design: each
process runs this pipeline over its own corpus shard; the Bloom-filter
dedup stage (``repro_torch.data.dedup``, on ``device``) is the paper's
technique wired in as a first-class pipeline stage.

The synthetic corpus deliberately injects near/exact duplicate documents at a
configurable rate so dedup efficacy is measurable (tests + examples).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 10_000
    vocab: int = 32_000
    doc_len_min: int = 32
    doc_len_max: int = 512
    dup_fraction: float = 0.2       # fraction of docs that are exact dups
    zipf_a: float = 1.3             # token distribution skew
    seed: int = 0


def synthetic_corpus(cfg: CorpusConfig, shard: int = 0, num_shards: int = 1
                     ) -> Iterator[np.ndarray]:
    """Yield token arrays (int32). Duplicates repeat earlier docs verbatim
    (possibly across shard boundaries — the realistic hard case for
    distributed dedup)."""
    rng = np.random.RandomState(cfg.seed + 7919 * shard)
    pool: List[np.ndarray] = []
    n_local = cfg.n_docs // num_shards
    for i in range(n_local):
        if pool and rng.rand() < cfg.dup_fraction:
            yield pool[rng.randint(len(pool))]
            continue
        ln = rng.randint(cfg.doc_len_min, cfg.doc_len_max + 1)
        doc = rng.zipf(cfg.zipf_a, size=ln).astype(np.int64)
        doc = (doc % (cfg.vocab - 2)) + 2           # 0=pad, 1=eos reserved
        doc = doc.astype(np.int32)
        pool.append(doc)
        yield doc


EOS = 1
PAD = 0


class Packer:
    """Greedy document packing into fixed (seq_len,) rows with EOS joints."""

    def __init__(self, seq_len: int):
        self.seq_len = seq_len
        self._buf = np.zeros((0,), np.int32)

    def feed(self, doc: np.ndarray) -> List[np.ndarray]:
        joined = np.concatenate([self._buf, doc, [EOS]])
        out = []
        while len(joined) >= self.seq_len:
            out.append(joined[: self.seq_len])
            joined = joined[self.seq_len:]
        self._buf = joined
        return out

    def flush(self) -> Optional[np.ndarray]:
        if len(self._buf) == 0:
            return None
        row = np.full((self.seq_len,), PAD, np.int32)
        row[: len(self._buf)] = self._buf
        self._buf = np.zeros((0,), np.int32)
        return row


def deduped_batches(cfg: CorpusConfig, batch_size: int, seq_len: int,
                    expected_docs: Optional[int] = None,
                    bits_per_key: float = 16.0, backend: str = "auto",
                    shard: int = 0, num_shards: int = 1, device=None,
                    **backend_kw
                    ) -> Iterator[np.ndarray]:
    """corpus -> Bloom dedup -> packing, as one composed stage.

    The dedup filter is a ``repro_torch.api`` filter on ``device`` (``None``
    = the card), so ``backend=`` reaches the whole engine registry."""
    from repro_torch.data.dedup import DedupFilter
    dd = DedupFilter(expected_docs=expected_docs or max(cfg.n_docs, 1024),
                     bits_per_key=bits_per_key, backend=backend,
                     device=device, **backend_kw)
    docs = synthetic_corpus(cfg, shard=shard, num_shards=num_shards)
    yield from batches(dd.filter_stream(docs), batch_size, seq_len)


def batches(doc_iter: Iterator[np.ndarray], batch_size: int, seq_len: int
            ) -> Iterator[np.ndarray]:
    """Pack a doc stream into (batch_size, seq_len) int32 batches."""
    packer = Packer(seq_len)
    rows: List[np.ndarray] = []
    for doc in doc_iter:
        rows.extend(packer.feed(doc))
        while len(rows) >= batch_size:
            yield np.stack(rows[:batch_size])
            rows = rows[batch_size:]
    tail = packer.flush()
    if tail is not None:
        rows.append(tail)
    while len(rows) >= batch_size:
        yield np.stack(rows[:batch_size])
        rows = rows[batch_size:]
