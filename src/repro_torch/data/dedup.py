"""Bloom-filter training-data dedup — the paper's technique as a pipeline stage.

Counterpart of ``repro.data.dedup``. Each document is folded to a 64-bit
signature (numpy, host-side) and tested against / inserted into a Bloom
filter via the **bulk** contains/add ops the paper optimizes. The filter is
a :class:`repro_torch.api.Filter` on ``device`` (``None`` = the card), so
the same stage runs on any registry engine; documents are buffered and
deduped in bulk (amortizing kernel launches exactly as the paper's bulk
APIs do). What the card answers comes back through ``.cpu().numpy()``.

Bloom semantics for dedup: a false positive drops a *unique* document
(bounded by the filter's FPR — pick c accordingly); a false negative never
happens, so no duplicate is ever *guaranteed* through. Near-duplicates are
out of scope (signature equality = exact token match).

Three deployment shapes:

* :class:`DedupFilter` — insert-only, exact over the whole corpus; right
  when the corpus is bounded and sized for up front.
* :class:`StreamingDedupFilter` — **sliding-window dedup with eviction**
  over a :class:`repro_torch.window.WindowedFilter` generation ring (or a
  cuckoo filter with per-key removes): duplicates are dropped only while
  their first occurrence is within the last ``window_docs`` documents, so
  memory and FPR stay bounded on an *unbounded* stream.
* :class:`TenantDedupFilter` — **per-tenant dedup over a filter bank**:
  tenant t's documents dedup only against tenant t's history; each batch
  is ONE routed ``contains(keys, tenants)`` + ONE valid-masked routed
  ``add``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch import api
from repro_torch.window import WindowedFilter


def doc_signature(tokens: np.ndarray) -> np.ndarray:
    """Fold a token array to a u64x2 signature (2 independent 32-bit mixes)."""
    t = np.asarray(tokens, dtype=np.uint32)
    h1 = np.uint32(0x811C9DC5)
    h2 = np.uint32(0x9E3779B9)
    with np.errstate(over="ignore"):
        # vectorized polynomial fold: h = sum t_i * P^i  (two prime bases),
        # then avalanche. Associative-friendly and order-sensitive.
        p1 = np.uint32(16777619)
        p2 = np.uint32(2246822519)
        w1 = np.cumprod(np.full(len(t), p1, np.uint32))
        w2 = np.cumprod(np.full(len(t), p2, np.uint32))
        h1 = h1 + np.uint32(np.sum(t * w1, dtype=np.uint64) & np.uint64(0xFFFFFFFF))
        h2 = h2 + np.uint32(np.sum(t * w2, dtype=np.uint64) & np.uint64(0xFFFFFFFF))
        h1 ^= np.uint32(len(t)); h1 *= np.uint32(2654435761); h1 ^= h1 >> np.uint32(16)
        h2 ^= np.uint32(len(t)); h2 *= np.uint32(3266489917); h2 ^= h2 >> np.uint32(15)
    return np.array([h1, h2], dtype=np.uint32)


def doc_signatures_batch(docs) -> np.ndarray:
    """Vectorized (n, 2) u64x2 signatures for a list of token arrays.

    Bit-exact with per-doc ``doc_signature``: zero-padding beyond each doc's
    length contributes nothing to the polynomial fold, and the length is
    mixed in explicitly."""
    n = len(docs)
    lens = np.array([len(d) for d in docs], np.uint32)
    L = max(int(lens.max()), 1)
    mat = np.zeros((n, L), np.uint32)
    for i, d in enumerate(docs):
        mat[i, : len(d)] = np.asarray(d, dtype=np.uint32)
    with np.errstate(over="ignore"):
        w1 = np.cumprod(np.full(L, 16777619, np.uint32))
        w2 = np.cumprod(np.full(L, 2246822519, np.uint32))
        h1 = np.uint32(0x811C9DC5) + (
            (mat * w1).sum(axis=1, dtype=np.uint64)
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        h2 = np.uint32(0x9E3779B9) + (
            (mat * w2).sum(axis=1, dtype=np.uint64)
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        h1 ^= lens; h1 *= np.uint32(2654435761); h1 ^= h1 >> np.uint32(16)
        h2 ^= lens; h2 *= np.uint32(3266489917); h2 ^= h2 >> np.uint32(15)
    return np.stack([h1, h2], axis=-1)


def ngram_signatures(tokens: np.ndarray, n: int = 8, stride: int = 4
                     ) -> np.ndarray:
    """(k, 2) u64x2 signatures of overlapping n-grams (contamination checks)."""
    t = np.asarray(tokens, dtype=np.uint32)
    if len(t) < n:
        return doc_signature(t)[None]
    starts = range(0, len(t) - n + 1, stride)
    return np.stack([doc_signature(t[s: s + n]) for s in starts])


@dataclasses.dataclass
class DedupStats:
    seen: int = 0
    dropped: int = 0

    @property
    def drop_rate(self) -> float:
        return self.dropped / max(self.seen, 1)


class DedupFilter:
    """Bulk Bloom dedup over a document stream."""

    def __init__(self, expected_docs: int = 1 << 20, bits_per_key: float = 16.0,
                 variant: str = "sbf", block_bits: int = 256,
                 backend: str = "auto", batch_docs: int = 256, device=None,
                 **backend_kw):
        self.filt = api.filter_for_n_items(expected_docs, bits_per_key,
                                           variant=variant,
                                           block_bits=block_bits,
                                           backend=backend, device=device,
                                           **backend_kw)
        self.batch_docs = batch_docs
        self.stats = DedupStats()

    def filter_stream(self, docs: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        buf: List[np.ndarray] = []
        for doc in docs:
            buf.append(doc)
            if len(buf) >= self.batch_docs:
                yield from self._flush(buf)
                buf = []
        if buf:
            yield from self._flush(buf)

    def _flush(self, docs: List[np.ndarray]):
        sigs = doc_signatures_batch(docs)                        # (n, 2)
        # bulk lookup, then bulk insert of the new ones (paper's bulk ops)
        present = self.filt.contains(sigs).cpu().numpy()
        fresh_idx = np.nonzero(~present)[0]
        if len(fresh_idx):
            # de-dup *within* the batch as well (first occurrence wins)
            seen_in_batch = {}
            keep = []
            for i in fresh_idx:
                key = sigs[i].tobytes()
                if key not in seen_in_batch:
                    seen_in_batch[key] = True
                    keep.append(i)
            # pad to the batch capacity (OR is idempotent) -> stable shapes,
            # the JAX package's shapes
            add_sigs = sigs[np.array(keep)]
            pad = self.batch_docs - len(add_sigs)
            if pad > 0:
                add_sigs = np.concatenate(
                    [add_sigs, np.repeat(add_sigs[-1:], pad, axis=0)])
            self.filt = self.filt.add(add_sigs)
            kept = set(keep)
        else:
            kept = set()
        self.stats.seen += len(docs)
        self.stats.dropped += len(docs) - len(kept)
        for i in sorted(kept):
            yield docs[i]


@dataclasses.dataclass
class StreamingDedupStats(DedupStats):
    advances: int = 0     # generations retired (evictions happen here)


class StreamingDedupFilter:
    """Sliding-window dedup over an unbounded stream, with eviction.

    Two eviction engines behind one stream interface:

    * ``engine="window"`` (default) — a
      :class:`repro_torch.window.WindowedFilter`
      generation ring: signatures land in the head generation, lookups OR
      the ring in one fused pass, and every ``window_docs / generations``
      admitted documents the ring advances, retiring the oldest
      generation (an *age class*) in O(1).
    * ``engine="cuckoo"`` — a fingerprint filter (``variant="cuckoo"``):
      the window's signatures are deleted *per key* via
      ``Filter.remove`` instead of by age-class rotation. One table
      (~slot_bits/0.95 bits per live key — no G-generation replication,
      half to a quarter of a 4-bit counting filter), and eviction is
      exact: a retired signature is individually cleared, not ORed away
      with its whole generation. The stage keeps the retiring
      generation's signatures host-side (it must know *what* to delete —
      the fingerprint filter trades that bookkeeping for the memory).

    Memory and FPR are stationary on an unbounded stream either way.
    Within the live window the no-false-negative guarantee holds: a
    duplicate of a document seen fewer than ``window_docs`` (at least
    ``window_docs * (G-1)/G``) documents ago is always dropped.
    """

    def __init__(self, window_docs: int = 1 << 16, generations: int = 4,
                 bits_per_key: float = 16.0, variant: str = "sbf",
                 block_bits: int = 256, batch_docs: int = 256,
                 engine: str = "window", device=None):
        if engine not in ("window", "cuckoo"):
            raise ValueError(f"engine must be 'window' or 'cuckoo': {engine}")
        self.engine = engine
        self.generations = generations
        self.batch_docs = batch_docs
        self.advance_every = max(window_docs // generations, 1)
        self._since_advance = 0
        self.stats = StreamingDedupStats()
        if engine == "window":
            self.window = WindowedFilter.for_window(
                window_docs, bits_per_key=bits_per_key,
                generations=generations, variant=variant,
                block_bits=block_bits, device=device)
        else:
            # live load peaks at the full window plus the not-yet-retired
            # newest generation; size the table so that stays under the
            # 0.95 achievable load factor
            self.filt = api.filter_for_n_items(
                window_docs + self.advance_every, bits_per_key=bits_per_key,
                variant="cuckoo", device=device)
            self._gens: List[List[np.ndarray]] = []   # admitted, oldest first
            self._cur: List[np.ndarray] = []          # filling generation

    def filter_stream(self, docs: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        buf: List[np.ndarray] = []
        for doc in docs:
            buf.append(doc)
            if len(buf) >= self.batch_docs:
                yield from self._flush(buf)
                buf = []
        if buf:
            yield from self._flush(buf)

    def _contains(self, sigs: np.ndarray) -> np.ndarray:
        filt = self.window if self.engine == "window" else self.filt
        return filt.contains(sigs).cpu().numpy()

    def _admit(self, add_sigs: np.ndarray):
        pad = self.batch_docs - len(add_sigs)
        if self.engine == "window":
            # ring generations are bit filters: repeat-key padding stays
            # OR-idempotent (the JAX package's stable shapes)
            if pad > 0:
                add_sigs = np.concatenate(
                    [add_sigs, np.repeat(add_sigs[-1:], pad, axis=0)])
            self.window = self.window.add(add_sigs)
            return
        # fingerprint inserts are NOT idempotent: pad with a validity mask
        valid = np.zeros(max(self.batch_docs, len(add_sigs)), np.uint8)
        valid[: len(add_sigs)] = 1
        if pad > 0:
            add_sigs = np.concatenate(
                [add_sigs, np.zeros((pad, 2), np.uint32)])
        self.filt = self.filt.add(add_sigs, valid=valid)
        self._cur.append(add_sigs[valid.astype(bool)])

    def _advance(self):
        """Retire the oldest generation: ring rotation, or per-key
        fingerprint deletion of exactly the signatures it admitted.

        Mirrors the ring's shape: after an advance the live window is the
        (empty) head plus ``generations - 1`` completed age classes."""
        if self.engine == "window":
            self.window = self.window.advance()
            return
        self._gens.append(self._cur)
        self._cur = []
        while len(self._gens) > self.generations - 1:
            old = self._gens.pop(0)
            if not old:
                continue
            sigs = np.concatenate(old)
            # pad to the next pow2 (as the JAX package) with a valid mask —
            # fingerprint removes are not idempotent either
            cap = 1 << max(int(np.ceil(np.log2(max(len(sigs), 1)))), 3)
            valid = np.zeros(cap, np.uint8)
            valid[: len(sigs)] = 1
            sigs = np.concatenate(
                [sigs, np.zeros((cap - len(sigs), 2), np.uint32)])
            self.filt = self.filt.remove(sigs, valid=valid)

    def _flush(self, docs: List[np.ndarray]):
        sigs = doc_signatures_batch(docs)                        # (n, 2)
        present = self._contains(sigs)
        fresh_idx = np.nonzero(~present)[0]
        kept = set()
        if len(fresh_idx):
            seen_in_batch = {}
            keep = []
            for i in fresh_idx:
                key = sigs[i].tobytes()
                if key not in seen_in_batch:
                    seen_in_batch[key] = True
                    keep.append(i)
            self._admit(sigs[np.array(keep)])
            kept = set(keep)
        self.stats.seen += len(docs)
        self.stats.dropped += len(docs) - len(kept)
        # advance on *admitted* docs: the window is measured in kept load
        self._since_advance += len(kept)
        while self._since_advance >= self.advance_every:
            self._advance()
            self.stats.advances += 1
            self._since_advance -= self.advance_every
        for i in sorted(kept):
            yield docs[i]


class TenantDedupFilter:
    """Per-tenant bulk dedup over one filter bank
    (:func:`repro_torch.api.filter_for_n_items` with ``bank=``).

    Every document carries a tenant id in ``[0, n_tenants)``; a duplicate
    is dropped only if the *same tenant* saw the signature before. The
    whole batch runs as one routed bank lookup plus one valid-masked
    routed bank add (tenant routing composed into the kernel's member
    offset on native engines — no scatter, no host loop). The sharded
    bank of the JAX package (``backend="sharded", mesh=...``) comes with
    the distributed engines (ROADMAP queue 1, item 14).
    """

    def __init__(self, n_tenants: int, expected_docs_per_tenant: int = 1 << 14,
                 bits_per_key: float = 16.0, variant: str = "sbf",
                 block_bits: int = 256, backend: str = "auto",
                 batch_docs: int = 256, engine: Optional[str] = None,
                 device=None, **backend_kw):
        if engine == "cuckoo":
            # fingerprint bank: per-tenant deletion at ~1x storage becomes
            # available (filt.remove(keys, tenants=...)) and the routed
            # adds below are already valid-masked — the exact padding
            # contract non-idempotent fingerprint inserts require
            variant = "cuckoo"
        elif engine == "counting":
            variant = "countingbf"
        elif engine is not None:
            raise ValueError(
                f"engine must be 'cuckoo', 'counting' or None (insert-only"
                f" bit filters via variant=/backend=): {engine!r}")
        self.filt = api.filter_for_n_items(
            expected_docs_per_tenant, bits_per_key, variant=variant,
            block_bits=block_bits, backend=backend, bank=n_tenants,
            device=device, **backend_kw)
        self.n_tenants = n_tenants
        self.batch_docs = batch_docs
        self.stats = DedupStats()

    def dedupe_batch(self, docs: List[np.ndarray], tenants) -> List[int]:
        """Returns the indices of ``docs`` to keep (first tenant-local
        occurrence of each signature), updating the bank."""
        n = len(docs)
        sigs = doc_signatures_batch(docs)                        # (n, 2)
        t = np.asarray(tenants, np.int64).reshape(n)
        # pad to the batch capacity (the JAX package's stable shapes)
        # (valid-masked adds make zero-padding exact; padded lookups are
        # sliced off by the routed contains itself)
        pad = self.batch_docs - n
        if pad > 0:
            sigs_p = np.concatenate([sigs, np.zeros((pad, 2), np.uint32)])
            t_p = np.concatenate([t, np.zeros(pad, np.int64)])
        else:
            sigs_p, t_p = sigs, t
        present = self.filt.contains(sigs_p, tenants=t_p).cpu().numpy()[:n]
        # in-batch dedup per (tenant, signature): first occurrence wins
        rows = np.concatenate([t[:, None].astype(np.uint32), sigs], axis=1)
        _, first_idx = np.unique(rows, axis=0, return_index=True)
        first = np.zeros(n, bool)
        first[first_idx] = True
        keep = (~present) & first
        valid = np.zeros(self.batch_docs if pad > 0 else n, np.uint8)
        valid[:n] = keep
        self.filt = self.filt.add(sigs_p, tenants=t_p, valid=valid)
        self.stats.seen += n
        self.stats.dropped += int(n - keep.sum())
        return [i for i in range(n) if keep[i]]

    def filter_stream(self, docs_with_tenants: Iterator) -> Iterator:
        """Stream of ``(doc, tenant_id)`` pairs -> kept pairs, batched."""
        buf: List = []
        for pair in docs_with_tenants:
            buf.append(pair)
            if len(buf) >= self.batch_docs:
                yield from self._flush(buf)
                buf = []
        if buf:
            yield from self._flush(buf)

    def _flush(self, pairs: List):
        docs = [d for d, _ in pairs]
        tenants = [t for _, t in pairs]
        for i in self.dedupe_batch(docs, tenants):
            yield pairs[i]
