"""Decode-time n-gram repetition guard — the paper's filter in the serve loop.

Counterpart of ``repro.serving.ngram_guard``. Per decode step, the guard
(1) records the n-gram ending at the newly emitted token into a Bloom
filter, and (2) before the next sampling step, bulk-tests the top-K
candidate continuations: any candidate that would complete an already-seen
n-gram gets a logit penalty.

**Bank layout.** The guard holds a per-sequence
:func:`repro_torch.api.make_filter_bank`: sequence b owns member b of a
B-member bank, so sequences never alias each other's n-grams. ``observe``
is one bank add of (B, 1) valid-masked keys; ``penalize`` one bank contains
of (B, K) candidate keys: on the card one launch each of the bank kernels
(``cuda-l2``/``cuda-dram``: the blocked bank add and contains; the counting
engine: its bank update and contains). Hashing is
``core.hashing.mix_rows`` on the device; the ``-1`` warm-up history wraps
to ``0xFFFFFFFF`` as in the JAX package's ``astype(uint32)``.

False positives penalize a novel n-gram (harmless, sampling just shifts);
false negatives never happen, so true loops are always caught.

**Time-decayed mode** (``decay_every=D``): the counting engine
(variant='countingbf') with one uniform ``decay()`` of the whole bank every
D observed decode steps, so a long-running serve loop never saturates the
filter.

The counters stay device tensors; only :attr:`NGramGuard.stats` syncs.
The top-K candidates are the first K of a stable descending sort, which
orders equal logits by index as ``jax.lax.top_k`` does (``torch.topk``
promises no order among ties), and -0.0 below +0.0 as XLA's total order
does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import api, resolve_device
from repro_torch.core import hashing as H


@dataclasses.dataclass
class GuardStats:
    observed: int = 0
    penalized: int = 0
    decays: int = 0


_SIGNED = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def top_k_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) indices of each row's k largest logits in ``jax.lax.top_k``'s
    order: floats in their total order (-0.0 below +0.0, NaN on top), ties
    by index. The sort runs on the integer key of that order."""
    bits = logits.view(_SIGNED[logits.element_size()])
    mag = torch.iinfo(bits.dtype).max
    key = torch.where(bits < 0, bits ^ mag, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :k]


class NGramGuard:
    """One guard serves a whole decode batch: a B-member filter bank, one
    member per sequence, on ``device`` (``None`` = the card).

    ``m_bits`` is the TOTAL guard budget; each member gets the largest
    power-of-two slice of it (floor 2^10). ``decay_every=D`` enables the
    time-decayed mode (see the module docstring)."""

    def __init__(self, batch: int, n: int = 4, m_bits: int = 1 << 18,
                 top_k: int = 64, penalty: float = -1e9,
                 backend: str = "auto", decay_every: Optional[int] = None,
                 device=None):
        self.n = n
        self.batch = batch
        self.top_k = top_k
        self.penalty = penalty
        self.decay_every = decay_every
        self.device = resolve_device(device)
        m_member = 1 << max(10, int(np.log2(max(m_bits // batch, 1))))
        variant = "countingbf" if decay_every else "sbf"
        self.filt = api.make_filter_bank(batch, variant, m_bits=m_member,
                                         k=8, block_bits=256, backend=backend,
                                         device=self.device)
        # rolling buffer of the last n-1 tokens per sequence (on the device)
        self.hist = torch.full((batch, n - 1), -1, dtype=torch.int32,
                               device=self.device)
        self._observed = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self._penalized = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._decays = 0
        self._obs_steps = 0
        self._steps_since_decay = 0

    @property
    def stats(self) -> GuardStats:
        """Host view of the device-side counters (the only place the guard
        synchronizes with the device)."""
        return GuardStats(observed=int(self._observed),
                          penalized=int(self._penalized),
                          decays=self._decays)

    def observe(self, tokens):
        """Record the n-gram completed by ``tokens`` (B,) and roll history."""
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.reshape(self.batch).to(device=self.device,
                                                   dtype=torch.int32)
        else:
            tokens = torch.as_tensor(
                np.asarray(tokens).reshape(self.batch).astype(np.int32),
                device=self.device)
        # history is full from observe number n-1 on: a host-derivable
        # fact, so the decay cadence needs no device sync
        ready_any = self._obs_steps >= self.n - 1
        self._obs_steps += 1
        hist = self.hist
        full = torch.cat([hist, tokens[:, None]], dim=1)
        keys = H.mix_rows(full)                              # (B, 2)
        ready = (hist >= 0).all(dim=1)                       # (B,)
        self.filt = self.filt.add(keys[:, None, :], valid=ready[:, None])
        self.hist = torch.cat([hist[:, 1:], tokens[:, None]], dim=1)
        self._observed = self._observed + ready.sum(dtype=torch.int32)
        if self.decay_every and ready_any:
            self._steps_since_decay += 1
            if self._steps_since_decay >= self.decay_every:
                self.filt = self.filt.decay()
                self._decays += 1
                self._steps_since_decay = 0

    def penalize(self, logits) -> torch.Tensor:
        """logits (B, V): penalize the top-K candidates completing a seen
        n-gram (each sequence consults only its own bank member)."""
        logits = torch.as_tensor(logits).to(self.device)
        B = logits.shape[0]
        hist = self.hist
        top_idx = top_k_indices(logits, self.top_k)                 # (B, K)
        histb = hist[:, None, :].expand(B, self.top_k, hist.shape[1])
        rows = torch.cat([histb, top_idx[:, :, None].to(torch.int32)],
                         dim=-1)
        keys = H.mix_rows(rows)                                     # (B, K, 2)
        hits = self.filt.contains(keys)                             # (B, K)
        ready = (hist >= 0).all(dim=1)
        hits = hits & ready[:, None]
        pen = torch.where(hits, self.penalty, 0.0).to(logits.dtype)
        self._penalized = self._penalized + hits.sum(dtype=torch.int32)
        # JAX adds a scatter of ``pen`` into zeros to the logits. For f32
        # XLA folds that into one scatter-add onto the logits, so a -0.0
        # logit outside the top K stays -0.0; for bf16 it adds in f32 and
        # rounds, as PyTorch's bf16 add does, and -0.0 + 0.0 gives +0.0
        if logits.dtype == torch.float32:
            return logits.scatter_add(1, top_idx, pen)
        return logits + torch.zeros_like(logits).scatter_add_(1, top_idx,
                                                                pen)
