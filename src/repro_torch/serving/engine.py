"""Batched serving engine: slot-based batching over ``decode_step``.

Counterpart of ``repro.serving.engine``. A fixed pool of B slots shares one
decode step (the whole batch advances together), requests are served in
batch-sized waves, and the KV cache is allocated at ``max_len`` by the
prefill and updated in place by each decode step. An optional
:class:`NGramGuard` applies the paper's filter per step; its counters and
its bank's health are surfaced through :meth:`Engine.stats`.

The JAX engine's semantics are kept as they are: prompts are left-padded
with 0 and nothing masks the padding; greedy sampling takes the first
maximum over the padded vocabulary; a last wave smaller than ``batch``
fails in the guard's ``observe`` (its tokens do not fill the batch).
Everything runs under ``torch.inference_mode()``, on the parameters'
device, in bf16 (the model's default compute dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.ngram_guard import NGramGuard
from repro_torch.telemetry import MetricsRegistry


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    out: Optional[List[int]] = None


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class Engine:
    def __init__(self, model: Model, params, batch: int, max_len: int,
                 guard: Optional[NGramGuard] = None,
                 sample: Callable = greedy_sample,
                 registry: Optional[MetricsRegistry] = None):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.guard = guard
        self.sample = sample
        self.device = params["embed"]["table"].device
        # the serving dashboard surface: pass the service's registry to
        # merge guard metrics into one snapshot, or let the engine own one
        self.registry = registry if registry is not None \
            else MetricsRegistry()

    def _decode(self, params, cache, tokens, pos):
        return self.model.decode_step(params, cache, tokens, pos)

    def stats(self) -> Dict[str, float]:
        """Namespaced serving-health snapshot (``guard.*`` keys), synced
        into the engine's telemetry registry: guard counters as counters,
        the guard filter's health as gauges."""
        if self.guard is not None:
            reg = self.registry
            st = self.guard.stats
            reg.counter("guard.observed").set_total(int(st.observed))
            reg.counter("guard.penalized").set_total(int(st.penalized))
            reg.counter("guard.decays").set_total(int(st.decays))
            h = self.guard.filt.health()
            if "fill_fraction" in h:
                reg.gauge("guard.fill_fraction").set(h["fill_fraction"])
            if "load_factor" in h:
                reg.gauge("guard.load_factor").set(h["load_factor"])
                reg.gauge("guard.insert_failures").set(
                    float(h["insert_failures"]))
            if "head" in h:
                reg.gauge("guard.generations").set(float(h["generations"]))
                reg.gauge("guard.head").set(float(np.max(h["head"])))
            reg.gauge("guard.approx_ngrams").set(float(h["approx_count"]))
        return self.registry.snapshot(prefix="guard.")

    def stats_legacy(self) -> Dict[str, float]:
        """DEPRECATED flat ``guard_*`` stats dict; use :meth:`stats`."""
        import warnings
        warnings.warn("Engine.stats_legacy() is deprecated; use stats() "
                      "(namespaced telemetry snapshot)",
                      DeprecationWarning, stacklevel=2)
        st = self.stats()
        legacy_names = {"guard.fill_fraction": "guard_fill"}
        return {legacy_names.get(k, k.replace(".", "_")): float(v)
                for k, v in st.items()}

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Process requests in batch-sized waves (prompts left-padded)."""
        results: List[List[int]] = []
        for i in range(0, len(requests), self.batch):
            wave = requests[i: i + self.batch]
            with torch.inference_mode():
                results.extend(self._run_wave(wave))
        return results

    def _run_wave(self, wave: List[Request]) -> List[List[int]]:
        B = self.batch
        S = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, S), np.int32)
        for j, r in enumerate(wave):
            toks[j, S - len(r.prompt):] = r.prompt    # left-pad
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(toks, device=self.device)},
            max_len=self.max_len)
        max_new = max(r.max_new_tokens for r in wave)
        outs = [[] for _ in wave]
        pos = S
        for step in range(max_new):
            if self.guard is not None:
                logits = self.guard.penalize(logits)
            cur = self.sample(logits)
            host = cur.cpu().numpy()
            if self.guard is not None:
                self.guard.observe(cur[:len(wave)])
            for j in range(len(wave)):
                if step < wave[j].max_new_tokens:
                    outs[j].append(int(host[j]))
            logits, cache = self._decode(self.params, cache, cur[:, None],
                                         pos)
            pos += 1
        return outs
