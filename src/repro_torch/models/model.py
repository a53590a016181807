"""Model facade: init/loss/prefill/decode over the ported architectures.

Counterpart of ``repro.models.model`` for decoder-only models built of
``"attn"`` and ``"local_attn"`` blocks with dense MLPs (the other families
raise ``NotImplementedError``, see ``models.transformer``). Batches:

    {"tokens": (B, S) int}                (+ "prefix" (B, P, D) float)

Loss is next-token NLL with the last position masked (targets are the
left-shifted tokens). The JAX package's ``dist=`` argument (its sharding
context, ``models/dist.py``) comes with the distributed engines (ROADMAP
queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- params ---------------------------------------------------------------
    def init(self, generator, dtype=torch.float32, device=None):
        """Parameters on ``device`` (``None`` = the card), drawn from
        ``generator``, a ``torch.Generator`` on that device."""
        return T.lm_init(generator, self.cfg, dtype=dtype, device=device)

    def param_count(self) -> int:
        """Parameters, counted from shapes on the meta device (nothing is
        allocated)."""
        params = self.init(None, device="meta")
        return sum(math.prod(t.shape) for t in _leaves(params))

    # -- training loss ----------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any], *,
             compute_dtype=torch.bfloat16, attn_schedule: str = "scan"):
        cfg = self.cfg
        T.check_supported(cfg)
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        targets = torch.cat([tokens[:, 1:], torch.zeros(
            (B, 1), dtype=tokens.dtype, device=dev)], dim=1)
        mask = torch.cat([torch.ones((B, S - 1), device=dev),
                          torch.zeros((B, 1), device=dev)], dim=1)
        if "mask" in batch:
            mask = mask * batch["mask"].float()
        prefix = batch.get("prefix")
        logits = T.lm_forward(params, cfg, tokens, prefix=prefix,
                              compute_dtype=compute_dtype, mode="train",
                              attn_schedule=attn_schedule)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        nll = cross_entropy(logits, targets, mask)
        return nll, {"nll": nll, "loss": nll}

    # -- serving ----------------------------------------------------------------
    def prefill(self, params, batch: Dict[str, Any], max_len: int, *,
                compute_dtype=torch.bfloat16):
        logits, cache = T.lm_forward(
            params, self.cfg, batch["tokens"], prefix=batch.get("prefix"),
            compute_dtype=compute_dtype, mode="prefill", max_len=max_len)
        return logits[:, -1], cache

    def decode_step(self, params, cache, tokens, pos: int, *,
                    compute_dtype=torch.bfloat16):
        """tokens (B, 1) int; pos: current sequence length. The cache is
        updated in place (and returned)."""
        logits, cache = T.lm_forward(
            params, self.cfg, tokens, compute_dtype=compute_dtype,
            mode="decode", pos=int(pos), cache=cache)
        return logits[:, -1], cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """An empty decode cache on ``device`` (``None`` = the card)."""
        T.check_supported(self.cfg)
        return T.lm_cache_init(self.cfg, batch, max_len, dtype, device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
