"""Decoder-only LM, generic over per-layer block types.

Counterpart of ``repro.models.transformer`` for the ``"attn"`` (global
causal GQA) and ``"local_attn"`` (sliding window) blocks with a dense MLP,
and the vision/audio ``prefix`` stub. The other block types (``"rglru"``,
``"rwkv"``, ``"attn_cross"``) and MoE FFNs raise ``NotImplementedError``:
they come with the rest of ROADMAP queue 1, item 15.

Layer order is the JAX package's: the ``n_dense_head`` head layers, then
``n_groups`` repeats of ``block_pattern``, then the tail (``_layer_plan``).
The JAX package scans the groups over stacked parameters to keep its HLO
small; eager PyTorch has nothing to compile, so the port keeps one flat
list ``params["layers"]`` in that order and runs it in a Python loop
(``interop.params_from_jax`` slices the stacked JAX leaves into it).

Three execution modes share the block code:
    train   — full sequence, no cache;
    prefill — full sequence, returns per-layer caches;
    decode  — one token against the caches, which it updates in place.

A global-attention cache is ``{"k", "v"}`` of ``(B, max_len, KV, hd)``; a
local one the ring ``{"k", "v"}`` of ``(B, window, KV, hd)`` with ``rpos``,
the absolute position each ring slot holds (-1 = empty).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

ATTN_BLOCKS = ("attn", "local_attn")
LATER = ("ROADMAP queue 1, item 15 (models/moe.py, models/recurrent.py, "
         "models/encdec.py)")


def _check_block(cfg: ArchConfig, btype: str, use_moe: bool) -> None:
    if btype not in ATTN_BLOCKS:
        raise NotImplementedError(
            f"block type {btype!r} is not ported yet: {LATER}")
    if use_moe:
        raise NotImplementedError(f"MoE FFNs are not ported yet: {LATER}")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run yet."""
    if cfg.is_encdec:
        raise NotImplementedError(f"enc-dec models are not ported yet: "
                                  f"{LATER}")
    for i, t in enumerate(layer_types(cfg)):
        _check_block(cfg, t, cfg.moe is not None and i >= cfg.n_dense_head)


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------

def block_init(generator, cfg: ArchConfig, btype: str, use_moe: bool,
               dtype=torch.float32, device=None):
    _check_block(cfg, btype, use_moe)
    norm_init, _ = L.make_norm(cfg.norm)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    return {"norm1": norm_init(d, **kw),
            "attn": A.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                hd, qkv_bias=cfg.qkv_bias, **kw),
            "norm2": norm_init(d, **kw),
            "mlp": L.mlp_init(generator, d, cfg.d_ff, cfg.mlp, **kw)}


# ---------------------------------------------------------------------------
# Cache init (for decode from an empty cache)
# ---------------------------------------------------------------------------

def block_cache_init(cfg: ArchConfig, btype: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None):
    _check_block(cfg, btype, False)
    device = L.init_device(device)
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    if btype == "attn":
        shape = (batch, max_len, kv, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    w = cfg.window
    return {"k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
            "rpos": torch.full((w,), -1, dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Block apply — shared by train / prefill / decode
# ---------------------------------------------------------------------------

def block_apply(p, x, btype: str, cfg: ArchConfig, *, cos_sin,
                mode: str = "train", cache=None, pos=None,
                attn_schedule: str = "scan", q_offset=0,
                max_len: Optional[int] = None):
    """Apply one block. Returns (x, cache): decode updates ``cache`` in
    place and returns it, prefill returns the harvested cache, train
    returns None."""
    _, norm = L.make_norm(cfg.norm)
    hd = cfg.resolved_head_dim
    h = norm(p["norm1"], x)
    q, k, v = A.qkv_project(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, hd)
    cos, sin = cos_sin
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    new_cache = None
    if mode == "decode":
        if btype == "local_attn":
            slot = pos % cfg.window
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            cache["rpos"][slot] = pos
            att = A.sdpa_decode_ring(q, cache["k"], cache["v"],
                                     cache["rpos"], pos, cfg.window)
        else:
            # a write past the cache lands on its last row, as JAX's
            # dynamic_update_slice clamps its start
            at = min(max(pos, 0), cache["k"].shape[1] - 1)
            cache["k"][:, at] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, at] = v[:, 0].to(cache["v"].dtype)
            att = A.sdpa_decode(q, cache["k"], cache["v"], pos + 1)
        new_cache = cache
    elif btype == "local_attn":
        att = A.sdpa_local(q, k, v, window=cfg.window, q_offset=q_offset)
    else:
        att = A.sdpa(q, k, v, causal=True, q_offset=q_offset,
                     schedule=attn_schedule)
    B, S = x.shape[0], x.shape[1]
    att = att.reshape(B, S, cfg.n_heads * hd) @ p["attn"]["wo"].to(x.dtype)
    x = x + att
    h2 = norm(p["norm2"], x)
    x = x + L.mlp_apply(p["mlp"], h2, cfg.mlp)
    if mode == "prefill":
        new_cache = _harvest_attn_cache(cfg, btype, k, v, max_len=max_len)
    return x, new_cache


def _harvest_attn_cache(cfg, btype, k, v, max_len=None):
    """Build the decode cache from prefill-computed K/V (post-RoPE).

    Global-attention caches are padded out to ``max_len`` so the decode
    steps can extend them in place."""
    B, S = k.shape[0], k.shape[1]
    if btype == "local_attn":
        w = cfg.window
        # ring slot j holds the latest position p < S with p % w == j
        j = torch.arange(w, device=k.device)
        last = S - 1 - ((S - 1 - j) % w)
        filled = (j < S) if S < w else torch.ones((w,), dtype=torch.bool,
                                                  device=k.device)
        idx = torch.clamp(last, 0, S - 1)
        keep = filled[None, :, None, None]
        rk = torch.where(keep, k[:, idx], torch.zeros((), dtype=k.dtype,
                                                      device=k.device))
        rv = torch.where(keep, v[:, idx], torch.zeros((), dtype=v.dtype,
                                                      device=v.device))
        rpos = torch.where(filled, last, -1).to(torch.int32)
        return {"k": rk, "v": rv, "rpos": rpos}
    if max_len is not None and max_len > S:
        pad = torch.zeros((B, max_len - S) + tuple(k.shape[2:]),
                          dtype=k.dtype, device=k.device)
        k, v = torch.cat([k, pad], dim=1), torch.cat([v, pad], dim=1)
    return {"k": k.contiguous(), "v": v.contiguous()}


# ---------------------------------------------------------------------------
# Parameter init for the whole LM
# ---------------------------------------------------------------------------

def layer_types(cfg: ArchConfig) -> List[str]:
    """The block type of each entry of ``params["layers"]``, in order:
    head, then ``n_groups`` x pattern, then tail (JAX's ``_layer_plan``)."""
    head, pattern, n_groups, tail = _layer_plan(cfg)
    return head + pattern * n_groups + tail


def _layer_plan(cfg: ArchConfig):
    """(head_types, pattern, n_groups, tail_types), as in the JAX package."""
    types = list(cfg.layer_types())
    head = types[: cfg.n_dense_head]
    rest = types[cfg.n_dense_head:]
    p = len(cfg.block_pattern)
    n_groups = len(rest) // p
    tail = rest[n_groups * p:]
    return head, list(cfg.block_pattern), n_groups, tail


def lm_init(generator, cfg: ArchConfig, dtype=torch.float32, device=None):
    check_supported(cfg)
    device = L.init_device(device, generator)
    norm_init, _ = L.make_norm(cfg.norm)
    kw = dict(dtype=dtype, device=device)
    params: Dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.padded_vocab, cfg.d_model, **kw),
        "final_norm": norm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.lm_head_init(generator, cfg.d_model,
                                           cfg.padded_vocab, **kw)
    params["layers"] = [block_init(generator, cfg, t, use_moe=False, **kw)
                        for t in layer_types(cfg)]
    return params


def lm_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    return [block_cache_init(cfg, t, batch, max_len, dtype, device)
            for t in layer_types(cfg)]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, tokens, prefix, compute_dtype):
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    if cfg.tie_embeddings:
        x = x * float(np.sqrt(cfg.d_model))   # a Python scalar: keeps bf16
    if prefix is not None:
        x = torch.cat([prefix.to(compute_dtype), x], dim=1)
    return x


def lm_forward(params, cfg: ArchConfig, tokens, *, prefix=None,
               compute_dtype=torch.bfloat16, attn_schedule: str = "scan",
               mode: str = "train", cache=None, pos=None,
               max_len: Optional[int] = None):
    """Modes: train -> logits; prefill -> (logits, cache); decode ->
    (logits, cache): tokens (B, 1), pos = current length (an int), the
    cache updated in place."""
    types = layer_types(cfg)
    x = _embed_inputs(params, cfg, tokens, prefix, compute_dtype)
    B, S = x.shape[0], x.shape[1]
    if mode == "decode":
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    cos_sin = L.rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
    new_cache = []
    for i, t in enumerate(types):
        c = cache[i] if cache is not None else None
        x, nc = block_apply(params["layers"][i], x, t, cfg, cos_sin=cos_sin,
                            mode=mode, cache=c, pos=pos,
                            attn_schedule=attn_schedule, max_len=max_len)
        new_cache.append(nc)
    _, norm = L.make_norm(cfg.norm)
    x = norm(params["final_norm"], x)
    logits = L.logits_from(params.get("lm_head"), x, params["embed"])
    if mode == "train":
        return logits
    if mode == "decode":
        return logits, cache          # the caller's list, updated in place
    return logits, new_cache
