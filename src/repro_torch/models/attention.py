"""Attention: GQA (full/causal), sliding-window local, decode-with-cache.

Counterpart of ``repro.models.attention`` in plain PyTorch (einsum and a
masked f32 softmax), as the JAX package computes attention outside any
Pallas kernel; no library attention kernel is used.

Training/prefill attention is an online softmax over KV chunks for each
Q chunk, as in the JAX package, so its memory is O(q_chunk * kv_chunk)
per (batch, head) and not O(S^2). The JAX package has two causal
schedules: ``"scan"`` visits every KV chunk with masks, ``"unrolled"``
skips the KV chunks that lie wholly above the causal diagonal. The
skipped chunks are exactly the ones the scan masks whole: each of their
scores is -1e30, so their probabilities are exp(-1e30 - m) = 0 and their
rescale factor exp(m - m) = 1 (the first chunk always holds key 0, so m
is a real score by then), and they change no bit of the statistics. The
port therefore has one implementation for both values of ``schedule``:
it skips those chunks under either.

Decode uses the full cache or a ring buffer of size ``window`` for local
layers. Cross-attention comes with the enc-dec slice (ROADMAP queue 1,
item 15: ``models/encdec.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import _dense_init, init_device

NEG_INF = -1e30
SCHEDULES = ("scan", "unrolled")


def attn_init(generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool = False, dtype=torch.float32,
              device=None):
    kw = dict(dtype=dtype, device=init_device(device, generator))
    p = {"wq": _dense_init(generator, (d_model, n_heads * head_dim), **kw),
         "wk": _dense_init(generator, (d_model, n_kv * head_dim), **kw),
         "wv": _dense_init(generator, (d_model, n_kv * head_dim), **kw),
         "wo": _dense_init(generator, (n_heads * head_dim, d_model), **kw)}
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), **kw)
        p["bk"] = torch.zeros((n_kv * head_dim,), **kw)
        p["bv"] = torch.zeros((n_kv * head_dim,), **kw)
    return p


def qkv_project(params, x, n_heads: int, n_kv: int, head_dim: int):
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim),
            v.reshape(B, S, n_kv, head_dim))


def _chunk_sizes(S: int, want: int) -> int:
    c = min(want, S)
    while S % c != 0:
        c //= 2
    return max(c, 1)


def _online_softmax_step(qc, kj, vj, mask, m, l, acc, scale):
    """One KV-chunk update of the online softmax. qc (..., C, hd);
    kj/vj (..., Ck, hd); mask broadcastable to (..., C, Ck) bool; the
    statistics m, l, acc in f32."""
    s = torch.einsum("...qd,...kd->...qk", qc, kj).float() * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "...qk,...kd->...qd", p.to(vj.dtype), vj).float()
    return m_new, l_new, acc_new


def _empty_stats(qc):
    """The online softmax's statistics (m, l, acc) before any KV chunk,
    for the q chunk qc (..., C, hd)."""
    kw = dict(dtype=torch.float32, device=qc.device)
    return (torch.full(qc.shape[:-1], NEG_INF, **kw),
            torch.zeros(qc.shape[:-1], **kw), torch.zeros(qc.shape, **kw))


def _normalized(l, acc, dtype):
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def sdpa(q, k, v, *, causal: bool = True, q_offset=0, q_chunk: int = 512,
         kv_chunk: int = 512, schedule: str = "scan") -> torch.Tensor:
    """Grouped-query chunked attention; q (B, Sq, H, hd), k/v (B, Skv, KV,
    hd); returns (B, Sq, H, hd). ``q_offset``: absolute position of q[0].
    ``schedule`` is either JAX schedule; both give the same result (the
    module docstring says why)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}: {schedule!r}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    C = _chunk_sizes(Sq, q_chunk)
    Ck = _chunk_sizes(Skv, kv_chunk)
    qr = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)   # (B,KV,G,Sq,hd)
    kr = k.permute(0, 2, 1, 3)[:, :, None]                 # (B,KV,1,Skv,hd)
    vr = v.permute(0, 2, 1, 3)[:, :, None]
    kpos = torch.arange(Skv, device=q.device)
    outs = []
    for i in range(0, Sq, C):
        qc = qr[:, :, :, i:i + C]
        qpos = q_offset + i + torch.arange(C, device=q.device)
        m, l, acc = _empty_stats(qc)
        # the KV chunks that hold a key at or below the last query's position
        hi = min(Skv, -(-(q_offset + i + C) // Ck) * Ck) if causal else Skv
        for j in range(0, hi, Ck):
            mask = (kpos[None, j:j + Ck] <= qpos[:, None] if causal else
                    torch.ones((C, Ck), dtype=torch.bool, device=q.device))
            m, l, acc = _online_softmax_step(
                qc, kr[:, :, :, j:j + Ck], vr[:, :, :, j:j + Ck], mask, m, l,
                acc, scale)
        outs.append(_normalized(l, acc, q.dtype))
    out = torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def sdpa_local(q, k, v, *, window: int, q_offset=0, q_chunk: int = 512
               ) -> torch.Tensor:
    """Causal sliding-window attention, linear in S: each q chunk attends
    to exactly the previous ``window`` keys (k/v front-padded by
    ``window``, chunk i slices [i*C, i*C + window + C))."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    C = _chunk_sizes(Sq, q_chunk)
    qr = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
    pad = torch.zeros((B, window) + tuple(k.shape[2:]), dtype=k.dtype,
                      device=k.device)
    kp = torch.cat([pad, k], dim=1).permute(0, 2, 1, 3)[:, :, None]
    vp = torch.cat([pad.to(v.dtype), v], dim=1).permute(0, 2, 1, 3)[:, :,
                                                                     None]
    ar_c = torch.arange(C, device=q.device)
    ar_w = torch.arange(window + C, device=q.device)
    outs = []
    for i in range(0, Sq, C):
        qpos = q_offset + i + ar_c
        kpos = q_offset + i + ar_w - window                    # absolute
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window)
                & (kpos[None, :] >= 0))
        qc = qr[:, :, :, i:i + C]
        _, l, acc = _online_softmax_step(
            qc, kp[:, :, :, i:i + window + C], vp[:, :, :, i:i + window + C],
            mask, *_empty_stats(qc), scale)
        outs.append(_normalized(l, acc, q.dtype))
    out = torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def _decode_softmax(q, cache_k, cache_v, ok):
    """q (B, 1, H, hd) against cache_k/v (B, S, KV, hd) where ``ok`` (S,)
    is true: a plain f32 softmax over the cache."""
    B, _, H, hd = q.shape
    KV = cache_k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qr = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qr, cache_k).float() * scale
    s = torch.where(ok[None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, cache_v)
    return out.reshape(B, 1, H, hd)


def sdpa_decode(q, cache_k, cache_v, cache_len) -> torch.Tensor:
    """q (B, 1, H, hd); cache_k/v (B, S, KV, hd); positions >= cache_len
    masked."""
    S = cache_k.shape[1]
    return _decode_softmax(q, cache_k, cache_v,
                           torch.arange(S, device=q.device) < cache_len)


def sdpa_decode_ring(q, ring_k, ring_v, ring_pos, cur_pos, window: int
                     ) -> torch.Tensor:
    """Decode against a ring-buffer window cache (local_attn layers).

    ring_k/v (B, window, KV, hd); ring_pos (window,) absolute positions
    (-1 = empty); cur_pos an int: keys older than the window are masked."""
    ok = ((ring_pos >= 0) & (ring_pos <= cur_pos)
          & (ring_pos > cur_pos - window))
    return _decode_softmax(q, ring_k, ring_v, ok)
