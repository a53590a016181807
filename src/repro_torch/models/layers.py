"""Shared neural-net layers: norms, RoPE, MLPs, embeddings.

Counterpart of ``repro.models.layers``. Functional style: params are plain
dicts of tensors; every function takes (params, inputs) and returns
outputs. Initializers take an explicit ``torch.Generator`` on the device
the tensors are made on: ``device=None`` is the card, as for every entry
point of the port; ``device="meta"`` makes shapes only and needs none.
Compute runs in the inputs' dtype (bf16 by default); params stay in
their stored dtype and are cast at use, as in the JAX package: norms and
RoPE compute in f32 and cast back, matmul weights are cast to the compute
dtype.

The matmuls, norms and softmaxes here are plain PyTorch, as they are plain
``jnp`` in the JAX package (no Pallas kernel reaches them).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch import resolve_device


def init_device(device=None, generator=None) -> torch.device:
    """The device an initializer makes its tensors on: ``device`` (``None``
    = the card, ``"meta"`` = shapes only). A ``generator`` must be on it."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    dev = resolve_device(device)
    if generator is not None and generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}; the "
                         f"parameters are made on {dev}")
    return dev


def _dense_init(generator, shape, scale=None, dtype=torch.float32,
                device=None):
    """N(0, 1) * scale (default 1/sqrt(fan_in)), drawn in f32 and cast."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    device = init_device(device, generator)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    device = init_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    device = init_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> (cos, sin) each (..., S, head_dim//2) f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, D); cos/sin broadcastable to (..., S, 1, D/2)."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    if kind in ("swiglu", "geglu"):
        return {"w_gate": _dense_init(generator, (d_model, d_ff), **kw),
                "w_up": _dense_init(generator, (d_model, d_ff), **kw),
                "w_down": _dense_init(generator, (d_ff, d_model), **kw)}
    if kind in ("relu2", "gelu"):
        return {"w_up": _dense_init(generator, (d_model, d_ff), **kw),
                "w_down": _dense_init(generator, (d_ff, d_model), **kw)}
    raise ValueError(kind)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return Fn.gelu(x, approximate="tanh")


def mlp_apply(params, x, kind: str):
    dt = x.dtype
    if kind == "swiglu":
        h = Fn.silu(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    elif kind == "geglu":
        h = _gelu(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    elif kind == "relu2":
        h = torch.square(torch.relu(x @ params["w_up"].to(dt)))
    elif kind == "gelu":
        h = _gelu(x @ params["w_up"].to(dt))
    else:
        raise ValueError(kind)
    return h @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def embed_init(generator, vocab: int, d_model: int, dtype=torch.float32,
               device=None):
    # 1/sqrt(d) scale keeps tied-head logits O(1); tied models scale the
    # input embeddings back up by sqrt(d) (Gemma convention).
    return {"table": _dense_init(generator, (vocab, d_model), dtype=dtype,
                                 device=device)}


def embed_lookup(params, ids: torch.Tensor, compute_dtype):
    # the rows are gathered first, then cast: the same values as casting
    # the whole table, without a compute-dtype copy of it
    return params["table"][ids].to(compute_dtype)


def lm_head_init(generator, d_model: int, vocab: int, dtype=torch.float32,
                 device=None):
    return {"w": _dense_init(generator, (d_model, vocab), dtype=dtype,
                             device=device)}


def logits_from(params_head, x, embed_params=None):
    """Untied: x @ w. Tied: x @ table.T."""
    if params_head is not None:
        return x @ params_head["w"].to(x.dtype)
    return x @ embed_params["table"].to(x.dtype).T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0):
    """Mean token NLL in fp32; logits (..., V), labels (...,) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if label_smoothing > 0:
        smooth = lse - torch.mean(logits, dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
