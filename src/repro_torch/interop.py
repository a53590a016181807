"""Carry filter state between the JAX package and the port.

The JAX package is not imported: both directions go through the plain dict
of ``repro.api.Filter.to_state()`` / ``from_state``, with numpy arrays.
Words keep their bits exactly: the port stores them as int32 tensors, the
JAX package as uint32 arrays, and the two are views of the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import Filter
from repro_torch.api.filter import as_keys

# The JAX engine each port engine stands in for.
JAX_ENGINE = {"torch": "jnp", "cuda-l2": "pallas-vmem",
              "cuda-dram": "pallas-hbm"}


def from_jax_state(state: dict, device=None) -> Filter:
    """The port's filter for the dict of ``repro.api.Filter.to_state()``.
    The JAX engine name resolves through the port's aliases on ``device``
    (``None`` = the card)."""
    st = dict(state)
    st["words"] = np.asarray(st["words"])
    if st["words"].dtype != np.uint32:
        raise ValueError(f"JAX state words must be uint32, got "
                         f"{st['words'].dtype}")
    return Filter.from_state(st, device=device)


def to_jax_state(filt: Filter) -> dict:
    """A dict that ``repro.api.Filter.from_state`` reads: uint32 words,
    the spec fields, and the JAX counterpart of the port's engine."""
    words = filt.dense_words().cpu().numpy().view(np.uint32).copy()
    return {"words": words, "spec": dataclasses.asdict(filt.spec),
            "backend": JAX_ENGINE[filt.backend]}


def keys_to_torch(np_keys: np.ndarray, device=None) -> torch.Tensor:
    """numpy keys (``(n, 2)`` u32 ``[hi, lo]`` or ``(n,)`` u64) as the
    port's ``(n, 2)`` int32 tensor on ``device`` (``None`` = the card)."""
    from repro_torch import resolve_device
    return as_keys(np_keys, resolve_device(device))
