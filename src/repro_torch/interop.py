"""Carry filter state between the JAX package and the port.

The JAX package is not imported: both directions go through plain dicts and
numpy arrays. Words keep their bits exactly: the port stores them as int32
tensors, the JAX package as uint32 arrays, and the two are views of the
same bits.

* ``from_jax_state`` / ``to_jax_state`` carry the dict of
  ``repro.api.Filter.to_state()`` / ``from_state``: the dense words, which
  for a counting filter are its occupancy bits only (counters come back at
  1), as in the JAX package.
* ``from_jax_words`` / ``to_jax_words`` carry an engine's raw words
  (``repro.api.Filter.words``) and the spec fields, losslessly: a counting
  filter keeps its counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import BackendOptions, Filter, FilterSpec, registry
from repro_torch.api.filter import as_keys, as_words

# The JAX engine each port engine stands in for.
JAX_ENGINE = {"torch": "jnp", "cuda-l2": "pallas-vmem",
              "cuda-dram": "pallas-hbm", "counting": "counting"}


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


def from_jax_words(spec_fields: dict, words_u32, backend: str = "auto",
                   device=None) -> Filter:
    """The port's filter holding the raw engine words ``words_u32`` (the
    ``repro.api.Filter.words`` of a scalar filter, as numpy uint32) for the
    spec with ``spec_fields`` (``dataclasses.asdict`` of its spec), on
    ``device`` (``None`` = the card)."""
    words = np.asarray(words_u32)
    if words.dtype != np.uint32:
        raise ValueError(f"JAX words must be uint32, got {words.dtype}")
    spec = FilterSpec(**{k: (v if isinstance(v, str) else int(v))
                         for k, v in spec_fields.items()})
    options = BackendOptions()
    ctx = options.ctx(device)
    eng = registry.select(spec, backend, ctx)
    if words.shape != (spec.storage_words,):
        raise ValueError(f"words {words.shape} do not match {spec} "
                         f"({spec.storage_words} storage words)")
    words = as_words(words, ctx.device)
    return Filter(spec=spec, words=words, backend=eng.name, options=options)


def to_jax_words(filt: Filter):
    """(spec fields, raw engine words as numpy uint32) of a port filter,
    the inverse of :func:`from_jax_words`."""
    return (dataclasses.asdict(filt.spec),
            filt.words.cpu().numpy().view(np.uint32).copy())


def keys_to_torch(np_keys: np.ndarray, device=None) -> torch.Tensor:
    """numpy keys (``(n, 2)`` u32 ``[hi, lo]`` or ``(n,)`` u64) as the
    port's ``(n, 2)`` int32 tensor on ``device`` (``None`` = the card)."""
    from repro_torch import resolve_device
    return as_keys(np_keys, resolve_device(device))
