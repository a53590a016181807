"""Carry filter state between the JAX package and the port.

The JAX package is not imported: both directions go through plain dicts and
numpy arrays. Words keep their bits exactly: the port stores them as int32
tensors, the JAX package as uint32 arrays, and the two are views of the
same bits.

* ``from_jax_state`` / ``to_jax_state`` carry the dict of
  ``repro.api.Filter.to_state()`` / ``from_state``: the dense words, which
  for a counting filter are its occupancy bits only (counters come back at
  1) and for a windowed filter the union of its ring (restored into
  generation 0 with head 0, its ring size under ``"options"``), as in the
  JAX package.
* ``from_jax_words`` / ``to_jax_words`` carry an engine's raw words
  (``repro.api.Filter.words``) and the spec fields, losslessly: a counting
  filter keeps its counts, and a windowed filter its ``(G, n_words)`` ring
  and its head (``int(repro.api.Filter.head)``), so a ring built by either
  package goes on sliding in the other. A bank's leading dims are named
  by ``bank_shape=``, so ``(B, n_words)`` bits, ``(B, 4 n_words)``
  counters and a ``(B, G, n_words)`` windowed bank (with its
  ``np.asarray(repro.api.Filter.head)`` heads) each load unambiguously.

Bank states (``"bank_shape"`` in the dict) go both ways as well.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import BackendOptions, Filter, FilterSpec, registry
from repro_torch.api.filter import as_keys, as_words

# The JAX engine each port engine stands in for.
JAX_ENGINE = {"torch": "jnp", "cuda-l2": "pallas-vmem",
              "cuda-dram": "pallas-hbm", "counting": "counting",
              "windowed": "windowed", "cuckoo": "cuckoo",
              "quotient": "quotient"}


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


def _u32_state(state: torch.Tensor) -> np.ndarray:
    return state.cpu().numpy().astype(np.uint32)


def to_jax_state(filt: Filter) -> dict:
    """A dict that ``repro.api.Filter.from_state`` reads: uint32 words,
    the spec fields, the JAX counterpart of the port's engine, a windowed
    filter's ring size and a fingerprint filter's uint32 failure count."""
    state = filt.to_state()
    state["words"] = state["words"].cpu().numpy().view(np.uint32).copy()
    state["backend"] = JAX_ENGINE[filt.backend]
    if "engine_state" in state:
        state["engine_state"] = _u32_state(state["engine_state"])
    return state


def from_jax_words(spec_fields: dict, words_u32, backend: str = "auto",
                   device=None, head=None, bank_shape=None,
                   engine_state=None) -> Filter:
    """The port's filter holding the raw engine words ``words_u32`` (the
    ``repro.api.Filter.words`` of a filter or bank, as numpy uint32) for
    the spec with ``spec_fields`` (``dataclasses.asdict`` of its spec), on
    ``device`` (``None`` = the card).

    ``bank_shape`` names the leading bank dims (``None`` or ``()``: a
    scalar filter). After them, one dim is a filter's words (counters for a
    counting spec) and two dims a windowed ``(G, n_words)`` ring, whose
    ``head`` is the insert generation (0 when ``None``): an int for a
    scalar ring, an array or sequence of ``bank_shape`` for a bank.
    ``engine_state`` is a fingerprint (cuckoo or quotient) filter's failure
    count (0 when ``None``), of ``bank_shape`` for a bank."""
    words = np.asarray(words_u32)
    if words.dtype != np.uint32:
        raise ValueError(f"JAX words must be uint32, got {words.dtype}")
    spec = FilterSpec(**{k: (v if isinstance(v, str) else int(v))
                         for k, v in spec_fields.items()})
    bank_shape = tuple(int(d) for d in (bank_shape or ()))
    nb = len(bank_shape)
    if tuple(words.shape[:nb]) != bank_shape or words.ndim not in (nb + 1,
                                                                  nb + 2):
        raise ValueError(f"words {words.shape} do not start with the bank "
                         f"shape {bank_shape} followed by one or two dims")
    ring = words.ndim == nb + 2
    options = BackendOptions(generations=words.shape[nb] if ring else None)
    B = int(np.prod(bank_shape)) if nb else None
    ctx = options.ctx(device, bank=B)
    eng = registry.select(spec, backend, ctx)
    base = ((words.shape[nb], spec.storage_words) if ring
            else (spec.storage_words,))
    if words.shape[nb:] != base:
        raise ValueError(f"words {words.shape} do not match {spec} "
                         f"({spec.storage_words} storage words)")
    state = eng.init_state(spec, options, ctx.device)
    if engine_state is not None and not eng.stateful_ops:
        raise ValueError(f"engine_state= is a fingerprint engine's state; "
                         f"engine {eng.name!r} has none")
    if head is not None and not ring:
        raise ValueError(f"head= needs a ring of generations, got words "
                         f"{words.shape}")
    if ring:
        heads = np.broadcast_to(np.asarray(0 if head is None else head,
                                           np.int64), bank_shape)
        if heads.size and not ((heads >= 0).all()
                               and (heads < words.shape[nb]).all()):
            raise ValueError(f"heads must lie in [0, {words.shape[nb]})")
        state = (tuple(int(h) for h in heads.reshape(-1)) if nb
                 else int(heads))
    elif eng.stateful_ops:
        es = np.asarray(0 if engine_state is None else engine_state)
        state = torch.from_numpy(np.broadcast_to(
            es.astype(np.int64), bank_shape).copy()).to(ctx.device)
    elif nb and state is not None:
        state = (state,) * B
    return Filter(spec=spec, words=as_words(words, ctx.device),
                  backend=eng.name, options=options, state=state)


def to_jax_words(filt: Filter):
    """The inverse of :func:`from_jax_words`: (spec fields, raw engine words
    as numpy uint32) for a scalar filter, (fields, ``(G, n_words)`` ring,
    head) for a windowed one, (fields, table, failure count as a 0-d
    uint32 array) for a cuckoo or quotient one, and (fields, words, state,
    bank_shape) for a bank, state being an int32 array of ``bank_shape`` for
    a windowed bank (JAX's head array), a uint32 one of failure counts for
    a cuckoo or quotient bank and ``None`` otherwise."""
    fields = dataclasses.asdict(filt.spec)
    words = filt.words.cpu().numpy().view(np.uint32).copy()
    if filt.engine.stateful_ops:
        state = _u32_state(filt.state)
        if filt.bank_shape:
            return fields, words, state, filt.bank_shape
        return fields, words, state
    if filt.bank_shape:
        heads = (None if filt.head is None else
                 np.asarray(filt.head, np.int32).reshape(filt.bank_shape))
        return fields, words, heads, filt.bank_shape
    if filt.head is None:
        return fields, words
    return fields, words, filt.head


def keys_to_torch(np_keys: np.ndarray, device=None) -> torch.Tensor:
    """numpy keys (``(n, 2)`` u32 ``[hi, lo]`` or ``(n,)`` u64) as the
    port's ``(n, 2)`` int32 tensor on ``device`` (``None`` = the card)."""
    from repro_torch import resolve_device
    return as_keys(np_keys, resolve_device(device))
