"""Atomic, async-capable checkpoints of tensors, arrays and filters.

Counterpart of ``repro.checkpoint.checkpoint``, with the same on-disk
layout, so a checkpoint written by either package restores in the other
(one directory per step):

    <dir>/step_000123/
        manifest.json      {key: {file, shape, dtype}}, step, extra metadata
        000000.npy ...     one .npy per leaf
        DONE               commit marker (atomicity: written last)

* **Atomic**: writers fill ``step_X.tmp`` then rename; readers only trust
  directories containing DONE. A crash mid-save never corrupts the latest
  good checkpoint.
* **Async**: ``save(..., sync=False)`` copies every leaf to host memory on
  the calling thread (a copy even of a CPU tensor), then writes on a
  background thread, so the caller may go on updating its tensors.
* **Leaves**: a state is a dict, list or tuple (nested at will) of torch
  tensors, numpy arrays, Python scalars or port ``Filter`` objects. Leaves
  are named as JAX's ``tree_flatten_with_path`` names them: dict keys
  sorted, sequence indices, ``"/"``-joined; a ``Filter`` is a node with the
  leaves ``.words`` (its raw engine words as uint32) and ``.state`` (an
  int32 ring head, or head array for a windowed bank; a uint32 failure
  count for a fingerprint engine; no leaf for ``None``), the JAX
  ``Filter`` pytree's leaves. bfloat16 and float8 leaves are stored as
  their bit patterns with the logical dtype in the manifest.
* **Device**: ``restore(..., device=)`` puts every tensor leaf on
  ``device``; by default each goes to the device of its template leaf (a
  non-tensor template leaf: the card). Sharded restore is not ported.
* **Filters**: ``save_filter``/``restore_filter`` store the
  engine-independent canonical state (``Filter.to_state``), so a filter
  written by one engine restores into another, and into the JAX package
  with ``backend=`` naming a JAX engine (``repro_torch.interop.JAX_ENGINE``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import ml_dtypes
import numpy as np
import torch

# numpy can't serialize bf16 etc. natively; store bit patterns + logical dtype
_EXTENDED = {"bfloat16": (ml_dtypes.bfloat16, np.uint16),
             "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, np.uint8),
             "float8_e5m2": (ml_dtypes.float8_e5m2, np.uint8)}
_TORCH_EXTENDED = {torch.bfloat16: "bfloat16",
                   torch.float8_e4m3fn: "float8_e4m3fn",
                   torch.float8_e5m2: "float8_e5m2"}
_BITS = {np.uint16: torch.int16, np.uint8: torch.uint8}


def _is_filter(x) -> bool:
    from repro_torch.api import Filter
    return isinstance(x, Filter)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor's values (never a view of a CPU tensor,
    which its owner may go on updating in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def _filter_leaves(filt) -> List[Tuple[str, np.ndarray]]:
    """A filter's leaves in the JAX ``Filter`` pytree's form."""
    out = [(".words", _host_copy(filt.words).view(np.uint32))]
    st = filt.state
    if isinstance(st, torch.Tensor):
        out.append((".state", _host_copy(st).astype(np.uint32)))
    elif st is not None:
        out.append((".state", np.asarray(st, np.int32).reshape(
            filt.bank_shape)))
    return out


def _flatten(tree) -> Tuple[List[str], List[Any]]:
    """(leaf names, leaves) in JAX's ``tree_flatten_with_path`` order."""
    keys, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif _is_filter(node):
            for name, leaf in _filter_leaves(node):
                keys.append("/".join(path + (name,)))
                leaves.append(leaf)
        else:
            keys.append("/".join(path))
            leaves.append(node)

    walk(tree, ())
    return keys, leaves


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array to write and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in _TORCH_EXTENDED:
            logical = _TORCH_EXTENDED[leaf.dtype]
            bits = _EXTENDED[logical][1]
            return _host_copy(leaf.view(_BITS[bits])).view(bits), logical
        arr = _host_copy(leaf)
    else:
        arr = np.array(leaf)
    logical = str(arr.dtype)
    if logical in _EXTENDED:
        arr = arr.view(_EXTENDED[logical][1])
    return np.asarray(arr, order="C"), logical


def save(ckpt_dir: str, step: int, state: Any, *, sync: bool = True,
         keep: int = 3, extra: Optional[Dict] = None):
    """Write ``state`` (a nest of tensors, arrays and filters) atomically
    under ckpt_dir; ``sync=False`` returns the writer thread."""
    keys, leaves = _flatten(state)
    # snapshot to host BEFORE going async: the caller keeps updating
    host_leaves = [_to_host(l) for l in leaves]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for i, (k, (arr, logical)) in enumerate(zip(keys, host_leaves)):
            fname = f"{i:06d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][k] = {"file": fname,
                                     "shape": list(arr.shape),
                                     "dtype": logical}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if sync:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for d in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, d)
        if (d.startswith("step_") and not d.endswith(".tmp")
                and os.path.exists(os.path.join(full, "DONE"))):
            out.append(int(d[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> Tuple[int, str]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return step, os.path.join(ckpt_dir, f"step_{step:08d}")


def _manifest(d: str) -> Dict:
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def save_filter(ckpt_dir: str, step: int, filt, *, sync: bool = True,
                keep: int = 3, extra: Optional[Dict] = None):
    """Checkpoint a port ``Filter`` in engine-independent form.

    The dense words (uint32, the bank dims leading) are the first leaf, a
    fingerprint engine's failure count (uint32) the second; spec, engine
    name, bank shape and ring geometry travel in the manifest's ``extra``,
    so ``restore_filter`` of either package can rebuild on any engine.
    ``extra`` adds caller metadata (JSON-able), read back with
    :func:`manifest_extra`."""
    state = filt.to_state()
    extra = dict(extra or {})
    extra.update({"filter_spec": state["spec"],
                  "filter_backend": state["backend"]})
    if "bank_shape" in state:
        extra["filter_bank_shape"] = state["bank_shape"]
    if "options" in state:
        extra["filter_options"] = state["options"]
    leaves = {"filter_words": state["words"].cpu().numpy().view(np.uint32)}
    if "engine_state" in state:
        leaves["filter_state"] = (state["engine_state"].cpu().numpy()
                                  .astype(np.uint32))
    return save(ckpt_dir, step, leaves, sync=sync, keep=keep, extra=extra)


def manifest_extra(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """The ``extra`` metadata of a checkpoint's manifest (latest step by
    default) — caller metadata stored by ``save``/``save_filter``."""
    _, d = _step_dir(ckpt_dir, step)
    return _manifest(d)["extra"]


def restore_filter(ckpt_dir: str, *, step: Optional[int] = None,
                   backend: Optional[str] = None, options=None, device=None):
    """Load a filter written by either package's ``save_filter``; returns
    (step, Filter) on ``device`` (``None`` = the card).

    ``backend``/``options`` re-home the state onto another engine than
    the one that wrote it (default: the writer's engine, a JAX engine name
    resolving through the port's aliases)."""
    from repro_torch.api import BackendOptions, Filter
    from repro_torch.core.variants import FilterSpec

    step, d = _step_dir(ckpt_dir, step)
    manifest = _manifest(d)
    extra = manifest["extra"]
    spec_d = extra["filter_spec"]
    spec = FilterSpec(**spec_d)
    words = np.load(os.path.join(d, manifest["leaves"]["filter_words"]["file"]))
    state = {"words": words.astype(np.uint32, copy=False), "spec": spec_d,
             "backend": extra["filter_backend"]}
    if "filter_state" in manifest["leaves"]:
        state["engine_state"] = np.load(
            os.path.join(d, manifest["leaves"]["filter_state"]["file"]))
    if "filter_bank_shape" in extra:
        state["bank_shape"] = extra["filter_bank_shape"]
    if "filter_options" in extra:
        state["options"] = extra["filter_options"]
    filt = Filter.from_state(state, backend=backend,
                             options=options or BackendOptions(),
                             device=device)
    if filt.spec != spec:
        raise ValueError(f"restored spec {filt.spec} != saved {spec}")
    return step, filt


def _load_leaf(d: str, meta: Dict) -> np.ndarray:
    arr = np.load(os.path.join(d, meta["file"]))
    if meta["dtype"] in _EXTENDED:
        arr = arr.view(_EXTENDED[meta["dtype"]][0])
    return arr


_LOGICAL_TORCH = {v: k for k, v in _TORCH_EXTENDED.items()}


def _tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` with the template tensor's dtype:
    a same-width integer dtype is a view of the bits (uint32 words as the
    port's int32), any other a value cast."""
    logical = str(arr.dtype)
    if logical in _EXTENDED:
        bits = _EXTENDED[logical][1]
        t = torch.from_numpy(arr.view(bits).copy()).view(
            _LOGICAL_TORCH[logical])
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    if isinstance(like, torch.Tensor) and t.dtype != like.dtype:
        ints = not (t.dtype.is_floating_point or like.dtype.is_floating_point
                    or torch.bool in (t.dtype, like.dtype))
        t = (t.view(like.dtype)
             if ints and t.element_size() == like.element_size()
             else t.to(like.dtype))
    return t.to(device)


def restore(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
            device=None):
    """Load into the structure of ``template``; returns (step, state).

    Each leaf comes back as a tensor of its template leaf's dtype (a
    filter as a filter, its state in the port's form) on ``device``; by
    default on its template leaf's device, the card for a leaf that is not
    a tensor."""
    from repro_torch import resolve_device

    step, d = _step_dir(ckpt_dir, step)
    metas = _manifest(d)["leaves"]
    fixed = None if device is None else resolve_device(device)

    def load(key: str, shape) -> np.ndarray:
        meta = metas.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _load_leaf(d, meta)
        if shape is not None and list(arr.shape) != list(shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape "
                             f"{list(arr.shape)} != template {list(shape)}")
        return arr

    def place(like) -> torch.device:
        if fixed is not None:
            return fixed
        if isinstance(like, torch.Tensor):
            return like.device
        return resolve_device(None)

    def build(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], path + (str(k),)) for k in node}
        if isinstance(node, (list, tuple)):
            out = [build(v, path + (str(i),)) for i, v in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        if _is_filter(node):
            return build_filter(node, path)
        shape = (list(node.shape) if hasattr(node, "shape")
                 else list(np.shape(node)))
        arr = load("/".join(path), shape)
        return _tensor(arr, node, place(node))

    def build_filter(filt, path):
        dev = place(filt.words)
        words = _tensor(load("/".join(path + (".words",)),
                             filt.words.shape).astype(np.uint32, copy=False),
                        filt.words, dev)
        st = filt.state
        if st is not None:
            arr = load("/".join(path + (".state",)), None)
            if isinstance(st, torch.Tensor):
                st = torch.from_numpy(arr.astype(np.int64).reshape(
                    tuple(st.shape))).to(dev)
            elif isinstance(st, tuple):
                st = tuple(int(h) for h in arr.reshape(-1))
            else:
                st = int(arr)
        return filt.replace(words=words, state=st)

    return step, build(template, ())
