"""(Θ, Φ, probe, depth, segments) autotuner: the paper's Table 1/2 grid
search as a library, extended to every axis the kernels expose.

Counterpart of ``repro.core.tuning``. ``tune_layout`` sweeps the valid (Θ, Φ)
grid for a (spec, tile) and returns the fastest layout; ``tune_plan`` also
picks the probe strategy, the cooperation axes (``coop``, ``mix``), the
DRAM-regime ``depth`` and the partitioned-update segment count, and returns
a :class:`Plan` that ``kernels.ops`` resolves ``"auto"`` through and
``api.tuned_options`` pins:

* ``mode="structural"`` (default) ranks the candidate grid by the
  calibrated performance model's predicted cost
  (``repro_torch.perfmodel.predict_config_us``, through the device's
  calibration). The §4.1 structural scorers remain for ``tune_layout`` and
  diagnostics;
* ``mode="measure"`` times the kernels through ``kernels.ops``: CUDA events
  on a card, ``time.perf_counter`` on the CPU, the best of ``repeats``
  after a warm-up. Counting specs are timed through ``counting_*``.

Every function that ranks or times takes the ``device`` it tunes for
(default the card). Plans are cached in-process (lru) and in a JSON file
(``REPRO_TUNING_CACHE``, default ``~/.cache/repro_torch/tuning.json``)
under a key that starts with ``repro_torch|`` and holds the device's
backend key (``perfmodel.calibrate.backend_key``): a plan timed on the CPU
never answers for a card, nor one package's for the other. As in the JAX
package, the key holds every axis that changes the candidate set (tile,
bank, pinned coop and mix), and a cached plan is re-validated before use.

Differences from the JAX package: a layout that does not validate raises
``ValueError`` here (an ``AssertionError`` there), and both are skipped;
the segment count is measured against the partitioned kernel's shared
memory (``sbf.partition_smem_bytes``) on a card and against
``CPU_SEGMENT_BYTES`` on the CPU, where the JAX package uses its VMEM
budget. Nothing reads ``Plan.n_segments``: ``ops.*_partitioned`` take 8
unless the caller passes a count.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import (COOPS, DEFAULT_TILE, DMA_DEPTHS, MIXES,
                                     PROBES, Layout, default_layout)

TUNABLE_DEPTHS = (2, 4, 8)        # the sweep; depth=1 (serial) is debug-only
TUNABLE_SEGMENTS = (4, 8, 16, 32)
# The shared memory a partitioned CTA may give its segment on an H100
# (232,448 bytes of opt-in shared memory less 1,152 of staged salts, as
# sbf.partition_smem_bytes reads it there): the segment budget on the CPU.
CPU_SEGMENT_BYTES = 231296
KEY_PREFIX = "repro_torch"


@dataclasses.dataclass(frozen=True)
class Plan:
    """One tuned kernel configuration (static, hashable; carried through
    ``api.BackendOptions``)."""

    layout: Layout
    probe: str = "gather"          # "loop" | "gather" (vmem-regime phase 2)
    depth: int = 2                 # DRAM contains keys in flight a thread
    n_segments: int = 8            # partitioned bulk-add grid width
    coop: str = "none"             # "none" | "subtile" lane-group probing
    mix: str = "full"              # "full" | "cheap" fused double-hash

    def to_dict(self) -> dict:
        return {"theta": self.layout.theta, "phi": self.layout.phi,
                "probe": self.probe, "depth": self.depth,
                "n_segments": self.n_segments, "coop": self.coop,
                "mix": self.mix}

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        return cls(Layout(int(d["theta"]), int(d["phi"])), str(d["probe"]),
                   int(d["depth"]), int(d["n_segments"]),
                   str(d.get("coop", "none")), str(d.get("mix", "full")))


# ---------------------------------------------------------------------------
# Disk-persisted cache
# ---------------------------------------------------------------------------

def cache_path() -> str:
    return os.environ.get(
        "REPRO_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "tuning.json"))


def _load_disk() -> dict:
    try:
        with open(cache_path()) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_disk(key: str, value: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _load_disk()
        data[key] = value
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                       # cache is an optimization, never an error


def _plan_key(spec: FilterSpec, op: str, regime: str, mode: str,
              tile: int, bank: int = 1, coop: str = "auto",
              mix: str = "auto", backend: str = "cpu") -> str:
    # The JAX package's key ("plan2", every axis that changes the candidate
    # set) behind the port's prefix, with the device's backend key in place
    # of jax.default_backend().
    base = (f"{KEY_PREFIX}|plan2|{backend}|{spec}|{op}|{regime}|{mode}"
            f"|tile{tile}|coop:{coop}|mix:{mix}")
    return base if bank == 1 else f"{base}|bank{bank}"


# ---------------------------------------------------------------------------
# (Θ, Φ) layout grid
# ---------------------------------------------------------------------------

def valid_layouts(spec: FilterSpec, tile: int = DEFAULT_TILE) -> List[Layout]:
    s = spec.s
    out = []
    for theta in (1, 2, 4, 8, 16):
        if tile % theta:
            continue
        for phi in (1, 2, 4, 8, 16, 32):
            if phi <= s and s % phi == 0 and theta * phi <= max(s, 8):
                out.append(Layout(theta, phi))
    return out


def structural_score(spec: FilterSpec, lay: Layout, op: str) -> float:
    """Lower is better. Mirrors §4.1: wide loads amortize issue cost; too
    much Θ under-utilizes lanes for lookups but tightens RMW windows for
    adds (the paper's Θ̂ rules, encoded as a soft preference)."""
    s = spec.s
    loads = s // lay.phi                      # load instructions per block
    steps = max(s // (lay.theta * lay.phi), 1)
    score = loads + 0.5 * steps
    if op == "contains":
        target = max(1, spec.block_bits // 256)
        score += 0.25 * abs(lay.theta - target)
    else:                                     # add: fully horizontal wins
        score += 0.25 * (s - min(lay.theta * lay.phi, s)) / max(s, 1)
        score += 0.1 * loads
    return score


def probe_schedule_steps(spec: FilterSpec, lay: Layout, op: str, tile: int,
                         probe: str, bank: int = 1) -> float:
    """Schedule-step count of one key tile's phase 2, the JAX package's.

    loop:   (tile/Θ) trips, each issuing s/Φ loads + 1 fused compare (or
            s/Φ RMW pairs for add) — the per-key scalar walk.
    gather: a constant number of whole-tile vector ops — index build,
            ONE gather, ONE fused compare for contains; sort, segmented
            scan, gather, scatter for add.

    ``bank``: a B-member bank widens the word array B×; both probes take a
    soft log2 term for it.
    """
    import math
    lg_b = math.log2(max(bank, 1))
    if probe == "loop":
        per_trip = spec.s // lay.phi + (1 if op == "contains" else
                                        spec.s // lay.phi)
        return (tile // lay.theta) * per_trip * (1.0 + 0.05 * lg_b)
    if op == "contains":
        return 3.0 + 0.25 * lg_b
    lg = max(math.log2(max(tile, 2)), 1.0)
    # sort + segmented scan + gather + scatter (+ bank index widening)
    return 2.0 * lg + 4.0 + 0.25 * lg_b


def depth_structural_score(spec: FilterSpec, depth: int) -> float:
    """Stall model for the DRAM contains pipeline: a row fetch costs a
    fixed latency plus the row transfer; each row in flight hides one
    row's compute. Deeper pipelines win for small rows (latency-bound) and
    waste registers for large rows (bandwidth-bound)."""
    s = spec.s
    latency = 32.0 + s             # fixed fetch latency + transfer (words)
    compute = float(s)             # per-row test cost
    stall = max(latency - (depth - 1) * compute, 0.0)
    return stall + compute + 0.1 * depth * s   # + register pressure tiebreak


def segment_budget_bytes(device=None) -> int:
    """Bytes a partitioned segment may take: the partitioned kernel's
    shared memory on a card, ``CPU_SEGMENT_BYTES`` on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import sbf
        return sbf.partition_smem_bytes(dev)
    return CPU_SEGMENT_BYTES


def segments_structural_score(spec: FilterSpec, n_segments: int,
                              device=None) -> float:
    """Prefer the smallest grid whose segment fits the partitioned kernel's
    shared memory (each CTA stages one segment there)."""
    if spec.n_blocks % n_segments or spec.storage_words % n_segments:
        return float("inf")
    seg_bytes = spec.storage_words * 4 / n_segments
    penalty = 0.0 if seg_bytes <= segment_budget_bytes(device) else seg_bytes
    return penalty + n_segments    # grid-launch overhead tiebreak


def _measure(spec: FilterSpec, op: str, n_keys: int, repeats: int,
             device=None, **kw) -> float:
    """Best-of-``repeats`` seconds of one bulk ``op`` of ``n_keys`` keys into
    an empty filter, after a warm-up: CUDA events on a card, the host clock
    on the CPU. The minimum over k runs is the noise-floor estimator (a
    perturbation only raises a sample)."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    keys = torch.from_numpy(
        H.random_u64x2(n_keys, seed=7).view(np.int32)).to(dev)
    filt = V.init(spec, dev)
    if spec.is_counting:
        fn = (ops.counting_contains if op == "contains"
              else ops.counting_add)
    else:
        fn = ops.bloom_contains if op == "contains" else ops.bloom_add
    call = functools.partial(fn, spec, filt, keys, **kw)
    call()                                            # warm-up
    best = float("inf")
    for _ in range(max(repeats, 1)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
    return best


@functools.lru_cache(maxsize=256)
def tune_layout(spec: FilterSpec, op: str = "contains",
                mode: str = "structural", n_keys: int = 1024,
                repeats: int = 3, tile: int = DEFAULT_TILE, device=None
                ) -> Tuple[Layout, List[Tuple[str, float]]]:
    """Returns (best layout, [(layout-name, score/time) ...]).

    ``tile`` is part of the cache key AND the validation constraint: Θ must
    divide the tile. ``repeats`` (measure mode) de-noises the grid search:
    each candidate is timed ``repeats`` times after a warm-up and scored by
    its best run."""
    if op not in ("contains", "add"):
        raise ValueError(f"op={op!r} not in ('contains', 'add')")
    cands = []
    for lay in valid_layouts(spec, tile):
        try:
            cands.append(lay.validate(spec, tile))
        except (ValueError, AssertionError):
            continue
    cands = sorted(set(cands), key=lambda l: (l.theta, l.phi))
    if not cands:
        return default_layout(spec, op), []
    if mode == "structural":
        scored = [(str(l), structural_score(spec, l, op)) for l in cands]
    else:
        scored = [(str(l), _measure(spec, op, n_keys, repeats, device,
                                    layout=l, tile=tile, probe="loop"))
                  for l in cands]
    best_name, _ = min(scored, key=lambda kv: kv[1])
    best = next(l for l in cands if str(l) == best_name)
    return best, sorted(scored, key=lambda kv: kv[1])


# ---------------------------------------------------------------------------
# Full-plan sweep: probe strategy x depth x segments (+ the layout grid)
# ---------------------------------------------------------------------------

def _model_candidates(coop: str, mix: str):
    """The (probe, coop, mix) candidate grid under optional pinning.
    coop="subtile" supersedes the probe strategy, so cooperative candidates
    are canonicalized to probe="gather". Order breaks predicted-cost ties
    toward the non-coop baseline; the full mix's cheap sibling is ranked by
    its strictly lower op count."""
    coops = ("none", "subtile") if coop == "auto" else (coop,)
    mixes = ("cheap", "full") if mix == "auto" else (mix,)
    out = []
    for c in coops:
        probes = ("gather", "loop") if c == "none" else ("gather",)
        for p in probes:
            for m in mixes:
                out.append((p, c, m))
    return out


@functools.lru_cache(maxsize=256)
def tune_plan(spec: FilterSpec, op: str = "contains", regime: str = "vmem",
              mode: str = "structural", n_keys: int = 1024, repeats: int = 3,
              tile: int = DEFAULT_TILE, bank: int = 1, coop: str = "auto",
              mix: str = "auto", device=None) -> Plan:
    """Pick (layout, probe, coop, mix, depth, n_segments) for a
    (spec, op, regime) on ``device`` (default the card).

    Checks the disk cache first; a miss runs the sweep and stores the
    winner. The default mode ranks the (layout x probe x coop x mix x
    depth) grid by the device's calibrated model
    (``perfmodel.predict_config_us``). ``coop``/``mix``: ``"auto"`` sweeps
    both axes; a pinned value restricts the grid and keys the cache entry.
    ``mode="measure"`` times the kernels for the probe and depth axes and
    keeps the pinned-or-baseline coop/mix. ``bank`` keys the plan to a
    B-member bank workload.
    """
    if op not in ("contains", "add") or bank < 1:
        raise ValueError(f"op={op!r} not in ('contains', 'add') or "
                         f"bank={bank} < 1")
    if coop != "auto" and coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS} or 'auto'")
    if mix != "auto" and mix not in MIXES:
        raise ValueError(f"mix={mix!r} not in {MIXES} or 'auto'")
    from repro_torch.perfmodel.calibrate import backend_key
    dev = resolve_device(device)
    key = _plan_key(spec, op, regime, mode, tile, bank, coop, mix,
                    backend_key(dev))
    cached = _load_disk().get(key)
    if cached is not None:
        try:
            plan = Plan.from_dict(cached)
            # Re-validate against the current constraint sets: a stale entry
            # must re-tune, not fail every "auto" call.
            if (plan.probe in PROBES and plan.depth in DMA_DEPTHS
                    and plan.n_segments in TUNABLE_SEGMENTS
                    and plan.coop in COOPS and plan.mix in MIXES):
                plan.layout.validate(spec, tile)
                return plan
        except (KeyError, ValueError, TypeError, AssertionError):
            pass                   # stale/corrupt entry: re-tune
    layout, _ = tune_layout(spec, op, mode=mode, n_keys=n_keys,
                            repeats=repeats, tile=tile, device=dev)
    if mode == "measure":
        if regime == "vmem":
            t_loop = _measure(spec, op, n_keys, repeats, dev, layout=layout,
                              tile=tile, probe="loop", regime="vmem")
            t_gather = _measure(spec, op, n_keys, repeats, dev, tile=tile,
                                probe="gather", regime="vmem")
            probe = "gather" if t_gather <= t_loop else "loop"
        else:
            probe = "gather"
        if regime == "hbm" and op == "contains":
            timed = {d: _measure(spec, op, n_keys, repeats, dev, regime="hbm",
                                 tile=tile, depth=d) for d in TUNABLE_DEPTHS}
            depth = min(timed, key=timed.get)
        else:
            depth = min(TUNABLE_DEPTHS,
                        key=lambda d: depth_structural_score(spec, d))
        best_coop = coop if coop != "auto" else "none"
        best_mix = mix if mix != "auto" else "full"
    else:
        from repro_torch import perfmodel as PM
        calib = PM.get_calibration(device=dev)

        def score(p, c, m, d):
            t = PM.predict_config_us(spec, op, regime, layout=layout,
                                     probe=p, coop=c, mix=m, depth=d,
                                     tile=tile, bank=bank, calib=calib)
            flops = PM.op_cost(spec, op, regime, layout=layout, probe=p,
                               coop=c, mix=m, depth=d, tile=tile,
                               n_keys=tile, bank=bank).flops
            return (t, flops)      # op-count tie-break: cheap mix wins ties

        cands = _model_candidates(coop, mix)
        probe, best_coop, best_mix = min(
            cands, key=lambda pcm: score(*pcm, 2))
        depth = min(TUNABLE_DEPTHS,
                    key=lambda d: score(probe, "none", best_mix, d))
    n_segments = min(TUNABLE_SEGMENTS,
                     key=lambda ns: segments_structural_score(spec, ns, dev))
    plan = Plan(layout=layout, probe=probe, depth=depth,
                n_segments=n_segments, coop=best_coop, mix=best_mix)
    _store_disk(key, plan.to_dict())
    return plan
