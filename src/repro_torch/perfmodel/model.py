"""First-principles per-bulk-op resource counts for every filter engine.

Counterpart of ``repro.perfmodel.model``: the counting formulas and their
constants are the JAX package's, formula for formula. They are
machine-independent; what makes a prediction the card's is the
:class:`~repro_torch.perfmodel.calibrate.Calibration` it is converted
through. Every function that reads a calibration takes the ``device`` it
predicts for (default the card) where none is given.

For one bulk call of ``n_keys`` keys the model counts, per configuration
(spec x op x regime x layout x probe x coop x mix x depth x tile x bank):

* ``bytes_hbm`` — traffic that must cross the slow tier: the key stream
  in, the result stream out, the one-time filter stream-in (VMEM regime)
  or the per-row block DMAs (HBM regime, deduplicated under cooperative
  probing);
* ``bytes_res`` — fast-tier traffic: every filter word the probe schedule
  touches while the table is resident (cooperative early-exit touches an
  *expected* fraction);
* ``flops``    — u32 ALU work: hashing (the cheap mix shares the
  seed-independent lane products of the fused double-hash), pattern
  generation, compares/RMWs;
* ``launches`` — dispatched programs (every engine launches one kernel
  entry point per bulk op);
* ``vops``     — schedule vector-ops: whole-tile ops issued across all
  grid steps. Each costs ``Calibration.step_us``: on a card the amortised
  cost of one more CTA step, on the CPU a Python-dispatch quantum.

``predict_us`` converts counts to expected wall time (roofline max of the
three resource terms + launch + schedule overhead); ``ceiling_us`` drops
the schedule term — the *practical speed of light*: the time the op could
not beat on this device even with a perfect schedule. ``chip_smoke.py``
(phase 4g) reports measured Mops/s over :func:`ceiling_mops` as the
speed-of-light fraction.

The expectation constants (early-exit column fraction, alternate-bucket
fraction, cluster-scan fraction) describe a mixed ~50% member workload —
they steer *ranking* between configurations.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

from repro_torch.core.variants import FilterSpec
from repro_torch.perfmodel.calibrate import Calibration, get_calibration

WORD = 4                       # u32 filter word, bytes
KEY_BYTES = 8                  # u64 key as 2x u32 lanes
OUT_BYTES = 1                  # bool membership result

# Hash flops per key: two 8-byte xxh32 streams. The full mix runs both
# independently (2 seeds x [2 lanes x (mul+rot+mul) + 3-step avalanche]);
# the cheap mix fuses them, sharing the seed-independent lane*PRIME3
# products (2 of 8 multiplies + both lane loads) — strictly fewer ops,
# bit-identical output (kernels/sbf._hash_streams).
HASH_FLOPS_FULL = 24.0
HASH_FLOPS_CHEAP = 20.0

# Pattern generation + test flops per touched word (index arith, bit
# select, mask OR / compare).
PATTERN_FLOPS_PER_WORD = 3.0

# Expected fraction of probe columns a cooperative early-exit contains
# actually executes, on a mixed (~50% member) key stream: negatives die on
# the first failing column, positives scan all s. Exact per-column algebra
# depends on load; 0.6 is the mid-load expectation used for ranking.
COOP_COL_FRACTION = 0.6
# Expected fraction of cuckoo lookups that must probe the alternate bucket
# (primary-bucket hit rate at ~50% member mix and moderate load).
CUCKOO_ALT_FRACTION = 0.6
# Expected fraction of the quotient run-scan a home-slot ballot avoids.
QUOTIENT_SCAN_FRACTION = 0.7
# Quotient contains reads the resident table several times per tile
# (metadata cumsums + two gathers + remainder compare).
QUOTIENT_SCAN_PASSES = 6.0
# Vector-op equivalents to issue one row DMA (descriptor build + wait
# bookkeeping); depth-d pipelining overlaps d-1 of every d issues.
DMA_ISSUE_VOPS = 2.0


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Machine-independent resource counts for ONE bulk op call."""

    bytes_hbm: float
    bytes_res: float
    flops: float
    launches: float
    vops: float

    def scaled(self, f: float) -> "OpCost":
        return OpCost(self.bytes_hbm * f, self.bytes_res * f,
                      self.flops * f, self.launches, self.vops * f)


def _hash_flops(mix: str) -> float:
    return HASH_FLOPS_CHEAP if mix == "cheap" else HASH_FLOPS_FULL


def _unique_fraction(n_rows: int, tile: int) -> float:
    """E[#unique rows]/tile for ``tile`` uniform draws over ``n_rows`` —
    the DMA dedup factor of the sorted cooperative HBM probe."""
    if n_rows <= 0 or tile <= 0:
        return 1.0
    exp_unique = n_rows * (1.0 - (1.0 - 1.0 / n_rows) ** tile)
    return min(exp_unique / tile, 1.0)


def _layout_trips(spec: FilterSpec, layout, tile: int) -> float:
    """Loop-probe schedule trips per tile for a (Θ, Φ) layout."""
    if layout is None:
        theta, phi = 1, min(spec.s, 8)
    else:
        theta, phi = layout.theta, layout.phi
    return (tile / max(theta, 1)) * (spec.s / max(phi, 1) + 1.0)


def op_cost(spec: FilterSpec, op: str, regime: str = "vmem", *,
            layout=None, probe: str = "gather", coop: str = "none",
            mix: str = "full", depth: int = 2, tile: int = 256,
            n_keys: Optional[int] = None, bank: int = 1) -> OpCost:
    """Resource counts for one bulk ``op`` ("contains"|"add"|"remove") of
    ``n_keys`` keys (default: one tile) under the given configuration.

    Covers every engine family: blocked bit filters (row = s words),
    counting filters (row = 4s counter words, contains collapses 4
    counter words per logical word), cuckoo (two bucket gathers, coop
    skips the alternate), quotient (whole-table run scan per tile, coop
    predicates it on the home-slot ballot).
    """
    n = int(n_keys) if n_keys else tile
    n_tiles = max(math.ceil(n / tile), 1)
    hash_f = _hash_flops(mix) * n
    lg_tile = max(math.log2(max(tile, 2)), 1.0)
    lg_bank = math.log2(max(bank, 1))

    # Key stream in + result stream out cross the slow tier for every op.
    io_hbm = n * KEY_BYTES + (n * OUT_BYTES if op == "contains" else 0.0)

    if spec.is_fingerprint:
        row_words = spec.s                     # one bucket = s words
        load = bank * spec.n_words * WORD      # resident table stream-in
        if op == "contains":
            buckets = 1.0 + (CUCKOO_ALT_FRACTION if coop == "subtile"
                             else 1.0)
            touched = n * buckets * row_words
            vops = n_tiles * (10.0 + (4.0 if coop == "subtile" else 0.0))
            flops = hash_f + touched * PATTERN_FLOPS_PER_WORD
        else:                                  # sorted bounded-kick RMW
            touched = 4.0 * n * row_words
            vops = n_tiles * (2.0 * lg_tile + 24.0)
            flops = hash_f + touched * 2.0 * PATTERN_FLOPS_PER_WORD
        return OpCost(io_hbm + load, touched * WORD, flops, 1.0, vops)

    if spec.is_quotient:
        load = bank * spec.n_words * WORD
        if op == "contains":
            frac = QUOTIENT_SCAN_FRACTION if coop == "subtile" else 1.0
            touched = (n_tiles * spec.n_words * QUOTIENT_SCAN_PASSES * frac)
            vops = n_tiles * (16.0 + (4.0 if coop == "subtile" else 0.0))
            flops = hash_f + touched * PATTERN_FLOPS_PER_WORD
        else:                                  # decode + sort + rebuild
            touched = n_tiles * spec.n_words * 10.0
            vops = n_tiles * (2.0 * lg_tile + 40.0)
            flops = hash_f + touched * 2.0 * PATTERN_FLOPS_PER_WORD
        return OpCost(io_hbm + load, touched * WORD, flops, 1.0, vops)

    # Blocked / classical bit filters and counting filters. A probe row is
    # s words (bit filters) or 4s counter words (counting); a counting
    # *contains* additionally collapses 4 counter words per logical word.
    counting = spec.is_counting
    row_words = spec.counter_row_words if counting else spec.s
    storage = bank * spec.storage_words * WORD

    if regime == "hbm":
        # Per-row DMA streaming; the filter never becomes resident.
        if op == "contains":
            uniq = (_unique_fraction(spec.n_blocks, tile)
                    if coop == "subtile" else 1.0)
            rows = n * uniq
            eff_depth = 1 if coop == "subtile" else max(depth, 1)
            dma_vops = rows * DMA_ISSUE_VOPS / eff_depth
            scratch_pen = 0.01 * eff_depth * row_words   # deeper = more VMEM
            vops = n_tiles * 6.0 + n * 3.0 + dma_vops + n_tiles * scratch_pen
            touched = n * row_words * (1.5 if counting else 1.0)
            flops = hash_f + touched * PATTERN_FLOPS_PER_WORD
            return OpCost(io_hbm + rows * row_words * WORD,
                          touched * WORD, flops, 1.0, vops)
        # adds/updates RMW each unique row once per tile (the baseline HBM
        # add is already sorted-cooperative): read + write per unique row.
        uniq = _unique_fraction(spec.n_blocks, tile)
        rows = n * uniq
        vops = (n_tiles * (2.0 * lg_tile + 10.0) + n * 2.0
                + rows * DMA_ISSUE_VOPS)
        touched = n * row_words
        flops = hash_f + touched * 2.0 * PATTERN_FLOPS_PER_WORD
        return OpCost(io_hbm + 2.0 * rows * row_words * WORD,
                      touched * WORD, flops, 1.0, vops)

    # VMEM regime: stream the filter in once, probe it resident.
    if op == "contains":
        collapse = 4.0 if counting else 1.0    # counter-word gathers/word
        if coop == "subtile":
            frac = COOP_COL_FRACTION
            touched = n * spec.s * frac * collapse
            vops = n_tiles * (6.0 + 2.0 * spec.s * frac * collapse)
        elif probe == "loop":
            touched = n * spec.s * collapse
            vops = n_tiles * _layout_trips(spec, layout, tile) \
                * (1.0 + 0.05 * lg_bank)
        else:                                  # whole-tile gather
            touched = n * spec.s * collapse
            vops = n_tiles * (6.0 + 2.0 * collapse + 0.25 * lg_bank)
        flops = hash_f + touched * PATTERN_FLOPS_PER_WORD
        return OpCost(io_hbm + storage, touched * WORD, flops, 1.0, vops)

    # add / remove (RMW: read + write every touched word)
    if coop == "subtile":
        # flat word-granular stream: sort tile*row_words, segment-reduce,
        # ONE gather + ONE conflict-free scatter
        lg_flat = max(math.log2(max(tile * row_words, 2)), 1.0)
        touched = 2.0 * n * row_words
        vops = n_tiles * (2.0 * lg_flat + 10.0)
    elif probe == "loop":
        touched = 2.0 * n * row_words
        vops = n_tiles * 2.0 * _layout_trips(spec, layout, tile) \
            * (1.0 + 0.05 * lg_bank)
    else:                                      # sorted segmented-OR gather
        touched = 2.0 * n * row_words
        vops = n_tiles * (2.0 * lg_tile + 12.0 + 0.25 * lg_bank)
    flops = hash_f + touched * PATTERN_FLOPS_PER_WORD
    return OpCost(io_hbm + storage, touched * WORD, flops, 1.0, vops)


# ---------------------------------------------------------------------------
# Counts -> time
# ---------------------------------------------------------------------------

def _roofline_us(cost: OpCost, calib: Calibration) -> float:
    t_hbm = cost.bytes_hbm / (calib.bw_hbm_gbs * 1e3)      # bytes/GBps -> us
    t_res = cost.bytes_res / (calib.bw_res_gbs * 1e3)
    t_alu = cost.flops / (calib.gops * 1e3)
    return max(t_hbm, t_res, t_alu) + cost.launches * calib.launch_us


def ceiling_us(cost: OpCost, calib: Optional[Calibration] = None,
               device=None) -> float:
    """The practical speed of light: the roofline max of the three
    resource terms plus launch overhead — no schedule term. A perfect
    schedule on this device cannot beat this. Without ``calib``,
    ``device``'s calibration (default the card)."""
    return _roofline_us(cost, calib or get_calibration(device=device))


def predict_us(cost: OpCost, calib: Optional[Calibration] = None,
               device=None) -> float:
    """Expected wall time: the ceiling plus the schedule vector-op cost."""
    calib = calib or get_calibration(device=device)
    return _roofline_us(cost, calib) + cost.vops * calib.step_us


def ceiling_mops(spec: FilterSpec, op: str, regime: str = "vmem", *,
                 n_keys: int = 1 << 16, calib: Optional[Calibration] = None,
                 device=None, **cfg) -> float:
    """Model-predicted throughput ceiling (Mops/s = keys/us) for a bulk op
    at ``n_keys`` — the denominator of the speed-of-light fraction."""
    c = op_cost(spec, op, regime, n_keys=n_keys, **cfg)
    return n_keys / ceiling_us(c, calib, device)


def predict_config_us(spec: FilterSpec, op: str, regime: str, *,
                      layout=None, probe: str = "gather",
                      coop: str = "none", mix: str = "full", depth: int = 2,
                      tile: int = 256, bank: int = 1,
                      calib: Optional[Calibration] = None,
                      device=None) -> float:
    """Predicted per-tile time of one configuration — the quantity
    ``core.tuning.tune_plan`` ranks its candidate grid by."""
    c = op_cost(spec, op, regime, layout=layout, probe=probe, coop=coop,
                mix=mix, depth=depth, tile=tile, n_keys=tile, bank=bank)
    return predict_us(c, calib, device)


@functools.lru_cache(maxsize=512)
def choose_coop(spec: FilterSpec, op: str = "contains",
                regime: str = "vmem", tile: int = 256, device=None) -> tuple:
    """(coop, mix) with the lowest predicted cost on ``device`` (default
    the card) — the ``"auto"`` resolution for engines outside the Bloom
    tuner (cuckoo/quotient). lru-cached: all-static arguments."""
    calib = get_calibration(device=device)
    best, best_key = ("none", "full"), None
    # candidate order breaks predict_us ties toward the cheap fused mix
    # (strictly fewer flops, bit-identical) and the non-coop baseline
    # (coop must *win*, not tie, to displace it).
    for coop in ("none", "subtile"):
        for mix in ("cheap", "full"):
            t = predict_config_us(spec, op, regime, coop=coop, mix=mix,
                                  tile=tile, calib=calib)
            c = op_cost(spec, op, regime, coop=coop, mix=mix, tile=tile,
                        n_keys=tile)
            key = (t, c.flops)
            if best_key is None or key < best_key:
                best, best_key = (coop, mix), key
    return best
