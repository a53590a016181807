"""Dispatch of bulk ``add``/``contains`` to the blocked and classical
Bloom kernels, of the counting filter's ``add``/``remove``/``contains``/
``decay`` to the counting kernels, and of the windowed filter's query to
the generation-ring kernel.

Counterpart of ``repro.kernels.ops.bloom_contains`` / ``bloom_add``,
``counting_add`` / ``counting_remove`` / ``counting_contains`` /
``counting_decay``, ``ring_contains`` and the bank forms
``bloom_bank_contains`` / ``bloom_bank_add`` / ``counting_bank_update`` /
``counting_bank_contains``:

* regime: a filter whose storage is at most ``L2_FILTER_BYTES`` runs the
  L2-resident kernels (``*_vmem``), a larger one the DRAM-resident kernels
  (``*_hbm``); for a ring the bytes of all G generations count. Decay is
  one kernel for both, and so is each classical-filter op
  (``kernels/cbf.py`` says why). A bank's regime comes from the whole
  bank's bytes (``bank_l2_resident``); the JAX package runs its bank kernels
  only on a VMEM-resident bank and sends the rest to jnp, while here the
  same bank kernel serves both regimes (``depth`` keys a thread in DRAM).
  The regime names stay ``"vmem"`` and ``"hbm"`` as in the JAX package.
  The regime never changes a result;
* ``probe``/``coop``/``mix``/``depth``/``layout``/``tile`` are validated as
  the JAX package does. ``"auto"`` (and ``depth=None``) resolve as the JAX
  dispatch resolves them, for the device of the keys: the Bloom and
  counting axes through ``core.tuning.tune_plan`` (lru and disk cached),
  with the tile clamped to the batch first (``_clamp_tile``), and the
  cuckoo and quotient ``coop`` through ``perfmodel.choose_coop``. Two
  resolutions have no JAX counterpart, since the JAX package runs bank and
  ring kernels on VMEM-resident state only: the depth of a bank contains
  in DRAM is ``tune_plan(regime="hbm", bank=B)``'s, and that of a ring
  contains in DRAM is the spec's ``tune_plan(regime="hbm")`` depth. The
  bank forms resolve probe and mix with coop pinned to ``"none"``, since
  the bank kernels have no cooperative form (the JAX dispatch leaves coop
  ``"auto"`` there; on the CPU calibration the two plans agree). The
  caller's ``layout`` reaches the blocked and counting wrappers as it was
  given, None included: there the card runs ``sbf.card_layout`` (the
  counting contains ``countingbf.card_layout``), where the JAX dispatch
  fills in ``default_layout`` (the plain path still validates it). Which
  axes the CUDA kernels act on is set out in ``kernels/sbf.py`` and
  ``kernels/countingbf.py``; no axis changes a result;
* keys on the CPU are padded to a tile multiple before the plain path, as
  in the JAX package: by repeating the last key (``_pad_keys``) for the
  OR-idempotent bit ops and for every contains, and with zero keys marked
  invalid (``_pad_keys_valid``) for counting updates, which are not
  idempotent. Flat routed bank keys pad the same way with their member
  ids (``_pad_flat`` for reads; ``_pad_flat_valid`` for every bank write:
  zero keys on member 0, marked invalid). The CUDA kernels mask the ragged
  tail themselves;
* ``bloom_add``/``counting_*(..., inplace=False)`` clone the words first,
  as JAX's immutable arrays behave; ``inplace=True`` is the counterpart of
  the JAX package's buffer donation and updates ``filt`` itself;
* ``bloom_add_partitioned`` / ``counting_update_partitioned`` bucket the
  keys by the filter segment that owns their block (``partition="jit"``:
  on the keys' device, doubling the capacity until nothing overflows
  unless the caller pins it, in which case the dropped keys take a
  residual pass through the atomic kernels; ``"host"``: the exact numpy
  partition) and run the partitioned kernels, one CTA a segment;
* the ``*_jit`` entry points are the JAX package's cached-jit layer as
  thin calls: PyTorch runs eagerly, so there is no executable to cache.
  ``jit_cache_info`` counts the configurations and batch shapes seen, as
  the JAX cache counts its executables (an LRU of 256); ``donate=True``
  (JAX's buffer donation) updates the passed tensor in place,
  ``donate=False`` leaves it untouched;
* ``cuckoo_*`` dispatch the cuckoo filter's kernels, which take any batch
  length (no padding). The JAX package runs its cuckoo kernels only on a
  table that fits VMEM and sends a larger one to jnp; here one kernel pair
  serves every size. The update's tile is ``_cuckoo_tile``, the JAX
  dispatch's, so the order of the inserts, and with it the table, is the
  JAX package's; a small batch's tile also sizes the kernel's sort;
* ``quotient_*`` dispatch the quotient filter's kernels. On the CPU the keys
  are padded to the JAX dispatch's tile (``_quotient_tile``) as it pads
  them: by repeating the last key for contains, with zero keys marked
  invalid for updates (inserts and removes are not idempotent). The CUDA
  kernels take any batch length. The JAX package runs its quotient kernels
  only on a table that fits VMEM and sends a larger one to jnp; here one
  kernel set serves every size, and the CUDA update rebuilds the table
  once a call (the words and flags do not depend on the tile).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fingerprint as F
from repro_torch.core import partition as P
from repro_torch.core import quotient as Q
from repro_torch.core.variants import BLOCKED, FilterSpec
from repro_torch.kernels import cbf as cbf_k
from repro_torch.kernels import countingbf as cnt_k
from repro_torch.kernels import cuckoofilter as ckoo_k
from repro_torch.kernels import quotientfilter as qf_k
from repro_torch.kernels import ring as ring_k
from repro_torch.kernels import sbf as sbf_k
from repro_torch.kernels.sbf import (COOPS, DEFAULT_TILE, MIXES, PROBES,
                                     Layout)

# Filters of at most this many bytes run the L2-resident kernels: the largest
# size of chip_smoke.py's crossover sweep (phase 4g: sbf and countingbf
# contains, 8-64 MiB, single filters and banks) at which the L2 schedule is
# no slower than the DRAM schedule at the depth the tuner gives it (8), on
# an NVIDIA H100 80GB HBM3 at 700.00 W: 0.59-0.90x at every swept size in
# two runs, so the line lies at or above 64 MiB. It holds only while the
# tuner picks depth 8: against the DRAM schedule at its best depth (1 or 2)
# the L2 schedule took 0.97-1.06x at every size (at depth 1 the two are one
# kernel instance), so there the line would decide nothing but the depth.
# Since the blocked contains runs Θ = 2 in both schedules, the sbf
# schedules differ only in depth: 0.91-1.00x at 8-64 MiB, a tie at 64 MiB;
# the counting contains keeps 0.73-0.84x.
L2_FILTER_BYTES = 64 * 1024 * 1024

REGIMES = ("vmem", "hbm")


def kernel_supported(spec: FilterSpec) -> bool:
    """Specs the CUDA bit-filter kernels serve: blocked variants with s <= 32
    words, and classical filters of at most 2^32 bits."""
    if spec.variant == "cbf":
        return spec.m_bits <= 1 << 32
    return spec.variant in BLOCKED and spec.s <= 32


def fits_l2(spec: FilterSpec, generations: int = 1) -> bool:
    """The filter's storage (times ``generations`` for a ring) fits
    ``L2_FILTER_BYTES``."""
    return generations * spec.storage_words * 4 <= L2_FILTER_BYTES


def _regime(spec: FilterSpec, regime: str, generations: int = 1) -> str:
    if regime == "auto":
        return "vmem" if fits_l2(spec, generations) else "hbm"
    if regime not in REGIMES:
        raise ValueError(f"regime={regime!r} not in {REGIMES} or 'auto'")
    return regime


def _clamp_tile(n: int, tile: int) -> int:
    """Shrink the key tile for small batches: next pow2 >= n, floor 8."""
    return min(tile, max(8, 1 << int(np.ceil(np.log2(n)))))


def _check_axis(value: str, choices, axis: str) -> None:
    if value != "auto" and value not in choices:
        raise ValueError(f"{axis}={value!r} not in {choices} or 'auto'")


def _check_axes(probe: str, coop: str, mix: str) -> None:
    """Validate the three schedule axes (each a value or ``"auto"``)."""
    _check_axis(probe, PROBES, "probe")
    _check_axis(coop, COOPS, "coop")
    _check_axis(mix, MIXES, "mix")


def _resolve_pcm(spec: FilterSpec, op: str, regime: str, tile: int,
                 probe: str = "auto", coop: str = "auto", mix: str = "auto",
                 bank: int = 1, device=None):
    """Resolve the (probe, coop, mix) triple: pinned values pass through,
    ``"auto"`` axes come from one ``tune_plan`` query keyed to the pinned
    axes (so a pinned coop never reuses a plan tuned under another)."""
    _check_axes(probe, coop, mix)
    if "auto" not in (probe, coop, mix):
        return probe, coop, mix
    from repro_torch.core import tuning
    plan = tuning.tune_plan(spec, op, regime=regime, tile=tile, bank=bank,
                            coop=coop, mix=mix, device=device)
    return (probe if probe != "auto" else plan.probe,
            coop if coop != "auto" else plan.coop,
            mix if mix != "auto" else plan.mix)


def _resolve_depth(spec: FilterSpec, op: str, depth: Optional[int],
                   tile: int, bank: int = 1, device=None) -> int:
    """``None`` takes the tuner's DRAM-regime depth for ``device``."""
    if depth is not None:
        return depth
    from repro_torch.core import tuning
    return tuning.tune_plan(spec, op, regime="hbm", tile=tile, bank=bank,
                            device=device).depth


def _resolve_coop_fp(spec: FilterSpec, coop: str, tile: int,
                     device=None) -> str:
    """``"auto"`` cooperation for the cuckoo and quotient engines: the
    lru-cached perfmodel helper (they have no layout grid, so they bypass
    ``tune_plan``)."""
    _check_axis(coop, COOPS, "coop")
    if coop != "auto":
        return coop
    from repro_torch import perfmodel as PM
    return PM.choose_coop(spec, "contains", "vmem", tile, device)[0]


def _pad_keys(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """Pad to a tile multiple by repeating the last key — valid for the
    OR-idempotent bit-filter ops only (a repeated add is a no-op, a repeated
    contains result is cut off)."""
    pad = (-keys.shape[0]) % tile
    if pad == 0:
        return keys
    return torch.cat([keys, keys[-1:].expand(pad, 2)])


def _pad_keys_valid(keys: torch.Tensor, tile: int,
                    valid: Optional[torch.Tensor] = None):
    """Pad to a tile multiple with zero keys marked invalid (never a
    repeated key: counting updates are not idempotent). Returns (padded
    keys, (n_padded,) uint8 valid)."""
    n = keys.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.uint8, device=keys.device)
    else:
        valid = valid.to(torch.uint8)
    pad = (-n) % tile
    if pad == 0:
        return keys, valid
    return (torch.cat([keys, keys.new_zeros((pad, 2))]),
            torch.cat([valid, valid.new_zeros((pad,))]))


def _check_spec(spec: FilterSpec) -> None:
    if spec.is_counting:
        raise ValueError("countingbf specs go through counting_add/"
                         "counting_remove/counting_contains")
    if spec.is_quotient:
        raise ValueError("quotient specs go through quotient_add/"
                         "quotient_remove/quotient_contains")
    if spec.is_fingerprint:
        raise ValueError("cuckoo specs go through cuckoo_add/cuckoo_remove/"
                         "cuckoo_contains")


def bloom_contains(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                   layout: Optional[Layout] = None, regime: str = "auto",
                   tile: int = DEFAULT_TILE, probe: str = "auto",
                   depth: Optional[int] = None, coop: str = "auto",
                   mix: str = "auto") -> torch.Tensor:
    """(n,) bool membership of ``keys`` (n, 2) int32 in ``filt``."""
    _check_spec(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    tile = _clamp_tile(n, tile)
    padded = keys if keys.is_cuda else _pad_keys(keys, tile)
    dev = keys.device
    if spec.variant == "cbf":
        _check_axes(probe, coop, mix)
        _regime(spec, regime)         # validated: one kernel serves both
        out = cbf_k.contains_vmem(spec, filt, padded)
    elif _regime(spec, regime) == "vmem":
        p, c, m = _resolve_pcm(spec, "contains", "vmem", tile, probe, coop,
                               mix, device=dev)
        out = sbf_k.contains_vmem(spec, filt, padded, layout, tile=tile,
                                  probe=p, coop=c, mix=m)
    else:
        _check_axis(probe, PROBES, "probe")
        _, c, m = _resolve_pcm(spec, "contains", "hbm", tile, "gather",
                               coop, mix, device=dev)
        out = sbf_k.contains_hbm(
            spec, filt, padded, coop=c, mix=m,
            depth=_resolve_depth(spec, "contains", depth, tile, device=dev))
    return out[:n]


def bloom_add(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
              layout: Optional[Layout] = None, regime: str = "auto",
              tile: int = DEFAULT_TILE, probe: str = "auto",
              coop: str = "auto", mix: str = "auto",
              inplace: bool = False) -> torch.Tensor:
    """OR ``keys`` into the filter; returns the words (``filt`` itself when
    ``inplace``, else a new tensor and ``filt`` is unchanged)."""
    _check_spec(spec)
    out = filt if inplace else filt.clone()
    n = keys.shape[0]
    if n == 0:
        return out
    tile = _clamp_tile(n, tile)
    padded = keys if keys.is_cuda else _pad_keys(keys, tile)
    dev = keys.device
    if spec.variant == "cbf":
        _check_axes(probe, coop, mix)
        _regime(spec, regime)         # validated: one kernel serves both
        return cbf_k.add_vmem(spec, out, padded)
    if _regime(spec, regime) == "vmem":
        p, c, m = _resolve_pcm(spec, "add", "vmem", tile, probe, coop, mix,
                               device=dev)
        return sbf_k.add_vmem(spec, out, padded, layout, tile=tile, probe=p,
                              coop=c, mix=m)
    _check_axis(probe, PROBES, "probe")
    _, c, m = _resolve_pcm(spec, "add", "hbm", tile, "gather", coop, mix,
                           device=dev)
    return sbf_k.add_hbm(spec, out, padded, coop=c, mix=m)


# ---------------------------------------------------------------------------
# Counting-filter dispatch (valid-masked padding on the plain path)
# ---------------------------------------------------------------------------

def counting_kernel_supported(spec: FilterSpec) -> bool:
    """Specs the CUDA counting kernels serve: countingbf, s <= 32 words."""
    return spec.is_counting and spec.s <= 32


def _check_counting(spec: FilterSpec) -> None:
    if not spec.is_counting:
        raise ValueError(f"{spec} is not a countingbf spec; use bloom_*")


def _counting_update(spec: FilterSpec, filt: torch.Tensor,
                     keys: torch.Tensor, op: str, layout: Optional[Layout],
                     regime: str, tile: int, valid: Optional[torch.Tensor],
                     probe: str, coop: str, mix: str,
                     inplace: bool) -> torch.Tensor:
    _check_counting(spec)
    out = filt if inplace else filt.clone()
    n = keys.shape[0]
    if n == 0:
        return out
    tile = _clamp_tile(n, tile)
    if not keys.is_cuda:
        keys, valid = _pad_keys_valid(keys, tile, valid)
    dev = keys.device
    if _regime(spec, regime) == "vmem":
        p, c, m = _resolve_pcm(spec, "add", "vmem", tile, probe, coop, mix,
                               device=dev)
        return cnt_k.update_vmem(
            spec, out, keys, valid, op, layout=layout, tile=tile, probe=p,
            coop=c, mix=m)
    _check_axis(probe, PROBES, "probe")
    _, c, m = _resolve_pcm(spec, "add", "hbm", tile, "gather", coop, mix,
                           device=dev)
    return cnt_k.update_hbm(spec, out, keys, valid, op, coop=c, mix=m)


def counting_add(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 layout: Optional[Layout] = None, regime: str = "auto",
                 tile: int = DEFAULT_TILE,
                 valid: Optional[torch.Tensor] = None, probe: str = "auto",
                 coop: str = "auto", mix: str = "auto",
                 inplace: bool = False) -> torch.Tensor:
    """Bulk saturating increment of each valid key's k counters."""
    return _counting_update(spec, filt, keys, "add", layout, regime, tile,
                            valid, probe, coop, mix, inplace)


def counting_remove(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                    layout: Optional[Layout] = None, regime: str = "auto",
                    tile: int = DEFAULT_TILE,
                    valid: Optional[torch.Tensor] = None, probe: str = "auto",
                    coop: str = "auto", mix: str = "auto",
                    inplace: bool = False) -> torch.Tensor:
    """Bulk guarded decrement (0 floors, saturated counters stick)."""
    return _counting_update(spec, filt, keys, "remove", layout, regime, tile,
                            valid, probe, coop, mix, inplace)


def counting_contains(spec: FilterSpec, filt: torch.Tensor,
                      keys: torch.Tensor, layout: Optional[Layout] = None,
                      regime: str = "auto", tile: int = DEFAULT_TILE,
                      probe: str = "auto", depth: Optional[int] = None,
                      coop: str = "auto", mix: str = "auto") -> torch.Tensor:
    """(n,) bool membership against the counter occupancy (read-only, so
    repeat-key padding is safe here: the padded results are cut off)."""
    _check_counting(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    tile = _clamp_tile(n, tile)
    padded = keys if keys.is_cuda else _pad_keys(keys, tile)
    dev = keys.device
    if _regime(spec, regime) == "vmem":
        p, c, m = _resolve_pcm(spec, "contains", "vmem", tile, probe, coop,
                               mix, device=dev)
        out = cnt_k.contains_vmem(
            spec, filt, padded, layout=layout, tile=tile, probe=p, coop=c,
            mix=m)
    else:
        _check_axis(probe, PROBES, "probe")
        _, c, m = _resolve_pcm(spec, "contains", "hbm", tile, "gather",
                               coop, mix, device=dev)
        out = cnt_k.contains_hbm(
            spec, filt, padded, coop=c, mix=m,
            depth=_resolve_depth(spec, "contains", depth, tile, device=dev))
    return out[:n]


def counting_decay(spec: FilterSpec, filt: torch.Tensor,
                   inplace: bool = False) -> torch.Tensor:
    """One aging step (every nonzero counter -1), one kernel launch."""
    _check_counting(spec)
    return cnt_k.decay(spec, filt if inplace else filt.clone())


# ---------------------------------------------------------------------------
# Generation-ring dispatch (the windowed filter's query)
# ---------------------------------------------------------------------------

def ring_contains(spec: FilterSpec, rings: torch.Tensor, keys: torch.Tensor,
                  regime: str = "auto", tile: int = DEFAULT_TILE
                  ) -> torch.Tensor:
    """Fused membership across a (G, n_words) generation ring: one hash per
    key, its G rows ORed before a single mask test. The regime comes from
    the whole ring's bytes, ``G * n_words * 4``, and picks the wrapper, whose
    rule (``ring.choose_contains_path``) picks the path; no schedule on the
    card takes a DMA depth, so none is resolved."""
    _check_spec(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    tile = _clamp_tile(n, tile)
    padded = keys if keys.is_cuda else _pad_keys(keys, tile)
    if _regime(spec, regime, rings.shape[0]) == "vmem":
        out = ring_k.ring_contains_vmem(spec, rings, padded)
    else:
        out = ring_k.ring_contains_hbm(spec, rings, padded)
    return out[:n]


# ---------------------------------------------------------------------------
# Bank dispatch: flat routed keys (keys (N, 2), member (N,)) against a
# (B, storage_words) bank, one launch for the whole bank in either regime
# ---------------------------------------------------------------------------

def bank_l2_resident(spec: FilterSpec, bank: int) -> bool:
    """Does a B-member bank fit ``L2_FILTER_BYTES`` whole?"""
    return bank * spec.storage_words * 4 <= L2_FILTER_BYTES


def _bank_regime(spec: FilterSpec, bank: int, regime: str) -> str:
    if regime == "auto":
        return "vmem" if bank_l2_resident(spec, bank) else "hbm"
    return _regime(spec, regime)


def _pad_flat(keys: torch.Tensor, member: torch.Tensor, tile: int):
    """Repeat-last padding of (keys, member) to a tile multiple: reads
    only."""
    pad = (-keys.shape[0]) % tile
    if pad == 0:
        return keys, member
    return (torch.cat([keys, keys[-1:].expand(pad, 2)]),
            torch.cat([member, member[-1:].expand(pad)]))


def _pad_flat_valid(keys: torch.Tensor, member: torch.Tensor,
                    valid: Optional[torch.Tensor], tile: int):
    """Zero padding of (keys, member) to a tile multiple with an explicit
    (n_padded,) uint8 validity mask: writes. A padded slot is the zero key
    on member 0, a real key, so the mask must be honoured."""
    n = keys.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.uint8, device=keys.device)
    valid = valid.to(torch.uint8)
    pad = (-n) % tile
    if pad == 0:
        return keys, member, valid
    return (torch.cat([keys, keys.new_zeros((pad, 2))]),
            torch.cat([member, member.new_zeros((pad,))]),
            torch.cat([valid, valid.new_zeros((pad,))]))


def _check_bank_spec(spec: FilterSpec) -> None:
    _check_spec(spec)
    if spec.variant == "cbf":
        raise ValueError("cbf banks have no bank kernel: they run the scalar "
                         "cbf kernel member by member (the engines' generic "
                         "bank path)")


def bloom_bank_contains(spec: FilterSpec, bank: torch.Tensor,
                        keys: torch.Tensor, member: torch.Tensor,
                        layout: Optional[Layout] = None, regime: str = "auto",
                        tile: int = DEFAULT_TILE, probe: str = "auto",
                        depth: Optional[int] = None, mix: str = "auto"
                        ) -> torch.Tensor:
    """(N,) bool membership of flat routed keys against a (B, n_words)
    bank."""
    _check_bank_spec(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    tile = _clamp_tile(n, tile)
    member = member.to(torch.int32)
    if not keys.is_cuda:
        keys, member = _pad_flat(keys, member, tile)
    B, dev = bank.shape[0], keys.device
    if _bank_regime(spec, B, regime) == "vmem":
        d = 1
    else:
        d = _resolve_depth(spec, "contains", depth, tile, bank=B, device=dev)
    p, _, m = _resolve_pcm(spec, "contains", "vmem", tile, probe, "none",
                           mix, bank=B, device=dev)
    out = sbf_k.bank_contains_vmem(spec, bank, keys, member, layout,
                                   tile=tile, probe=p, mix=m, depth=d)
    return out[:n]


def bloom_bank_add(spec: FilterSpec, bank: torch.Tensor, keys: torch.Tensor,
                   member: torch.Tensor, valid: Optional[torch.Tensor] = None,
                   layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                   probe: str = "auto", mix: str = "auto",
                   inplace: bool = False) -> torch.Tensor:
    """Valid-masked bulk OR of flat routed keys into a (B, n_words) bank;
    one kernel serves a bank in L2 and one in DRAM alike."""
    _check_bank_spec(spec)
    out = bank if inplace else bank.clone()
    n = keys.shape[0]
    if n == 0:
        return out
    tile = _clamp_tile(n, tile)
    member = member.to(torch.int32)
    if not keys.is_cuda:
        keys, member, valid = _pad_flat_valid(keys, member, valid, tile)
    p, _, m = _resolve_pcm(spec, "add", "vmem", tile, probe, "none", mix,
                           bank=bank.shape[0], device=keys.device)
    return sbf_k.bank_add_vmem(spec, out, keys, member, valid, layout,
                               tile=tile, probe=p, mix=m)


def counting_bank_update(spec: FilterSpec, bank: torch.Tensor,
                         keys: torch.Tensor, member: torch.Tensor,
                         op: str = "add",
                         valid: Optional[torch.Tensor] = None,
                         layout: Optional[Layout] = None,
                         tile: int = DEFAULT_TILE, probe: str = "auto",
                         mix: str = "auto", inplace: bool = False
                         ) -> torch.Tensor:
    """Flat routed counter increment/decrement of a (B, storage_words)
    bank; one kernel serves a bank in L2 and one in DRAM alike."""
    _check_counting(spec)
    out = bank if inplace else bank.clone()
    n = keys.shape[0]
    if n == 0:
        return out
    tile = _clamp_tile(n, tile)
    member = member.to(torch.int32)
    if not keys.is_cuda:
        keys, member, valid = _pad_flat_valid(keys, member, valid, tile)
    p, _, m = _resolve_pcm(spec, "add", "vmem", tile, probe, "none", mix,
                           bank=bank.shape[0], device=keys.device)
    return cnt_k.bank_update_vmem(
        spec, out, keys, member, valid, op, layout=layout, tile=tile,
        probe=p, mix=m)


def counting_bank_contains(spec: FilterSpec, bank: torch.Tensor,
                           keys: torch.Tensor, member: torch.Tensor,
                           regime: str = "auto", tile: int = DEFAULT_TILE,
                           depth: Optional[int] = None) -> torch.Tensor:
    """(N,) bool occupancy membership against a counter bank."""
    _check_counting(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    tile = _clamp_tile(n, tile)
    member = member.to(torch.int32)
    if not keys.is_cuda:
        keys, member = _pad_flat(keys, member, tile)
    B = bank.shape[0]
    if _bank_regime(spec, B, regime) == "vmem":
        d = 1
    else:
        d = _resolve_depth(spec, "contains", depth, tile, bank=B,
                           device=keys.device)
    out = cnt_k.bank_contains_vmem(spec, bank, keys, member, depth=d)
    return out[:n]


# ---------------------------------------------------------------------------
# Partitioned ownership path: keys bucketed by filter segment, one CTA a
# segment
# ---------------------------------------------------------------------------

def _default_capacity(n: int, n_segments: int) -> int:
    """4 x the mean keys a segment (about overflow-free for uniform
    hashes), 8-aligned."""
    cap = max(4 * n // n_segments, 8)
    return (cap + 7) & ~7


def _partition_device(spec: FilterSpec, keys: torch.Tensor, n_segments: int,
                      capacity: Optional[int]) -> P.JitPartition:
    """``partition_jit``, doubling the capacity until no key overflows when
    the caller pins none (bounded: a capacity of n cannot overflow). A
    pinned capacity is kept; the caller handles the overflow."""
    n = keys.shape[0]
    cap = capacity or _default_capacity(n, n_segments)
    part = P.partition_jit(spec, keys, n_segments, cap)
    if capacity is not None:
        return part
    while int(part.overflow) > 0:
        cap = min(2 * cap, (n + 7) & ~7)
        part = P.partition_jit(spec, keys, n_segments, cap)
    return part


def _residual_or(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """OR the keys the partition dropped (``~keep``) into ``filt`` in place,
    through ``bloom_add``: exact whatever the capacity."""
    return bloom_add(spec, filt, keys[~keep], inplace=True)


def _residual_counting(spec: FilterSpec, filt: torch.Tensor,
                       keys: torch.Tensor, keep: torch.Tensor,
                       op: str) -> torch.Tensor:
    """Update the dropped keys' counters in place, valid-masked so that the
    pass touches only them (counter updates are not idempotent)."""
    return _counting_update(spec, filt, keys, op, None, "auto",
                            DEFAULT_TILE, (~keep).to(torch.uint8), "auto",
                            "auto", "auto", True)


def _check_partition(partition: str) -> None:
    if partition not in ("jit", "host"):
        raise ValueError(f"partition={partition!r} not in ('jit', 'host')")


def bloom_add_partitioned(spec: FilterSpec, filt: torch.Tensor,
                          keys: torch.Tensor, n_segments: int = 8,
                          capacity: Optional[int] = None,
                          partition: str = "jit", inplace: bool = False
                          ) -> torch.Tensor:
    """OR ``keys`` in through the partitioned kernel: the keys are bucketed
    by segment (``partition="jit"`` on their device, ``"host"`` exactly in
    numpy), then each CTA owns one segment. A pinned ``capacity`` that
    overflows sends the dropped keys through ``bloom_add``; no key is
    lost. The kernel's path comes from the filter's regime
    (:func:`fits_l2`)."""
    _check_spec(spec)
    if spec.variant == "cbf":
        raise ValueError("the classical filter has no block locality to "
                         "partition by")
    _check_partition(partition)
    out = filt if inplace else filt.clone()
    if keys.shape[0] == 0:
        return out
    if partition == "host":
        by_seg, valid, _ = P.partition_host(spec, keys, n_segments)
        return sbf_k.add_partitioned(spec, out, by_seg.to(out.device),
                                     valid.to(out.device), n_segments,
                                     l2_resident=fits_l2(spec))
    part = _partition_device(spec, keys, n_segments, capacity)
    sbf_k.add_partitioned(spec, out, part.keys_by_seg, part.valid,
                          n_segments, l2_resident=fits_l2(spec))
    if int(part.overflow) == 0:
        return out
    return _residual_or(spec, out, keys, part.keep)


def counting_update_partitioned(spec: FilterSpec, filt: torch.Tensor,
                                keys: torch.Tensor, op: str = "add",
                                n_segments: int = 8,
                                capacity: Optional[int] = None,
                                partition: str = "jit",
                                inplace: bool = False) -> torch.Tensor:
    """Counter increment (``op="add"``) or guarded decrement through the
    partitioned kernel, with the partition and overflow contract of
    :func:`bloom_add_partitioned` (the residual pass is valid-masked)."""
    _check_counting(spec)
    _check_partition(partition)
    out = filt if inplace else filt.clone()
    if keys.shape[0] == 0:
        return out
    if partition == "host":
        by_seg, valid, _ = P.partition_host(spec, keys, n_segments)
        return cnt_k.update_partitioned(spec, out, by_seg.to(out.device),
                                        valid.to(out.device), n_segments, op)
    part = _partition_device(spec, keys, n_segments, capacity)
    cnt_k.update_partitioned(spec, out, part.keys_by_seg, part.valid,
                             n_segments, op)
    if int(part.overflow) == 0:
        return out
    return _residual_counting(spec, out, keys, part.keep, op)


# ---------------------------------------------------------------------------
# Cached dispatch layer (the JAX package's cached-jit entry points)
# ---------------------------------------------------------------------------

_JIT_KEYS: "OrderedDict" = OrderedDict()
_JIT_KEYS_MAX = 256      # the JAX cache's LRU bound


def jit_cache_info() -> Tuple[int, ...]:
    """(number of distinct dispatch configurations seen,), counted as the
    JAX package counts its cached executables."""
    return (len(_JIT_KEYS),)


def jit_cache_clear() -> None:
    _JIT_KEYS.clear()


def _seen(key) -> None:
    _JIT_KEYS[key] = None
    _JIT_KEYS.move_to_end(key)
    if len(_JIT_KEYS) > _JIT_KEYS_MAX:
        _JIT_KEYS.popitem(last=False)


def _resolved(spec: FilterSpec, regime: str, probe: str, coop: str,
              mix: str) -> dict:
    """The dispatch of one configuration: the regime resolved, the schedule
    axes validated and passed on, so that ``"auto"`` resolves in the call
    as it does without the cached layer (through the tuner, with the tile
    clamped to the batch)."""
    _check_axes(probe, coop, mix)
    return {"regime": _regime(spec, regime), "probe": probe, "coop": coop,
            "mix": mix}


def bloom_add_jit(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  *, layout: Optional[Layout] = None, regime: str = "auto",
                  tile: int = DEFAULT_TILE, probe: str = "auto",
                  coop: str = "auto", mix: str = "auto",
                  donate: bool = True) -> torch.Tensor:
    """Bulk add. ``donate=True`` updates ``filt`` itself and returns it
    (JAX donates the buffer); ``donate=False`` leaves it untouched."""
    _seen(("bloom_add", spec, layout, regime, tile, probe, coop, mix,
           tuple(keys.shape), str(keys.dtype), bool(donate)))
    return bloom_add(spec, filt, keys, layout=layout, tile=tile,
                     inplace=donate,
                     **_resolved(spec, regime, probe, coop, mix))


def bloom_contains_jit(spec: FilterSpec, filt: torch.Tensor,
                       keys: torch.Tensor, *, layout: Optional[Layout] = None,
                       regime: str = "auto", tile: int = DEFAULT_TILE,
                       probe: str = "auto", depth: Optional[int] = None,
                       coop: str = "auto", mix: str = "auto") -> torch.Tensor:
    """Bulk membership (read-only: nothing to donate)."""
    _seen(("bloom_contains", spec, layout, regime, tile, probe, depth, coop,
           mix, tuple(keys.shape), str(keys.dtype)))
    return bloom_contains(spec, filt, keys, layout=layout, tile=tile,
                          depth=depth,
                          **_resolved(spec, regime, probe, coop, mix))


def counting_update_jit(spec: FilterSpec, filt: torch.Tensor,
                        keys: torch.Tensor, op: str = "add", *,
                        layout: Optional[Layout] = None, regime: str = "auto",
                        tile: int = DEFAULT_TILE, probe: str = "auto",
                        coop: str = "auto", mix: str = "auto",
                        donate: bool = True) -> torch.Tensor:
    """Counter increment/decrement; ``donate`` as in
    :func:`bloom_add_jit`."""
    _check_counting(spec)
    _seen(("counting_update", spec, op, layout, regime, tile, probe, coop,
           mix, tuple(keys.shape), str(keys.dtype), bool(donate)))
    fn = counting_add if op == "add" else counting_remove
    return fn(spec, filt, keys, layout=layout, tile=tile, inplace=donate,
              **_resolved(spec, regime, probe, coop, mix))


# ---------------------------------------------------------------------------
# Cuckoo fingerprint dispatch (valid-masked padding on the plain path)
# ---------------------------------------------------------------------------

def cuckoo_kernel_supported(spec: FilterSpec) -> bool:
    """Cuckoo specs the CUDA cuckoo kernels serve."""
    return ckoo_k.kernel_supported(spec)


def _check_cuckoo(spec: FilterSpec) -> None:
    if spec.variant != "cuckoo":
        raise ValueError(f"{spec} is not a cuckoo spec")


def cuckoo_contains(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                    tile: Optional[int] = DEFAULT_TILE,
                    coop: str = "auto") -> torch.Tensor:
    """(n,) bool two-bucket membership, one launch for the batch. ``tile``
    is the JAX signature's; the kernel takes a thread a key."""
    _check_cuckoo(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    c = _resolve_coop_fp(spec, coop, _clamp_tile(n, tile or DEFAULT_TILE),
                         keys.device)
    return ckoo_k.contains_vmem(spec, filt, keys, coop=c)


def _cuckoo_tile(n: int, tile: Optional[int]) -> int:
    """The bulk update's tile, as ``fingerprint.cuckoo_add`` chunks the
    unpadded batch: a batch of at most T keys is one tile (padded up to a
    power of two, at least 8), a larger one tiles of T."""
    T = tile or F.CUCKOO_ADD_TILE
    if n <= T:
        return max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
    return T


def _cuckoo_update(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                   op: str, valid: Optional[torch.Tensor],
                   tile: Optional[int], inplace: bool):
    _check_cuckoo(spec)
    out = filt if inplace else filt.clone()
    n = keys.shape[0]
    if n == 0:
        return out, torch.zeros((0,), dtype=torch.bool, device=keys.device)
    fn = ckoo_k.add_vmem if op == "add" else ckoo_k.remove_vmem
    return fn(spec, out, keys, valid, tile=_cuckoo_tile(n, tile))


def cuckoo_add(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
               valid: Optional[torch.Tensor] = None,
               tile: Optional[int] = None, inplace: bool = False):
    """Ordered bulk insert: (table, ok); ``ok[i]`` False is key i's
    bounded-kick failure (the API accumulates it in
    ``Filter.insert_failures``)."""
    return _cuckoo_update(spec, filt, keys, "add", valid, tile, inplace)


def cuckoo_remove(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  tile: Optional[int] = None, inplace: bool = False):
    """Ordered bulk delete, one slot a key: (table, found)."""
    return _cuckoo_update(spec, filt, keys, "remove", valid, tile, inplace)


# ---------------------------------------------------------------------------
# Quotient filter dispatch (valid-masked padding on the plain path)
# ---------------------------------------------------------------------------

def quotient_kernel_supported(spec: FilterSpec) -> bool:
    """Quotient specs the CUDA quotient kernels serve."""
    return qf_k.kernel_supported(spec)


def _check_quotient(spec: FilterSpec) -> None:
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")


def quotient_contains(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                      tile: Optional[int] = DEFAULT_TILE,
                      coop: str = "auto") -> torch.Tensor:
    """(n,) bool run-scan membership, one launch for the batch; ``coop`` is
    validated (both values run the one kernel)."""
    _check_quotient(spec)
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=keys.device)
    tile = _clamp_tile(n, tile or DEFAULT_TILE)
    c = _resolve_coop_fp(spec, coop, tile, keys.device)
    padded = keys if keys.is_cuda else _pad_keys(keys, tile)
    return qf_k.contains_vmem(spec, filt, padded, coop=c)[:n]


def _quotient_tile(n: int, tile: Optional[int]) -> int:
    """The bulk update's tile, as the JAX dispatch takes it: a batch of at
    most T keys is one tile (padded up to a power of two, at least 8), a
    larger one tiles of T. The words and flags do not depend on it."""
    T = tile or Q.QUOTIENT_ADD_TILE
    if n <= T:
        return max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
    return T


def _quotient_update(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                     op: str, valid: Optional[torch.Tensor],
                     tile: Optional[int], inplace: bool):
    _check_quotient(spec)
    out = filt if inplace else filt.clone()
    n = keys.shape[0]
    if n == 0:
        return out, torch.zeros((0,), dtype=torch.bool, device=keys.device)
    fn = qf_k.add_vmem if op == "add" else qf_k.remove_vmem
    eff = _quotient_tile(n, tile)
    if keys.is_cuda:
        return fn(spec, out, keys, valid, tile=eff)
    pk, pv = _pad_keys_valid(keys, eff, valid)
    out, flags = fn(spec, out, pk, pv, tile=eff)
    return out, flags[:n]


def quotient_add(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 tile: Optional[int] = None, inplace: bool = False):
    """Bulk decode-and-rebuild insert: (table, ok); ``ok[i]`` False is the
    table-full signal for key i (the API accumulates it in
    ``Filter.insert_failures``)."""
    return _quotient_update(spec, filt, keys, "add", valid, tile, inplace)


def quotient_remove(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    tile: Optional[int] = None, inplace: bool = False):
    """Bulk delete, one fingerprint copy a key: (table, found)."""
    return _quotient_update(spec, filt, keys, "remove", valid, tile, inplace)
