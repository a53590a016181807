"""Blocked Bloom filter kernels (sbf/bbf/rbbf/csbf) for Hopper, and their
plain PyTorch versions.

Counterpart of ``repro.kernels.sbf``. The six wrappers keep the JAX names,
so each row of the kernel table maps one to one:

================== ============================= ===========================
wrapper            replaces (repro/kernels/      CUDA kernel (csrc/bloom.cu)
                   sbf.py)
================== ============================= ===========================
contains_vmem      contains_vmem (L2 regime)     bloom_contains_kernel,
                                                 DEPTH=1
contains_hbm       contains_hbm (DRAM regime)    bloom_contains_kernel,
                                                 DEPTH=depth
add_vmem           add_vmem                      bloom_add_kernel
add_hbm            add_hbm                       bloom_add_kernel
bank_contains_vmem bank_contains_vmem            bloom_contains_kernel, bank
                                                 form; DEPTH=depth
bank_add_vmem      bank_add_vmem                 bloom_add_kernel, bank form
add_partitioned    add_partitioned               bloom_add_partitioned_
                                                 global_kernel or
                                                 bloom_add_partitioned_
                                                 shared_kernel
================== ============================= ===========================

``add_partitioned`` takes keys already bucketed by the segment that owns
their block, ``(n_segments, capacity, 2)`` with a ``(n_segments,
capacity)`` valid mask (``core.partition``), and ORs each valid slot into
its segment at ``start mod seg_words``. It has two paths on the card, which
give the same words: *global* (a warp compacts its valid slots and groups
of Θ lanes OR each key's mask with global atomics, Θ from
:func:`card_layout`) and *shared* (one CTA a segment, staging the
segment's words in shared memory, where no global atomic runs).
:func:`choose_partitioned_path`, a pure function fitted to a sweep on the
H100, picks the path from the caller's regime; ``LAST_PARTITIONED_PLAN``
keeps the last card call's plan (:func:`partitioned_plan`) and
:func:`add_partitioned_model` is the shared path in plain PyTorch, for
tests.

The bank wrappers take a ``(B, n_words)`` bank, flat keys and ``member``
``(n,)`` int32 ids in ``[0, B)`` (checked: a ``ValueError`` otherwise, so
no launch writes outside the bank). The JAX package runs them only on a
bank that fits VMEM; here one kernel serves a bank in L2 (``depth=1``) and
one in DRAM (``depth`` keys a group), as ``ops.bloom_bank_*`` picks.

Schedule axes. Three act on the card, as the paper's (Θ, Φ) layout and
the DMA depth (:func:`launch_geometry` resolves them, with the grid):

* ``layout.theta`` is Θ, the lanes of a warp that own one key together
  (1, 2, 4, ..., 32, clamped to s): each lane owns s/Θ contiguous words of
  the key's block, hashes one key of the warp's 32 and shares it by
  shuffle, and a group decides a key by a ballot. Θ = 1 is one thread a
  key. Θ = s makes an add one L2 sector request a key instead of s;
* ``layout.phi`` is Φ, the words a lane moves with one load, capped at 4
  (128 bits, the widest load) and at the lane's s/Θ words. A schedule
  deeper than 1 loads the widest vector;
* ``depth`` is the keys a group keeps in flight, all their loads issued
  before any test (``contains_hbm``, ``bank_contains_vmem``), capped so that
  a lane holds at most ``MAX_WORDS_IN_FLIGHT`` = 64 words.

A layout the caller passes acts as given (``contains_vmem``, ``add_vmem``
and the bank wrappers). Where the caller passes none, and always in the
DRAM wrappers, which take no layout (as in JAX), :func:`card_layout`
decides. ``default_layout`` stays the JAX package's and is what the plain
path validates. Every other axis is accepted and validated as the JAX
package does it, and runs the same kernel: ``tile`` (tiles exist for the
plain path's padding, so the DRAM wrappers take none), ``probe="gather"``
and ``coop="subtile"`` (the lanes' walk already is the gather, and a group
is the sub-tile), and ``mix="cheap"`` (the kernels always share the lane
products of the two hash streams, which gives the same hashes). No axis
changes a result.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]`` and
filter words ``(n_words,)``. For CPU tensors a wrapper runs its plain
version (:func:`contains_plain`, :func:`add_plain`); for CUDA tensors it
launches its kernel or raises. The add wrappers update ``filt`` in place and
return it. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core.partition import check_ids
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec

DEFAULT_TILE = 256
PROBES = ("loop", "gather")
COOPS = ("none", "subtile")
MIXES = ("full", "cheap")
DMA_DEPTHS = (1, 2, 4, 8)
DEFAULT_DMA_DEPTH = 2
MAX_WORDS_IN_FLIGHT = 64        # block words a contains lane holds
BLOCKED_VARIANTS = ("sbf", "bbf", "rbbf", "csbf")
WARP = 32                       # lanes a warp; Θ divides it
THREADS = 256                   # CUDA threads a CTA (csrc kThreads)
MAX_VEC = 4                     # words a load: 128 bits

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0, "contains_hbm": 0,
            "add_hbm": 0, "bank_contains_vmem": 0, "bank_add_vmem": 0,
            "add_partitioned": 0}
# The geometry of each wrapper's last launch (what a run resolved)
LAST_GEOMETRY: dict = {}
# The partitioned add's paths, and the plan of its last call on the card
PARTITIONED_PATHS = ("shared", "global")
LAST_PARTITIONED_PLAN: dict = {}
# The partitioned add's rule, fitted to a sweep of both paths in turns on
# an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4e: the sbf cells' batch
# at n_segments 8 ... 16 x the fitting count; PERF.md): the shared path won
# only for a filter in L2 with segments of at most SHARED_MAX_SEGMENT_BYTES;
# in DRAM the global path won at every count (its atomics merge in L2 once
# a segment's keys arrive together).
SHARED_MAX_SEGMENT_BYTES = 1 << 15

_VARIANT_CODE = {"sbf": 0, "bbf": 1, "rbbf": 1, "csbf": 2}
_salts_on: dict = {}
_smem_on: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Layout:
    """(Θ, Φ) vectorization layout of the paper (§4.1).

    theta: keys processed per inner step; phi: contiguous words per load.
    On the card Θ is the lanes that own one key and Φ the words a lane
    loads at a time (:func:`launch_geometry`)."""
    theta: int = 1
    phi: int = 8

    def validate(self, spec: FilterSpec, tile: int) -> "Layout":
        s = spec.s
        phi = min(self.phi, s)
        if not (_is_pow2(self.theta) and _is_pow2(phi)):
            raise ValueError(f"theta={self.theta}, phi={phi} must be powers "
                             f"of two")
        if s % phi:
            raise ValueError(f"phi={phi} must divide s={s}")
        if tile % self.theta:
            raise ValueError(f"theta={self.theta} must divide tile={tile}")
        return Layout(self.theta, phi)

    def __str__(self):
        return f"Θ{self.theta}Φ{self.phi}"


def default_layout(spec: FilterSpec, op: str) -> Layout:
    """The paper's empirically-optimal layouts (§5.2), as in the JAX package."""
    s = spec.s
    if op == "contains":
        theta = min(max(1, spec.block_bits // 256), 8)
        return Layout(theta, max(1, min(8, s // theta)))
    theta = min(s, 8)
    return Layout(theta, max(1, s // theta))


def card_layout(spec: FilterSpec, op: str) -> Layout:
    """The (Θ, Φ) the card runs where the caller passes no layout, in
    both regimes; ``chip_smoke.py``'s Θ sweeps (phases 4 and 4a) set it and
    check it against Θ = 1 at every block the default path serves
    (PERF.md, rows 1-4).

    sbf and rbbf: the add at Θ = s, one word a lane, so a key's atomics
    leave the warp as one sector request (the paper's Θ̂ = s); the contains
    at Θ = s/4 lanes with one 128-bit load each (Θ = 1 below s = 4), so a
    warp instruction reads whole sectors. bbf: each lane places all k bits
    by hash to find its own, so more lanes cost integer work: the add at Θ
    = min(s, 8), the contains at Θ = 1. csbf: Θ = 1 for both (a key's bits
    lie in z words, one a group, so more lanes add work and remove no
    request)."""
    if op not in ("contains", "add"):
        raise ValueError(f"op={op!r} not in ('contains', 'add')")
    if spec.variant == "csbf" or (spec.variant == "bbf" and op == "contains"):
        return Layout(1, MAX_VEC)
    if op == "add":
        return Layout(min(spec.s, 8 if spec.variant == "bbf" else WARP), 1)
    return Layout(max(1, spec.s // MAX_VEC), MAX_VEC)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How a blocked-filter kernel runs on the card (``csrc/bloom.cu``).

    A group of ``theta`` adjacent lanes owns one key; lane ``j`` of it owns
    the ``words`` = s/Θ block words ``[j * words, (j + 1) * words)`` and
    loads them ``vec`` words at a time. A group keeps ``depth`` keys in
    flight, so a lane hashes ``keys_per_lane`` keys of each warp tile; a
    CTA of ``THREADS`` threads takes ``keys_per_cta`` keys and ``grid(n)``
    CTAs take ``n``."""
    s: int
    theta: int
    vec: int
    depth: int

    @property
    def words(self) -> int:
        return self.s // self.theta

    @property
    def words_in_flight(self) -> int:
        return self.depth * self.words

    @property
    def keys_per_lane(self) -> int:
        return max(1, self.depth // self.theta)

    @property
    def keys_per_cta(self) -> int:
        return THREADS * self.keys_per_lane

    def grid(self, n: int) -> int:
        """CTAs for ``n`` keys."""
        return -(-n // self.keys_per_cta)

    def group(self, lane: int) -> range:
        """The lanes of ``lane``'s group."""
        first = lane - lane % self.theta
        return range(first, first + self.theta)

    def loads(self, lane: int) -> list:
        """First block word of each of ``lane``'s loads (``vec`` words)."""
        first = (lane % self.theta) * self.words
        return [first + c * self.vec for c in range(self.words // self.vec)]


def launch_geometry(spec: FilterSpec, op: str, layout: Layout,
                    depth: int = 1) -> Geometry:
    """Resolve a layout and depth for the card: Θ clamped to s, Φ capped at
    4 words and at a lane's s/Θ words (a deeper schedule loads the widest
    vector), the depth capped at ``MAX_WORDS_IN_FLIGHT`` words a lane.
    Raises ``ValueError`` for a Θ or Φ that is not a power of two, a depth
    not in ``DMA_DEPTHS`` (an add takes 1) or an s the kernels do not
    serve."""
    if op not in ("contains", "add"):
        raise ValueError(f"op={op!r} not in ('contains', 'add')")
    s = spec.s
    if not (_is_pow2(s) and s <= WARP):
        raise ValueError(f"the kernels serve s in 1..{WARP} words, not {s}")
    if not (_is_pow2(layout.theta) and _is_pow2(layout.phi)):
        raise ValueError(f"theta={layout.theta}, phi={layout.phi} must be "
                         f"powers of two")
    if depth not in (DMA_DEPTHS if op == "contains" else (1,)):
        raise ValueError(f"depth={depth} for {op}")
    theta = min(layout.theta, s)
    words = s // theta
    depth = min(depth, max(1, MAX_WORDS_IN_FLIGHT // words))
    vec = min(words, MAX_VEC) if depth > 1 else min(layout.phi, words,
                                                    MAX_VEC)
    return Geometry(s, theta, vec, depth)


def _check_axes(probe: str = "loop", coop: str = "none", mix: str = "full"):
    if probe not in PROBES:
        raise ValueError(f"probe={probe!r} not in {PROBES}")
    if coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS}")
    if mix not in MIXES:
        raise ValueError(f"mix={mix!r} not in {MIXES}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def contains_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of ``contains_vmem`` and ``contains_hbm``: (n,) bool."""
    return V.contains(spec, filt, keys)


def add_plain(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor
              ) -> torch.Tensor:
    """Plain version of ``add_vmem`` and ``add_hbm``: new (n_words,) int32
    words (sort-and-segment OR; ``filt`` is not modified)."""
    return V.add_rows(spec, filt, keys)


def bank_contains_plain(spec: FilterSpec, bank: torch.Tensor,
                        keys: torch.Tensor, member: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of ``bank_contains_vmem``: (n,) bool."""
    return V.bank_contains_rows(spec, bank, keys, member)


def bank_add_plain(spec: FilterSpec, bank: torch.Tensor, keys: torch.Tensor,
                   member: torch.Tensor, valid=None) -> torch.Tensor:
    """Plain version of ``bank_add_vmem``: new (B, n_words) int32 words
    (``bank`` is not modified)."""
    return V.bank_add_rows(spec, bank, keys, member, valid)


def add_partitioned_plain(spec: FilterSpec, filt: torch.Tensor,
                          keys_by_seg: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of ``add_partitioned``: new (n_words,) int32 words
    (``filt`` is not modified)."""
    return V.partitioned_add(spec, filt, keys_by_seg, valid)


# ---------------------------------------------------------------------------
# CUDA launch plumbing
# ---------------------------------------------------------------------------

def _on_cuda(filt: torch.Tensor, keys: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on anything else."""
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (n, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if filt.ndim != 1 or filt.dtype != torch.int32:
        raise ValueError(f"filter words must be (n_words,) int32, got "
                         f"{tuple(filt.shape)} {filt.dtype}")
    if filt.device != keys.device:
        raise ValueError(f"filter on {filt.device}, keys on {keys.device}")
    if filt.device.type == "cpu":
        return False
    if filt.device.type != "cuda":
        raise ValueError(f"unsupported device {filt.device}")
    return True


def _salts(device: torch.device) -> torch.Tensor:
    """(3, 96) int32 salt table on ``device`` (bit, word, group salts)."""
    if device not in _salts_on:
        table = np.stack([H.SALTS, H.WORD_SALTS, H.GROUP_SALTS])
        _salts_on[device] = torch.from_numpy(
            table.view(np.int32).copy()).to(device)
    return _salts_on[device]


def _geometry(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor):
    if spec.variant not in _VARIANT_CODE or spec.s > 32:
        raise ValueError(f"the CUDA kernels serve sbf/bbf/rbbf/csbf with "
                         f"s <= 32 words per block, not {spec}")
    if spec.n_words >= 1 << 31:
        raise ValueError(f"{spec} has {spec.n_words} words; block starts "
                         f"must fit int32")
    if filt.numel() != spec.n_words:
        raise ValueError(f"filter has {filt.numel()} words, spec "
                         f"{spec.n_words}")
    if not (keys.is_contiguous() and filt.is_contiguous()):
        raise ValueError("keys and filter words must be contiguous")
    if keys.data_ptr() % 8 or filt.data_ptr() % 16:
        raise ValueError("keys must be 8-byte and words 16-byte aligned")
    log2g = V._log2i(spec.g) if spec.variant == "csbf" else 0
    return (spec.n_blocks - 1, spec.s, _VARIANT_CODE[spec.variant], spec.k,
            spec.z, log2g)


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what}: no kernel instance for this shape")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _layout_on_card(spec: FilterSpec, op: str, layout: Optional[Layout],
                    tile: int) -> Layout:
    """Validate the caller's layout, or where it passes none the JAX
    default (what the plain path is checked against), and return the
    layout the card runs: the caller's, else :func:`card_layout`."""
    if layout is None:
        default_layout(spec, op).validate(spec, tile)
        return card_layout(spec, op)
    return layout.validate(spec, tile)


def _counted(name: str, geo: Geometry, err: int) -> None:
    _raise_on(err, name)
    LAUNCHES[name] += 1
    LAST_GEOMETRY[name] = geo


def _launch_contains(name: str, spec, filt, keys, geo: Geometry
                     ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, filt, keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.bloom_contains(keys.data_ptr(), filt.data_ptr(),
                                 out.data_ptr(), _salts(keys.device).data_ptr(),
                                 n, block_mask, s, geo.theta, geo.vec,
                                 geo.depth, geo.grid(n), variant, k, z,
                                 log2g, stream)
    _counted(name, geo, err)
    return out


def _launch_add(name: str, spec, filt, keys, geo: Geometry) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, filt, keys)
    n = keys.shape[0]
    if n == 0:
        return filt
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.bloom_add(keys.data_ptr(), filt.data_ptr(),
                            _salts(keys.device).data_ptr(), n, block_mask, s,
                            geo.theta, geo.grid(n), variant, k, z, log2g,
                            stream)
    _counted(name, geo, err)
    return filt


def partition_smem_bytes(device: torch.device) -> int:
    """Shared memory (bytes) a partitioned-update CTA may give its segment
    on a CUDA ``device``: the card's opt-in limit less the staged salts."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _smem_on:
        from repro_torch.kernels._build import library
        budget = library().bloom_partition_smem(index)
        if budget < 0:
            raise RuntimeError(f"cannot read the shared-memory limit of "
                               f"{device}")
        _smem_on[index] = budget
    return _smem_on[index]


def check_partitioned(filt: torch.Tensor, keys_by_seg: torch.Tensor,
                      valid: torch.Tensor, n_segments: int, width: int
                      ) -> bool:
    """Validate a partitioned call's tensors (shared by the counting
    wrapper, whose words are ``width = storage_words``): words ``(width,)``
    int32 with ``width % n_segments == 0``, keys ``(n_segments, capacity,
    2)`` int32 and valid ``(n_segments, capacity)`` uint8/bool, on one
    device. True for CUDA tensors, False for CPU tensors; raises
    ``ValueError`` otherwise."""
    if n_segments < 1 or width % n_segments:
        raise ValueError(f"n_segments={n_segments} must divide the "
                         f"{width} words")
    if (keys_by_seg.ndim != 3 or keys_by_seg.shape[0] != n_segments
            or keys_by_seg.shape[2] != 2):
        raise ValueError(f"keys_by_seg must be ({n_segments}, capacity, 2), "
                         f"got {tuple(keys_by_seg.shape)}")
    if filt.numel() != width:
        raise ValueError(f"filter has {filt.numel()} words, spec {width}")
    on_cuda = _on_cuda(filt, keys_by_seg[0])
    if valid.shape != keys_by_seg.shape[:2]:
        raise ValueError(f"valid must be {tuple(keys_by_seg.shape[:2])}, "
                         f"got {tuple(valid.shape)}")
    if valid.device != keys_by_seg.device:
        raise ValueError(f"valid on {valid.device}, keys on "
                         f"{keys_by_seg.device}")
    if valid.dtype not in (torch.uint8, torch.bool):
        raise ValueError(f"valid must be uint8 or bool, got {valid.dtype}")
    if on_cuda and not (keys_by_seg.is_contiguous() and filt.is_contiguous()
                        and keys_by_seg.data_ptr() % 8 == 0
                        and filt.data_ptr() % 16 == 0):
        raise ValueError("keys must be contiguous and 8-byte aligned, words "
                         "contiguous and 16-byte aligned")
    return on_cuda


def segment_fits(seg_words: int, device) -> bool:
    """Whether a segment of ``seg_words`` words fits a CTA's shared memory:
    the shared path's capacity limit."""
    return seg_words * 4 <= partition_smem_bytes(device)


def choose_partitioned_path(n_segments: int, seg_words: int, capacity: int,
                            smem_bytes: int, l2_resident: bool) -> str:
    """The partitioned add's path on the card, a pure function of the
    segments (``n_segments`` of ``seg_words`` words, ``capacity`` slots
    each), the card's shared memory a CTA and whether the filter sits in L2.

    Shared for a filter in L2 whose segments hold at most
    ``SHARED_MAX_SEGMENT_BYTES`` (and fit ``smem_bytes`` in 16-byte
    vectors): there many small CTAs an SM apply their keys with shared
    atomics and copy L2 lines in and out. Global everywhere else: in DRAM
    the global atomics of a segment's keys, which arrive together, merge in
    L2 before the DRAM sees them, and no copy through an SM is needed. The
    path never changes a result."""
    if n_segments < 1 or seg_words < 1 or capacity < 0:
        raise ValueError(f"no partitioned add of {n_segments} segments of "
                         f"{seg_words} words, {capacity} slots each")
    if (l2_resident and seg_words * 4 <= min(SHARED_MAX_SEGMENT_BYTES,
                                              smem_bytes)
            and seg_words % 4 == 0):
        return "shared"
    return "global"


def partitioned_plan(spec: FilterSpec, n_segments: int, capacity: int,
                     path: str) -> dict:
    """What a partitioned add runs: ``path``, ``n_segments``, ``capacity``
    (slots a segment), ``theta`` (global: lanes a key; 0 on the shared path)
    and ``ctas``."""
    if path not in PARTITIONED_PATHS:
        raise ValueError(f"path must be one of {PARTITIONED_PATHS}, not "
                         f"{path!r}")
    if path == "global":
        return {"path": path, "n_segments": n_segments,
                "capacity": capacity,
                "theta": card_layout(spec, "add").theta,
                "ctas": -(-n_segments * capacity // THREADS)}
    if (spec.n_words // n_segments) % max(spec.s, 4):
        raise ValueError(f"the shared path stages segments of whole rows and "
                         f"16-byte vectors, not {spec.n_words // n_segments} "
                         f"words")
    return {"path": path, "n_segments": n_segments, "capacity": capacity,
            "theta": 0, "ctas": n_segments}


def add_partitioned_model(spec: FilterSpec, filt: torch.Tensor,
                          keys_by_seg: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """The shared path in plain PyTorch, for tests: new (n_words,) int32
    words. The CTA of segment i ORs, into its copy of the segment's words,
    each valid slot of segment i at its word offset (block * s) mod
    seg_words, and writes the copy back where a key touched it. ``filt`` is
    not modified."""
    n_seg = keys_by_seg.shape[0]
    seg_words = spec.n_words // n_seg
    partitioned_plan(spec, n_seg, keys_by_seg.shape[1], "shared")
    keys, live, seg, _ = V._slots(keys_by_seg, valid)
    mine = live != 0
    blk, masks = V._blocks_and_masks(spec, keys[mine])
    rows = (seg[mine] * seg_words + (blk * spec.s) % seg_words) // spec.s
    copy = H.u32(V.or_rows(spec, filt.clone(), rows, masks,
                           n_rows=spec.n_words // spec.s)).reshape(n_seg, -1)
    out = H.u32(filt).clone().reshape(n_seg, seg_words)
    touched = torch.zeros(n_seg, dtype=torch.bool)
    touched[seg[mine]] = True
    out[touched] = copy[touched]
    return H.to_i32(out.reshape(-1))


def check_bank(spec: FilterSpec, bank: torch.Tensor, keys: torch.Tensor,
               member: torch.Tensor, valid=None, width: int = None) -> bool:
    """Validate a bank call's tensors (shared by the counting wrappers,
    whose rows are ``width = storage_words`` wide): bank ``(B, width)``
    int32, keys ``(n, 2)`` int32, member ``(n,)`` int32 in ``[0, B)`` and
    valid ``(n,)`` uint8/bool or None, all on one device. True for CUDA
    tensors, False for CPU tensors; raises ``ValueError`` otherwise."""
    width = spec.n_words if width is None else width
    if bank.ndim != 2 or bank.dtype != torch.int32 or bank.shape[1] != width:
        raise ValueError(f"bank must be (B, {width}) int32, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    on_cuda = _on_cuda(bank[0], keys)
    if member.shape != (keys.shape[0],) or member.dtype != torch.int32:
        raise ValueError(f"member must be ({keys.shape[0]},) int32, got "
                         f"{tuple(member.shape)} {member.dtype}")
    if member.device != keys.device:
        raise ValueError(f"member on {member.device}, keys on {keys.device}")
    if valid is not None:
        if valid.shape != (keys.shape[0],):
            raise ValueError(f"valid must be ({keys.shape[0]},), got "
                             f"{tuple(valid.shape)}")
        if valid.device != keys.device:
            raise ValueError(f"valid on {valid.device}, keys on "
                             f"{keys.device}")
        if valid.dtype not in (torch.uint8, torch.bool):
            raise ValueError(f"valid must be uint8 or bool, got "
                             f"{valid.dtype}")
    check_ids(member, bank.shape[0])
    if on_cuda and not (bank.is_contiguous() and member.is_contiguous()):
        raise ValueError("bank and member ids must be contiguous")
    return on_cuda


def _launch_bank_contains(spec, bank, keys, member, geo: Geometry
                          ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, bank[0], keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.bloom_bank_contains(
            keys.data_ptr(), member.data_ptr(), bank.data_ptr(),
            out.data_ptr(), _salts(keys.device).data_ptr(), n, spec.n_words,
            block_mask, s, geo.theta, geo.vec, geo.depth, geo.grid(n),
            variant, k, z, log2g, stream)
    _counted("bank_contains_vmem", geo, err)
    return out


def _launch_bank_add(spec, bank, keys, member, valid, geo: Geometry
                     ) -> torch.Tensor:
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, bank[0], keys)
    n = keys.shape[0]
    if n == 0:
        return bank
    if valid is not None:
        valid = valid.contiguous().view(torch.uint8)
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.bloom_bank_add(
            keys.data_ptr(), member.data_ptr(),
            None if valid is None else valid.data_ptr(), bank.data_ptr(),
            _salts(keys.device).data_ptr(), n, spec.n_words, block_mask, s,
            geo.theta, geo.grid(n), variant, k, z, log2g, stream)
    _counted("bank_add_vmem", geo, err)
    return bank


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def contains_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                  layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                  probe: str = "loop", coop: str = "none",
                  mix: str = "full") -> torch.Tensor:
    """Bulk membership, L2-resident regime. (n,) bool. ``layout=None``
    runs :func:`card_layout` on the card."""
    _check_axes(probe, coop, mix)
    layout = _layout_on_card(spec, "contains", layout, tile)
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_vmem", spec, filt, keys,
                            launch_geometry(spec, "contains", layout))


def add_vmem(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
             layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
             probe: str = "loop", coop: str = "none", mix: str = "full"
             ) -> torch.Tensor:
    """Bulk insert, L2-resident regime; updates ``filt`` in place.
    ``layout=None`` runs :func:`card_layout` on the card."""
    _check_axes(probe, coop, mix)
    layout = _layout_on_card(spec, "add", layout, tile)
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    return _launch_add("add_vmem", spec, filt, keys,
                       launch_geometry(spec, "add", layout))


def contains_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
                 depth: int = DEFAULT_DMA_DEPTH, coop: str = "none",
                 mix: str = "full") -> torch.Tensor:
    """Bulk membership, DRAM-resident regime, at :func:`card_layout`.
    (n,) bool."""
    _check_axes(coop=coop, mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    if not _on_cuda(filt, keys):
        return contains_plain(spec, filt, keys)
    return _launch_contains("contains_hbm", spec, filt, keys, launch_geometry(
        spec, "contains", card_layout(spec, "contains"), depth))


def add_hbm(spec: FilterSpec, filt: torch.Tensor, keys: torch.Tensor,
            coop: str = "none", mix: str = "full") -> torch.Tensor:
    """Bulk insert, DRAM-resident regime, at :func:`card_layout`; updates
    ``filt`` in place."""
    _check_axes(coop=coop, mix=mix)
    if not _on_cuda(filt, keys):
        return filt.copy_(add_plain(spec, filt, keys))
    return _launch_add("add_hbm", spec, filt, keys, launch_geometry(
        spec, "add", card_layout(spec, "add")))


def add_partitioned(spec: FilterSpec, filt: torch.Tensor,
                    keys_by_seg: torch.Tensor, valid: torch.Tensor,
                    n_segments: int, mix: str = "full", *,
                    l2_resident: bool = False,
                    path: Optional[str] = None) -> torch.Tensor:
    """OR the valid slots of ``keys_by_seg`` (n_segments, capacity, 2), each
    into the segment that owns it, one launch. Updates ``filt`` in place.

    On the card the path is :func:`choose_partitioned_path`'s for the
    caller's regime (``l2_resident``: the filter sits in L2, as
    ``ops.bloom_add_partitioned`` decides). ``path`` is private (tests and
    the smoke; ``ops`` never passes it)."""
    _check_axes(mix=mix)
    if path is not None and path not in PARTITIONED_PATHS:
        raise ValueError(f"path must be one of {PARTITIONED_PATHS}, not "
                         f"{path!r}")
    if spec.variant not in BLOCKED_VARIANTS:
        raise ValueError(f"add_partitioned serves the blocked variants, not "
                         f"{spec}")
    if not check_partitioned(filt, keys_by_seg, valid, n_segments,
                             spec.n_words):
        return filt.copy_(add_partitioned_plain(spec, filt, keys_by_seg,
                                                valid))
    from repro_torch.kernels._build import library
    block_mask, s, variant, k, z, log2g = _geometry(spec, filt,
                                                    keys_by_seg[0])
    seg_words = spec.n_words // n_segments
    capacity = keys_by_seg.shape[1]
    if path is None:
        path = choose_partitioned_path(n_segments, seg_words, capacity,
                                       partition_smem_bytes(filt.device),
                                       l2_resident)
    plan = partitioned_plan(spec, n_segments, capacity, path)
    valid = valid.contiguous().view(torch.uint8)
    lib = library()
    with torch.cuda.device(filt.device):
        stream = torch.cuda.current_stream(filt.device).cuda_stream
        err = lib.bloom_add_partitioned(
            keys_by_seg.data_ptr(), valid.data_ptr(), filt.data_ptr(),
            _salts(filt.device).data_ptr(), n_segments, capacity, seg_words,
            block_mask, s, plan["theta"], variant, k, z, log2g,
            int(path == "shared"), stream)
    _raise_on(err, "add_partitioned")
    LAUNCHES["add_partitioned"] += 1
    LAST_PARTITIONED_PLAN.clear()
    LAST_PARTITIONED_PLAN.update(plan)
    return filt


def bank_contains_vmem(spec: FilterSpec, bank: torch.Tensor,
                       keys: torch.Tensor, member: torch.Tensor,
                       layout: Optional[Layout] = None,
                       tile: int = DEFAULT_TILE, probe: str = "gather",
                       mix: str = "full", depth: int = 1) -> torch.Tensor:
    """Flat routed membership against a (B, n_words) bank, one launch.
    ``depth=1`` is the L2 regime; a larger ``depth`` (a value of
    ``DMA_DEPTHS``) the DRAM regime. ``layout=None`` runs
    :func:`card_layout` on the card. (n,) bool."""
    _check_axes(probe=probe, mix=mix)
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth={depth} not in {DMA_DEPTHS}")
    layout = _layout_on_card(spec, "contains", layout, tile)
    if not check_bank(spec, bank, keys, member):
        return bank_contains_plain(spec, bank, keys, member)
    return _launch_bank_contains(spec, bank, keys, member, launch_geometry(
        spec, "contains", layout, depth))


def bank_add_vmem(spec: FilterSpec, bank: torch.Tensor, keys: torch.Tensor,
                  member: torch.Tensor, valid,
                  layout: Optional[Layout] = None, tile: int = DEFAULT_TILE,
                  probe: str = "gather", mix: str = "full") -> torch.Tensor:
    """Flat routed insert into a (B, n_words) bank, one launch, both
    regimes; slots with ``valid`` 0 are skipped (``None``: every key
    valid). ``layout=None`` runs :func:`card_layout` on the card. Updates
    ``bank`` in place."""
    _check_axes(probe=probe, mix=mix)
    layout = _layout_on_card(spec, "add", layout, tile)
    if not check_bank(spec, bank, keys, member, valid):
        return bank.copy_(bank_add_plain(spec, bank, keys, member, valid))
    return _launch_bank_add(spec, bank, keys, member, valid,
                            launch_geometry(spec, "add", layout))
