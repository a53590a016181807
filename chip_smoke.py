#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without printing a result:

1. device: the card's name and power limit (``nvidia-smi``), and the count;
2. build: compile every source of ``src/repro_torch/kernels/csrc/``
   (``bloom.cu``, ``bloom_contains.cu``, ``bloom_bank_contains.cu``,
   ``counting.cu``, ``counting_contains.cu``, ``cbf.cu``, ``ring.cu``,
   ``cuckoo.cu``, ``quotient.cu``, ``calibrate.cu``; one nvcc each, in
   parallel) and time it; print the
   card's L2 fetch granularity;
3. every blocked-filter kernel wrapper against its plain PyTorch version on
   the card, at m = 2^20 bits and 65537 keys, for six blocked specs and
   every value of the schedule axes: the add and the contains at every Θ
   (lanes a key, 1 ... s), every load width and every depth, and at the
   card's default (``sbf.card_layout``); ragged n 1/31/33/255/257; words
   and results must be equal bit for bit, and the FPR measured on 2^20
   probes must lie within 0.5-2.0x theory;
3b. the same for the counting kernels: four countingbf specs (B = 64 ...
   512) at m = 2^20, 65537 keys inserted 1-3 times each plus one key 20
   times (it saturates), then removes of a subset and of keys never added,
   and two decays; every schedule value, ragged sizes and a valid mask;
   each update path forced (one-pass; binned at the default bins, over
   several internal batches, in the smallest bins, in the largest bins,
   whose runs split into parts that share rows; and one bin of a 2^17-bit
   filter, whose parts sum their counts in shared memory), valid-masked; the
   contains at every Θ (s/8 ... s), load width and depth;
3c. the classical-filter kernels at m = 2^20 for k in 1/7/11/32 (65537
   keys, n = 0/1/255/257) and at m = 2^32 (2^20 keys; positions use all 32
   bits), the add on each path forced (one-pass, binned; also over several
   internal batches, in smaller bins, on a filter smaller than a bin, with
   keys in one bin and one key repeated), and the generation-ring
   contains for s = 1 ... 32 words (sbf/bbf/rbbf/csbf) at G = 1 ... 9
   through both wrappers on both paths forced (one-pass at every Θ and
   accepted depth; binned at the default bins, over
   several internal batches, in bins of 1 and 8 rows), n = 0/1/255/257 and
   65537 probes + the live keys; words and results equal bit for bit, FPR
   within 0.5-2.0x theory at m = 2^20;
3d. the bank kernels (the bank forms of the blocked kernels and of
   ``counting.cu``) against their plain versions: sbf/bbf/rbbf/csbf banks
   of B = 1, 7, 64 members of 2^17, 2^16, 2^14 bits, 65537 routed keys with
   ~25 % invalid slots, uniform and skewed (half on member 0) member mixes,
   the contains in both regimes through ``ops`` and at depth 1/2/4, both
   forms at every Θ and depth, ragged n; the countingbf bank
   (add of keys 1-3 times on each update path, remove incl. keys never
   added, contains at every Θ and depth, decay of the whole bank); and the
   generic per-member path of a cbf bank and a
   windowed bank (G = 4, one advance) at B = 8 against per-member plain
   filters;
3e. the partitioned kernels (``sbf.add_partitioned``,
   ``countingbf.update_partitioned``) for sbf/bbf/rbbf/csbf and countingbf
   at m = 2^20 (and sbf at 2^22) through ``ops`` at n_segments 1/8/64 with
   the capacity escalated, pinned so that it overflows (the residual pass)
   and the host partition, on the path ``ops`` picks and with global
   atomics forced; the partitioned add also on each path forced (global;
   shared, one CTA a segment), with a key placed in a foreign segment; and the cuckoo kernels for every instance (u8 x 4/8/16,
   u16 x 2/4/8/16) with 16384 slots, batches at 0.9 and 1.2 of the slots
   (kick failures) with duplicates, valid masks and 256-key tiles, the
   update at windows 1, 2, 32 and the default; adversarial batches (512
   copies of one key, keys of one bucket pair, tiles 1/8/2048/8192, a step
   cap of 1) at the same windows: words, flags and contains equal to the
   plain version's; and the update kernel's counters equal to the CPU
   model's (``cuckoofilter.update_windowed``) round for round;
3f. the quotient kernels for u8, u16 and u32 lanes over six (r, q)
   geometries: batches at 0.5, 0.9 and 1.3 of the slots (past capacity)
   with duplicates, with and without a valid mask, a second batch into the
   filled table, removes of half, of repeats and of absent keys, clusters
   that wrap past the last slot, tiles 256 / 2048 / the whole batch and
   both coop values: words, ok/found flags and contains (the walk and
   binned, binned also at a quotient a bin, 8 and 32 quotients a bin with
   4-word windows and small caps) equal to the plain
   version's; and merge and resize (the plain decode and layout on the
   card) equal to the update kernels' builds;
3g. the calibration kernels: the step kernel (``x + 1`` a (8, 128) block
   a CTA) at g = 1, 16 and the measuring grid, the chain kernel at the
   gops probe's grid (512 steps), one CTA of the probe's 16384 steps and a
   ragged size, and the gather kernel at the resident-bandwidth probe's shape and
   a ragged one, each equal to its plain version (checksums printed);
4. the blocked main path, ``repro_torch.api.filter_for_n_items(...)`` then
   ``Filter.add`` / ``Filter.contains``, at an L2-resident size (2^23 keys,
   2^27 bits) and a DRAM-resident size (2^28 keys, 2^32 bits): no false
   negatives, the main path's words, hits and results on 2^22 probes equal
   to the plain version's in full (the plain version runs in 2^22-key
   chunks; the FPR's ratio to theory is printed), every wrapper of the
   regime launched during the main path at the geometry ``sbf.card_layout``
   gives (printed); then a Θ sweep of the add and the contains at full size
   (in DRAM at every depth, in L2 at every load width), the resolved Θ
   against Θ = 1 (one thread a key) in turns, which must not be slower
   beyond the rounds' spread, and the uncoalesced atomic rate of the Θ = 1
   add (the counting cells' atomics estimate uses it);
4a. ``sbf.card_layout`` at the other blocks the default path serves (sbf
   at s = 2, 4, 16 and 32 words, bbf B = 256 and 512, csbf B = 512, as
   ``filter_for_n_items(n, bits_per_key=16)`` makes them) at 2^23 keys
   (16 MiB) and 2^26 keys (128 MiB): the default add runs its geometry;
   the add and the contains at every Θ in turns, printed; ``card_layout``'s
   Θ must not be slower than Θ = 1 beyond the rounds' spread;
4b. the counting main path, ``filter_for_n_items(n, variant="countingbf")``
   then ``add``, ``contains``, ``remove`` of half the keys, ``contains`` of
   the other half and ``decay(1)``, at an L2-resident size (2^22 keys, 2^26
   bits, 32 MiB of counters) and a DRAM-resident size (2^26 keys, 2^30
   bits, 512 MiB): no false negatives, every step's words and results
   equal to the plain version's in full (in 2^22-key chunks, and the other
   update path's too), every counting wrapper of the regime launched, each
   update on the path ``countingbf.choose_update_path`` picks (its plans,
   ``countingbf.LAST_UPDATE_PLAN``, and the contains' geometry printed);
   both update paths timed in turns at each cell's size (add and remove;
   the add also in bins of other sizes), an add's peak extra device
   memory on each path, the contains at every Θ, load width and depth in
   turns; and the update rule's sweep (B = 256, 2^20-2^29 counter bytes x
   2^16-2^26 keys, both paths in turns; a size where the rule's path is
   the slower is timed again over more rounds), which prints every size
   where the rule's path is the slower and fails where it is slower
   beyond the rounds' spread by more than 10 %;
4c. the classical main path, ``filter_for_n_items(n, variant="cbf")`` (k =
   11) then ``add`` of all keys and ``contains`` of them and of 2^22
   probes, at 2^23 keys (2^27 bits, 16 MiB, engine ``cuda-l2``) and 2^28
   keys (2^32 bits, 512 MiB, ``cuda-dram``), the add on the path
   ``cbf.choose_path`` picks (its plan, ``cbf.LAST_ADD_PLAN``, printed);
   both add paths (one-pass, binned) timed in turns at each cell's size,
   with an add's peak extra device memory; and the path rule's sweep (k =
   11, filters of 2^23-2^32 bits, 2^14-2^28 keys, both paths in turns),
   which fails where the rule's path is the slower one beyond the rounds'
   spread; the same for the contains (``cbf.choose_contains_path``,
   ``cbf.LAST_CONTAINS_PLAN``), whose sweep times batches of which none,
   half or all keys are members and fails where the rule picks binned and
   binned is slower at one share, or one-pass and binned is faster at all
   three; and the windowed main path,
   ``filter_for_n_items(W, block_bits=256, generations=4)``: five batches
   of W/4 keys with ``advance()`` after each of the first four, then
   ``contains`` of batches 1-4 (no false negatives), of the retired batch
   0 and of W fresh probes, at W = 2^22 (2^26 bits a generation, a 32 MiB
   ring) and W = 2^26 (2^30 bits, a 512 MiB ring). The ring and head after
   every step and every result equal the plain path's in full (in 2^22-key
   chunks); engines and launches checked in each cell, each contains on
   the path ``ring.choose_contains_path`` picks (its plans printed); both
   paths and Θ = 1 in turns on the three contains (the rule's path must
   not be the slower beyond the rounds' spread), binned batch sizes in
   turns, the floors and the binned call's peak extra memory; then the ring rule's sweep (rings of
   32 / 128 / 512 MiB, G = 2/4/8, 2^16 ... 2^26 keys with member shares
   0, 1/2, 1, both paths in turns), which fails where the rule's path is
   the slower at some share beyond the rounds' spread;
4d. the bank cells: ``filter_for_n_items(n, bits_per_key=16, bank=1024)``
   then routed ``add`` of uniformly routed keys, routed ``contains`` of
   them and of 2^22 probes: sbf at 2^13 keys a member (16 MiB bank,
   ``cuda-l2``, 2^23 keys) and 2^18 (512 MiB, ``cuda-dram``, 2^28 keys);
   countingbf at 2^12 (32 MiB, 2^22 keys) and 2^16 (512 MiB, 2^26 keys),
   which also removes half, queries the rest and decays once, and times
   both update paths in turns and the contains at every Θ and depth. Words
   and
   results equal to the plain version's in full (2^22-key chunks), no
   false negatives, exactly one kernel launch per routed call; then the
   generic cbf and windowed banks' routed ops timed at B = 64;
4e. the partitioned cells: ``ops.bloom_add_partitioned`` of the sbf cells'
   keys (2^23 into 2^27 bits; 2^28 into 2^32 bits in 2^24-key batches) and
   ``ops.counting_update_partitioned`` add and remove of half of the
   countingbf cells' keys (2^22 into 32 MiB; 2^26 into 512 MiB in 2^24-key
   batches), at n_segments 8 and the smallest count whose segment fits
   shared memory (and, in the sbf L2 cell, the smallest count whose
   segments the rule sends to the shared path), the words equal to the
   plain version's in full, the
   partition step, the kernel and the atomic kernel timed on one batch,
   each call's plan (``sbf`` / ``countingbf.LAST_PARTITIONED_PLAN``, the
   rule's); both paths of each in turns at n_segments 8, 16, ... up to 16
   x the fitting count, which fail where the rule's path is the slower beyond the rounds' spread;
   and the cuckoo cell, ``filter_for_n_items(2^22, bits_per_key=16,
   variant="cuckoo")`` (u16 x 4, 2^21 buckets, 16 MiB): add 2^22 keys, add
   3,355,443 more (load 0.9), contains of all and of 2^22 probes, remove
   half, contains the rest; occupied slots equal to the inserts that
   succeeded, false negatives and unfound removes at most the failed
   inserts, every contains equal to the plain version's in full, and the
   update's words and flags (at the default window and at window 1) equal
   to the plain version's on 2^18 keys into the empty full-size table and
   from the load-0.9 table (2^16 inserts, 2^18 removes); the updates timed
   one call each, with the apply kernel's counters (rounds, keys a round,
   rounds ended on a conflict or a capped key, keys finished alone, the
   rounds' longest chains); and the DRAM cuckoo cell,
   ``filter_for_n_items(2^27, bits_per_key=16, variant="cuckoo")`` (u16 x
   4, 2^26 buckets, 512 MiB): add 2^27 keys (load 0.5), add to load 0.9
   where 32 x the L2 cell's add from 0.5 to 0.9 fits in 60 s, contains of
   all and of 2^22 probes, remove half, contains the rest, with the L2
   cell's invariants, every contains equal to the plain version's (2^22-key
   chunks) and the update at the default window equal to the kernel at
   window 1 (the serial order) on 2^18 keys, fresh and into the load-0.5
   table; its three contains timed alone, with bounds and the sector
   floor at the card's random-sector rate, measured in the same run;
4f. the quotient cells, ``filter_for_n_items(n, variant="quotient")`` at n
   = 2^22 (q23 + r5, u8, an 8 MiB table in L2) and 2^25 (q26 + r5, 64 MiB,
   the largest table the 31-bit fingerprint allows; batches of 2^24 keys):
   add to load 0.5, then to load 0.9, contains of every key and of 2^22
   probes, remove half, contains of the rest, merge of two half-stream
   tables (equal to the whole stream's), resize one step up and back (equal
   to the plain layout and the original), and a shrink that would overflow
   refused; every update's words and flags and every contains equal to the
   plain version's in full, no false negative, occupied slots equal to the
   successful inserts, each kernel launched on the main path; the
   contains' paths in turns, its plan, floor and peak extra memory, and
   the load sample's time; then ``phase_quotient_rule``: the walk, binned
   and the rule's path in turns at q23 ... q27, loads 0.5 and 0.9, 2^16
   ... 2^26 keys with none, half or all of them members, results equal
   (binned also at smaller bins and half windows), the rule's path (at the
   load it samples) held at each point to the faster path: no slower
   beyond the rounds' spread by more than 5 % and 5 us;
4g. the tuning main path: ``perfmodel.get_calibration(measure=True)`` on
   fresh caches, ``core.tuning.tune_plan`` of the sbf and countingbf cells'
   contains and add and ``api.tuned_options``, with every calibration
   kernel launched and every constant of the calibration from its probe
   (``measured``, and no constant equal to its default); each of the five
   probes called again on its own (each must be finite and > 0) and
   printed with the card's name and power limit; the structural and measure-mode plans of the cells; the DRAM
   contains of rows 3, 5, 13 and 16 at their cells' full size at every
   depth and at the depth ``ops`` resolves; the L2 crossover sweep (sbf
   and countingbf contains through the L2 schedule and the DRAM schedule
   at every depth, at 8-64 MiB, single filters at the powers of two and
   banks of 8 MiB members at every size; the crossover against the tuned
   and against the best DRAM depth); measured Mops/s over ``perfmodel.ceiling_mops`` for rows
   1-4 and 10-13; the step kernel's times and bound (row 24) and
   ``measure_step_us``'s time. ``build/repro_torch/smoke_tuning.json``
   keeps these numbers;
4h. the filter service (``repro_torch.service``) on the card, after the
   other phases: the main cell, a ``FilterService`` over a bank of 64 sbf
   tenants sized for 2^20 keys each at 16 bits a key (128 MiB, past the
   L2), flushes of 2^16, 2^21 adds (tenant 0 a quarter of them, past its
   quota) and 2^21 contains (half admitted keys, half fresh) in bursts of
   2^14 through ``submit_many`` and ``pump()`` on a virtual clock; one
   bank-kernel launch a flush; no false negative; every flush's words and
   results, the seq ids and the shed counts equal to the same stream on
   the plain engine (``torch``) on the card; requests and flushes a second,
   the flush latency's p50 / p99 and the shares of launch, sync and the
   rest on the real clock, a ``member_fill`` refresh, a bank clone, the
   routed id check. Then small counting (removes, decay cadence),
   windowed (advance cadence), cuckoo (past its load: health sheds),
   quotient (``grow_capacity``) and ``grow_bank`` passes, each equal flush
   for flush to the same stream on the CPU (the plain versions), and the
   recovery drill (``ServiceDriver``, a ``SimulatedFailure`` at step 7,
   restore from the flush-barrier checkpoint, replay) equal to the clean
   run;
5. times with CUDA events (warm-up, then 5 rounds of 20 calls; an update is
   timed on state restored before each call, outside the events) at the
   main path's size and, against the plain version, on 2^22 keys into an
   empty full-size filter (the DRAM cbf cell's full-size calls: 3 rounds of
   5); printed with the card's name and power limit, beside the bound and,
   for the blocked add and contains, the sector bound (keys, results and
   one 32-byte sector a key read, and written again for add); and one JSON
   line with a record per kernel.

The last line is ``{"ok": true, "device": {...}}``. Needs one CUDA card; the
script exits non-zero where there is none, or where the repository's
``src/`` is missing beside it.

    python3 chip_smoke.py --profile

instead prints the device time by kernel (``torch.profiler``) of the
binned cbf add in the two cbf cells (the scatter's time among them), of
the quotient update and contains paths in both quotient cells' shapes, of
the cuckoo contains in both cuckoo cells' shapes, of the DRAM windowed
cell's binned contains and of a DRAM partitioned sbf add batch, and no
result.

    python3 chip_smoke.py --service

runs the build and phase 4h alone.

    python3 chip_smoke.py --contains

runs the build, phases 3f, 4f and the quotient contains' rule sweep, then
3e (cuckoo) and 4e (both cuckoo cells), and prints the two contains
records, for work on those kernels.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import variants as V  # noqa: E402
from repro_torch.core import fingerprint as F  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402
from repro_torch.core import quotient as Q  # noqa: E402
from repro_torch.kernels import _build, cbf, ops, ring, sbf  # noqa: E402
from repro_torch.kernels import countingbf as cnt  # noqa: E402
from repro_torch.kernels import cuckoofilter as ckoo  # noqa: E402
from repro_torch.kernels import quotientfilter as qf  # noqa: E402
from repro_torch.kernels import calibrate as kc  # noqa: E402
from repro_torch.kernels.sbf import DEFAULT_TILE  # noqa: E402
from repro_torch import perfmodel as PM  # noqa: E402
from repro_torch.perfmodel import calibrate as PC  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.roofline import report_utils as RU  # noqa: E402
from repro_torch import service as S  # noqa: E402
from repro_torch.runtime.fault_tolerance import SimulatedFailure  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12              # non-tensor peak (fp32 rate, the guide's table)
SECTOR = 32                    # bytes of a DRAM / L2 sector
# Uncoalesced 32-bit atomics a second, by cell: the blocked add at Θ = 1
# (one thread a key, one atomicOr a nonzero word, each to its own sector),
# measured by phase_main in this run; the counting estimate reads it
CAS_PER_S = {}
REPS = 20                      # calls per timing round
ROUNDS = 5                     # timing rounds; the median is reported
PLAIN_REPS, PLAIN_ROUNDS = 3, 3    # the plain versions take 10-100 ms a call
SUBSET = 1 << 22               # keys of the kernel-vs-plain comparison
SOURCE = "src/repro_torch/kernels/csrc/bloom.cu"
# the add and contains templates (instantiated by bloom.cu,
# bloom_contains.cu and bloom_bank_contains.cu)
COOP_SOURCE = "src/repro_torch/kernels/csrc/bloom_blocked.cuh"
COUNTING_SOURCE = "src/repro_torch/kernels/csrc/counting.cu"
REPLACES = {"contains_vmem": "src/repro/kernels/sbf.py:311",
            "add_vmem": "src/repro/kernels/sbf.py:348",
            "contains_hbm": "src/repro/kernels/sbf.py:503",
            "add_hbm": "src/repro/kernels/sbf.py:537"}
COUNTING_REPLACES = {
    "update_vmem": "src/repro/kernels/countingbf.py:258",
    "contains_vmem": "src/repro/kernels/countingbf.py:296",
    "update_hbm": "src/repro/kernels/countingbf.py:592",
    "contains_hbm": "src/repro/kernels/countingbf.py:624",
    "decay": "src/repro/kernels/countingbf.py:725"}

PHASE3_SPECS = [
    V.FilterSpec("sbf", 1 << 20, 16, block_bits=256),
    V.FilterSpec("sbf", 1 << 20, 16, block_bits=512),
    V.FilterSpec("sbf", 1 << 20, 32, block_bits=1024),
    V.FilterSpec("bbf", 1 << 20, 8, block_bits=256),
    V.FilterSpec("rbbf", 1 << 20, 4),
    V.FilterSpec("csbf", 1 << 20, 8, block_bits=512, z=2),
]
PHASE3B_SPECS = [V.FilterSpec("countingbf", 1 << 20, k, block_bits=b)
                 for b, k in ((64, 2), (128, 4), (256, 8), (512, 16))]


def gen_keys(n: int, seed: int, probe: bool = False) -> torch.Tensor:
    """n random (n, 2) int32 [hi, lo] keys on the card, from a seeded
    generator: top bit of hi clear (insert keyspace) or set (probes)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 32, (n, 2), dtype=torch.int64, device="cuda",
                      generator=g)
    x[:, 0] = (x[:, 0] | (1 << 31)) if probe else (x[:, 0] & 0x7FFFFFFF)
    return H.to_i32(x).contiguous()


def max_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest absolute difference (u32 values for words, 0/1 for results);
    raises unless the two are equal bit for bit."""
    if got.dtype == torch.bool:
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    else:
        diff = (H.u32(got) - H.u32(want)).abs()
    err = int(diff.max().item()) if diff.numel() else 0
    if err:
        raise AssertionError(f"kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


def update_in_chunks(update, words: torch.Tensor, keys: torch.Tensor
                     ) -> torch.Tensor:
    """``update(words, chunk)`` over ``SUBSET``-key chunks, the plain
    versions' working memory kept to one chunk. An OR, a saturating add or a
    guarded subtract split into chunks gives the words of one call on all
    keys."""
    for chunk in keys.split(SUBSET):
        words = update(words, chunk)
    return words


def contains_in_chunks(contains, words: torch.Tensor, keys: torch.Tensor
                       ) -> torch.Tensor:
    """``contains(words, chunk)`` over ``SUBSET``-key chunks, concatenated."""
    return torch.cat([contains(words, chunk) for chunk in keys.split(SUBSET)])


SPREAD = {}                    # label -> (min, max) ms of the timing rounds


def time_ms(fn, label: str, reps: int = REPS, rounds: int = ROUNDS,
            warmup: int = 3) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events; the rounds' min and max go to ``SPREAD``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_round.append(start.elapsed_time(end) / reps)
    per_round.sort()
    SPREAD[label] = (per_round[0], per_round[-1])
    return per_round[len(per_round) // 2]


def ops_per_key(spec: V.FilterSpec, op: str) -> int:
    """Integer operations per key: two xxh32 streams (~38), block index (2),
    4 per salt bit, and 2 per word for the test (1 atomic per word for add)."""
    return 40 + 4 * spec.k + (2 * spec.s if op == "contains" else spec.s)


def bound_ms(spec: V.FilterSpec, n: int, op: str, extra_bytes: int = 0):
    """Least time for the work: max(bytes / memory rate, ops / peak rate).
    Bytes: 8 per key, 1 per result (contains), and min(m/8, B/8 per key) of
    filter read, written again for add; plus ``extra_bytes`` (a bank's
    member ids and valid bytes)."""
    filt = min(spec.m_bits // 8, spec.block_bits // 8 * n)
    nbytes = (8 * n + extra_bytes
              + (n + filt if op == "contains" else 2 * filt))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops_per_key(spec, op) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sector_bound_ms(n: int, op: str, extra_bytes: int = 0) -> float:
    """The DRAM regime's practical speed of light: keys (8 B) and results
    (1 B, contains), plus one 32-byte sector a key read (and written again
    for add), plus ``extra_bytes`` (a bank's member ids and valid bytes),
    at the DRAM rate. Random blocks cannot do better than a sector each,
    whatever the filter's size."""
    nbytes = extra_bytes + n * (8 + (1 + SECTOR if op == "contains"
                                     else 2 * SECTOR))
    return nbytes / HBM_BYTES_PER_S * 1e3


def thetas(spec: V.FilterSpec) -> list:
    """Every Θ the wrappers run for ``spec`` (1, 2, ..., up to s)."""
    return [t for t in (1, 2, 4, 8, 16, 32) if t <= spec.s]


def warm_calls(reps: int) -> int:
    """Untimed calls before a timing round of ``reps`` calls."""
    return reps // 4


def time_turns(fns: dict, label: str, reps: int = REPS,
               rounds: int = ROUNDS, lead: str | None = None) -> dict:
    """Time the calls of ``fns`` in turns (each round runs them in order,
    then reversed): the median of each one's rounds; min and max go to
    ``SPREAD`` under ``label``. Each round of a call starts with
    ``warm_calls(reps)`` untimed calls of it: a host-bound call timed just
    after another call's long wait for the card runs slower for a while,
    and the turns' order puts one call there in more rounds than another.
    ``lead``, where given, starts every round and the others take turns
    after it, so that each meets the card in the state it leaves (after a
    binned quotient contains the walk runs up to 10 % faster or slower
    until binned runs again)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    per = {k: [] for k in fns}
    rest = [k for k in fns if k != lead]
    for r in range(rounds):
        order = rest if r % 2 == 0 else rest[::-1]
        for key in ([lead] if lead is not None else []) + order:
            for _ in range(warm_calls(reps)):
                fns[key]()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[key]()
            end.record()
            torch.cuda.synchronize()
            per[key].append(start.elapsed_time(end) / reps)
    out = {}
    for key, ts in per.items():
        ts.sort()
        SPREAD[f"{label} {key}"] = (ts[0], ts[-1])
        out[key] = ts[len(ts) // 2]
    return out


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {name} x{count}")
    torch.cuda.synchronize()
    return smi, name, count


def phase_build():
    t0 = time.perf_counter()
    paths = _build.build()                    # one nvcc per source, together
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    _build.library()                          # binds every entry point
    for name in _build.SOURCES:
        log = _build.build_log(name)
        spills = [ln for ln in log.splitlines() if "spill" in ln and not
                  ln.strip().startswith("ptxas info    : Function")]
        n_spill = sum(1 for ln in spills if " 0 bytes spill stores" not in ln)
        arch = "sm_90a" if "sm_90a" in log else "arch not reported"
        # the bank forms (template flag BANK = true, mangled "Lb1E")
        bank, fn = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln
            elif "spill stores" in ln and "Lb1E" in fn:
                bank.append([" 0 bytes spill stores" not in ln, 0])
            elif "Used" in ln and "registers" in ln and "Lb1E" in fn and bank:
                bank[-1][1] = int(ln.split("Used")[1].split()[0])
        extra = (f"; bank forms: {len(bank)} instances, "
                 f"{sum(b[0] for b in bank)} with spills, at most "
                 f"{max(b[1] for b in bank)} registers" if bank else "")
        print(f"build: {name}: {len(spills)} kernel instances for {arch}, "
              f"{n_spill} with spills{extra}")
    gran = _build.library().bloom_l2_fetch_granularity(
        torch.cuda.current_device())
    print(f"device: cudaLimitMaxL2FetchGranularity {gran} B (the library "
          f"sets no limit)")
    torch.cuda.synchronize()


def phase_kernels(errs: dict):
    n = 65537
    for i, spec in enumerate(PHASE3_SPECS):
        keys = gen_keys(n, 100 + i)
        probes = gen_keys(n, 200 + i, probe=True)
        want_words = sbf.add_plain(spec, V.init(spec, "cuda"), keys)
        queries = torch.cat([keys, probes])
        want = sbf.contains_plain(spec, want_words, queries)
        runs = 0
        add_cases = [
            ("add_vmem", lambda f, **kw: sbf.add_vmem(
                spec, f, keys, sbf.default_layout(spec, "add"), **kw)),
            ("add_hbm", lambda f, **kw: sbf.add_hbm(spec, f, keys, **kw))]
        for name, run in add_cases:
            for kw in ({}, {"coop": "subtile"}, {"mix": "cheap"}) + (
                    ({"probe": "gather"},) if name == "add_vmem" else ()):
                got = run(V.init(spec, "cuda"), **kw)
                errs[name] = max(errs[name], max_err(got, want_words))
                runs += 1
        for phi in (1, 2, 4, 8):
            got = sbf.contains_vmem(spec, want_words, queries,
                                    sbf.Layout(1, phi))
            errs["contains_vmem"] = max(errs["contains_vmem"],
                                        max_err(got, want))
            runs += 1
        for depth in sbf.DMA_DEPTHS:
            got = sbf.contains_hbm(spec, want_words, queries, depth=depth)
            errs["contains_hbm"] = max(errs["contains_hbm"],
                                       max_err(got, want))
            runs += 1
        lay = sbf.default_layout(spec, "contains")
        for kw in ({"probe": "gather"}, {"coop": "subtile"}, {"mix": "cheap"}):
            got = sbf.contains_vmem(spec, want_words, queries, lay, **kw)
            errs["contains_vmem"] = max(errs["contains_vmem"],
                                        max_err(got, want))
            kw.pop("probe", None)
            got = sbf.contains_hbm(spec, want_words, queries, **kw)
            errs["contains_hbm"] = max(errs["contains_hbm"],
                                       max_err(got, want))
            runs += 2
        # every Θ the wrappers take: the add, the L2 contains at every Φ
        # and the contains at every depth, each against the plain version
        for th in thetas(spec):
            got = sbf.add_vmem(spec, V.init(spec, "cuda"), keys,
                               sbf.Layout(th, 1))
            errs["add_vmem"] = max(errs["add_vmem"],
                                   max_err(got, want_words))
            for phi in (1, 2, 4):
                got = sbf.contains_vmem(spec, want_words, queries,
                                        sbf.Layout(th, phi))
                errs["contains_vmem"] = max(errs["contains_vmem"],
                                            max_err(got, want))
            for depth in sbf.DMA_DEPTHS[1:]:
                geo = sbf.launch_geometry(spec, "contains",
                                          sbf.Layout(th, 4), depth)
                got = sbf._launch_contains("contains_hbm", spec, want_words,
                                           queries, geo)
                errs["contains_hbm"] = max(errs["contains_hbm"],
                                           max_err(got, want))
            runs += 7
        if i == 0:                                    # ragged tails
            for m in (1, 31, 33, 255, 257):
                w = sbf.add_plain(spec, V.init(spec, "cuda"), keys[:m])
                for layout in (sbf.default_layout(spec, "add"), None):
                    got = sbf.add_vmem(spec, V.init(spec, "cuda"), keys[:m],
                                       layout)
                    errs["add_vmem"] = max(errs["add_vmem"], max_err(got, w))
                got = sbf.add_hbm(spec, V.init(spec, "cuda"), keys[:m])
                errs["add_hbm"] = max(errs["add_hbm"], max_err(got, w))
                c = sbf.contains_plain(spec, w, queries[:m])
                for layout in (lay, None):
                    got = sbf.contains_vmem(spec, w, queries[:m], layout)
                    errs["contains_vmem"] = max(errs["contains_vmem"],
                                                max_err(got, c))
                got = sbf.contains_hbm(spec, w, queries[:m])
                errs["contains_hbm"] = max(errs["contains_hbm"],
                                           max_err(got, c))
                runs += 6
        fpr = float(sbf.contains_vmem(
            spec, want_words, gen_keys(1 << 20, 300 + i, probe=True), lay
        ).to(torch.float64).mean().item())
        theory = V.fpr_theory(spec, n)
        if not 0.5 * theory <= fpr <= 2.0 * theory:
            raise AssertionError(f"{spec}: FPR {fpr} outside 0.5-2.0 x "
                                 f"theory {theory}")
        torch.cuda.synchronize()
        print(f"kernels: {spec}: {runs} kernel runs equal to the plain "
              f"version ({n} keys, {n} probes; Θ in {thetas(spec)}); FPR "
              f"{fpr:.6f} = "
              f"{fpr / theory:.3f} x theory on 2^20 probes")


def phase_main(regime: str, n: int, errs: dict, records: dict, launches: dict,
               card: str):
    add_name, contains_name = (("add_vmem", "contains_vmem") if regime == "L2"
                               else ("add_hbm", "contains_hbm"))
    engine = "cuda-l2" if regime == "L2" else "cuda-dram"
    f = api.filter_for_n_items(n, bits_per_key=16, variant="sbf",
                               block_bits=256, device="cuda")
    spec = f.spec
    if f.backend != engine:
        raise AssertionError(f"main {regime}: engine {f.backend}, not {engine}")
    keys = gen_keys(n, 1)
    probes = gen_keys(SUBSET, 2, probe=True)
    torch.cuda.synchronize()

    sbf.reset_launches()                   # the main path, counted
    t0 = time.perf_counter()
    g = f.add(keys)
    hits = g.contains(keys)
    false_pos = g.contains(probes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(sbf.LAUNCHES)
    for name in (add_name, contains_name):
        if counted[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        launches[name] = counted[name]
    if not bool(hits.all()):
        raise AssertionError(f"{regime}: {int((~hits).sum())} false "
                             f"negatives")
    # the main path's words and results against the plain version, in full;
    # the FPR's ratio to theory is printed, not bounded: at this load the
    # reference's two xxh32 streams are dependent and the FPR exceeds
    # theory (PERF.md)
    want_words = update_in_chunks(functools.partial(sbf.add_plain, spec),
                                  V.init(spec, "cuda"), keys)
    errs[add_name] = max(errs[add_name], max_err(g.words, want_words))
    plain_contains = functools.partial(sbf.contains_plain, spec)
    errs[contains_name] = max(errs[contains_name], max_err(
        hits, contains_in_chunks(plain_contains, want_words, keys)))
    errs[contains_name] = max(errs[contains_name], max_err(
        false_pos, plain_contains(want_words, probes)))
    del want_words
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = g.fpr_theory(n)
    print(f"main {regime}: {spec} on {g.backend}, {n} keys, "
          f"{g.nbytes / 2**20:.0f} MiB filter: add+contains+probe "
          f"{wall * 1e3:.1f} ms host clock, no false negatives, words, hits "
          f"and probe results equal to the plain version's in full, FPR "
          f"{fpr:.6f}, {fpr / theory:.3f} x theory {theory:.6f}, "
          f"launches {counted}")

    # the geometry the main path ran: card_layout's, at the tuned depth
    depth = 1 if regime == "L2" else ops._resolve_depth(
        spec, "contains", None, DEFAULT_TILE, device=torch.device("cuda"))
    ran = {op: sbf.LAST_GEOMETRY[name] for op, name in
           (("add", add_name), ("contains", contains_name))}
    for op, d in (("add", 1), ("contains", depth)):
        want = sbf.launch_geometry(spec, op, sbf.card_layout(spec, op), d)
        if ran[op] != want:
            raise AssertionError(f"main {regime} {op}: ran {ran[op]}, not "
                                 f"card_layout's {want}")
    print(f"main {regime}: the main path ran " + "; ".join(
        f"{op} Θ={geo.theta} ({geo.words} words a lane, {geo.vec}-word "
        f"loads, depth {geo.depth}, {geo.grid(n)} CTAs for {n} keys)"
        for op, geo in ran.items()))

    # the timing columns' subset: 2^22 keys into an empty full-size filter
    sub = keys[:SUBSET]

    def run_add(words, k):
        if regime == "L2":
            return sbf.add_vmem(spec, words, k)
        return sbf.add_hbm(spec, words, k)

    def run_contains(words, q):
        if regime == "L2":
            return sbf.contains_vmem(spec, words, q)
        return sbf.contains_hbm(spec, words, q, depth=depth)

    want_words = sbf.add_plain(spec, V.init(spec, "cuda"), sub)
    queries = torch.cat([sub[: SUBSET // 2], probes[: SUBSET // 2]])
    torch.cuda.synchronize()

    # times: the main path at full size, and kernel vs plain on the subset
    words = g.words.clone()
    sub_words = want_words.clone()
    t = {}
    for label, fn in (
            ("add", lambda: run_add(words, keys)),
            ("contains", lambda: run_contains(g.words, keys)),
            ("Filter.add", lambda: g.add(keys)),
            ("Filter.contains", lambda: g.contains(keys)),
            ("add sub", lambda: run_add(sub_words, sub)),
            ("contains sub", lambda: run_contains(want_words, queries)),
            ("add plain", lambda: sbf.add_plain(spec, want_words, sub)),
            ("contains plain", lambda: sbf.contains_plain(spec, want_words,
                                                          queries))):
        t[label] = time_ms(fn, f"{regime} {label}")

    # the Θ sweep at full size (every Θ; in DRAM every depth of the
    # contains, in L2 every load width), and the resolved Θ against Θ = 1,
    # the one-thread-a-key design, timed in turns
    def add_at(theta):
        geo = sbf.launch_geometry(spec, "add", sbf.Layout(theta, 1))
        return lambda: sbf._launch_add(add_name, spec, words, keys, geo)

    def contains_at(theta, d, phi=sbf.MAX_VEC):
        geo = sbf.launch_geometry(spec, "contains", sbf.Layout(theta, phi), d)
        return lambda: sbf._launch_contains(contains_name, spec, g.words,
                                            keys, geo)

    sweep = {}
    for th in thetas(spec):
        sweep[f"add theta={th}"] = time_ms(add_at(th),
                                           f"{regime} add theta={th}")
        for d in (1,) if regime == "L2" else sbf.DMA_DEPTHS:
            for phi in (1, 2, 4) if regime == "L2" else (4,):
                geo = sbf.launch_geometry(spec, "contains",
                                          sbf.Layout(th, phi), d)
                key = (f"contains theta={th} depth={geo.depth} "
                       f"vec={geo.vec}")
                if key not in sweep:
                    sweep[key] = time_ms(contains_at(th, d, phi),
                                         f"{regime} {key}")
    print(f"time {regime} Θ sweep [{card}], {n} keys: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sweep.items()))
    turns = {
        "add": time_turns({"resolved": add_at(ran["add"].theta),
                           "theta=1": add_at(1)}, f"{regime} add turns"),
        "contains": time_turns({"resolved": contains_at(
            ran["contains"].theta, depth), "theta=1": contains_at(1, depth)},
            f"{regime} contains turns")}
    for op, tt in turns.items():
        lo, _ = SPREAD[f"{regime} {op} turns resolved"]
        _, hi1 = SPREAD[f"{regime} {op} turns theta=1"]
        if lo > hi1:
            raise AssertionError(
                f"{regime} {op}: the resolved Θ={ran[op].theta} "
                f"({tt['resolved']:.4f} ms) is slower than Θ = 1 "
                f"({tt['theta=1']:.4f} ms) beyond the rounds' spread")
    # the uncoalesced atomic rate: Θ = 1, one atomicOr a nonzero mask word
    # (sbf: salt i lands in word i % s, so min(k, s) words a key)
    CAS_PER_S[regime] = n * min(spec.k, spec.s) / (
        turns["add"]["theta=1"] * 1e-3)
    print(f"time {regime} uncoalesced atomics [{card}]: "
          f"{CAS_PER_S[regime]:.4g} 32-bit atomicOr a second (Θ = 1 add, "
          f"{n} keys x {min(spec.k, spec.s)} words)")
    for name, op in ((add_name, "add"), (contains_name, "contains")):
        t_full, t_sub, t_plain = t[op], t[f"{op} sub"], t[f"{op} plain"]
        b_full, by_full = bound_ms(spec, n, op)
        b_sub, by_sub = bound_ms(spec, SUBSET, op)
        s_full, s_sub = sector_bound_ms(n, op), sector_bound_ms(SUBSET, op)
        t1, tr = turns[op]["theta=1"], turns[op]["resolved"]
        lo, hi = SPREAD[f"{regime} {op}"]
        lo1, hi1 = SPREAD[f"{regime} {op} turns theta=1"]
        geo = ran[op]
        print(f"time {regime} {op} [{card}]: kernel {t_full:.4f} ms at "
              f"Θ={geo.theta}, depth {geo.depth} (rounds {lo:.4f}-{hi:.4f}; "
              f"{n / t_full / 1e3:.1f} Mops/s) at {n} keys; in turns "
              f"{tr:.4f} ms against Θ = 1 {t1:.4f} ms (rounds {lo1:.4f}-"
              f"{hi1:.4f}), {t1 / tr:.2f}x; bound {b_full:.4f} ms "
              f"({by_full}), {b_full / t_full:.1%} of it; sector bound "
              f"{s_full:.4f} ms, {s_full / t_full:.1%} of it; Filter.{op} "
              f"{t[f'Filter.{op}']:.4f} ms; at {SUBSET} keys kernel "
              f"{t_sub:.4f} ms, plain {t_plain:.4f} ms, bound {b_sub:.4f} ms, "
              f"sector bound {s_sub:.4f} ms")
        records[name] = {
            "name": name, "route": "cuda", "source": COOP_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t_sub, "plain_ms": t_plain,
            "bound_ms": b_sub, "bound_by": by_sub, "library_ms": None,
            "n_keys": SUBSET, "m_bits": spec.m_bits, "main_n_keys": n,
            "main_ms": t_full, "main_bound_ms": b_full,
            "api_ms": t[f"Filter.{op}"], "theta": geo.theta,
            "vec": geo.vec, "depth": geo.depth, "turns_ms": tr,
            "theta1_ms": t1, "sector_bound_ms": s_sub,
            "main_sector_bound_ms": s_full,
            "sweep_ms": {k: v for k, v in sweep.items()
                         if k.startswith(op)}}
    del g, f, keys, words, sub_words, want_words
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


# The other blocks the default path serves (variant, block bits): s = 2, 4,
# 16 and 32 words, and the bbf and csbf masks; the main path is sbf B = 256
RULE_CELLS = [("sbf", 64), ("sbf", 128), ("sbf", 512), ("sbf", 1024),
              ("bbf", 256), ("bbf", 512), ("csbf", 512)]


def phase_card_rule(card: str) -> None:
    """Phase 4a: ``sbf.card_layout`` at the other blocks the default path
    serves (``RULE_CELLS``, as ``filter_for_n_items(n, bits_per_key=16,
    variant=, block_bits=)`` makes them), at an L2 size (2^23 keys, 16 MiB)
    and a DRAM size (2^26 keys, 128 MiB): the default path's add runs
    ``card_layout``'s geometry; then the add and the contains (of the added
    keys, at the depth ``ops`` resolves) at every Θ, timed in turns. Every
    cell is printed; then the phase fails where ``card_layout``'s Θ was
    slower than Θ = 1 beyond the rounds' spread."""
    dev = torch.device("cuda")
    slower = []
    for variant, block_bits in RULE_CELLS:
        for regime, n in (("L2", 1 << 23), ("DRAM", 1 << 26)):
            f = api.filter_for_n_items(n, bits_per_key=16, variant=variant,
                                       block_bits=block_bits, device="cuda")
            spec = f.spec
            keys = gen_keys(n, 7)
            g = f.add(keys)
            add_name, con_name = (("add_vmem", "contains_vmem")
                                  if regime == "L2"
                                  else ("add_hbm", "contains_hbm"))
            depth = 1 if regime == "L2" else ops._resolve_depth(
                spec, "contains", None, DEFAULT_TILE, device=dev)
            rule = {op: sbf.card_layout(spec, op) for op in ("add",
                                                             "contains")}
            if sbf.LAST_GEOMETRY[add_name] != sbf.launch_geometry(
                    spec, "add", rule["add"]):
                raise AssertionError(f"rule {spec} {regime}: the default "
                                     f"add ran {sbf.LAST_GEOMETRY[add_name]}")
            words = g.words.clone()
            fns = {"add": {}, "contains": {}}
            for th in thetas(spec):
                ga = sbf.launch_geometry(spec, "add", sbf.Layout(th, 1))
                fns["add"][th] = functools.partial(
                    sbf._launch_add, add_name, spec, words, keys, ga)
                gc = sbf.launch_geometry(spec, "contains",
                                         sbf.Layout(th, sbf.MAX_VEC), depth)
                fns["contains"][th] = functools.partial(
                    sbf._launch_contains, con_name, spec, g.words, keys, gc)
            reps, rounds = (REPS, ROUNDS) if regime == "L2" else (3, ROUNDS)
            for op, calls in fns.items():
                label = f"rule {spec} {regime} {op}"
                t = time_turns({f"theta={th}": fn for th, fn in calls.items()},
                               label, reps, rounds)
                th = min(rule[op].theta, spec.s)
                lo, _ = SPREAD[f"{label} theta={th}"]
                _, hi1 = SPREAD[f"{label} theta=1"]
                print(f"time rule [{card}] {spec} {regime} {op}, {n} keys, "
                      f"depth {depth if op == 'contains' else 1}: " +
                      ", ".join(f"Θ={k.split('=')[1]} {v:.4f} ms"
                                for k, v in t.items()) +
                      f"; card_layout Θ={th} {t[f'theta={th}']:.4f} ms "
                      f"against Θ = 1 {t['theta=1']:.4f} ms, "
                      f"{t['theta=1'] / t[f'theta={th}']:.2f}x")
                if lo > hi1:
                    slower.append(f"{label}: Θ={th} {t[f'theta={th}']:.4f} "
                                  f"ms, Θ = 1 {t['theta=1']:.4f} ms")
            del f, g, keys, words, fns
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if slower:
        raise AssertionError("card_layout slower than Θ = 1 beyond the "
                             "rounds' spread: " + "; ".join(slower))


# ---------------------------------------------------------------------------
# The counting filter (phases 3b, 4b and its times)
# ---------------------------------------------------------------------------

def multiset(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """Each key 1-3 times plus ``keys[0]`` 20 more times (its counters
    saturate), in a seeded random order, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    reps = torch.randint(1, 4, (keys.shape[0],), device="cuda", generator=g)
    batch = torch.cat([keys.repeat_interleave(reps, dim=0),
                       keys[:1].expand(20, 2)])
    perm = torch.randperm(batch.shape[0], device="cuda", generator=g)
    return batch[perm].contiguous()


def valid_mask(n: int, seed: int) -> torch.Tensor:
    """(n,) uint8, about a quarter zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand(n, device="cuda", generator=g) > 0.25).to(torch.uint8)


def counting_path_cases(spec: V.FilterSpec) -> list:
    """The update's paths forced: one-pass; binned at the default bins,
    over several internal batches, in the smallest and in the largest bins
    one filter's rows take (the largest: one bin a filter, whose run
    splits into parts that update its rows by CAS)."""
    least = cnt.binned_bin_row_bits(spec.n_blocks, 1 << 40)
    most = min(cnt.MAX_BIN_ROW_BITS, (spec.n_blocks - 1).bit_length())
    return [{"path": "one-pass"}, {"path": "binned"},
            {"path": "binned", "cap": 1000},
            {"path": "binned", "bin_row_bits": least, "cap": 4097},
            {"path": "binned", "bin_row_bits": most}]


def counting_thetas(spec: V.FilterSpec) -> list:
    """The contains' lanes a key the card runs: s/8 ... s."""
    return [t for t in (1, 2, 4, 8, 16, 32)
            if max(1, spec.s // 8) <= t <= spec.s]


def counting_geometries(spec: V.FilterSpec) -> list:
    """Every (Θ, depth) the contains runs, 16-byte loads; depth 1 also at
    every narrower load width."""
    geos = []
    for t in counting_thetas(spec):
        for d in sbf.DMA_DEPTHS:
            geo = cnt.contains_geometry(spec, sbf.Layout(t, sbf.MAX_VEC), d)
            if geo.depth == d:
                geos.append(geo)
        geos += [cnt.contains_geometry(spec, sbf.Layout(t, v))
                 for v in (1, 2)]
    return geos


def phase_counting_kernels(errs: dict):
    n = 65537
    for i, spec in enumerate(PHASE3B_SPECS):
        keys = gen_keys(n, 400 + i)
        batch = multiset(keys, 500 + i)
        gone = torch.cat([keys[: n // 2],                    # a subset
                          gen_keys(4096, 600 + i, probe=True)])  # never added
        queries = torch.cat([keys, gen_keys(n, 700 + i, probe=True)])
        valid = valid_mask(batch.shape[0], 800 + i)
        init = V.init(spec, "cuda")
        want_add = cnt.update_plain(spec, init, batch, None, "add")
        want_rm = cnt.update_plain(spec, want_add, gone, None, "remove")
        want_valid = cnt.update_plain(spec, init, batch, valid, "add")
        # removing added keys leaves no false negative among the rest (keys
        # never added may clear a shared counter: the guard only floors at 0)
        if not bool(cnt.contains_plain(spec, cnt.update_plain(
                spec, want_add, keys[: n // 2], None, "remove"),
                keys[n // 2:]).all()):
            raise AssertionError(f"{spec}: remove made a false negative")
        runs = 0
        cs = spec.counter_row_words
        vmem_axes = ({}, {"probe": "gather"}, {"coop": "subtile"},
                     {"mix": "cheap"}, {"layout": sbf.Layout(1, 1)},
                     {"layout": sbf.Layout(min(spec.s, 8), min(cs, 4)),
                      "tile": 64})
        for name, axes in (("update_vmem", vmem_axes),
                           ("update_hbm", ({}, {"coop": "subtile"},
                                           {"mix": "cheap"}))):
            update = getattr(cnt, name)
            for kw in axes:
                w = update(spec, V.init(spec, "cuda"), batch, None, "add", **kw)
                errs[name] = max(errs[name], max_err(w, want_add))
                update(spec, w, gone, None, "remove", **kw)
                errs[name] = max(errs[name], max_err(w, want_rm))
                runs += 2
            w = update(spec, V.init(spec, "cuda"), batch, valid, "add")
            errs[name] = max(errs[name], max_err(w, want_valid))
            w = update(spec, V.init(spec, "cuda"), batch,
                       valid.to(torch.bool), "add")
            errs[name] = max(errs[name], max_err(w, want_valid))
            runs += 2
        # every update path forced, valid-masked, then a remove
        want_valid_rm = cnt.update_plain(spec, want_valid, gone, None,
                                         "remove")
        for name in ("update_vmem", "update_hbm"):
            for kw in counting_path_cases(spec):
                w = cnt._launch_update(name, spec, V.init(spec, "cuda"),
                                       batch, valid, "add", **kw)
                errs[name] = max(errs[name], max_err(w, want_valid))
                cnt._launch_update(name, spec, w, gone, None, "remove", **kw)
                errs[name] = max(errs[name], max_err(w, want_valid_rm))
                runs += 2
        # one bin of a small filter's rows (2^17 bits) takes the batch: its
        # parts run at once, each summing its chunks' counts in shared
        # memory and applying them by CAS
        small = V.FilterSpec("countingbf", 1 << 17, spec.k,
                             block_bits=spec.block_bits)
        one_bin = min(cnt.MAX_BIN_ROW_BITS, (small.n_blocks - 1).bit_length())
        want_small = cnt.update_plain(small, V.init(small, "cuda"), batch,
                                      valid, "add")
        want_small_rm = cnt.update_plain(small, want_small, gone, None,
                                         "remove")
        for name in ("update_vmem", "update_hbm"):
            w = cnt._launch_update(name, small, V.init(small, "cuda"), batch,
                                   valid, "add", path="binned",
                                   bin_row_bits=one_bin)
            errs[name] = max(errs[name], max_err(w, want_small))
            cnt._launch_update(name, small, w, gone, None, "remove",
                               path="binned", bin_row_bits=one_bin)
            errs[name] = max(errs[name], max_err(w, want_small_rm))
            runs += 2
        for words in (want_add, want_rm):
            want = cnt.contains_plain(spec, words, queries)
            phis = [p for p in (1, 2, 4, 8, 16, 32, 64, 128) if p <= cs]
            for kw in ([{"layout": sbf.Layout(t, p)} for p in phis
                        for t in counting_thetas(spec)]
                       + [{"probe": "gather"}, {"coop": "subtile"},
                          {"mix": "cheap"}]):
                got = cnt.contains_vmem(spec, words, queries, **kw)
                errs["contains_vmem"] = max(errs["contains_vmem"],
                                            max_err(got, want))
                runs += 1
            for kw in ([{"depth": d} for d in sbf.DMA_DEPTHS]
                       + [{"coop": "subtile"}, {"mix": "cheap"}]):
                got = cnt.contains_hbm(spec, words, queries, **kw)
                errs["contains_hbm"] = max(errs["contains_hbm"],
                                           max_err(got, want))
                runs += 1
            for geo in counting_geometries(spec):          # every Θ, depth
                got = cnt._launch_contains("contains_hbm", spec, words,
                                           queries, geo)
                errs["contains_hbm"] = max(errs["contains_hbm"],
                                           max_err(got, want))
                runs += 1
        w = want_rm.clone()
        for _ in range(2):                                 # decay twice
            want = cnt.decay_plain(spec, w)
            cnt.decay(spec, w)
            errs["decay"] = max(errs["decay"], max_err(w, want))
            runs += 1
        if i == 2:                                   # ragged tails, B = 256
            for m in (1, 255, 257):
                sub, v = batch[:m], valid[:m]
                want = cnt.update_plain(spec, init, sub, v, "add")
                for name in ("update_vmem", "update_hbm"):
                    got = getattr(cnt, name)(spec, V.init(spec, "cuda"), sub,
                                             v, "add")
                    errs[name] = max(errs[name], max_err(got, want))
                    want_r = cnt.update_plain(spec, want, sub[: m // 2 + 1],
                                              None, "remove")
                    getattr(cnt, name)(spec, got, sub[: m // 2 + 1], None,
                                       "remove")
                    errs[name] = max(errs[name], max_err(got, want_r))
                c = cnt.contains_plain(spec, want, queries[:m])
                for name in ("contains_vmem", "contains_hbm"):
                    got = getattr(cnt, name)(spec, want, queries[:m])
                    errs[name] = max(errs[name], max_err(got, c))
                runs += 6
        fpr = float(cnt.contains_vmem(
            spec, want_add, gen_keys(1 << 20, 900 + i, probe=True)
        ).to(torch.float64).mean().item())
        theory = V.fpr_theory(spec, n)
        if not 0.5 * theory <= fpr <= 2.0 * theory:
            raise AssertionError(f"{spec}: FPR {fpr} outside 0.5-2.0 x "
                                 f"theory {theory}")
        torch.cuda.synchronize()
        print(f"kernels: {spec}: {runs} counting kernel runs equal to the "
              f"plain version ({batch.shape[0]} inserts of {n} keys, "
              f"removes, decays, valid masks); FPR {fpr:.6f} = "
              f"{fpr / theory:.3f} x theory on 2^20 probes")


def time_restored_ms(fn, restore, label: str, reps: int = REPS,
                     rounds: int = ROUNDS, warmup: int = 2) -> float:
    """Like :func:`time_ms` for a call that changes its state: ``restore()``
    runs before every call, outside the CUDA events that time the call."""
    for _ in range(warmup):
        restore()
        fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        events = []
        for _ in range(reps):
            restore()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        per_round.append(sum(a.elapsed_time(b) for a, b in events) / reps)
    per_round.sort()
    SPREAD[label] = (per_round[0], per_round[-1])
    return per_round[len(per_round) // 2]


def time_restored_turns(fns: dict, restore, label: str, reps: int = REPS,
                        rounds: int = ROUNDS) -> dict:
    """:func:`time_turns` for calls that change their state: ``restore()``
    runs before every call, outside the CUDA events that time it (the
    untimed calls that start a round too)."""
    for fn in fns.values():
        restore()
        fn()
    torch.cuda.synchronize()
    per = {key: [] for key in fns}
    for r in range(rounds):
        for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            for _ in range(warm_calls(reps)):
                restore()
                fns[key]()
            events = []
            for _ in range(reps):
                restore()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[key]()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            per[key].append(sum(a.elapsed_time(b) for a, b in events) / reps)
    out = {}
    for key, ts in per.items():
        ts.sort()
        SPREAD[f"{label} {key}"] = (ts[0], ts[-1])
        out[key] = ts[len(ts) // 2]
    return out


def counter_updates(spec: V.FilterSpec, keys: torch.Tensor) -> int:
    """Counter words the keys' masks touch, summed over keys: the atomicCAS
    loops an update runs (at least one CAS each)."""
    total = 0
    for chunk in keys.split(SUBSET):
        masks = V.block_patterns(spec, H.hash_keys(chunk)[0])
        for c in range(4):
            total += int((((masks >> (8 * c)) & 0xFF) != 0).sum().item())
    return total


def touched_sectors(words: torch.Tensor) -> int:
    """32-byte counter sectors holding a nonzero word."""
    return int((words.view(-1, 8) != 0).any(dim=1).sum().item())


def counting_bound_ms(spec: V.FilterSpec, n: int, op: str, sectors: int,
                      updates: int, extra_bytes: int = 0):
    """Least time: max(bytes / memory rate, ops / peak rate). Bytes: 8 per
    key and 1 per result (contains), plus the touched 32-byte sectors read
    (contains), read and written (updates), or every counter byte read and
    written (decay), plus ``extra_bytes`` (a bank's member ids and valid
    bytes). Ops: 40 per key for the two hash streams, 4 per salt bit, and 12
    (contains) or 20 (update) per touched counter word; 12 per word for
    decay."""
    if op == "decay":
        nbytes = 2 * 4 * spec.storage_words
        n_ops = 12 * spec.storage_words
    else:
        per_word = 12 if op == "contains" else 20
        nbytes = 8 * n + extra_bytes + (n + 32 * sectors if op == "contains"
                                        else 2 * 32 * sectors)
        n_ops = n * (40 + 4 * spec.k) + per_word * updates
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


COUNTING_KERNELS = {
    "update": ["counting_update_kernel<S, OP, BANK> (one-pass)",
               "counting_bin_count_kernel", "bin_column_kernel",
               "bin_scan_kernel", "counting_bin_scatter_kernel",
               "counting_bin_apply_kernel<S, OP>",
               "counting_bin_parts_kernel (over-full bins)",
               "counting_bin_split_kernel<S, OP> (over-full bins)"],
    "contains": ["counting_contains_kernel<S, THETA, V, DEPTH, BANK>"],
    "decay": ["counting_decay_kernel"]}
COUNTING_CONTAINS_SOURCE = "src/repro_torch/kernels/csrc/counting_contains.cu"


def counting_binned_floor_ms(spec: V.FilterSpec, n: int, rows: int,
                             extra_bytes: int = 0) -> float:
    """The binned update's design floor: the keys read twice (count and
    scatter), an 8-byte slot a key written and read once, each touched
    counter row read and written once, plus ``extra_bytes`` (member ids and
    valid bytes, read twice)."""
    nbytes = 16 * n + 16 * n + 2 * rows * 4 * spec.counter_row_words
    return (nbytes + 2 * extra_bytes) / HBM_BYTES_PER_S * 1e3


def touched_rows(spec: V.FilterSpec, words: torch.Tensor) -> int:
    """Counter rows holding a nonzero word."""
    return int((words.view(-1, spec.counter_row_words) != 0).any(
        dim=1).sum().item())


def update_path_turns(label: str, run, restore, reps: int, rounds: int,
                      bin_bits: tuple = ()) -> dict:
    """The update's paths in turns on restored state, and the binned path
    in bins of 2^b rows for each b of ``bin_bits``: ``run(**kw)`` is one
    call."""
    fns = {p: (lambda p=p: run(path=p)) for p in cnt.UPDATE_PATHS}
    for b in bin_bits:
        fns[f"binned 2^{b} rows"] = (lambda b=b: run(path="binned",
                                                     bin_row_bits=b))
    return time_restored_turns(fns, restore, label, reps, rounds)


def update_peak_bytes(run, restore) -> dict:
    """Peak extra device memory of one call on each path, against its
    plan's workspace (the binned add's slots; none for one-pass)."""
    peak = {}
    for p in cnt.UPDATE_PATHS:
        restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        plan = run(path=p)
        torch.cuda.synchronize()
        peak[p] = (torch.cuda.max_memory_allocated() - before,
                   plan["workspace_bytes"])
        if peak[p][0] > peak[p][1] + 512:      # the allocator's rounding
            raise AssertionError(f"{p} update: peak extra memory {peak[p][0]} "
                                 f"B above its workspace {peak[p][1]} B")
    return peak


def contains_sweep(label: str, run, spec, reps: int, bank: bool = False
                   ) -> dict:
    """The contains at every (Θ, depth) and, at depth 1, load width (a
    bank: 16-byte loads only), in turns; ``run(geo)`` is one call."""
    fns = {f"Θ{g.theta} d{g.depth} v{g.vec}": (lambda g=g: run(g))
           for g in counting_geometries(spec)
           if not bank or g.vec == sbf.MAX_VEC}
    return time_turns(fns, label, reps, 3)


def phase_counting_main(regime: str, n: int, errs: dict, records: dict,
                        launches: dict, card: str):
    upd, con = (("update_vmem", "contains_vmem") if regime == "L2"
                else ("update_hbm", "contains_hbm"))
    f = api.filter_for_n_items(n, bits_per_key=16, variant="countingbf",
                               block_bits=256, device="cuda")
    spec = f.spec
    if f.backend != "counting" or spec.k != 8:
        raise AssertionError(f"counting {regime}: {spec} on {f.backend}")
    if ops.fits_l2(spec) != (regime == "L2"):
        raise AssertionError(f"counting {regime}: {spec} in the wrong regime")
    keys = gen_keys(n, 11)
    probes = gen_keys(SUBSET, 12, probe=True)
    half = n // 2
    smem = sbf.partition_smem_bytes(keys.device)
    torch.cuda.synchronize()

    cnt.reset_launches()                   # the main path, counted
    t0 = time.perf_counter()
    g = f.add(keys)
    aplan = dict(cnt.LAST_UPDATE_PLAN[upd])
    hits = g.contains(keys)
    geo = cnt.LAST_GEOMETRY[con]
    h = g.remove(keys[:half])
    rplan = dict(cnt.LAST_UPDATE_PLAN[upd])
    kept = h.contains(keys[half:])
    d = h.decay(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(cnt.LAUNCHES)
    for name in (upd, con, "decay"):
        if counted[name] == 0:
            raise AssertionError(f"{name} was not launched on the counting "
                                 f"main path")
        launches[name] = launches.get(name, 0) + counted[name]
    for m, plan in ((n, aplan), (half, rplan)):
        if plan["path"] != cnt.choose_update_path(
                m, spec.storage_words, spec.counter_row_words, smem):
            raise AssertionError(f"counting {regime}: an update of {m} keys "
                                 f"ran {plan}, not the rule's path")
    if not (bool(hits.all()) and bool(kept.all())):
        raise AssertionError(f"counting {regime}: false negatives")
    false_pos = g.contains(probes)

    # the main path's words and results against the plain version, in full
    def plain_update(op):
        return lambda w, c: cnt.update_plain(spec, w, c, None, op)
    plain_contains = functools.partial(cnt.contains_plain, spec)
    want_add = update_in_chunks(plain_update("add"), V.init(spec, "cuda"),
                                keys)
    errs[upd] = max(errs[upd], max_err(g.words, want_add))
    errs[con] = max(errs[con], max_err(
        hits, contains_in_chunks(plain_contains, want_add, keys)))
    errs[con] = max(errs[con], max_err(false_pos,
                                       plain_contains(want_add, probes)))
    want_rm = update_in_chunks(plain_update("remove"), want_add, keys[:half])
    errs[upd] = max(errs[upd], max_err(h.words, want_rm))
    errs[con] = max(errs[con], max_err(
        kept, contains_in_chunks(plain_contains, want_rm, keys[half:])))
    errs["decay"] = max(errs["decay"], max_err(
        d.words, cnt.decay_plain(spec, want_rm)))
    # the other update path on the cell's keys, against the plain version
    other = "one-pass" if aplan["path"] == "binned" else "binned"
    w = cnt._launch_update(upd, spec, V.init(spec, "cuda"), keys, None,
                           "add", path=other)
    errs[upd] = max(errs[upd], max_err(w, want_add))
    cnt._launch_update(upd, spec, w, keys[:half], None, "remove", path=other)
    errs[upd] = max(errs[upd], max_err(w, want_rm))
    del want_add, want_rm, w
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = g.fpr_theory(n)
    print(f"main counting {regime}: {spec} on {g.backend}, {n} keys, "
          f"{g.nbytes / 2**20:.0f} MiB of counters: add, contains, remove "
          f"of {half}, contains of the rest, decay(1) in {wall * 1e3:.1f} ms "
          f"host clock, no false negatives; every step's words, hits and "
          f"probe results equal to the plain version's in full (and the "
          f"{other} update's); FPR {fpr:.6f}, {fpr / theory:.3f} x theory "
          f"{theory:.6f}, launches {counted}; the add's plan "
          f"(cnt.LAST_UPDATE_PLAN) {aplan}; the remove's {rplan}; the "
          f"contains' geometry {geo}")

    # the timing columns' subset: 2^22 keys into an empty full-size filter
    sub = keys[:SUBSET]
    sub_half = sub.shape[0] // 2
    sub_add = cnt.update_plain(spec, V.init(spec, "cuda"), sub, None, "add")
    torch.cuda.synchronize()

    # times: the main path at full size, and kernel vs plain on 2^22 keys
    run_upd = getattr(cnt, upd)
    run_con = getattr(cnt, con)
    scratch = V.init(spec, "cuda")
    t = {
        "add": time_restored_ms(
            lambda: run_upd(spec, scratch, keys, None, "add"),
            scratch.zero_, f"{regime} add"),
        "contains": time_ms(lambda: run_con(spec, g.words, keys),
                            f"{regime} contains"),
        "remove": time_restored_ms(
            lambda: run_upd(spec, scratch, keys[:half], None, "remove"),
            lambda: scratch.copy_(g.words), f"{regime} remove"),
        "decay": time_restored_ms(
            lambda: cnt.decay(spec, scratch),
            lambda: scratch.copy_(h.words), f"{regime} decay"),
        "Filter.add": time_ms(lambda: f.add(keys), f"{regime} Filter.add"),
        "Filter.contains": time_ms(lambda: g.contains(keys),
                                   f"{regime} Filter.contains"),
        "Filter.remove": time_ms(lambda: g.remove(keys[:half]),
                                 f"{regime} Filter.remove"),
        "Filter.decay": time_ms(lambda: h.decay(1), f"{regime} Filter.decay"),
        "add sub": time_restored_ms(
            lambda: run_upd(spec, scratch, sub, None, "add"),
            scratch.zero_, f"{regime} add sub"),
        "contains sub": time_ms(lambda: run_con(spec, sub_add, sub),
                                f"{regime} contains sub"),
        "remove sub": time_restored_ms(
            lambda: run_upd(spec, scratch, sub[:sub_half], None, "remove"),
            lambda: scratch.copy_(sub_add), f"{regime} remove sub"),
        "add plain": time_ms(
            lambda: cnt.update_plain(spec, V.init(spec, "cuda"), sub, None,
                                     "add"),
            f"{regime} add plain", PLAIN_REPS, PLAIN_ROUNDS),
        "contains plain": time_ms(
            lambda: cnt.contains_plain(spec, sub_add, sub),
            f"{regime} contains plain", PLAIN_REPS, PLAIN_ROUNDS),
        "remove plain": time_ms(
            lambda: cnt.update_plain(spec, sub_add, sub[:sub_half], None,
                                     "remove"),
            f"{regime} remove plain", PLAIN_REPS, PLAIN_ROUNDS),
        "decay plain": time_ms(lambda: cnt.decay_plain(spec, h.words),
                               f"{regime} decay plain", PLAIN_REPS,
                               PLAIN_ROUNDS),
    }
    # both update paths in turns at the cell's size (the add also in bins
    # of half, twice and four times the rule's rows, where they fit), an
    # add's peak extra memory on each path, and the contains at every Θ
    # and depth
    reps = REPS if regime == "L2" else 5
    rb = aplan["bin_row_bits"]
    other_bins = () if rb is None else tuple(
        b for b in (rb - 1, rb + 1, rb + 2)
        if cnt.binned_fits(aplan["total_rows"], b, smem))
    paths = {op: update_path_turns(
        f"counting {regime} {op} paths",
        lambda op=op, nk=nk, **kw: cnt._launch_update(
            upd, spec, scratch, keys[:nk], None, op, **kw),
        restore, reps, ROUNDS, bins)
        for op, nk, restore, bins in (
            ("add", n, scratch.zero_, other_bins),
            ("remove", half, lambda: scratch.copy_(g.words), ()))}
    peak = update_peak_bytes(
        lambda **kw: (cnt._launch_update(upd, spec, scratch, keys, None,
                                         "add", **kw),
                      cnt.LAST_UPDATE_PLAN[upd])[1], scratch.zero_)
    sweep = contains_sweep(
        f"counting {regime} contains sweep",
        lambda geo: cnt._launch_contains(con, spec, g.words, keys, geo),
        spec, REPS if regime == "L2" else 5)
    best = min(sweep, key=sweep.get)
    ran = f"Θ{geo.theta} d{geo.depth} v{geo.vec}"
    for op in ("add", "remove"):
        lo_hi = {p: SPREAD[f"counting {regime} {op} paths {p}"]
                 for p in paths[op]}
        print(f"time counting {regime} {op} paths [{card}] "
              f"({n if op == 'add' else half} keys, in turns, restored "
              f"state): " + ", ".join(
                  f"{p} {v:.4f} ms (rounds {lo_hi[p][0]:.4f}-"
                  f"{lo_hi[p][1]:.4f})" for p, v in paths[op].items())
              + f"; one-pass / binned "
              f"{paths[op]['one-pass'] / paths[op]['binned']:.2f}x; the "
              f"rule ran {(aplan if op == 'add' else rplan)['path']} (bins "
              f"of 2^{(aplan if op == 'add' else rplan)['bin_row_bits']} "
              f"rows where binned)")
    print(f"counting {regime} add peak extra memory [{card}]: " + ", ".join(
        f"{p} {b} B (workspace {w} B)" for p, (b, w) in peak.items()))
    print(f"time counting {regime} contains sweep [{card}] ({n} member "
          f"keys, in turns): " + ", ".join(
              f"{k} {v:.4f}" for k, v in sweep.items())
          + f" ms; the main path ran {ran} ({sweep.get(ran, float('nan')):.4f}"
          f" ms), the best {best} ({sweep[best]:.4f} ms)")
    # the bound's data-dependent terms: sectors and counter words touched
    full = {"add": (n, touched_sectors(g.words), counter_updates(spec, keys)),
            "remove": (half, touched_sectors(run_upd(
                spec, V.init(spec, "cuda"), keys[:half], None, "add")),
                counter_updates(spec, keys[:half]))}
    full["contains"] = full["add"]
    part = {"add": (sub.shape[0], touched_sectors(sub_add),
                    counter_updates(spec, sub)),
            "remove": (sub_half, touched_sectors(cnt.update_plain(
                spec, V.init(spec, "cuda"), sub[:sub_half], None, "add")),
                counter_updates(spec, sub[:sub_half]))}
    part["contains"] = part["add"]
    floors = {"add": counting_binned_floor_ms(spec, n,
                                              touched_rows(spec, g.words)),
              "remove": counting_binned_floor_ms(spec, half, touched_rows(
                  spec, g.words))}
    for op in ("add", "contains", "remove"):
        nk, sectors, updates = full[op]
        b_full, by_full = counting_bound_ms(spec, nk, op, sectors, updates)
        nk_s, sectors_s, updates_s = part[op]
        b_sub, by_sub = counting_bound_ms(spec, nk_s, op, sectors_s,
                                          updates_s)
        lo, hi = SPREAD[f"{regime} {op}"]
        floor = ("" if op == "contains" else
                 f"; binned floor {floors[op]:.4f} ms, "
                 f"{floors[op] / t[op]:.1%} of it")
        print(f"time counting {regime} {op} [{card}]: kernel "
              f"{t[op]:.4f} ms (rounds {lo:.4f}-{hi:.4f}; "
              f"{nk / t[op] / 1e3:.1f} Mops/s) at {nk} keys, bound "
              f"{b_full:.4f} ms ({by_full}; {sectors} sectors), "
              f"{b_full / t[op]:.1%} of it{floor}; Filter.{op} "
              f"{t[f'Filter.{op}']:.4f} ms; at {nk_s} keys kernel "
              f"{t[f'{op} sub']:.4f} ms, plain {t[f'{op} plain']:.4f} ms, "
              f"bound {b_sub:.4f} ms ({by_sub})")
        name = upd if op != "contains" else con
        if op == "remove":
            records[name].update(remove_ms=t["remove sub"],
                                 remove_plain_ms=t["remove plain"],
                                 remove_bound_ms=b_sub,
                                 main_remove_ms=t["remove"],
                                 api_remove_ms=t["Filter.remove"],
                                 remove_path=rplan["path"],
                                 remove_paths_ms=paths["remove"],
                                 remove_binned_floor_ms=floors["remove"])
            continue
        records[name] = {
            "name": f"counting_{name}", "route": "cuda",
            "source": (COUNTING_SOURCE if op == "add"
                       else COUNTING_CONTAINS_SOURCE),
            "replaces": COUNTING_REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t[f"{op} sub"], "plain_ms": t[f"{op} plain"],
            "bound_ms": b_sub, "bound_by": by_sub, "library_ms": None,
            "n_keys": nk_s, "m_bits": spec.m_bits, "main_n_keys": nk,
            "main_ms": t[op], "main_bound_ms": b_full,
            "api_ms": t[f"Filter.{op}"],
            "cuda_kernels": COUNTING_KERNELS["update" if op == "add"
                                             else "contains"]}
        if op == "add":
            records[name].update(path=aplan["path"], plan=aplan,
                                 paths_ms=paths["add"],
                                 binned_floor_ms=floors["add"],
                                 peak_extra_bytes=peak[aplan["path"]][0])
        else:
            records[name].update(geometry=ran, sweep_ms=sweep,
                                 best=best)
    b_dec, by_dec = counting_bound_ms(spec, 0, "decay", 0, 0)
    lo, hi = SPREAD[f"{regime} decay"]
    print(f"time counting {regime} decay [{card}]: kernel {t['decay']:.4f} ms "
          f"(rounds {lo:.4f}-{hi:.4f}) over {g.nbytes / 2**20:.0f} MiB, bound "
          f"{b_dec:.4f} ms ({by_dec}), {b_dec / t['decay']:.1%} of it; "
          f"Filter.decay {t['Filter.decay']:.4f} ms; plain "
          f"{t['decay plain']:.4f} ms")
    if regime == "DRAM":     # decay streams the counters: the DRAM cell
        records["decay"] = {
            "name": "counting_decay", "route": "cuda",
            "source": COUNTING_SOURCE, "replaces": COUNTING_REPLACES["decay"],
            "launches": launches["decay"], "max_abs_err": errs["decay"],
            "ms": t["decay"], "plain_ms": t["decay plain"],
            "bound_ms": b_dec, "bound_by": by_dec, "library_ms": None,
            "m_bits": spec.m_bits, "api_ms": t["Filter.decay"],
            "cuda_kernels": COUNTING_KERNELS["decay"]}
    del f, g, h, d, keys, scratch, sub_add
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


COUNTING_RULE_LOG2B = range(20, 30)     # counter bytes of the rule's sweep
COUNTING_RULE_LOG2N = range(16, 27)     # keys of the rule's sweep
COUNTING_RULE_RETIME_ROUNDS = 9         # where the rule's path was slower


def phase_counting_rule(card: str):
    """The update's path rule against both paths timed in turns: B = 256,
    k = 8, 2^20 ... 2^29 counter bytes x 2^16 ... 2^26 keys added into
    empty counters. Prints every size where the rule's path is the slower;
    fails where it is slower than the other beyond the rounds' spread by
    more than 10 % and 0.01 ms. A size where the rule's path was the
    slower in the sweep's 3 rounds is timed again over
    ``COUNTING_RULE_RETIME_ROUNDS`` rounds, and judged by those."""
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    keys = gen_keys(1 << max(COUNTING_RULE_LOG2N), 31)
    rows, slower, wrong, retimed = [], [], [], []
    for log2b in COUNTING_RULE_LOG2B:
        spec = V.FilterSpec("countingbf", 1 << (log2b + 1), 8,
                            block_bits=256)
        words = V.init(spec, "cuda")
        for log2n in COUNTING_RULE_LOG2N:
            sub = keys[: 1 << log2n]
            fns = {p: (lambda p=p: cnt._launch_update(
                "update_hbm", spec, words, sub, None, "add", path=p))
                for p in cnt.UPDATE_PATHS}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fns["one-pass"]()
            start.record()
            fns["one-pass"]()
            end.record()
            torch.cuda.synchronize()
            reps = max(1, min(REPS, int(10 / max(start.elapsed_time(end),
                                                 1e-3))))
            label = f"counting rule 2^{log2b} 2^{log2n}"
            t = time_restored_turns(fns, words.zero_, label, reps, 3)
            chosen = cnt.choose_update_path(1 << log2n, spec.storage_words,
                                            spec.counter_row_words, smem)
            other = "binned" if chosen == "one-pass" else "one-pass"
            first = ""
            if t[chosen] > t[other]:
                first = (f" (3 rounds: {t[chosen]:.4f} against "
                         f"{t[other]:.4f})")
                t = time_restored_turns(fns, words.zero_, label, reps,
                                        COUNTING_RULE_RETIME_ROUNDS)
                retimed.append(f"2^{log2b} B/2^{log2n} keys {chosen} "
                               f"{t[chosen]:.4f} against {t[other]:.4f} ms"
                               f"{first}")
            if t[chosen] > t[other]:
                slower.append(f"2^{log2b} B/2^{log2n} keys {chosen} "
                              f"{t[chosen]:.4f} against {t[other]:.4f} ms "
                              f"(+{t[chosen] / t[other] - 1:.1%}, "
                              f"{COUNTING_RULE_RETIME_ROUNDS} rounds){first}")
            if (t[chosen] > SPREAD[f"{label} {other}"][1]
                    and t[chosen] > 1.10 * t[other]
                    and t[chosen] - t[other] > 0.01):
                wrong.append((log2b, log2n, t[chosen], t[other]))
            rows.append(f"2^{log2b}/2^{log2n} {t['one-pass']:.4f}/"
                        f"{t['binned']:.4f}{'*' if chosen == 'binned' else ''}")
        del words
    del keys
    torch.cuda.empty_cache()
    print(f"counting update rule sweep [{card}] (counter bytes / keys: "
          f"one-pass / binned ms, median of 3 rounds in turns on restored "
          f"counters; * the rule picks binned): " + ", ".join(rows))
    print(f"counting update rule: timed again over "
          f"{COUNTING_RULE_RETIME_ROUNDS} rounds: "
          + ("; ".join(retimed) if retimed else "none"))
    print(f"counting update rule: the rule's path is the slower at "
          f"{len(slower)} of {len(rows)} sizes: "
          + ("; ".join(slower) if slower else "none"))
    if wrong:
        raise AssertionError(f"counting update rule picks the slower path "
                             f"by more than 10 % at (log2 bytes, log2 n, "
                             f"chosen ms, other ms) {wrong}")


# ---------------------------------------------------------------------------
# The classical filter and the windowed filter (phases 3c, 4c and their times)
# ---------------------------------------------------------------------------

CBF_SOURCE = "src/repro_torch/kernels/csrc/cbf.cu"
RING_SOURCE = "src/repro_torch/kernels/csrc/ring.cu"
CBF_REPLACES = {"contains_vmem": "src/repro/kernels/cbf.py:64",
                "add_vmem": "src/repro/kernels/cbf.py:80"}
RING_REPLACES = {"ring_contains_vmem": "src/repro/kernels/ring.py:99",
                 "ring_contains_hbm": "src/repro/kernels/ring.py:120"}
RING_KERNELS = ["ring_contains_kernel (one-pass)", "ring_bin_count_kernel",
                "bin_column_kernel", "bin_scan_kernel",
                "ring_bin_scatter_kernel", "ring_bin_test_kernel"]
PHASE3C_RING_SPECS = [                  # s = 8, 8, 1, 16, 2, 4, 32 words
    V.FilterSpec("sbf", 1 << 20, 16, block_bits=256),
    V.FilterSpec("bbf", 1 << 20, 8, block_bits=256),
    V.FilterSpec("rbbf", 1 << 20, 4),
    V.FilterSpec("csbf", 1 << 20, 8, block_bits=512, z=2),
    V.FilterSpec("sbf", 1 << 20, 4, block_bits=64),
    V.FilterSpec("sbf", 1 << 20, 8, block_bits=128),
    V.FilterSpec("sbf", 1 << 20, 32, block_bits=1024),
]
DRAM_CBF_REPS, DRAM_CBF_ROUNDS = 5, 3   # the DRAM cbf cell's calls take ~0.1 s
CBF_KERNELS = {"contains_vmem": ["cbf_contains_kernel (one-pass)",
                                  "cbf_bin_count_kernel",
                                  "bin_column_kernel",
                                  "bin_scan_kernel",
                                  "cbf_bin_scatter_kernel<uint64_t>",
                                  "cbf_bin_test_kernel"],
               "add_vmem": ["cbf_add_kernel (one-pass)",
                            "cbf_bin_count_kernel", "bin_column_kernel",
                            "bin_scan_kernel",
                            "cbf_bin_scatter_kernel<uint32_t>",
                            "cbf_bin_apply_kernel"]}


def phase_cbf_kernels(errs: dict):
    n = 65537
    for i, k in enumerate((1, 7, 11, 32)):
        spec = V.FilterSpec("cbf", 1 << 20, k)
        keys = gen_keys(n, 1000 + i)
        queries = torch.cat([keys, gen_keys(n, 1100 + i, probe=True)])
        want_words = cbf.add_plain(spec, V.init(spec, "cuda"), keys)
        want = cbf.contains_plain(spec, want_words, queries)
        got = cbf.add_vmem(spec, V.init(spec, "cuda"), keys)
        errs["add_vmem"] = max(errs["add_vmem"], max_err(got, want_words))
        got = cbf.contains_vmem(spec, want_words, queries)
        errs["contains_vmem"] = max(errs["contains_vmem"], max_err(got, want))
        for m in (0, 1, 255, 257):                     # ragged and empty
            w = cbf.add_plain(spec, V.init(spec, "cuda"), keys[:m])
            got = cbf.add_vmem(spec, V.init(spec, "cuda"), keys[:m])
            errs["add_vmem"] = max(errs["add_vmem"], max_err(got, w))
            got = cbf.contains_vmem(spec, w, queries[:m])
            errs["contains_vmem"] = max(errs["contains_vmem"], max_err(
                got, cbf.contains_plain(spec, w, queries[:m])))
        fpr = float(cbf.contains_vmem(
            spec, want_words, gen_keys(1 << 20, 1200 + i, probe=True)
        ).to(torch.float64).mean().item())
        theory = V.fpr_theory(spec, n)
        if not 0.5 * theory <= fpr <= 2.0 * theory:
            raise AssertionError(f"{spec}: FPR {fpr} outside 0.5-2.0 x "
                                 f"theory {theory}")
        torch.cuda.synchronize()
        print(f"kernels: {spec}: add and contains equal to the plain "
              f"version ({n} keys, {n} probes, n in 0/1/255/257); FPR "
              f"{fpr:.6f} = {fpr / theory:.3f} x theory on 2^20 probes")
    # all 32 bits of a position at m = 2^32 (the shift is 0)
    spec = V.FilterSpec("cbf", 1 << 32, 11)
    keys = gen_keys(1 << 20, 1300)
    h1, h2 = H.hash_keys(keys[:4096])
    if int(V.cbf_positions(spec, h1, h2).max().item()) < 1 << 31:
        raise AssertionError("cbf positions at m = 2^32 miss the top bit")
    want_words = cbf.add_plain(spec, V.init(spec, "cuda"), keys)
    got = cbf.add_vmem(spec, V.init(spec, "cuda"), keys)
    errs["add_vmem"] = max(errs["add_vmem"], max_err(got, want_words))
    queries = torch.cat([keys, gen_keys(1 << 20, 1301, probe=True)])
    errs["contains_vmem"] = max(errs["contains_vmem"], max_err(
        cbf.contains_vmem(spec, want_words, queries),
        cbf.contains_plain(spec, want_words, queries)))
    for path in cbf.PATHS:                   # both add paths, forced
        got = cbf.add_vmem(spec, V.init(spec, "cuda"), keys, path=path)
        errs["add_vmem"] = max(errs["add_vmem"], max_err(got, want_words))
    got = cbf.add_vmem(spec, V.init(spec, "cuda"), keys, path="binned",
                       cap=11 * 300000)           # 4 internal batches
    errs["add_vmem"] = max(errs["add_vmem"], max_err(got, want_words))
    if not bool(got[spec.n_words // 2:].any()):
        raise AssertionError("the binned add left the top half unset")
    del got, want_words
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"kernels: {spec}: add of 2^20 keys (the rule's path, one-pass, "
          f"binned, binned in 4 internal batches) and contains of 2^21 "
          f"equal to the plain version (positions use all 32 bits)")
    phase_cbf_paths(errs)


def phase_cbf_paths(errs: dict):
    """Both add paths forced against the plain version: k in 1/7/11/32 at
    m = 2^20 (two bins), a filter smaller than a bin (m = 2^5), several
    internal batches, bins smaller than the default, keys whose positions
    all fall in one bin, one key repeated, words that already hold keys."""
    runs = 0
    for i, k in enumerate((1, 7, 11, 32)):
        for log2m in (5, 20):
            spec = V.FilterSpec("cbf", 1 << log2m, k)
            keys = gen_keys(65537, 1310 + i)
            base = cbf.add_plain(spec, V.init(spec, "cuda"),
                                 gen_keys(4096, 1320 + i))
            want = cbf.add_plain(spec, base, keys)
            for path, kw in (("one-pass", {}), ("binned", {}),
                             ("binned", {"cap": k * 9000}),
                             ("binned", {"bin_bits": 5 if log2m == 5
                                         else 9})):
                got = cbf.add_vmem(spec, base.clone(), keys, path=path, **kw)
                errs["add_vmem"] = max(errs["add_vmem"], max_err(got, want))
                if cbf.LAST_ADD_PLAN["path"] != path:
                    raise AssertionError(f"{spec}: ran {cbf.LAST_ADD_PLAN}")
                runs += 1
    spec = V.FilterSpec("cbf", 1 << 20, 3)
    cand = gen_keys(1 << 21, 1330)
    h1, h2 = H.hash_keys(cand)
    one_bin = cand[(V.cbf_positions(spec, h1, h2) < 1 << 19).all(dim=1)]
    for keys in (one_bin.contiguous(), cand[:1].expand(1 << 18, 2)
                 .contiguous()):
        want = cbf.add_plain(spec, V.init(spec, "cuda"), keys)
        for path in cbf.PATHS:
            got = cbf.add_vmem(spec, V.init(spec, "cuda"), keys, path=path)
            errs["add_vmem"] = max(errs["add_vmem"], max_err(got, want))
            runs += 1
    torch.cuda.synchronize()
    print(f"kernels: cbf add paths: {runs} forced runs (one-pass, binned; "
          f"m = 2^5 / 2^20, k = 1/7/11/32, 8 internal batches, small bins, "
          f"{one_bin.shape[0]} keys in one bin, one key 2^18 times) equal "
          f"to the plain version")
    phase_cbf_contains_paths(errs, one_bin)


def phase_cbf_contains_paths(errs: dict, one_bin: torch.Tensor):
    """Both contains paths forced against the plain version: m = 2^16,
    2^20, 2^30, 2^32 x k = 1/7/11/32 (members, keys never added and one
    key 300 times), each binned also over several internal batches (a
    lowered cap) and in bins of 2^(log2 m - 13) bits (8192 bins; 2^5 bits
    at m = 2^16); a filter
    smaller than a bin (m = 2^5), keys whose probes all fall in one bin,
    and n = 0 / 1 / 2."""
    runs = 0
    for i, k in enumerate((1, 7, 11, 32)):
        for log2m in (16, 20, 30, 32):
            spec = V.FilterSpec("cbf", 1 << log2m, k)
            n = 65537 if log2m < 30 else 1 << 20
            keys = gen_keys(n, 1340 + i)
            words = cbf.add_plain(spec, V.init(spec, "cuda"), keys)
            q = torch.cat([keys, gen_keys(n, 1350 + i, probe=True),
                           keys[:1].expand(300, 2)]).contiguous()
            want = cbf.contains_plain(spec, words, q)
            for path, kw in (("one-pass", {}), ("binned", {}),
                             ("binned", {"cap": k * 99999}),
                             ("binned", {"bin_bits": max(5, log2m - 13)})):
                got = cbf.contains_vmem(spec, words, q, path=path, **kw)
                errs["contains_vmem"] = max(errs["contains_vmem"],
                                            max_err(got, want))
                if cbf.LAST_CONTAINS_PLAN["path"] != path:
                    raise AssertionError(f"{spec}: ran "
                                         f"{cbf.LAST_CONTAINS_PLAN}")
                runs += 1
            del words, keys, q
    spec = V.FilterSpec("cbf", 1 << 20, 3)
    words = cbf.add_plain(spec, V.init(spec, "cuda"), one_bin[::2])
    tiny = V.FilterSpec("cbf", 1 << 5, 7)
    tiny_words = cbf.add_plain(tiny, V.init(tiny, "cuda"), one_bin[:3])
    for sp, w, q in ((spec, words, one_bin), (tiny, tiny_words, one_bin),
                     (tiny, tiny_words, one_bin[:0]),
                     (tiny, tiny_words, one_bin[:1]),
                     (tiny, tiny_words, one_bin[:2])):
        want = cbf.contains_plain(sp, w, q)
        for path in cbf.PATHS:
            got = cbf.contains_vmem(sp, w, q, path=path)
            errs["contains_vmem"] = max(errs["contains_vmem"],
                                        max_err(got, want))
            runs += 1
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"kernels: cbf contains paths: {runs} forced runs (one-pass, "
          f"binned; m = 2^16 / 2^20 / 2^30 / 2^32 x k = 1/7/11/32, several "
          f"internal batches, 8192 bins, m = 2^5, {one_bin.shape[0]} keys "
          f"in one bin, n = 0/1/2, one key 300 times) equal to the plain "
          f"version")


def ring_paths(spec: V.FilterSpec, rings: torch.Tensor, q: torch.Tensor,
               want: torch.Tensor, errs: dict) -> int:
    """Both ring wrappers on both paths forced against the plain results:
    one-pass at every Θ (and at every depth ``contains_hbm`` accepts);
    binned at the default bins, over several internal batches and in bins
    of one row and of 8 rows; the runs made."""
    runs = 0
    thetas_ = [t for t in (1, 2, 4, 8, 16, 32) if t <= spec.s]
    calls = [("ring_contains_vmem", {}), ("ring_contains_vmem",
                                          {"path": "binned"})]
    calls += [("ring_contains_hbm", {"depth": d, "path": "one-pass"})
              for d in sbf.DMA_DEPTHS]
    calls += [("ring_contains_vmem", {"path": "one-pass", "theta": t})
              for t in thetas_]
    calls += [("ring_contains_hbm", {"path": "binned", "bin_row_bits": b,
                                     "cap": c})
              for b, c in ((None, 1000), (0, 1 << 16), (3, 4097))
              if b is None or ring.binned_fits(spec.n_words, spec.s, b)]
    for name, kw in calls:
        got = getattr(ring, name)(spec, rings, q, **kw)
        errs[name] = max(errs[name], max_err(got, want))
        if q.shape[0] and kw.get("path") and (
                ring.LAST_CONTAINS_PLAN["path"] != kw["path"]):
            raise AssertionError(f"ring {name} {kw}: ran "
                                 f"{ring.LAST_CONTAINS_PLAN}")
        runs += 1
    return runs


def phase_ring_kernels(errs: dict):
    """Phase 3c, ring: each spec (s = 1 ... 32 words) at G = 1 ... 9,
    65536 / G keys a generation, the last generation's keys and 65537
    probes; every path of :func:`ring_paths` at n = 65537 + the live keys,
    0, 1, 255 and 257 against ``ring_contains_ref``; the FPR at G = 2, 4
    and 8."""
    for i, spec in enumerate(PHASE3C_RING_SPECS):
        total = 0
        for G in range(1, 10):
            per_gen = 65536 // G
            rings = torch.stack([
                sbf.add_plain(spec, V.init(spec, "cuda"),
                              gen_keys(per_gen, 1400 + 10 * i + g))
                for g in range(G)])
            live = gen_keys(per_gen, 1400 + 10 * i + G - 1)
            queries = torch.cat([live, gen_keys(65537, 1500 + i, probe=True)])
            want = ring.ring_contains_ref(spec, rings, queries)
            if not bool(want[:per_gen].all()):
                raise AssertionError(f"{spec} G={G}: false negatives")
            for m in (queries.shape[0], 0, 1, 255, 257):
                total += ring_paths(spec, rings, queries[:m], want[:m], errs)
            if G not in (2, 4, 8):
                continue
            # the union of G generations holds all 65536 keys
            fpr = float(ring.ring_contains_vmem(
                spec, rings, gen_keys(1 << 20, 1600 + i, probe=True)
            ).to(torch.float64).mean().item())
            theory = V.fpr_theory(spec, per_gen * G)
            if not 0.5 * theory <= fpr <= 2.0 * theory:
                raise AssertionError(f"{spec} G={G}: FPR {fpr} outside "
                                     f"0.5-2.0 x theory {theory}")
        torch.cuda.synchronize()
        print(f"kernels: rings of G = 1 ... 9 x {spec}: {total} ring kernel "
              f"runs equal to the plain version (one-pass at every Θ; "
              f"binned at the default bins, in "
              f"several internal batches and in bins of 1 and 8 rows; n = "
              f"0/1/255/257/65537 + the live keys); FPR within 0.5-2.0 x "
              f"theory at G = 2/4/8 on 2^20 probes")


def cbf_probes_needed(spec: V.FilterSpec, words: torch.Tensor,
                      keys: torch.Tensor) -> int:
    """Probes a contains must make: every probe of a member key, and for
    any other key the probes up to and including its first miss."""
    total = 0
    for chunk in keys.split(SUBSET):
        h1, h2 = H.hash_keys(chunk)
        pos = V.cbf_positions(spec, h1, h2)
        hit = (H.u32(words[pos >> 5]) >> (pos & 31)) & 1 == 1
        miss = ~hit
        first = torch.where(miss.any(dim=1), miss.to(torch.int8).argmax(dim=1)
                            + 1, spec.k)
        total += int(first.sum().item())
    return total


def cbf_bound_ms(spec: V.FilterSpec, n: int, op: str, probes: int):
    """Least time: max(bytes / memory rate, ops / peak rate). Bytes: 8 per
    key, 1 per result (contains), and one 32-byte sector per probe needed
    (``probes``; k a key for add), capped by the filter, read (contains) or
    read and written (add). Ops: 40 per key for the hash, 6 per probe."""
    sectors = min(spec.m_bits // 8, 32 * probes)
    nbytes = 8 * n + (n + sectors if op == "contains" else 2 * sectors)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (40 * n + 6 * probes) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cbf_binned_floor_ms(spec: V.FilterSpec, n: int, plan: dict) -> float:
    """The binned add's own floor: each batch reads its keys twice (count,
    scatter), writes and reads 4 B a position, and reads and writes every
    touched bin once (all of them at these sizes), at the DRAM rate."""
    filt = min(spec.m_bits // 8, 2 ** plan["bin_bits"] // 8 * n * spec.k)
    nbytes = 16 * n + 8 * n * spec.k + 2 * filt * plan["batches"]
    return nbytes / HBM_BYTES_PER_S * 1e3


def cbf_binned_contains_floor_ms(spec: V.FilterSpec, n: int,
                                 plan: dict) -> float:
    """The binned contains' own floor: each batch reads its keys twice
    (count, scatter), writes and reads 8 B a probe (its offset and its
    key), and reads every touched bin once (all of them at these sizes);
    the results are written once, at the DRAM rate. There is no early
    exit: every probe is binned."""
    filt = min(spec.m_bits // 8, 2 ** plan["bin_bits"] // 8 * n * spec.k)
    nbytes = 16 * n + 16 * n * spec.k + filt * plan["batches"] + n
    return nbytes / HBM_BYTES_PER_S * 1e3


CBF_RULE_LOG2M = (23, 25, 27, 28, 29, 30, 31, 32)
CBF_RULE_LOG2N = tuple(range(14, 29, 2))


def phase_cbf_rule(card: str):
    """The add's path rule against both paths timed in turns: k = 11,
    filters of 2^23 ... 2^32 bits, 2^14 ... 2^28 keys. Fails where the
    rule's path is slower than the other beyond the rounds' spread (and by
    more than 5 % and 5 us)."""
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    keys = gen_keys(1 << max(CBF_RULE_LOG2N), 31)
    rows, wrong = [], []
    for log2m in CBF_RULE_LOG2M:
        spec = V.FilterSpec("cbf", 1 << log2m, 11)
        words = V.init(spec, "cuda")
        for log2n in CBF_RULE_LOG2N:
            sub = keys[: 1 << log2n]
            fns = {p: (lambda p=p: cbf.add_vmem(spec, words, sub, path=p))
                   for p in cbf.PATHS}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fns["one-pass"]()
            start.record()
            fns["one-pass"]()
            end.record()
            torch.cuda.synchronize()
            reps = max(1, min(REPS, int(20 / max(start.elapsed_time(end),
                                                 1e-3))))
            label = f"cbf rule 2^{log2m} 2^{log2n}"
            t = time_turns(fns, label, reps, 3)
            chosen = cbf.choose_path(1 << log2n, 1 << log2m, 11, smem)
            other = "binned" if chosen == "one-pass" else "one-pass"
            hi_other = SPREAD[f"{label} {other}"][1]
            if (t[chosen] > hi_other and t[chosen] > 1.05 * t[other]
                    and t[chosen] - t[other] > 0.005):
                wrong.append((log2m, log2n, t[chosen], t[other]))
            rows.append(f"2^{log2m}/2^{log2n} {t['one-pass']:.4f}/"
                        f"{t['binned']:.4f}{'*' if chosen == 'binned' else ''}")
        del words
    del keys
    torch.cuda.empty_cache()
    print(f"cbf add rule sweep [{card}] (m / n: one-pass / binned ms, "
          f"median of 3 rounds in turns; * the rule picks binned): "
          + ", ".join(rows))
    if wrong:
        raise AssertionError(f"cbf add rule picks the slower path at "
                             f"(log2 m, log2 n, chosen ms, other ms) {wrong}")
    print(f"cbf add rule: at each of {len(rows)} sizes the rule's path is "
          f"the faster one within the rounds' spread")
    phase_cbf_contains_rule(card, smem)


CBF_MEMBER_SHARES = (0.0, 0.5, 1.0)


def cbf_mixed(keys: torch.Tensor, probes: torch.Tensor, added: int, n: int,
              share: float) -> torch.Tensor:
    """n keys: the first ``share`` of them taken from the ``added`` keys of
    the filter (repeated where there are fewer), the rest keys never
    added."""
    members = int(n * share)
    pool = keys[:added]
    return torch.cat([pool.repeat(-(-members // added), 1)[:members],
                      probes[: n - members]])


def phase_cbf_contains_rule(card: str, smem: int):
    """The contains' path rule against both paths timed in turns: k = 11,
    filters of 2^23 ... 2^32 bits filled with m / 16 keys (their design
    load), batches of 2^14 ... 2^28 keys of which a share of 0, 1/2 or 1
    are members (the main path sends shares 1 and 0: the cell's keys and
    the probes). The rule cannot see the share and picks binned only where
    it is no slower at any share. Fails where it picks binned and binned is
    slower at some share, or picks one-pass and binned is faster at every
    share; slower: beyond the rounds' spread and by more than 5 % and 5
    us."""
    keys = gen_keys(1 << max(CBF_RULE_LOG2N), 31)
    probes = gen_keys(1 << max(CBF_RULE_LOG2N), 33, probe=True)
    rows, wrong = [], []
    for log2m in CBF_RULE_LOG2M:
        spec = V.FilterSpec("cbf", 1 << log2m, 11)
        words = cbf.add_vmem(spec, V.init(spec, "cuda"),
                             keys[: 1 << (log2m - 4)])
        for log2n in CBF_RULE_LOG2N:
            n = 1 << log2n
            qs = {s: cbf_mixed(keys, probes, 1 << (log2m - 4), n, s)
                  for s in CBF_MEMBER_SHARES}
            fns = {(p, s): (lambda p=p, s=s: cbf.contains_vmem(
                spec, words, qs[s], path=p))
                for s in CBF_MEMBER_SHARES for p in cbf.PATHS}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fns["one-pass", 1.0]()
            start.record()
            fns["one-pass", 1.0]()
            end.record()
            torch.cuda.synchronize()
            reps = max(1, min(REPS, int(20 / max(start.elapsed_time(end),
                                                 1e-3))))
            label = f"cbf contains rule 2^{log2m} 2^{log2n}"
            t = time_turns({f"{p} s={s}": fn for (p, s), fn in fns.items()},
                           label, reps, 3)
            chosen = cbf.choose_contains_path(n, 1 << log2m, 11, smem)

            def slower(p, s):
                q = "binned" if p == "one-pass" else "one-pass"
                mine, theirs = t[f"{p} s={s}"], t[f"{q} s={s}"]
                return (mine > SPREAD[f"{label} {q} s={s}"][1]
                        and mine > 1.05 * theirs and mine - theirs > 0.005)

            lost = [s for s in CBF_MEMBER_SHARES if slower(chosen, s)]
            if (lost if chosen == "binned"
                    else len(lost) == len(CBF_MEMBER_SHARES)):
                wrong.append((log2m, log2n, chosen, lost))
            rows.append(f"2^{log2m}/2^{log2n} " + " ".join(
                f"{t[f'one-pass s={s}']:.4f}/{t[f'binned s={s}']:.4f}"
                for s in CBF_MEMBER_SHARES)
                + ("*" if chosen == "binned" else ""))
            del qs
        del words
    del keys, probes
    torch.cuda.empty_cache()
    print(f"cbf contains rule sweep [{card}] (m / n: one-pass / binned ms at "
          f"member shares {' '.join(map(str, CBF_MEMBER_SHARES))}, median of "
          f"3 rounds in turns, a filter at its design load; * the rule picks "
          f"binned): " + ", ".join(rows))
    if wrong:
        raise AssertionError(f"cbf contains rule: binned slower at some "
                             f"share, or one-pass slower at every share, at "
                             f"(log2 m, log2 n, chosen, shares where the "
                             f"chosen path is slower) {wrong}")
    print(f"cbf contains rule: at each of {len(rows)} sizes binned where it "
          f"is no slower at any of the member shares "
          f"{' '.join(map(str, CBF_MEMBER_SHARES))}, one-pass where it is "
          f"faster at one of them, within the rounds' spread")


def ring_bound_ms(spec: V.FilterSpec, generations: int, n: int):
    """Least time of a ring contains: 8 B per key and 1 per result, and the
    key's block row in each generation, at least one 32-byte sector (for
    B = 256 the row is one sector, so the early exit saves no bytes),
    capped by the ring; ops as a blocked contains plus one OR per word and
    generation."""
    row = max(spec.block_bits // 8, 32)
    ring_bytes = min(generations * spec.m_bits // 8, generations * row * n)
    t_bytes = (9 * n + ring_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n * (ops_per_key(spec, "contains") + generations * spec.s
                 ) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ring_floors_ms(spec: V.FilterSpec, generations: int, n: int,
                   plan: dict) -> tuple:
    """(sector floor, binned floor) of a ring contains of n keys at the DRAM
    rate. Sector: 8 B a key, 1 a result and one 32-byte sector a
    generation (G random row reads, what one pass must move). Binned (with
    ``plan``'s batches): the keys read twice, a 16-byte slot written and
    read, the ring read once a batch, the results written once."""
    sector = n * (9 + SECTOR * generations)
    binned = (n * (16 + 2 * ring.SLOT_BYTES + 1)
              + max(1, plan["batches"]) * 4 * generations * spec.n_words)
    return (sector / HBM_BYTES_PER_S * 1e3, binned / HBM_BYTES_PER_S * 1e3)


RING_RULE_BYTES = (1 << 25, 1 << 27, 1 << 29)    # 32 MiB (L2) ... 512 MiB
RING_RULE_GENS = (2, 4, 8)
RING_RULE_LOG2N = (16, 18, 20, 22, 24, 26)
RING_MEMBER_SHARES = (0.0, 0.5, 1.0)


def phase_ring_rule(card: str):
    """The ring contains' path rule against both paths timed in turns:
    rings of 32 MiB (L2), 128 MiB and 512 MiB of G = 2, 4 and 8 sbf
    generations (B = 256, k = 8) each filled to 16 bits a key, batches of
    2^16 ... 2^26 keys of which a share of 0, 1/2 or 1 are members, drawn
    from every generation alike (one-pass: the early stop, which members
    make cheaper; binned reads every bin a batch touches). The rule cannot
    see the share: fails where it picks binned and binned is slower at some
    share, or picks one-pass and binned is faster at every share; slower:
    beyond the rounds' spread and by more than 5 % and 5 us."""
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    probes = gen_keys(1 << max(RING_RULE_LOG2N), 35, probe=True)
    rows, wrong = [], []
    for nbytes in RING_RULE_BYTES:
        for G in RING_RULE_GENS:
            spec = V.FilterSpec("sbf", 8 * nbytes // G, 8, block_bits=256)
            per_gen = spec.m_bits // 16
            rings = torch.zeros((G, spec.n_words), dtype=torch.int32,
                                device="cuda")
            for g in range(G):
                for part in range(0, per_gen, SUBSET):
                    sbf.add_hbm(spec, rings[g], gen_keys(
                        min(SUBSET, per_gen - part), 3000 + 97 * g + part))
            members = torch.cat([gen_keys(min(per_gen, SUBSET) // G,
                                          3000 + 97 * g) for g in range(G)])
            l2 = ops.fits_l2(spec, G)
            for log2n in RING_RULE_LOG2N:
                n = 1 << log2n
                chosen = ring.choose_contains_path(n, spec.n_words, G,
                                                   spec.s, smem, l2)
                t, slower = {}, {}
                other = "binned" if chosen == "one-pass" else "one-pass"
                for share in RING_MEMBER_SHARES:
                    q = cbf_mixed(members, probes, members.shape[0], n,
                                  share)
                    fns = {p: (lambda p=p, q=q: ring.ring_contains_hbm(
                        spec, rings, q, path=p)) for p in ring.PATHS}
                    label = f"ring rule {nbytes} {G} 2^{log2n} {share}"
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    fns["one-pass"]()
                    start.record()
                    fns["one-pass"]()
                    end.record()
                    torch.cuda.synchronize()
                    reps = max(1, min(REPS, int(
                        10 / max(start.elapsed_time(end), 1e-3))))
                    t[share] = time_turns(fns, label, reps, 3)
                    hi_other = SPREAD[f"{label} {other}"][1]
                    tc, to = t[share][chosen], t[share][other]
                    slower[share] = (tc > hi_other and tc > 1.05 * to
                                     and tc - to > 0.005)
                # binned only where it is no slower at any share; one-pass
                # unless binned is faster at all of them
                if (any(slower.values()) if chosen == "binned"
                        else all(slower.values())):
                    wrong.append((nbytes >> 20, G, log2n, chosen,
                                  [s_ for s_, v in slower.items() if v]))
                rows.append(f"{nbytes >> 20}M/G{G}/2^{log2n} " + " ".join(
                    f"{t[x]['one-pass']:.4f}/{t[x]['binned']:.4f}"
                    for x in RING_MEMBER_SHARES)
                    + ("*" if chosen == "binned" else ""))
            del rings, members
            torch.cuda.empty_cache()
    del probes
    print(f"ring contains rule sweep [{card}] (ring MiB / G / keys: "
          f"one-pass / binned ms at member shares "
          f"{' '.join(map(str, RING_MEMBER_SHARES))}, median of 3 rounds in "
          f"turns; * the rule picks binned): " + ", ".join(rows))
    if wrong:
        raise AssertionError(f"ring contains rule picks the slower path at "
                             f"(MiB, G, log2 n, chosen, the shares where it "
                             f"is slower) {wrong}")
    print(f"ring contains rule: at each of {len(rows)} sizes binned where it "
          f"is no slower at any of the member shares "
          f"{' '.join(map(str, RING_MEMBER_SHARES))}, one-pass where binned "
          f"is not faster at all three, within the rounds' spread")


def phase_cbf_main(regime: str, n: int, errs: dict, records: dict,
                   launches: dict, card: str):
    engine = "cuda-l2" if regime == "L2" else "cuda-dram"
    f = api.filter_for_n_items(n, bits_per_key=16, variant="cbf",
                               device="cuda")
    spec = f.spec
    if f.backend != engine or spec.k != 11:
        raise AssertionError(f"cbf {regime}: {spec} on {f.backend}, not "
                             f"{engine} with k = 11")
    keys = gen_keys(n, 21)
    probes = gen_keys(SUBSET, 22, probe=True)
    torch.cuda.synchronize()

    cbf.reset_launches()                   # the main path, counted
    t0 = time.perf_counter()
    g = f.add(keys)
    plan = dict(cbf.LAST_ADD_PLAN)
    hits = g.contains(keys)
    cplan = dict(cbf.LAST_CONTAINS_PLAN)
    false_pos = g.contains(probes)
    pplan = dict(cbf.LAST_CONTAINS_PLAN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(cbf.LAUNCHES)
    smem = sbf.partition_smem_bytes(keys.device)
    if plan["path"] != cbf.choose_path(n, spec.m_bits, spec.k, smem):
        raise AssertionError(f"cbf {regime}: the add ran {plan}, not the "
                             f"rule's path")
    for m, p in ((n, cplan), (SUBSET, pplan)):
        if p["path"] != cbf.choose_contains_path(m, spec.m_bits, spec.k,
                                                 smem):
            raise AssertionError(f"cbf {regime}: a contains of {m} keys "
                                 f"ran {p}, not the rule's path")
    for name in ("add_vmem", "contains_vmem"):
        if counted[name] == 0:
            raise AssertionError(f"cbf {name} was not launched on the main "
                                 f"path")
        launches[name] = launches.get(name, 0) + counted[name]
    if not bool(hits.all()):
        raise AssertionError(f"cbf {regime}: {int((~hits).sum())} false "
                             f"negatives")
    want_words = update_in_chunks(functools.partial(cbf.add_plain, spec),
                                  V.init(spec, "cuda"), keys)
    errs["add_vmem"] = max(errs["add_vmem"], max_err(g.words, want_words))
    plain_contains = functools.partial(cbf.contains_plain, spec)
    errs["contains_vmem"] = max(errs["contains_vmem"], max_err(
        hits, contains_in_chunks(plain_contains, want_words, keys)))
    errs["contains_vmem"] = max(errs["contains_vmem"], max_err(
        false_pos, plain_contains(want_words, probes)))
    del want_words
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = g.fpr_theory(n)
    print(f"main cbf {regime}: {spec} on {g.backend}, {n} keys, "
          f"{g.nbytes / 2**20:.0f} MiB filter: add+contains+probe "
          f"{wall * 1e3:.1f} ms host clock, no false negatives, words, hits "
          f"and probe results equal to the plain version's in full, FPR "
          f"{fpr:.6f}, {fpr / theory:.3f} x theory {theory:.6f}, launches "
          f"{counted}; the add's plan (cbf.LAST_ADD_PLAN) {plan}; the "
          f"contains' plans (cbf.LAST_CONTAINS_PLAN): keys (member share "
          f"1) {cplan}, probes (member share 0) {pplan}")

    sub = keys[:SUBSET]
    sub_words = cbf.add_plain(spec, V.init(spec, "cuda"), sub)
    queries = torch.cat([sub[: SUBSET // 2], probes[: SUBSET // 2]])
    words = g.words.clone()
    scratch = sub_words.clone()
    torch.cuda.synchronize()
    reps, rounds = ((REPS, ROUNDS) if regime == "L2"
                    else (DRAM_CBF_REPS, DRAM_CBF_ROUNDS))
    t = {}
    for label, fn, r, rd in (
            ("add", lambda: cbf.add_vmem(spec, words, keys), reps, rounds),
            ("contains", lambda: cbf.contains_vmem(spec, g.words, keys),
             reps, rounds),
            ("Filter.add", lambda: f.add(keys), reps, rounds),
            ("Filter.contains", lambda: g.contains(keys), reps, rounds),
            ("add sub", lambda: cbf.add_vmem(spec, scratch, sub), REPS,
             ROUNDS),
            ("contains sub", lambda: cbf.contains_vmem(spec, sub_words,
                                                       queries), REPS, ROUNDS),
            ("add plain", lambda: cbf.add_plain(spec, sub_words, sub),
             PLAIN_REPS, PLAIN_ROUNDS),
            ("contains plain", lambda: cbf.contains_plain(spec, sub_words,
                                                          queries),
             PLAIN_REPS, PLAIN_ROUNDS)):
        t[label] = time_ms(fn, f"cbf {regime} {label}", r, rd)
    # both add paths in turns at the cell's size, and an add's peak extra
    # device memory (the binned path's workspace; none for one-pass)
    paths = time_turns({p: (lambda p=p: cbf.add_vmem(spec, words, keys,
                                                      path=p))
                        for p in cbf.PATHS}, f"cbf {regime} add path",
                       reps, rounds)
    peak = {}
    for p in cbf.PATHS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        cbf.add_vmem(spec, words, keys, path=p)
        torch.cuda.synchronize()
        peak[p] = (torch.cuda.max_memory_allocated() - before,
                   cbf.LAST_ADD_PLAN["workspace_bytes"])
        if peak[p][0] > peak[p][1] + 512:     # the allocator's rounding
            raise AssertionError(f"cbf {regime} {p} add: peak extra memory "
                                 f"{peak[p][0]} B above its workspace "
                                 f"{peak[p][1]} B")
    # both contains paths in turns on the cell's keys, and a contains' peak
    # extra device memory: its workspace, beside the (n,) result
    cpaths = time_turns({p: (lambda p=p: cbf.contains_vmem(
        spec, g.words, keys, path=p)) for p in cbf.PATHS},
        f"cbf {regime} contains path", reps, rounds)
    cpeak = {}
    out_bytes = -(-n // 512) * 512
    for p in cbf.PATHS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = cbf.contains_vmem(spec, g.words, keys, path=p)
        torch.cuda.synchronize()
        cpeak[p] = (torch.cuda.max_memory_allocated() - before - out_bytes,
                    cbf.LAST_CONTAINS_PLAN["workspace_bytes"])
        errs["contains_vmem"] = max(errs["contains_vmem"], max_err(got,
                                                                   hits))
        del got
        if cpeak[p][0] > cpeak[p][1] + 512:
            raise AssertionError(f"cbf {regime} {p} contains: peak extra "
                                 f"memory {cpeak[p][0]} B beside the result "
                                 f"above its workspace {cpeak[p][1]} B")
    cap_bytes = 4 * cbf.POSITION_CAP
    floor_ms = cbf_binned_floor_ms(spec, n, plan if plan["path"] == "binned"
                                   else cbf.add_plan(n, spec.m_bits, spec.k,
                                                     "binned"))
    spread = {p: SPREAD[f"cbf {regime} add path {p}"] for p in cbf.PATHS}
    print(f"time cbf {regime} add paths [{card}] ({n} keys, in turns): "
          + ", ".join(f"{p} {paths[p]:.4f} ms (rounds {spread[p][0]:.4f}-"
                      f"{spread[p][1]:.4f})" for p in cbf.PATHS)
          + f"; one-pass / binned {paths['one-pass'] / paths['binned']:.2f}x"
          f"; the rule ran {plan['path']}; binned floor (keys read twice, "
          f"8 B a position, each touched bin read and written once a batch) "
          f"{floor_ms:.4f} ms; peak extra memory of an add: "
          + ", ".join(f"{p} {b} B (workspace {w} B)"
                      for p, (b, w) in peak.items())
          + f"; the workspace: the cap's {cap_bytes} B of positions, "
          f"the counts and at most 7 slots of padding a chunk a bin")
    cfloor_ms = cbf_binned_contains_floor_ms(
        spec, n, cplan if cplan["path"] == "binned"
        else cbf.contains_plan(n, spec.m_bits, spec.k, "binned"))
    cspread = {p: SPREAD[f"cbf {regime} contains path {p}"]
               for p in cbf.PATHS}
    print(f"time cbf {regime} contains paths [{card}] ({n} keys, in turns): "
          + ", ".join(f"{p} {cpaths[p]:.4f} ms (rounds {cspread[p][0]:.4f}-"
                      f"{cspread[p][1]:.4f})" for p in cbf.PATHS)
          + f"; one-pass / binned "
          f"{cpaths['one-pass'] / cpaths['binned']:.2f}x; the rule ran "
          f"{cplan['path']}; binned floor (keys read twice, 8 B a probe "
          f"written and read, each touched bin read once a batch, results "
          f"once) {cfloor_ms:.4f} ms; peak extra memory of a contains beside "
          f"its {n} B result: " + ", ".join(
              f"{p} {b} B (workspace {w} B)" for p, (b, w) in cpeak.items()))
    probes_full = cbf_probes_needed(spec, g.words, keys)
    probes_sub = cbf_probes_needed(spec, sub_words, queries)
    for name, op in (("add_vmem", "add"), ("contains_vmem", "contains")):
        full_probes = n * spec.k if op == "add" else probes_full
        sub_probes = SUBSET * spec.k if op == "add" else probes_sub
        b_full, by_full = cbf_bound_ms(spec, n, op, full_probes)
        b_sub, by_sub = cbf_bound_ms(spec, SUBSET, op, sub_probes)
        lo, hi = SPREAD[f"cbf {regime} {op}"]
        print(f"time cbf {regime} {op} [{card}]: kernel {t[op]:.4f} ms "
              f"(rounds {lo:.4f}-{hi:.4f}; {n / t[op] / 1e3:.1f} Mops/s) at "
              f"{n} keys ({full_probes} probes), bound {b_full:.4f} ms "
              f"({by_full}), {b_full / t[op]:.1%} of it; Filter.{op} "
              f"{t[f'Filter.{op}']:.4f} ms; at {SUBSET} keys kernel "
              f"{t[f'{op} sub']:.4f} ms, plain {t[f'{op} plain']:.4f} ms, "
              f"bound {b_sub:.4f} ms ({by_sub})")
        cell = {"ms": t[f"{op} sub"], "plain_ms": t[f"{op} plain"],
                "bound_ms": b_sub, "bound_by": by_sub, "m_bits": spec.m_bits,
                "main_n_keys": n, "main_ms": t[op], "main_bound_ms": b_full,
                "api_ms": t[f"Filter.{op}"]}
        if op == "add":
            cell.update(path=plan["path"], plan=plan,
                        one_pass_ms=paths["one-pass"],
                        binned_ms=paths["binned"], binned_floor_ms=floor_ms,
                        peak_extra_bytes=peak[plan["path"]][0])
        else:
            cell.update(path=cplan["path"], plan=cplan,
                        probes_plan=pplan, one_pass_ms=cpaths["one-pass"],
                        binned_ms=cpaths["binned"],
                        binned_floor_ms=cfloor_ms,
                        peak_extra_bytes=cpeak[cplan["path"]][0])
        if regime == "L2":
            records[name] = {
                "name": f"cbf_{name}", "route": "cuda", "source": CBF_SOURCE,
                "replaces": CBF_REPLACES[name], "launches": 0,
                "max_abs_err": 0, "library_ms": None, "n_keys": SUBSET,
                "cuda_kernels": CBF_KERNELS[name], **cell}
        else:
            records[name].update({f"dram_{k}": v for k, v in cell.items()})
    del f, g, keys, words, scratch, sub_words
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def phase_windowed_main(regime: str, window: int, errs: dict, records: dict,
                        launches: dict, card: str):
    add_name = "add_vmem" if regime == "L2" else "add_hbm"
    con_name = ("ring_contains_vmem" if regime == "L2"
                else "ring_contains_hbm")
    G = 4
    f = api.filter_for_n_items(window, bits_per_key=16, block_bits=256,
                               generations=G, device="cuda")
    spec = f.spec
    if f.backend != "windowed" or f.words.shape != (G, spec.n_words):
        raise AssertionError(f"windowed {regime}: {f}")
    if (ops.fits_l2(spec, G) != (regime == "L2")
            or ops.fits_l2(spec) != (regime == "L2")):
        raise AssertionError(f"windowed {regime}: {spec} x {G} in the "
                             f"wrong regime")
    batch = window // G
    batches = [gen_keys(batch, 31 + i) for i in range(G + 1)]
    fresh = gen_keys(window, 40, probe=True)
    torch.cuda.synchronize()

    sbf.reset_launches()                   # the main path, counted
    ring.reset_launches()
    t0 = time.perf_counter()
    states = []
    w = f
    for i, b in enumerate(batches):
        w = w.add(b)
        states.append((w.words, w.head))
        if i < G:
            w = w.advance()
            states.append((w.words, w.head))
    live = torch.cat(batches[1:])
    plans = {}
    hits = w.contains(live)
    plans["live"] = dict(ring.LAST_CONTAINS_PLAN)
    retired = w.contains(batches[0])
    plans["retired"] = dict(ring.LAST_CONTAINS_PLAN)
    false_pos = w.contains(fresh)
    plans["fresh"] = dict(ring.LAST_CONTAINS_PLAN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {**sbf.LAUNCHES, **ring.LAUNCHES}
    smem = sbf.partition_smem_bytes(live.device)
    for label, q in (("live", live), ("retired", batches[0]),
                     ("fresh", fresh)):
        rule = ring.choose_contains_path(q.shape[0], spec.n_words, G, spec.s,
                                         smem, ops.fits_l2(spec, G))
        if plans[label]["path"] != rule:
            raise AssertionError(f"windowed {regime}: the {label} contains "
                                 f"ran {plans[label]}, not the rule's {rule}")
    for name in (add_name, con_name):
        if counted[name] == 0:
            raise AssertionError(f"{name} was not launched on the windowed "
                                 f"main path")
    launches[con_name] = counted[con_name]
    launches[f"windowed {add_name}"] = counted[add_name]
    if not bool(hits.all()):
        raise AssertionError(f"windowed {regime}: {int((~hits).sum())} "
                             f"false negatives among live keys")
    # every step's ring and head, and every result, against the plain path
    plain = torch.zeros_like(f.words)
    head, step = 0, 0
    for i, b in enumerate(batches):
        plain[head] = update_in_chunks(functools.partial(sbf.add_plain, spec),
                                       plain[head], b)
        words, h = states[step]
        max_err(words, plain)                  # add: exact or raise
        step += 1
        if h != head:
            raise AssertionError(f"windowed {regime}: head {h}, not {head}")
        if i < G:
            head = (head + 1) % G
            plain[head] = 0
            words, h = states[step]
            max_err(words, plain)              # advance: exact or raise
            step += 1
            if h != head:
                raise AssertionError(f"windowed {regime}: head {h} after "
                                     f"advance, not {head}")
    del states
    plain_contains = functools.partial(ring.ring_contains_ref, spec)
    for got, q in ((hits, live), (retired, batches[0]), (false_pos, fresh)):
        errs[con_name] = max(errs[con_name], max_err(
            got, contains_in_chunks(plain_contains, plain, q)))
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = w.fpr_theory(window)
    print(f"main windowed {regime}: {G} x {spec} on {w.backend}, window "
          f"{window} keys in batches of {batch}, {w.nbytes / 2**20:.0f} MiB "
          f"ring: 5 adds, 4 advances and 3 contains in {wall * 1e3:.1f} ms "
          f"host clock; no false negatives among {live.shape[0]} live keys, "
          f"{float(retired.to(torch.float64).mean().item()):.4f} of the "
          f"retired batch still hit; ring and head after every step and "
          f"every result equal to the plain path's in full; FPR {fpr:.6f}, "
          f"{fpr / theory:.3f} x theory {theory:.6f}; launches "
          f"{add_name} {counted[add_name]}, {con_name} {counted[con_name]}; "
          f"contains plans (ring.LAST_CONTAINS_PLAN, the rule's): "
          + "; ".join(f"{k} {v}" for k, v in plans.items()))

    # times: the main path at full size, and kernel vs plain on 2^22 keys
    n_sub = min(SUBSET, window)
    queries = torch.cat([live[: n_sub // 2], fresh[: n_sub - n_sub // 2]])
    run_con = getattr(ring, con_name)
    t = {
        "contains": time_ms(lambda: run_con(spec, w.words, live),
                            f"windowed {regime} contains"),
        "contains sub": time_ms(lambda: run_con(spec, w.words, queries),
                                f"windowed {regime} contains sub"),
        "contains plain": time_ms(lambda: ring.ring_contains_ref(
            spec, w.words, queries), f"windowed {regime} contains plain",
            PLAIN_REPS, PLAIN_ROUNDS),
        "Filter.add": time_ms(lambda: w.add(batches[0]),
                              f"windowed {regime} Filter.add"),
        "Filter.contains": time_ms(lambda: w.contains(live),
                                   f"windowed {regime} Filter.contains"),
        "Filter.advance": time_ms(w.advance,
                                  f"windowed {regime} Filter.advance"),
    }
    b_full, by_full = ring_bound_ms(spec, G, live.shape[0])
    b_sub, by_sub = ring_bound_ms(spec, G, n_sub)
    lo, hi = SPREAD[f"windowed {regime} contains"]
    print(f"time windowed {regime} {con_name} [{card}]: kernel "
          f"{t['contains']:.4f} ms (rounds {lo:.4f}-{hi:.4f}; "
          f"{live.shape[0] / t['contains'] / 1e3:.1f} Mops/s) at "
          f"{live.shape[0]} keys, bound {b_full:.4f} ms ({by_full}), "
          f"{b_full / t['contains']:.1%} of it; Filter.contains "
          f"{t['Filter.contains']:.4f} ms; at {n_sub} keys kernel "
          f"{t['contains sub']:.4f} ms, plain {t['contains plain']:.4f} ms, "
          f"bound {b_sub:.4f} ms ({by_sub}); Filter.add of {batch} keys "
          f"{t['Filter.add']:.4f} ms ({add_name} on the head generation, "
          f"after a clone of the ring); Filter.advance "
          f"{t['Filter.advance']:.4f} ms")
    # both paths in turns on the cell's three contains, and Θ = 1
    card_theta = ring.contains_geometry(spec).theta
    reps, rounds = (REPS, ROUNDS) if regime == "L2" else (5, 3)
    turns = {}
    for label, q in (("live", live), ("retired", batches[0]),
                     ("fresh", fresh)):
        fns = {"one-pass": lambda q=q: ring.ring_contains_hbm(
                   spec, w.words, q, path="one-pass"),
               "binned": lambda q=q: ring.ring_contains_hbm(
                   spec, w.words, q, path="binned"),
               "theta=1": lambda q=q: ring.ring_contains_hbm(
                   spec, w.words, q, path="one-pass", theta=1)}
        turns[label] = time_turns(fns, f"windowed {regime} {label} paths",
                                  reps, rounds)
        turns[label]["rule"] = plans[label]["path"]
    wrong = [(label, t["rule"], t[t["rule"]], other, t[other])
             for label, t in turns.items() for other in ring.PATHS
             if other != t["rule"] and t[t["rule"]] > SPREAD[
                 f"windowed {regime} {label} paths {other}"][1]
             and t[t["rule"]] > 1.05 * t[other]
             and t[t["rule"]] - t[other] > 0.005]
    print(f"time windowed {regime} contains paths in turns [{card}] (ms; "
          f"one-pass at Θ = {card_theta}): " + "; ".join(
              f"{label} ({q.shape[0]} keys, rule {t['rule']}): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in t.items() if k != "rule")
              for (label, t), q in zip(turns.items(),
                                       (live, batches[0], fresh))))
    if wrong:
        raise AssertionError(f"windowed {regime}: the rule's path is the "
                             f"slower at (keys, rule, ms, other, ms) {wrong}")
    sweep = {}
    # where a ring contains' time goes: against the union as a ring of one
    # generation and as a blocked filter (one row a key)
    dense = ring.ring_dense(w.words)
    union = dense[None].contiguous()
    blocked = (functools.partial(sbf.contains_vmem, spec, dense, live)
               if regime == "L2" else
               functools.partial(sbf.contains_hbm, spec, dense, live))
    sweep["one-generation ring of the union"] = time_ms(
        lambda: ring.ring_contains_hbm(spec, union, live, path="one-pass"),
        f"windowed {regime} G=1", 5, 3)
    sweep["blocked contains of the union"] = time_ms(
        blocked, f"windowed {regime} blocked", 5, 3)
    print(f"time windowed {regime} one-pass against the union [{card}] at "
          f"{live.shape[0]} keys: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in sweep.items()
              if k.endswith("union")))
    if regime == "DRAM":
        caps = time_turns({f"cap=2^{c}": (
            lambda c=c: ring.ring_contains_hbm(spec, w.words, live,
                                               path="binned", cap=1 << c))
            for c in (23, 24, 25, 26)}, "windowed DRAM caps", 5, 3)
        print(f"time windowed DRAM binned contains of {live.shape[0]} live "
              f"keys by keys a batch, in turns [{card}] (ms; the default "
              f"2^{ring.CONTAINS_KEY_CAP.bit_length() - 1}): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in caps.items()))
        sweep.update(caps)
    # peak extra memory of a binned contains of the live keys, and floors
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ring.ring_contains_hbm(spec, w.words, live, path="binned")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    bplan = dict(ring.LAST_CONTAINS_PLAN)
    floors = {label: ring_floors_ms(spec, G, q.shape[0], bplan)
              for label, q in (("live", live), ("retired", batches[0]),
                               ("fresh", fresh))}
    print(f"windowed {regime} floors (ms; sector: keys, results and G "
          f"32-byte sectors a key; binned: keys twice, 16-byte slots written "
          f"and read, the ring once a batch, results): " + "; ".join(
              f"{k} sector {a:.4f}, binned {b:.4f}"
              for k, (a, b) in floors.items())
          + f"; peak extra memory of the binned live contains {peak} B "
          f"(plan {bplan})")
    records[con_name] = {
        "name": con_name, "route": "cuda", "source": RING_SOURCE,
        "replaces": RING_REPLACES[con_name], "launches": 0,
        "max_abs_err": 0, "ms": t["contains sub"],
        "plain_ms": t["contains plain"], "bound_ms": b_sub,
        "bound_by": by_sub, "library_ms": None, "n_keys": n_sub,
        "generations": G, "m_bits": spec.m_bits,
        "main_n_keys": live.shape[0], "main_ms": t["contains"],
        "main_bound_ms": b_full, "api_ms": t["Filter.contains"],
        "api_add_ms": t["Filter.add"], "api_advance_ms": t["Filter.advance"],
        "plans": plans, "paths_ms": turns, "sweep_ms": sweep, "floors_ms": floors,
        "binned_peak_extra_bytes": peak,
        "cuda_kernels": RING_KERNELS}
    del f, w, plain, batches, live, fresh, dense, union
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Filter banks (phases 3d, 4d and their times)
# ---------------------------------------------------------------------------

BANK_REPLACES = {
    "bank_contains_vmem": "src/repro/kernels/sbf.py:663",
    "bank_add_vmem": "src/repro/kernels/sbf.py:694"}
COUNTING_BANK_REPLACES = {
    "bank_update_vmem": "src/repro/kernels/countingbf.py:410",
    "bank_contains_vmem": "src/repro/kernels/countingbf.py:445"}
BANK_MEMBERS = 1024             # the bank cells' tenants
PHASE3D_BANKS = ((1, 17), (7, 16), (64, 14))      # (B, log2 member bits)


def gen_members(n: int, B: int, seed: int, skewed: bool = False
                ) -> torch.Tensor:
    """(n,) int32 member ids on the card, uniform over [0, B) from a seeded
    generator; ``skewed`` puts about half of them on member 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    member = torch.randint(0, B, (n,), dtype=torch.int32, device="cuda",
                           generator=g)
    if skewed:
        member[torch.rand(n, device="cuda", generator=g) < 0.5] = 0
    return member


def bank_update_in_chunks(update, words, keys, member, valid=None):
    """``update(words, keys, member, valid)`` over ``SUBSET``-key chunks."""
    for i in range(0, keys.shape[0], SUBSET):
        words = update(words, keys[i:i + SUBSET], member[i:i + SUBSET],
                       None if valid is None else valid[i:i + SUBSET])
    return words


def bank_contains_in_chunks(contains, words, keys, member):
    """``contains(words, keys, member)`` over ``SUBSET``-key chunks."""
    return torch.cat([contains(words, keys[i:i + SUBSET],
                               member[i:i + SUBSET])
                      for i in range(0, keys.shape[0], SUBSET)])


def bank_geometry(spec, op: str, regime: str = "L2",
                  depth: int = sbf.DEFAULT_DMA_DEPTH):
    """The geometry ``ops.bloom_bank_*`` runs by default: card_layout's,
    the contains at ``depth`` in DRAM."""
    d = 1 if op == "add" or regime == "L2" else depth
    return sbf.launch_geometry(spec, op, sbf.card_layout(spec, op), d)


def bank_contains_launch(spec, bank, keys, member, regime: str):
    """The bank contains kernel alone (no member range check), with the
    schedule ``ops.bloom_bank_contains`` gives the regime."""
    return sbf._launch_bank_contains(spec, bank, keys, member,
                                     bank_geometry(spec, "contains", regime))


def counting_bank_contains_at(spec, bank, keys, member, depth: int):
    """The counting bank contains kernel alone (no member range check) at
    ``card_layout`` and ``depth``."""
    return cnt._launch_contains(
        "bank_contains_vmem", spec, bank, keys,
        cnt.contains_geometry(spec, cnt.card_layout(spec), depth), member)


def counting_bank_contains_launch(spec, bank, keys, member, regime: str):
    return counting_bank_contains_at(
        spec, bank, keys, member,
        1 if regime == "L2" else sbf.DEFAULT_DMA_DEPTH)


def phase_bank_kernels(errs: dict, cerrs: dict):
    n = 65537
    for B, log2m in PHASE3D_BANKS:
        m = 1 << log2m
        specs = [V.FilterSpec("sbf", m, 8, block_bits=256),
                 V.FilterSpec("bbf", m, 8, block_bits=256),
                 V.FilterSpec("rbbf", m, 4),
                 V.FilterSpec("csbf", m, 8, block_bits=512, z=2)]
        for i, spec in enumerate(specs):
            runs = 0
            for skewed in (False, True):
                seed = 2000 + 100 * B + 10 * i + skewed
                keys = gen_keys(n, seed)
                member = gen_members(n, B, seed, skewed)
                valid = valid_mask(n, seed)
                empty = torch.zeros((B, spec.n_words), dtype=torch.int32,
                                    device="cuda")
                want = sbf.bank_add_plain(spec, empty, keys, member, valid)
                got = sbf.bank_add_vmem(spec, empty.clone(), keys, member,
                                        valid, sbf.default_layout(spec, "add"))
                errs["bank_add_vmem"] = max(errs["bank_add_vmem"],
                                            max_err(got, want))
                got = ops.bloom_bank_add(spec, empty, keys, member,
                                         valid=valid)
                errs["bank_add_vmem"] = max(errs["bank_add_vmem"],
                                            max_err(got, want))
                queries = torch.cat([keys, gen_keys(n, seed, probe=True)])
                qm = torch.cat([member, member.flip(0)])
                hits = sbf.bank_contains_plain(spec, want, queries, qm)
                if not bool(hits[:n][valid.bool()].all()):
                    raise AssertionError(f"bank {spec} B={B}: false "
                                         f"negatives")
                lay = sbf.default_layout(spec, "contains")
                for depth in (1, 2, 4):
                    got = sbf.bank_contains_vmem(spec, want, queries, qm, lay,
                                                 depth=depth)
                    errs["bank_contains_vmem"] = max(
                        errs["bank_contains_vmem"], max_err(got, hits))
                for regime in ("vmem", "hbm"):
                    got = ops.bloom_bank_contains(spec, want, queries, qm,
                                                  regime=regime)
                    errs["bank_contains_vmem"] = max(
                        errs["bank_contains_vmem"], max_err(got, hits))
                runs += 7
                for th in thetas(spec):                # every Θ
                    got = sbf.bank_add_vmem(spec, empty.clone(), keys,
                                            member, valid, sbf.Layout(th, 1))
                    errs["bank_add_vmem"] = max(errs["bank_add_vmem"],
                                                max_err(got, want))
                    for depth in sbf.DMA_DEPTHS:
                        got = sbf.bank_contains_vmem(
                            spec, want, queries, qm, sbf.Layout(th, 4),
                            depth=depth)
                        errs["bank_contains_vmem"] = max(
                            errs["bank_contains_vmem"], max_err(got, hits))
                    runs += 5
                if i == 0 and skewed:                  # ragged tails
                    for r in (1, 255, 257):
                        w = sbf.bank_add_plain(spec, empty, keys[:r],
                                               member[:r], valid[:r])
                        got = ops.bloom_bank_add(spec, empty, keys[:r],
                                                 member[:r], valid=valid[:r])
                        errs["bank_add_vmem"] = max(errs["bank_add_vmem"],
                                                    max_err(got, w))
                        got = ops.bloom_bank_contains(spec, w, queries[:r],
                                                      qm[:r], regime="hbm")
                        errs["bank_contains_vmem"] = max(
                            errs["bank_contains_vmem"], max_err(
                                got, sbf.bank_contains_plain(
                                    spec, w, queries[:r], qm[:r])))
                        runs += 2
            torch.cuda.synchronize()
            print(f"kernels: bank of {B} x {spec}: {runs} bank kernel runs "
                  f"equal to the plain version ({n} routed keys, ~25 % "
                  f"invalid, uniform and skewed members, depth 1/2/4/8, Θ "
                  f"in {thetas(spec)})")
        # the counting bank: add (keys 1-3 times, one saturating), remove
        # of a subset and of keys never added, contains, decay of the bank
        cspec = V.FilterSpec("countingbf", m, 8, block_bits=256)
        runs = 0
        for skewed in (False, True):
            seed = 3000 + 100 * B + skewed
            keys = gen_keys(n, seed)
            batch = multiset(keys, seed)
            member = gen_members(batch.shape[0], B, seed, skewed)
            valid = valid_mask(batch.shape[0], seed)
            empty = torch.zeros((B, cspec.storage_words), dtype=torch.int32,
                                device="cuda")
            want = cnt.bank_update_plain(cspec, empty, batch, member, valid,
                                         "add")
            got = cnt.bank_update_vmem(cspec, empty.clone(), batch, member,
                                       valid, "add")
            cerrs["bank_update_vmem"] = max(cerrs["bank_update_vmem"],
                                            max_err(got, want))
            gone = torch.cat([batch[: n // 2],
                              gen_keys(4096, seed, probe=True)])
            gm = torch.cat([member[: n // 2],
                            gen_members(4096, B, seed + 1)])
            want_rm = cnt.bank_update_plain(cspec, want, gone, gm, None,
                                            "remove")
            got = ops.counting_bank_update(cspec, want, gone, gm, "remove")
            cerrs["bank_update_vmem"] = max(cerrs["bank_update_vmem"],
                                            max_err(got, want_rm))
            for kw in counting_path_cases(cspec):   # each path forced
                got = cnt._launch_update("bank_update_vmem", cspec,
                                         empty.clone(), batch, valid, "add",
                                         member, **kw)
                cerrs["bank_update_vmem"] = max(cerrs["bank_update_vmem"],
                                                max_err(got, want))
                cnt._launch_update("bank_update_vmem", cspec, got, gone,
                                   None, "remove", gm, **kw)
                cerrs["bank_update_vmem"] = max(cerrs["bank_update_vmem"],
                                                max_err(got, want_rm))
                runs += 2
            queries = torch.cat([batch, gen_keys(n, seed, probe=True)])
            qm = torch.cat([member, gen_members(n, B, seed + 2, skewed)])
            for words in (want, want_rm):
                hits = cnt.bank_contains_plain(cspec, words, queries, qm)
                for depth in (1, 2, 4):
                    got = cnt.bank_contains_vmem(cspec, words, queries, qm,
                                                 depth=depth)
                    cerrs["bank_contains_vmem"] = max(
                        cerrs["bank_contains_vmem"], max_err(got, hits))
                for geo in counting_geometries(cspec):
                    if geo.vec != sbf.MAX_VEC:
                        continue
                    got = cnt._launch_contains("bank_contains_vmem", cspec,
                                               words, queries, geo, qm)
                    cerrs["bank_contains_vmem"] = max(
                        cerrs["bank_contains_vmem"], max_err(got, hits))
                    runs += 1
            hits = cnt.bank_contains_plain(cspec, want, batch, member)
            if not bool(hits[valid.bool()].all()):
                raise AssertionError(f"counting bank B={B}: false negatives")
            got = cnt.decay(cspec, want_rm.clone())
            cerrs["decay"] = max(cerrs["decay"], max_err(
                got, cnt.decay_plain(cspec, want_rm)))
            runs += 9
        torch.cuda.synchronize()
        print(f"kernels: bank of {B} x {cspec}: {runs} counting bank kernel "
              f"runs equal to the plain version ({batch.shape[0]} routed "
              f"inserts, removes incl. keys never added, uniform and skewed "
              f"members, each update path, the contains at every Θ and "
              f"depth, bank decay)")


def phase_generic_banks(card: str, B: int = 8, time_it: bool = False):
    """The cbf and windowed banks run the generic per-member path (one
    scalar launch a member): hold them against per-member plain filters at
    B members; with ``time_it``, time routed add and contains and count
    their launches."""
    n = 1 << 16
    keys = gen_keys(n, 4000 + B)
    member = gen_members(n, B, 4000 + B)
    valid = valid_mask(n, 4000 + B)
    probes = gen_keys(n, 4100 + B, probe=True)
    out = {}
    # classical bank
    c = api.make_filter_bank(B, "cbf", m_bits=1 << 16, k=7, device="cuda")
    spec = c.spec
    cbf.reset_launches()
    g = c.add(keys, tenants=member, valid=valid)
    hits = g.contains(keys, tenants=member)
    fp = g.contains(probes, tenants=member)
    torch.cuda.synchronize()
    out["cbf"] = dict(cbf.LAUNCHES)
    if c.backend != "cuda-l2" or out["cbf"] != {"contains_vmem": 2 * B,
                                                "add_vmem": B}:
        raise AssertionError(f"cbf bank on {c.backend}: {out['cbf']}")
    ok = valid.bool()
    for b in range(B):
        sel = member == b
        w = cbf.add_plain(spec, V.init(spec, "cuda"), keys[sel & ok])
        max_err(g.words[b], w)
        max_err(hits[sel], cbf.contains_plain(spec, w, keys[sel]))
        max_err(fp[sel], cbf.contains_plain(spec, w, probes[sel]))
    if not bool(hits[ok].all()):
        raise AssertionError("cbf bank: false negatives")
    # windowed bank: add, advance (lockstep), add, contains
    G = 4
    w0 = api.make_filter_bank(B, "sbf", m_bits=1 << 16, k=8, generations=G,
                              device="cuda")
    wspec = w0.spec
    half = n // 2
    sbf.reset_launches()
    ring.reset_launches()
    w1 = w0.add(keys[:half], tenants=member[:half])
    w2 = w1.advance().add(keys[half:], tenants=member[half:])
    whits = w2.contains(keys, tenants=member)
    wfp = w2.contains(probes, tenants=member)
    torch.cuda.synchronize()
    out["windowed"] = {**{k: v for k, v in sbf.LAUNCHES.items() if v},
                       **{k: v for k, v in ring.LAUNCHES.items() if v}}
    if w2.head != (1,) * B:
        raise AssertionError(f"windowed bank heads {w2.head}")
    for b in range(B):
        plain = torch.zeros((G, wspec.n_words), dtype=torch.int32,
                            device="cuda")
        sel0, sel1 = member[:half] == b, member[half:] == b
        plain[0] = sbf.add_plain(wspec, plain[0], keys[:half][sel0])
        plain[1] = sbf.add_plain(wspec, plain[1], keys[half:][sel1])
        max_err(w2.words[b], plain)
        sel = member == b
        max_err(whits[sel], ring.ring_contains_ref(wspec, plain, keys[sel]))
        max_err(wfp[sel], ring.ring_contains_ref(wspec, plain, probes[sel]))
    if not bool(whits.all()):
        raise AssertionError("windowed bank: false negatives")
    print(f"kernels: generic banks of {B}: cbf (m = 2^16, k = 7) add and "
          f"contains, windowed ({G} x {wspec}) add, advance, add and "
          f"contains of {n} routed keys equal to per-member plain filters; "
          f"launches cbf {out['cbf']}, windowed {out['windowed']}")
    if not time_it:
        return None
    t = {"cbf add": time_ms(lambda: c.add(keys, tenants=member, valid=valid),
                            "generic cbf add", 5, 3),
         "cbf contains": time_ms(lambda: g.contains(keys, tenants=member),
                                 "generic cbf contains", 5, 3),
         "windowed add": time_ms(lambda: w1.add(keys[half:],
                                                tenants=member[half:]),
                                 "generic windowed add", 5, 3),
         "windowed advance": time_ms(w1.advance, "generic windowed advance",
                                     5, 3),
         "windowed contains": time_ms(lambda: w2.contains(keys,
                                                          tenants=member),
                                      "generic windowed contains", 5, 3)}
    print(f"time generic banks of {B} [{card}] ({n} routed keys; one scalar "
          f"launch a member): " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in t.items()))
    return {"members": B, "n_keys": n, "launches": out, "ms": t}


def phase_bank_main(kind: str, regime: str, n_per: int, n: int, errs: dict,
                    records: dict, launches: dict, card: str):
    """A bank cell: ``filter_for_n_items(n_per, bank=1024)``, routed add of
    ``n`` keys (member ids uniform from the seed), routed contains of them
    and of 2^22 probes; a counting bank also removes half, queries the
    rest and decays once."""
    B = BANK_MEMBERS
    counting = kind == "countingbf"
    mod = cnt if counting else sbf
    add_name = "bank_update_vmem" if counting else "bank_add_vmem"
    con_name = "bank_contains_vmem"
    f = api.filter_for_n_items(n_per, bits_per_key=16, variant=kind,
                               block_bits=256, bank=B, device="cuda")
    spec = f.spec
    engine = ("counting" if counting else
              "cuda-l2" if regime == "L2" else "cuda-dram")
    if (f.backend != engine or spec.k != 8 or f.bank_shape != (B,)
            or ops.bank_l2_resident(spec, B) != (regime == "L2")):
        raise AssertionError(f"bank {kind} {regime}: {f}")
    label = f"bank {kind} {regime}"
    keys = gen_keys(n, 51)
    member = gen_members(n, B, 52)
    valid = torch.ones((n,), dtype=torch.uint8, device="cuda")
    probes = gen_keys(SUBSET, 53, probe=True)
    pmember = gen_members(SUBSET, B, 54)
    half = n // 2
    torch.cuda.synchronize()

    mod.reset_launches()                   # the main path, counted
    t0 = time.perf_counter()
    g = f.add(keys, tenants=member, valid=valid)
    hits = g.contains(keys, tenants=member)
    false_pos = g.contains(probes, tenants=pmember)
    calls = {add_name: 1, con_name: 2}
    if counting:
        h = g.remove(keys[:half], tenants=member[:half])
        kept = h.contains(keys[half:], tenants=member[half:])
        d = h.decay(1)
        calls = {add_name: 2, con_name: 3, "decay": 1}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {k: v for k, v in mod.LAUNCHES.items() if v}
    if counted != calls:
        raise AssertionError(f"{label}: launches {counted}, not one per "
                             f"routed call {calls}")
    for name in (add_name, con_name):
        launches[name] = launches.get(name, 0) + counted[name]
    if not bool(hits.all()) or (counting and not bool(kept.all())):
        raise AssertionError(f"{label}: false negatives")

    # the main path's words and results against the plain version, in full
    empty = torch.zeros_like(f.words)
    if counting:
        def plain_update(op):
            return lambda w, k, m, v: cnt.bank_update_plain(spec, w, k, m, v,
                                                            op)
        plain_contains = functools.partial(cnt.bank_contains_plain, spec)
    else:
        def plain_update(op):
            return lambda w, k, m, v: sbf.bank_add_plain(spec, w, k, m, v)
        plain_contains = functools.partial(sbf.bank_contains_plain, spec)
    err = errs.setdefault(add_name, 0)
    want = bank_update_in_chunks(plain_update("add"), empty, keys, member,
                                 valid)
    errs[add_name] = max(err, max_err(g.words, want))
    errs[con_name] = max(errs.get(con_name, 0), max_err(
        hits, bank_contains_in_chunks(plain_contains, want, keys, member)))
    errs[con_name] = max(errs[con_name], max_err(
        false_pos, plain_contains(want, probes, pmember)))
    extra = ""
    if counting:
        want_rm = bank_update_in_chunks(plain_update("remove"), want,
                                        keys[:half], member[:half])
        errs[add_name] = max(errs[add_name], max_err(h.words, want_rm))
        errs[con_name] = max(errs[con_name], max_err(
            kept, bank_contains_in_chunks(plain_contains, want_rm,
                                          keys[half:], member[half:])))
        errs["decay"] = max(errs["decay"], max_err(
            d.words, cnt.decay_plain(spec, want_rm)))
        del want_rm
        extra = (f", remove of {half}, contains of the rest, decay(1) of "
                 f"the whole bank")
    del want, empty
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = g.fpr_theory(n // B)
    print(f"main {label}: {B} x {spec} on {g.backend}, {n} routed keys "
          f"({n // B} a member), {g.nbytes / 2**20:.0f} MiB bank: routed add, "
          f"contains and 2^22 probes{extra} in {wall * 1e3:.1f} ms host "
          f"clock, no false negatives; words and results equal to the plain "
          f"version's in full; FPR {fpr:.6f}, {fpr / theory:.3f} x theory "
          f"{theory:.6f}; launches {counted} (one per routed call)")

    # times: the kernel alone, the wrapper (+ member range check) and the
    # Filter call at full size; kernel, plain version and bound on 2^22
    # keys into the full-size bank
    sub, msub, vsub = keys[:SUBSET], member[:SUBSET], valid[:SUBSET]
    sub_half = SUBSET // 2
    scratch = f.words.clone()
    if counting:
        sub_words = cnt.bank_update_plain(spec, torch.zeros_like(f.words),
                                          sub, msub, vsub, "add")
        queries, qm = sub, msub

        def run_update(words, k, m, v, op, **kw):
            return cnt._launch_update("bank_update_vmem", spec, words, k, v,
                                      op, m, **kw)

        def run_contains(words, k, m):
            return counting_bank_contains_launch(spec, words, k, m, regime)
        t = {"add": time_restored_ms(
                lambda: run_update(scratch, keys, member, valid, "add"),
                scratch.zero_, f"{label} add"),
             "remove": time_restored_ms(
                lambda: run_update(scratch, keys[:half], member[:half], None,
                                   "remove"),
                lambda: scratch.copy_(g.words), f"{label} remove"),
             "wrapper add": time_restored_ms(
                lambda: cnt.bank_update_vmem(spec, scratch, keys, member,
                                             valid, "add"),
                scratch.zero_, f"{label} wrapper add"),
             "decay": time_restored_ms(
                lambda: cnt.decay(spec, scratch),
                lambda: scratch.copy_(h.words), f"{label} decay"),
             "Filter.remove": time_ms(
                lambda: g.remove(keys[:half], tenants=member[:half]),
                f"{label} Filter.remove"),
             "remove sub": time_restored_ms(
                lambda: run_update(scratch, sub[:sub_half], msub[:sub_half],
                                   None, "remove"),
                lambda: scratch.copy_(sub_words), f"{label} remove sub"),
             "remove plain": time_ms(
                lambda: cnt.bank_update_plain(spec, sub_words,
                                              sub[:sub_half],
                                              msub[:sub_half], None,
                                              "remove"),
                f"{label} remove plain", PLAIN_REPS, PLAIN_ROUNDS),
             "add sub": time_restored_ms(
                lambda: run_update(scratch, sub, msub, vsub, "add"),
                scratch.zero_, f"{label} add sub"),
             "add plain": time_ms(
                lambda: cnt.bank_update_plain(spec, torch.zeros_like(f.words),
                                              sub, msub, vsub, "add"),
                f"{label} add plain", PLAIN_REPS, PLAIN_ROUNDS)}
    else:
        sub_words = sbf.bank_add_plain(spec, torch.zeros_like(f.words), sub,
                                       msub, vsub)
        queries = torch.cat([sub[:sub_half], probes[:SUBSET - sub_half]])
        qm = torch.cat([msub[:sub_half], pmember[:SUBSET - sub_half]])

        def run_contains(words, k, m):
            return bank_contains_launch(spec, words, k, m, regime)
        sub_scratch = sub_words.clone()
        geo_add = bank_geometry(spec, "add")
        t = {"add": time_ms(lambda: sbf._launch_bank_add(
                spec, scratch, keys, member, valid, geo_add), f"{label} add"),
             "wrapper add": time_ms(lambda: sbf.bank_add_vmem(
                spec, scratch, keys, member, valid), f"{label} wrapper add"),
             "add sub": time_ms(lambda: sbf._launch_bank_add(
                spec, sub_scratch, sub, msub, vsub, geo_add),
                f"{label} add sub"),
             "add plain": time_ms(
                lambda: sbf.bank_add_plain(spec, sub_words, sub, msub, vsub),
                f"{label} add plain", PLAIN_REPS, PLAIN_ROUNDS)}
    t.update({
        "contains": time_ms(lambda: run_contains(g.words, keys, member),
                            f"{label} contains"),
        "wrapper contains": time_ms(
            lambda: (cnt.bank_contains_vmem(
                spec, g.words, keys, member,
                depth=1 if regime == "L2" else sbf.DEFAULT_DMA_DEPTH)
                if counting else sbf.bank_contains_vmem(
                    spec, g.words, keys, member,
                    depth=1 if regime == "L2" else sbf.DEFAULT_DMA_DEPTH)),
            f"{label} wrapper contains"),
        "Filter.add": time_ms(lambda: f.add(keys, tenants=member,
                                            valid=valid),
                              f"{label} Filter.add"),
        "Filter.contains": time_ms(lambda: g.contains(keys, tenants=member),
                                   f"{label} Filter.contains"),
        "contains sub": time_ms(lambda: run_contains(sub_words, queries, qm),
                                f"{label} contains sub"),
        "contains plain": time_ms(lambda: plain_contains(sub_words, queries,
                                                         qm),
                                  f"{label} contains plain", PLAIN_REPS,
                                  PLAIN_ROUNDS)})
    # bounds: the super-filter of B members, plus 4 B a key of member id
    # and 1 B a key of valid mask where one is read
    ops_name = {"add": add_name, "contains": con_name}
    if counting:
        full = {"add": (n, touched_sectors(g.words),
                        counter_updates(spec, keys), 5 * n),
                "remove": (half, touched_sectors(bank_update_in_chunks(
                    plain_update("add"), torch.zeros_like(f.words),
                    keys[:half], member[:half])),
                    counter_updates(spec, keys[:half]), 4 * half)}
        full["contains"] = full["add"][:3] + (4 * n,)
        part = {"add": (SUBSET, touched_sectors(sub_words),
                        counter_updates(spec, sub), 5 * SUBSET),
                "remove": (sub_half, touched_sectors(cnt.bank_update_plain(
                    spec, torch.zeros_like(f.words), sub[:sub_half],
                    msub[:sub_half], None, "add")),
                    counter_updates(spec, sub[:sub_half]), 4 * sub_half)}
        part["contains"] = part["add"][:3] + (4 * SUBSET,)
        def cb(op, nk, sectors, updates, extra):
            return counting_bound_ms(spec, nk, op, sectors, updates,
                                     extra_bytes=extra)
        bounds = {op: (cb(op, *full[op]), cb(op, *part[op]))
                  for op in ("add", "remove", "contains")}
        ops_list = ("add", "contains", "remove")
    else:
        whole = V.FilterSpec(spec.variant, spec.m_bits * B, spec.k,
                             block_bits=spec.block_bits)
        bounds = {"add": (bound_ms(whole, n, "add", extra_bytes=5 * n),
                          bound_ms(whole, SUBSET, "add",
                                   extra_bytes=5 * SUBSET)),
                  "contains": (bound_ms(whole, n, "contains",
                                        extra_bytes=4 * n),
                               bound_ms(whole, SUBSET, "contains",
                                        extra_bytes=4 * SUBSET))}
        ops_list = ("add", "contains")
        # the resolved Θ against Θ = 1 in turns, at the timed schedules,
        # and the sector bound with the member ids (and valid bytes)
        def bank_at(op, theta):
            if op == "add":
                geo = sbf.launch_geometry(spec, "add", sbf.Layout(theta, 1))
                return lambda: sbf._launch_bank_add(spec, scratch, keys,
                                                    member, valid, geo)
            geo = sbf.launch_geometry(
                spec, "contains", sbf.Layout(theta, sbf.MAX_VEC),
                1 if regime == "L2" else sbf.DEFAULT_DMA_DEPTH)
            return lambda: sbf._launch_bank_contains(spec, g.words, keys,
                                                     member, geo)
        resolved = {op: bank_geometry(spec, op, regime).theta
                    for op in ops_list}
        turns = {op: time_turns({"resolved": bank_at(op, resolved[op]),
                                 "theta=1": bank_at(op, 1)},
                                f"{label} {op} turns") for op in ops_list}
        sectors = {"add": sector_bound_ms(n, "add", 5 * n),
                   "contains": sector_bound_ms(n, "contains", 4 * n)}
    if counting:
        # both update paths (and the one-pass schedules) in turns at the
        # cell's size, an add's peak extra memory, and the contains at
        # every Θ and depth
        paths = {op: update_path_turns(
            f"{label} {op} paths",
            lambda op=op, nk=nk, **kw: run_update(
                scratch, keys[:nk], member[:nk], None, op, **kw),
            restore, 5, 3)
            for op, nk, restore in (
                ("add", n, scratch.zero_),
                ("remove", half, lambda: scratch.copy_(g.words)))}
        peak = update_peak_bytes(
            lambda **kw: (run_update(scratch, keys, member, None, "add", **kw),
                          cnt.LAST_UPDATE_PLAN["bank_update_vmem"])[1],
            scratch.zero_)
        sweep = contains_sweep(
            f"{label} contains sweep",
            lambda geo: cnt._launch_contains("bank_contains_vmem", spec,
                                             g.words, keys, geo, member),
            spec, 5, bank=True)
        best = min(sweep, key=sweep.get)
        for op in ("add", "remove"):
            print(f"time {label} {op} paths [{card}] ("
                  f"{n if op == 'add' else half} routed keys, in turns): "
                  + ", ".join(f"{p} {v:.4f} ms" for p, v in paths[op].items())
                  + f"; one-pass / binned "
                  f"{paths[op]['one-pass'] / paths[op]['binned']:.2f}x")
        print(f"{label} add peak extra memory [{card}]: " + ", ".join(
            f"{p} {b} B (workspace {w} B)" for p, (b, w) in peak.items()))
        print(f"time {label} contains sweep [{card}] (in turns): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items())
              + f" ms; the best {best}")
    for op in ops_list:
        (b_full, by_full), (b_sub, by_sub) = bounds[op]
        nk = half if op == "remove" else n
        lo, hi = SPREAD[f"{label} {op}"]
        wrap = (f"; wrapper (with the member range check) "
                f"{t['wrapper ' + op]:.4f} ms" if f"wrapper {op}" in t
                else "")
        coop = ""
        if not counting:
            lo1, hi1 = SPREAD[f"{label} {op} turns theta=1"]
            tr, t1 = turns[op]["resolved"], turns[op]["theta=1"]
            coop = (f"; Θ={resolved[op]} in turns {tr:.4f} ms against Θ = 1 "
                    f"{t1:.4f} ms (rounds {lo1:.4f}-{hi1:.4f}), "
                    f"{t1 / tr:.2f}x; sector bound {sectors[op]:.4f} ms, "
                    f"{sectors[op] / t[op]:.1%} of it")
        print(f"time {label} {op} [{card}]: kernel {t[op]:.4f} ms (rounds "
              f"{lo:.4f}-{hi:.4f}; {nk / t[op] / 1e3:.1f} Mops/s) at {nk} "
              f"keys, bound {b_full:.4f} ms ({by_full}), "
              f"{b_full / t[op]:.1%} of it{coop}{wrap}; Filter.{op} "
              f"{t[f'Filter.{op}']:.4f} ms; at {SUBSET if op != 'remove' else sub_half} "
              f"keys kernel {t[f'{op} sub']:.4f} ms, plain "
              f"{t[f'{op} plain']:.4f} ms, bound {b_sub:.4f} ms ({by_sub})")
        if op == "remove":
            records[add_name].update(
                {f"{'dram_' if regime == 'DRAM' else ''}{k}": v for k, v in {
                    "remove_ms": t["remove sub"],
                    "remove_plain_ms": t["remove plain"],
                    "remove_bound_ms": b_sub, "main_remove_ms": t["remove"],
                    "api_remove_ms": t["Filter.remove"]}.items()})
            continue
        cell = {"ms": t[f"{op} sub"], "plain_ms": t[f"{op} plain"],
                "bound_ms": b_sub, "bound_by": by_sub, "main_n_keys": n,
                "main_ms": t[op], "main_bound_ms": b_full,
                "wrapper_ms": t[f"wrapper {op}"],
                "api_ms": t[f"Filter.{op}"], "m_bits": spec.m_bits,
                "members": B}
        if not counting:
            cell.update(theta=resolved[op], turns_ms=turns[op]["resolved"],
                        theta1_ms=turns[op]["theta=1"],
                        main_sector_bound_ms=sectors[op])
        elif op == "add":
            cell.update(paths_ms=paths["add"],
                        remove_paths_ms=paths["remove"],
                        path=cnt.choose_update_path(
                            n, B * spec.storage_words,
                            spec.counter_row_words,
                            sbf.partition_smem_bytes(keys.device)),
                        peak_extra_bytes=peak)
        else:
            cell.update(sweep_ms=sweep, best=best)
        name = ops_name[op]
        if regime == "L2":
            records[name] = {
                "name": f"{'counting_' if counting else ''}{name}",
                "route": "cuda",
                "source": ((COUNTING_SOURCE if op == "add"
                            else COUNTING_CONTAINS_SOURCE) if counting
                           else COOP_SOURCE),
                "replaces": (COUNTING_BANK_REPLACES if counting
                             else BANK_REPLACES)[name],
                "launches": 0, "max_abs_err": 0, "library_ms": None,
                "n_keys": SUBSET, **cell}
            if counting:
                records[name]["cuda_kernels"] = COUNTING_KERNELS[
                    "update" if op == "add" else "contains"]
        else:
            records[name].update({f"dram_{k}": v for k, v in cell.items()})
    if counting:
        lo, hi = SPREAD[f"{label} decay"]
        print(f"time {label} decay [{card}]: kernel {t['decay']:.4f} ms "
              f"(rounds {lo:.4f}-{hi:.4f}) over the {g.nbytes / 2**20:.0f} "
              f"MiB bank, one launch")
    del f, g, keys, member, valid, scratch, sub_words
    if counting:
        del h, d
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Partitioned updates and the cuckoo filter (phases 3e, 4e and their times)
# ---------------------------------------------------------------------------

PART_REPLACES = {"add_partitioned": "src/repro/kernels/sbf.py:759",
                 "update_partitioned": "src/repro/kernels/countingbf.py:689"}
CUCKOO_SOURCE = "src/repro_torch/kernels/csrc/cuckoo.cu"
CUCKOO_REPLACES = {"cuckoo_contains": "src/repro/kernels/cuckoofilter.py:47",
                   "cuckoo_update": "src/repro/kernels/cuckoofilter.py:87"}
PHASE3E_SPECS = [V.FilterSpec("sbf", 1 << 20, 16, block_bits=256),
                 V.FilterSpec("bbf", 1 << 20, 8, block_bits=256),
                 V.FilterSpec("rbbf", 1 << 20, 4),
                 V.FilterSpec("csbf", 1 << 20, 8, block_bits=512, z=2),
                 V.FilterSpec("countingbf", 1 << 20, 8, block_bits=256),
                 V.FilterSpec("sbf", 1 << 22, 16, block_bits=256)]
# windows of the cuckoo update the checks run: serial, two keys, a warp,
# the default
CUCKOO_WINDOWS = (1, 2, 32, ckoo.WINDOW)
DRAM_BATCH = 1 << 24           # keys a partitioned call takes in DRAM cells
CUCKOO_SUB = 1 << 18           # keys of the cuckoo kernel-vs-plain checks


def partitioned_update(spec, words, keys, n_segments, op="add", **kw):
    """``ops.bloom_add_partitioned`` / ``counting_update_partitioned`` in
    place: the partitioned main path."""
    if spec.is_counting:
        return ops.counting_update_partitioned(
            spec, words, keys, op, n_segments=n_segments, inplace=True, **kw)
    return ops.bloom_add_partitioned(spec, words, keys, n_segments=n_segments,
                                     inplace=True, **kw)


@contextlib.contextmanager
def global_atomics():
    """Send the partitioned kernels down their global-atomic path: no
    segment fits a shared-memory budget of 0."""
    budget = sbf.partition_smem_bytes
    sbf.partition_smem_bytes = lambda device: 0
    try:
        yield
    finally:
        sbf.partition_smem_bytes = budget


def fitting_segments(spec: V.FilterSpec) -> int:
    """The smallest n_segments whose segment fits a CTA's shared memory."""
    budget = sbf.partition_smem_bytes("cuda")
    n_seg = 1
    while spec.storage_words * 4 // n_seg > budget:
        n_seg *= 2
    return n_seg


def counting_paths(spec, batch, gone, n_seg: int, want, want_rm,
                   errs: dict) -> int:
    """``countingbf.update_partitioned`` on each path forced (the grouped
    one where its histogram holds a segment's rows), add of ``batch`` and
    remove of ``gone``, and an add of 40 keys on one row twice over (80
    increments of its counters, each key's nibbles past 15), against the
    plain version; the runs made."""
    cand = gen_keys(1 << 18, 640 + n_seg)
    blk = H.block_index(H.hash_keys(cand)[1], spec.n_blocks)
    one_row = cand[blk == blk[0]][:40]
    one_row = torch.cat([one_row, one_row]).contiguous()
    cap = 4 * batch.shape[0] // n_seg + 64
    part = P.partition_jit(spec, batch, n_seg, cap)
    rpart = P.partition_jit(spec, gone, n_seg, cap)
    opart = P.partition_jit(spec, one_row, n_seg, 128)
    if int(part.overflow) + int(rpart.overflow) + int(opart.overflow):
        raise AssertionError("partitioned: a pinned capacity overflowed")
    want_one = cnt.update_plain(spec, V.init(spec, "cuda"), one_row, None,
                                "add")
    runs = 0
    for path in cnt.PARTITIONED_PATHS:
        if path == "grouped" and not 1 <= cnt.grouped_rows(
                spec.storage_words, n_seg, spec.counter_row_words
        ) <= cnt.GROUPED_MAX_ROWS:
            continue
        got = cnt.update_partitioned(spec, V.init(spec, "cuda"),
                                     part.keys_by_seg, part.valid, n_seg,
                                     "add", path=path)
        errs["update_partitioned"] = max(errs["update_partitioned"],
                                         max_err(got, want))
        got = cnt.update_partitioned(spec, got, rpart.keys_by_seg,
                                     rpart.valid, n_seg, "remove", path=path)
        errs["update_partitioned"] = max(errs["update_partitioned"],
                                         max_err(got, want_rm))
        got = cnt.update_partitioned(spec, V.init(spec, "cuda"),
                                     opart.keys_by_seg, opart.valid, n_seg,
                                     "add", path=path)
        errs["update_partitioned"] = max(errs["update_partitioned"],
                                         max_err(got, want_one))
        if cnt.LAST_PARTITIONED_PLAN["path"] != path:
            raise AssertionError(f"partitioned: ran "
                                 f"{cnt.LAST_PARTITIONED_PLAN}, not {path}")
        runs += 3
    return runs


def bits_paths(spec, keys_by_seg, valid, n_seg: int, errs: dict) -> int:
    """``sbf.add_partitioned`` on each path forced (global; shared where a
    segment fits shared memory in 16-byte vectors), on the given slots and
    on a copy with a key placed in a foreign segment, against the plain
    version; the runs made."""
    smem = sbf.partition_smem_bytes("cuda")
    seg_words = spec.n_words // n_seg
    paths = ["global"] + (["shared"] if seg_words % 4 == 0
                          and seg_words * 4 <= smem else [])
    foreign = keys_by_seg.clone()
    fvalid = valid.clone()
    owner = n_seg // 2
    free = (fvalid[owner] == 0).nonzero()
    if free.numel():
        foreign[owner, int(free[0])] = gen_keys(1, 700 + n_seg)[0]
        fvalid[owner, int(free[0])] = 1
    runs = 0
    for kb, v in ((keys_by_seg, valid), (foreign, fvalid)):
        plain = sbf.add_partitioned_plain(spec, V.init(spec, "cuda"), kb, v)
        for path in paths:
            got = sbf.add_partitioned(spec, V.init(spec, "cuda"), kb, v,
                                      n_seg, path=path)
            errs["add_partitioned"] = max(errs["add_partitioned"],
                                          max_err(got, plain))
            plan = sbf.LAST_PARTITIONED_PLAN
            if plan["path"] != path:
                raise AssertionError(f"partitioned: ran {plan}, not {path}")
            runs += 1
    return runs


def phase_partitioned_kernels(errs: dict):
    """Phase 3e, partitioned: every spec at n_segments 1/8/64, the default
    capacity (escalated for a batch that falls in one segment), pinned to
    half the mean (the residual pass) and the host partition, each on the
    path ``ops`` picks (bits: shared memory where a segment fits; counters:
    ``countingbf.choose_partitioned_path``) and with global atomics forced;
    for counters also each path forced (:func:`counting_paths`); the words
    against the plain version and the atomic kernels of rows 2 and 10."""
    n = 65537
    budget = sbf.partition_smem_bytes("cuda")
    for i, spec in enumerate(PHASE3E_SPECS):
        counting = spec.is_counting
        name = "update_partitioned" if counting else "add_partitioned"
        keys = gen_keys(n, 600 + i)
        init = functools.partial(V.init, spec, "cuda")
        if counting:
            batch = multiset(keys, 610 + i)
            gone = torch.cat([batch[: batch.shape[0] // 2],
                              gen_keys(1000, 620 + i, probe=True)])
            want = cnt.update_plain(spec, init(), batch, None, "add")
            want_rm = cnt.update_plain(spec, want, gone, None, "remove")
            max_err(ops.counting_add(spec, init(), batch), want)
        else:
            batch = keys
            want = sbf.add_plain(spec, init(), keys)
            max_err(ops.bloom_add(spec, init(), keys), want)
        runs, paths = 0, set()
        for n_seg in (1, 8, 64):
            if not counting:
                paths.add(sbf.choose_partitioned_path(
                    n_seg, spec.n_words // n_seg, 4 * n // n_seg, budget,
                    ops.fits_l2(spec)))
            mean = batch.shape[0] // n_seg
            for kw in ({}, {"capacity": max(8, mean // 2)},
                       {"partition": "host"}):
                for forced in (False, True):
                    with (global_atomics() if forced
                          else contextlib.nullcontext()):
                        got = partitioned_update(spec, init(), batch, n_seg,
                                                 **kw)
                        errs[name] = max(errs[name], max_err(got, want))
                        runs += 1
                        if counting:
                            got = partitioned_update(spec, got, gone, n_seg,
                                                     op="remove", **kw)
                            errs[name] = max(errs[name],
                                             max_err(got, want_rm))
                            runs += 1
            # a batch in one segment: the default capacity escalates
            skew = batch[P.segment_ids(spec, batch, n_seg) == 0]
            got = partitioned_update(spec, init(), skew, n_seg)
            plain = (cnt.update_plain(spec, init(), skew, None, "add")
                     if counting else sbf.add_plain(spec, init(), skew))
            errs[name] = max(errs[name], max_err(got, plain))
            runs += 1
            part = P.partition_jit(spec, batch, n_seg, max(8, mean // 2))
            if counting:
                plain = cnt.update_partitioned_plain(
                    spec, init(), part.keys_by_seg, part.valid, "add")
                got = cnt.update_partitioned(spec, init(), part.keys_by_seg,
                                             part.valid, n_seg, "add")
                runs += counting_paths(spec, batch, gone, n_seg, want,
                                       want_rm, errs)
                paths.add(cnt.choose_partitioned_path(
                    n_seg, spec.storage_words, spec.counter_row_words,
                    budget))
            else:
                plain = sbf.add_partitioned_plain(spec, init(),
                                                  part.keys_by_seg,
                                                  part.valid)
                got = sbf.add_partitioned(spec, init(), part.keys_by_seg,
                                          part.valid, n_seg,
                                          l2_resident=ops.fits_l2(spec))
                runs += bits_paths(spec, part.keys_by_seg, part.valid,
                                   n_seg, errs)
            errs[name] = max(errs[name], max_err(got, plain))
            runs += 1
        torch.cuda.synchronize()
        print(f"partitioned: {spec}: {runs} kernel runs equal to the plain "
              f"version and the atomic kernel ({batch.shape[0]} keys; "
              f"n_segments 1/8/64; the default capacity, escalated for a "
              f"batch in one segment, pinned with overflow, host partition; "
              f"paths {sorted(paths)} and global forced"
              + ("; the counting update on each path forced, a row of 80 "
                 "increments" if counting else "; the add on each path "
                 "forced, with a key in a foreign segment") + ")")


def cuckoo_spec(slot_bits: int, spb: int, n_buckets: int) -> V.FilterSpec:
    return V.FilterSpec("cuckoo", n_buckets * spb * slot_bits, 2,
                        slot_bits=slot_bits, slots_per_bucket=spb)


def cuckoo_windows(spec, table, keys, vmask, op, tile, want, flags, errs,
                   windows=CUCKOO_WINDOWS, step_cap=None) -> int:
    """The update at each window (and ``step_cap``) on a copy of
    ``table``, held against the plain version's words and flags; returns
    the number of kernel runs."""
    fn = ckoo.add_vmem if op == "add" else ckoo.remove_vmem
    for w in windows:
        got, got_flags = fn(spec, table.clone(), keys, vmask, tile, window=w,
                            step_cap=step_cap)
        errs["cuckoo_update"] = max(errs["cuckoo_update"], max_err(got, want),
                                    max_err(got_flags, flags))
    return len(windows)


def pair_keys(spec, n: int, seed: int) -> torch.Tensor:
    """n keys whose primary and alternate buckets are one pair {x, y}."""
    keys = gen_keys(1 << 22, seed)
    b1, fp, _ = F.cuckoo_hashes(spec, keys)
    alt = F.alt_bucket(spec, b1, fp)
    i = int(torch.nonzero(b1 != alt)[0])
    x, y = int(b1[i]), int(alt[i])
    out = keys[((b1 == x) & (alt == y)) | ((b1 == y) & (alt == x))][:n]
    if out.shape[0] != n:
        raise AssertionError(f"only {out.shape[0]} keys in one bucket pair")
    return out.contiguous()


def phase_cuckoo_kernels(errs: dict):
    """Phase 3e, cuckoo: every instance (u8 x 4/8/16, u16 x 2/4/8/16) with
    16384 slots; batches at 0.9 and 1.2 of the slots (kick failures), 5 %
    duplicates, in 256-key tiles, and with a valid mask in the default
    tile; the update at windows 1, 2, 32 and the default, its words and
    ok/found flags against the plain version, the contains (both coop
    values) too. Then the adversarial batches (u16 x 4): 512 copies of one
    key, keys that share one bucket pair, tiles of 1, 8, 2048 and 8192
    over a multi-tile batch, a step cap of 1, and the kernel's counters
    against the CPU model's (``ckoo.update_windowed``)."""
    for i, (sb, spb) in enumerate(ckoo.INSTANCES):
        spec = cuckoo_spec(sb, spb, (1 << 14) // spb)
        runs, fails = 0, 0
        for load in (0.9, 1.2):
            n = int(spec.n_slots * load)
            keys = gen_keys(n, 700 + i)
            keys = torch.cat([keys, keys[: n // 20]])
            valid = valid_mask(keys.shape[0], 710 + i)
            probes = gen_keys(4096, 720 + i, probe=True)
            for vmask, tile in ((None, 256), (valid, None)):
                t = tile or F.CUCKOO_ADD_TILE
                empty = F.init(spec, "cuda")
                want, ok = ckoo.update_plain(spec, empty, keys, vmask, "add",
                                             t)
                runs += cuckoo_windows(spec, empty, keys, vmask, "add", t,
                                       want, ok, errs)
                got, got_ok = ops.cuckoo_add(spec, empty, keys, valid=vmask,
                                             tile=tile)
                errs["cuckoo_update"] = max(errs["cuckoo_update"],
                                            max_err(got, want),
                                            max_err(got_ok, ok))
                if load > 1 and vmask is None and bool(ok.all()):
                    raise AssertionError(f"{spec}: no kick failure at load "
                                         f"{load}")
                if int(F.occupied_slots(spec, got)) != int(
                        (ok & (torch.ones_like(ok) if vmask is None
                               else vmask.bool())).sum()):
                    raise AssertionError(f"{spec}: occupied slots != ok")
                fails += int((~ok).sum())
                queries = torch.cat([keys, probes])
                hit = ckoo.contains_plain(spec, want, queries)
                for coop in ("none", "subtile"):
                    errs["cuckoo_contains"] = max(
                        errs["cuckoo_contains"], max_err(ops.cuckoo_contains(
                            spec, got, queries, coop=coop), hit))
                gone = torch.cat([keys[: keys.shape[0] // 2], probes[:64]])
                want_rm, found = ckoo.update_plain(spec, want, gone, None,
                                                   "remove", t)
                runs += cuckoo_windows(spec, got, gone, None, "remove", t,
                                       want_rm, found, errs)
                runs += 3
        torch.cuda.synchronize()
        print(f"cuckoo: {spec}: {runs} kernel runs equal to the plain "
              f"version (loads 0.9 and 1.2 of {spec.n_slots} slots, 5 % "
              f"duplicates; 256-key tiles, and a valid mask with the "
              f"2048-key tile; windows {CUCKOO_WINDOWS}; {fails} kick "
              f"failures, matched flag for flag)")
    spec = cuckoo_spec(16, 4, 1 << 12)
    runs = 0
    keys = gen_keys(4096, 730)
    copies = torch.cat([keys[:2048], keys[7:8].expand(512, 2),
                        keys[2048:]]).contiguous()
    pair = cuckoo_spec(16, 4, 1 << 6)
    cases = [("512 copies of one key", spec, copies, None, 2048, None),
             ("keys of one bucket pair", pair, pair_keys(pair, 64, 731),
              None, 64, None)]
    multi = gen_keys(int(spec.n_slots * 0.9), 732)
    mask = valid_mask(multi.shape[0], 733)
    cases += [(f"tile {t}", spec, multi, mask, t, None)
              for t in (1, 8, 2048, 8192)]
    cases += [("step cap 1", spec, multi, None, 2048, 1)]
    for label, sp, k, vmask, t, cap in cases:
        empty = F.init(sp, "cuda")
        want, ok = ckoo.update_plain(sp, empty, k, vmask, "add", t)
        runs += cuckoo_windows(sp, empty, k, vmask, "add", t, want, ok, errs,
                               step_cap=cap)
        gone = k[: k.shape[0] // 2]
        want_rm, found = ckoo.update_plain(sp, want, gone, None, "remove", t)
        runs += cuckoo_windows(sp, want, gone, None, "remove", t, want_rm,
                               found, errs, step_cap=cap)
    torch.cuda.synchronize()
    print(f"cuckoo: adversarial batches ({', '.join(c[0] for c in cases)}):"
          f" {runs} kernel runs at windows {CUCKOO_WINDOWS} equal to the "
          f"plain version")
    # the counters against the model's, round for round
    small = cuckoo_spec(16, 4, 1 << 10)
    k = gen_keys(int(small.n_slots * 0.95), 734)
    for w, cap, t in ((1, None, 256), (32, None, 256),
                      (ckoo.WINDOW, None, 256), (ckoo.WINDOW, 1, 2048)):
        got, _ = ckoo.add_vmem(small, F.init(small, "cuda"), k, None, t,
                               window=w, step_cap=cap)
        counted = ckoo.LAST_UPDATE_STATS["add_vmem"].read()
        m_words, _, model = ckoo.update_windowed(
            small, F.init(small, "cpu"), k.cpu(), None, "add", t, w,
            cap or ckoo.STEP_CAP)
        errs["cuckoo_update"] = max(errs["cuckoo_update"],
                                    max_err(got.cpu(), m_words))
        if counted != model:
            raise AssertionError(f"cuckoo counters at window {w}: kernel "
                                 f"{counted}, model {model}")
    print(f"cuckoo: the kernel's counters equal the CPU model's at windows "
          f"1, 32 and {ckoo.WINDOW} (step cap {ckoo.STEP_CAP} and 1), "
          f"{k.shape[0]} keys into {small.n_slots} slots")


def partitioned_bound_ms(spec, n: int, slots: int, sectors=0, updates=0):
    """The bound of rows 2/4 (bits) or 10/12 (counters) for n keys, plus the
    partition's valid bytes: 1 B a slot. The kernels read a slot's valid
    byte first and load its key only when it is set, and the invalid slots
    are each segment row's tail, so only the n valid keys' 8 B move."""
    extra = slots
    if spec.is_counting:
        return counting_bound_ms(spec, n, "add", sectors, updates,
                                 extra_bytes=extra)
    return bound_ms(spec, n, "add", extra_bytes=extra)


def counting_path_turns(spec, first: torch.Tensor, n_seg: int, label: str,
                        reps: int, rounds: int) -> dict:
    """Both paths of ``countingbf.update_partitioned`` (the grouped one
    where it fits) on one batch at ``n_seg``, in turns on zeroed counters:
    {path: ms}, the rule's path under "rule"."""
    part = ops._partition_device(spec, first, n_seg, None)
    scratch = V.init(spec, "cuda")
    smem = sbf.partition_smem_bytes("cuda")
    paths = [p for p in cnt.PARTITIONED_PATHS if p == "global"
             or cnt.grouped_fits(spec.storage_words, n_seg,
                                 spec.counter_row_words, smem)]
    t = time_restored_turns(
        {p: (lambda p=p: cnt.update_partitioned(
            spec, scratch, part.keys_by_seg, part.valid, n_seg, "add",
            path=p)) for p in paths}, scratch.zero_, f"{label} {n_seg}",
        reps, rounds)
    t["rule"] = cnt.choose_partitioned_path(n_seg, spec.storage_words,
                                            spec.counter_row_words, smem)
    return t


def bits_path_turns(spec, first: torch.Tensor, n_seg: int, label: str,
                    reps: int, rounds: int) -> dict:
    """Both paths of ``sbf.add_partitioned`` on one batch at ``n_seg``, in
    turns (the OR of the same keys again does the same work): global, and
    shared where a segment fits shared memory. {path: ms}, the rule's path
    under "rule"."""
    part = ops._partition_device(spec, first, n_seg, None)
    scratch = V.init(spec, "cuda")
    smem = sbf.partition_smem_bytes("cuda")
    seg_words = spec.n_words // n_seg
    paths = ["global"] + (["shared"] if seg_words % 4 == 0
                          and seg_words * 4 <= smem else [])
    t = time_turns({p: (lambda p=p: sbf.add_partitioned(
        spec, scratch, part.keys_by_seg, part.valid, n_seg, path=p))
        for p in paths}, f"{label} {n_seg}", reps, rounds)
    t["rule"] = sbf.choose_partitioned_path(
        n_seg, seg_words, part.valid.shape[1], smem, ops.fits_l2(spec))
    if t["rule"] not in t:
        raise AssertionError(f"{label} {n_seg}: the rule's {t['rule']} "
                             f"was not timed")
    return t


def partitioned_grouped_floor_ms(spec, part, chunk: int) -> float:
    """The grouped path's own floor for one partitioned batch: the valid
    bytes and the valid keys read once, and each touched row read and
    written once a chunk that touches it, at the DRAM rate."""
    n_seg, cap = part.valid.shape
    rows = cnt.grouped_rows(spec.storage_words, n_seg,
                            spec.counter_row_words)
    live = part.valid.reshape(-1) != 0
    slot = torch.arange(n_seg * cap, device=live.device)[live]
    h2 = H.hash_keys(part.keys_by_seg.reshape(-1, 2)[live])[1]
    row = H.block_index(h2, spec.n_blocks) % rows
    visit = ((slot // cap) * (-(-cap // chunk)) + (slot % cap) // chunk
             ) * rows + row
    visits = int(torch.unique(visit).numel())
    nbytes = (n_seg * cap + 8 * int(live.sum())
              + 2 * 4 * spec.counter_row_words * visits)
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_partitioned_main(kind: str, regime: str, n: int, errs: dict,
                           records: dict, launches: dict, card: str):
    """Phase 4e, partitioned: ``ops.bloom_add_partitioned`` (sbf) or
    ``ops.counting_update_partitioned`` (countingbf) of n keys into the
    filter of ``filter_for_n_items(n, bits_per_key=16)``, at JAX's default
    n_segments = 8 and at the smallest count whose segment fits shared
    memory; DRAM cells in batches of 2^24 keys. Words against the plain
    version in full; the partition step, the partitioned kernel and the
    atomic kernel timed on one batch. Counters: each call's plan
    (``countingbf.LAST_PARTITIONED_PLAN``) and peak extra memory, both
    paths in turns at n_segments 8, 16, ... up to 16 x the fitting count
    (the rule's path must not be the slower beyond the rounds' spread), and
    the grouped path's floor."""
    counting = kind == "countingbf"
    name = "update_partitioned" if counting else "add_partitioned"
    mod = cnt if counting else sbf
    f = api.filter_for_n_items(n, bits_per_key=16, variant=kind,
                               block_bits=256, device="cuda")
    spec = f.spec
    if ops.fits_l2(spec) != (regime == "L2"):
        raise AssertionError(f"partitioned {kind} {regime}: {spec}")
    label = f"partitioned {kind} {regime}"
    keys = gen_keys(n, 81 if counting else 82)
    batch = n if regime == "L2" else DRAM_BATCH
    half = n // 2
    if counting:
        want = update_in_chunks(
            lambda w, k: cnt.update_plain(spec, w, k, None, "add"),
            V.init(spec, "cuda"), keys)
        want_rm = update_in_chunks(
            lambda w, k: cnt.update_plain(spec, w, k, None, "remove"),
            want.clone(), keys[:half])
    else:
        want = update_in_chunks(functools.partial(sbf.add_plain, spec),
                                V.init(spec, "cuda"), keys)
    sub = keys[:SUBSET]
    first = keys[:batch]
    reps, rounds = (REPS, ROUNDS) if regime == "L2" else (5, 3)
    n_fit = fitting_segments(spec)
    smem = sbf.partition_smem_bytes("cuda")
    counts = [8, n_fit]
    if not counting and regime == "L2":
        # the shared path's side of the rule
        counts.append(spec.n_words * 4 // sbf.SHARED_MAX_SEGMENT_BYTES)
    cell = {}
    for n_seg in counts:
        words = V.init(spec, "cuda")
        torch.cuda.synchronize()
        mod.reset_launches()               # the main path, counted
        t0 = time.perf_counter()
        for chunk in keys.split(batch):
            partitioned_update(spec, words, chunk, n_seg)
        plan = dict(mod.LAST_PARTITIONED_PLAN)
        if counting:
            for chunk in keys[:half].split(batch):
                partitioned_update(spec, words, chunk, n_seg, op="remove")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = mod.LAUNCHES[name]
        if counted == 0:
            raise AssertionError(f"{label}: {name} was not launched")
        launches[name] = launches.get(name, 0) + counted
        errs[name] = max(errs[name],
                         max_err(words, want_rm if counting else want))
        # one batch, the partition step and the kernel apart
        part = ops._partition_device(spec, first, n_seg, None)
        scratch = V.init(spec, "cuda")
        t_part = time_ms(lambda: ops._partition_device(spec, first, n_seg,
                                                       None),
                         f"{label} {n_seg} partition", reps, rounds)
        if counting:
            path = cnt.choose_partitioned_path(
                n_seg, spec.storage_words, spec.counter_row_words, smem)
            if plan["path"] != path:
                raise AssertionError(f"{label}: ran {plan}, not the rule's "
                                     f"{path}")
            t_kernel = time_restored_ms(
                lambda: cnt.update_partitioned(spec, scratch,
                                               part.keys_by_seg, part.valid,
                                               n_seg, "add"),
                scratch.zero_, f"{label} {n_seg} kernel", reps, rounds)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            cnt.update_partitioned(spec, scratch, part.keys_by_seg,
                                   part.valid, n_seg, "remove")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            if peak > 0:
                raise AssertionError(f"{label}: the update allocated "
                                     f"{peak} B; its plan has no workspace")
            how = f"{path}, plan {plan}, peak extra memory {peak} B"
        else:
            path = sbf.choose_partitioned_path(
                n_seg, spec.n_words // n_seg, part.valid.shape[1], smem,
                ops.fits_l2(spec))
            if plan["path"] != path:
                raise AssertionError(f"{label}: ran {plan}, not the rule's "
                                     f"{path}")
            t_kernel = time_ms(lambda: sbf.add_partitioned(
                spec, scratch, part.keys_by_seg, part.valid, n_seg,
                l2_resident=ops.fits_l2(spec)),
                f"{label} {n_seg} kernel", reps, rounds)
            if sbf.LAST_PARTITIONED_PLAN["path"] != path:
                raise AssertionError(f"{label}: timed "
                                     f"{sbf.LAST_PARTITIONED_PLAN}, not the "
                                     f"rule's {path}")
            how = f"{path}, plan {plan}"
        slots = part.valid.numel()
        lo, hi = SPREAD[f"{label} {n_seg} kernel"]
        print(f"main {label}: {spec}, {n} keys in batches of {batch}, "
              f"n_segments {n_seg} ({how}, capacity "
              f"{part.valid.shape[1]}): "
              f"{'add and remove of half' if counting else 'add'} in "
              f"{wall * 1e3:.1f} ms host clock, words equal to the plain "
              f"version's in full, {counted} launches [{card}]; one batch: "
              f"partition {t_part:.4f} ms, kernel {t_kernel:.4f} ms (rounds "
              f"{lo:.4f}-{hi:.4f}), {batch / t_kernel / 1e3:.1f} Mops/s")
        cell[n_seg] = {"partition_ms": t_part, "kernel_ms": t_kernel,
                       "slots": slots, "path": path,
                       "capacity": part.valid.shape[1]}
        del words, part, scratch
    if counting:
        # both paths in turns from n_segments 8 up: the rule's sweep
        sweep, wrong, rows = {}, [], []
        n_seg = 8
        while n_seg <= 16 * n_fit:
            t = counting_path_turns(spec, first, n_seg, f"{label} paths",
                                    reps, rounds)
            sweep[n_seg] = t
            rule = t["rule"]
            for other in cnt.PARTITIONED_PATHS:
                if other == rule or other not in t:
                    continue
                hi_other = SPREAD[f"{label} paths {n_seg} {other}"][1]
                if (t[rule] > hi_other and t[rule] > 1.05 * t[other]
                        and t[rule] - t[other] > 0.005):
                    wrong.append((n_seg, rule, t[rule], other, t[other]))
            rows.append(f"{n_seg}: global {t['global']:.4f}"
                        + (f" / grouped {t['grouped']:.4f}"
                           if "grouped" in t else "") + f" (rule {rule})")
            n_seg *= 2
        print(f"time {label} paths in turns [{card}] (one batch of {batch} "
              f"keys, add into zeroed counters; n_segments: ms): "
              + ", ".join(rows))
        if wrong:
            raise AssertionError(f"{label}: the rule picks the slower path "
                                 f"at (n_segments, rule, ms, other, ms) "
                                 f"{wrong}")
        t_global = sweep[n_fit]["global"]
        fpart = ops._partition_device(spec, first, n_fit, None)
        floor_ms = partitioned_grouped_floor_ms(spec, fpart,
                                                cnt.GROUPED_CHUNK)
        del fpart
        print(f"{label}: at each of {len(sweep)} counts the rule's path is "
              f"the faster one within the rounds' spread; the grouped "
              f"path's floor at n_segments {n_fit} (valid bytes and keys "
              f"once, each touched row read and written once a chunk) "
              f"{floor_ms:.4f} ms a batch")
        want_first = update_in_chunks(
            lambda w, k: cnt.update_plain(spec, w, k, None, "add"),
            V.init(spec, "cuda"), first)
    else:
        # both paths in turns from n_segments 8 up: the rule's sweep
        sweep, wrong, rows = {}, [], []
        n_seg = min(8, n_fit)
        while n_seg <= 16 * n_fit:
            t = bits_path_turns(spec, first, n_seg, f"{label} paths", reps,
                                rounds)
            sweep[n_seg] = t
            rule = t["rule"]
            for other in sbf.PARTITIONED_PATHS:
                if other == rule or other not in t:
                    continue
                hi_other = SPREAD[f"{label} paths {n_seg} {other}"][1]
                if (t[rule] > hi_other and t[rule] > 1.05 * t[other]
                        and t[rule] - t[other] > 0.005):
                    wrong.append((n_seg, rule, t[rule], other, t[other]))
            rows.append(f"{n_seg}: " + " / ".join(
                f"{p} {t[p]:.4f}" for p in sbf.PARTITIONED_PATHS if p in t)
                + f" (rule {rule})")
            n_seg *= 2
        print(f"time {label} paths in turns [{card}] (one batch of {batch} "
              f"keys; n_segments: ms): " + ", ".join(rows))
        if wrong:
            raise AssertionError(f"{label}: the rule picks the slower path "
                                 f"at (n_segments, rule, ms, other, ms) "
                                 f"{wrong}")
        print(f"{label}: at each of {len(sweep)} counts the rule's path is "
              f"the faster one within the rounds' spread")
        t_global = sweep[n_fit]["global"]
        part = ops._partition_device(spec, first, n_fit, None)
        scratch = V.init(spec, "cuda")
        sbf.add_partitioned(spec, scratch, part.keys_by_seg, part.valid,
                            n_fit, l2_resident=ops.fits_l2(spec))
        want_first = update_in_chunks(functools.partial(sbf.add_plain,
                                                        spec),
                                      V.init(spec, "cuda"), first)
        errs[name] = max(errs[name], max_err(scratch, want_first))
    # beside them: the atomic kernel of rows 2/4 or 10/12 on the same batch
    scratch = V.init(spec, "cuda")
    if counting:
        t_atomic = time_restored_ms(
            lambda: (cnt.update_vmem if regime == "L2" else cnt.update_hbm)(
                spec, scratch, first, None, "add"), scratch.zero_,
            f"{label} atomic", reps, rounds)
    else:
        t_atomic = time_ms(
            lambda: (sbf.add_vmem(spec, scratch, first) if regime == "L2"
                     else sbf.add_hbm(spec, scratch, first)),
            f"{label} atomic", reps, rounds)
    # kernel vs plain and bound on 2^22 keys at the fitting n_segments
    part = ops._partition_device(spec, sub, n_fit, None)
    scratch = V.init(spec, "cuda")
    if counting:
        t_sub = time_restored_ms(lambda: cnt.update_partitioned(
            spec, scratch, part.keys_by_seg, part.valid, n_fit, "add"),
            scratch.zero_, f"{label} sub")
        t_plain = time_ms(lambda: cnt.update_partitioned_plain(
            spec, V.init(spec, "cuda"), part.keys_by_seg, part.valid, "add"),
            f"{label} plain", PLAIN_REPS, PLAIN_ROUNDS)
        sub_words = cnt.update_plain(spec, V.init(spec, "cuda"), sub, None,
                                     "add")
        b_sub = partitioned_bound_ms(spec, SUBSET, part.valid.numel(),
                                     touched_sectors(sub_words),
                                     counter_updates(spec, sub))
        b_batch = partitioned_bound_ms(
            spec, batch, cell[n_fit]["slots"], touched_sectors(want_first),
            counter_updates(spec, first))
    else:
        t_sub = time_ms(lambda: sbf.add_partitioned(
            spec, scratch, part.keys_by_seg, part.valid, n_fit,
            l2_resident=ops.fits_l2(spec)), f"{label} sub")
        t_plain = time_ms(lambda: sbf.add_partitioned_plain(
            spec, V.init(spec, "cuda"), part.keys_by_seg, part.valid),
            f"{label} plain", PLAIN_REPS, PLAIN_ROUNDS)
        b_sub = partitioned_bound_ms(spec, SUBSET, part.valid.numel())
        b_batch = partitioned_bound_ms(spec, batch, cell[n_fit]["slots"])
    n_batches = -(-n // batch)
    print(f"time {label} [{card}]: one batch of {batch} keys: atomic kernel "
          f"{t_atomic:.4f} ms; " + "; ".join(
              f"n_segments {s}: partition {c['partition_ms']:.4f} + kernel "
              f"{c['kernel_ms']:.4f} ms" for s, c in cell.items())
          + f"; bound {b_batch[0]:.4f} ms ({b_batch[1]}); cell ({n_batches} "
          f"batch{'es' if n_batches > 1 else ''}) kernel at n_segments "
          f"{n_fit} {n_batches * cell[n_fit]['kernel_ms']:.4f} ms; at "
          f"{SUBSET} keys kernel {t_sub:.4f} ms, plain {t_plain:.4f} ms, "
          f"bound {b_sub[0]:.4f} ms ({b_sub[1]})")
    rec = records.setdefault(name, {
        "name": name, "route": "cuda",
        "source": COUNTING_SOURCE if counting else SOURCE,
        "replaces": PART_REPLACES[name], "launches": 0, "max_abs_err": 0,
        "library_ms": None, "n_keys": SUBSET})
    rec["cuda_kernels"] = (["counting_partitioned_grouped_kernel",
                            "counting_partitioned_global_kernel"]
                           if counting else
                           ["bloom_add_partitioned_global_kernel",
                            "bloom_add_partitioned_shared_kernel"])
    prefix = "" if regime == "L2" else "dram_"
    if regime == "L2":
        rec.update({"ms": t_sub, "plain_ms": t_plain, "bound_ms": b_sub[0],
                    "bound_by": b_sub[1], "m_bits": spec.m_bits,
                    "n_segments": n_fit})
    rec.update({f"{prefix}main_n_keys": n, f"{prefix}batch": batch,
                f"{prefix}atomic_ms": t_atomic,
                f"{prefix}batch_bound_ms": b_batch[0],
                f"{prefix}global_ms": t_global,
                f"{prefix}cells": {str(s): c for s, c in cell.items()},
                f"{prefix}sweep_ms": {str(s): v for s, v in sweep.items()}})
    if counting:
        rec[f"{prefix}grouped_floor_ms"] = floor_ms
    del keys, want, want_first, scratch, part
    if counting:
        del want_rm
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def plain_bucket_accesses(fn):
    """``fn()`` with the plain cuckoo loop's bucket reads and writes
    counted: (result, reads, writes), the dependent accesses the update's
    bound counts."""
    count = {"read": 0, "write": 0}
    read, write = F._bucket_slots, F._store_bucket

    def counted_read(*a):
        count["read"] += 1
        return read(*a)

    def counted_write(*a):
        count["write"] += 1
        return write(*a)

    F._bucket_slots, F._store_bucket = counted_read, counted_write
    try:
        out = fn()
    finally:
        F._bucket_slots, F._store_bucket = read, write
    return out, count["read"], count["write"]


def cuckoo_update_bound_ms(spec, n: int, reads: int, writes: int):
    """Least time of an update: 8 B of key and 1 B of flag a key, one
    32-byte sector a dependent bucket read and a write (at most the table,
    read and written once); 40 operations a key for the hashes and 10 a
    bucket access. Beside it the script reports two floors of schedules,
    not bounds of the work: the one-thread order's (the reads times
    ``dependent_load_ns``) and the windowed kernel's (its rounds' longest
    chains, ``chain_reads``, times ``dependent_load_ns``)."""
    table = spec.n_words * 4
    nbytes = 9 * n + min(32 * reads, table) + min(32 * writes, table)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (40 * n + 10 * (reads + writes)) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dependent_load_ns(nbytes: int, stride: int, steps: int = 1 << 17,
                      dram: bool = False) -> float:
    """ns a load of one thread's chain of dependent loads through a random
    cycle over ``nbytes`` on the card (a link every ``stride`` bytes): the
    round trip each of the cuckoo update's chained bucket reads waits for.
    The buffer is read once beforehand, so it stays in L2 where it fits;
    with ``dram`` a 128 MiB write empties L2 before each call (the chain's
    2^17 links would otherwise stay there from the call before). Median of
    3 calls, by CUDA events."""
    step = stride // 4
    nodes = (nbytes // 4) // step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(95)
    order = torch.randperm(nodes, device="cuda", generator=gen) * step
    chain = torch.zeros(nbytes // 4, dtype=torch.int32, device="cuda")
    chain[order] = torch.roll(order, -1).to(torch.int32)   # one cycle, word 0 in it
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    int(chain.sum())
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def chase():
        if lib.cuckoo_chase(chain.data_ptr(), steps, out.data_ptr(), stream):
            raise RuntimeError("cuckoo_chase did not launch")

    if dram:
        junk = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
        ms = time_restored_ms(chase, junk.zero_, "dependent load DRAM", 1, 3,
                              warmup=1)
    else:
        ms = time_ms(chase, "dependent load", 1, 3, warmup=1)
    return ms * 1e6 / steps


def cuckoo_contains_bound_ms(spec, table, keys):
    """Least time of a contains: 8 B of key and 1 B of result a key, and one
    32-byte sector for its primary bucket and one more where the primary
    bucket misses, at most the table once; 40 operations a key and 8 a
    bucket."""
    second = primary_misses(spec, table, keys)
    n = keys.shape[0]
    nbytes = 9 * n + min(32 * (n + second), spec.n_words * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (40 * n + 8 * (n + second)) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def primary_misses(spec, table, keys) -> int:
    """Keys whose primary bucket does not hold their fingerprint (in
    SUBSET-key chunks)."""
    out = 0
    for chunk in keys.split(SUBSET):
        b1, fp, _ = F.cuckoo_hashes(spec, chunk)
        out += int((~F._hit(spec, table, b1, fp)).sum())
    return out


def cuckoo_cell_bounds(spec, n_keys: dict, missing: int) -> dict:
    """Bounds of a cell's full-size updates, whose own bucket accesses the
    plain loop cannot count at that size: at least one sector read a key,
    and written for every add and every remove that found its key."""
    return {k: cuckoo_update_bound_ms(
        spec, n, n, n - missing if k == "remove" else n)
        for k, n in n_keys.items()}


def counters_line(label: str, stats, load_ns: float) -> dict:
    """The apply kernel's counters of one update, read, printed and kept,
    with the windowed floor: the rounds' longest chains times
    ``load_ns``."""
    c = stats.read()
    c["window_floor_ms"] = c["chain_reads"] * load_ns * 1e-6
    print(f"  counters {label}: {c['rounds']} rounds, keys a round mean "
          f"{c['mean_committed']:.1f} min {c['min_committed']} max "
          f"{c['max_committed']}; rounds ended on a conflict "
          f"{c['conflict_rounds']}, on a capped key {c['capped_rounds']}; "
          f"keys finished alone {c['alone_keys']}; longest chains "
          f"{c['chain_reads']} reads ({c['window_floor_ms']:.3f} ms at "
          f"{load_ns:.1f} ns), all reads {c['reads']}")
    return c


def phase_cuckoo_main(errs: dict, records: dict, launches: dict, card: str):
    """Phase 4e, cuckoo: ``filter_for_n_items(2^22, bits_per_key=16,
    variant="cuckoo")`` (u16 slots, 2^21 buckets of 4, 16 MiB); add 2^22
    keys (load 0.5), add 3,355,443 more (load 0.9), contains of all keys and
    of 2^22 probes, remove of half, contains of the rest. Invariants in
    full; every contains against the plain version in full; the update
    words and flags against the plain version and the kernel at window 1
    on 2^18 keys into the full table (fresh; from the load-0.9 table a
    remove, and an add of 2^16 keys, whose kick chains make the plain loop
    slow); the apply kernel's counters of the three full-size updates."""
    n1, n2 = 1 << 22, 3355443
    f = api.filter_for_n_items(n1, bits_per_key=16, variant="cuckoo",
                               device="cuda")
    spec = f.spec
    if (f.backend != "cuckoo" or spec.slot_bits != 16
            or spec.slots_per_bucket != 4 or spec.n_buckets != 1 << 21
            or f.nbytes != 16 << 20):
        raise AssertionError(f"cuckoo cell: {f}")
    keys1, keys2 = gen_keys(n1, 91), gen_keys(n2, 92)
    allkeys = torch.cat([keys1, keys2])
    probes = gen_keys(SUBSET, 93, probe=True)
    half = allkeys.shape[0] // 2
    torch.cuda.synchronize()
    steps = ("add", "add more", "contains", "contains probes", "remove",
             "contains rest")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
    ckoo.reset_launches()                  # the main path, counted
    t0 = time.perf_counter()
    ev[0].record()
    g1 = f.add(keys1)
    s_add = ckoo.LAST_UPDATE_STATS["add_vmem"]
    ev[1].record()
    g2 = g1.add(keys2)
    s_more = ckoo.LAST_UPDATE_STATS["add_vmem"]
    ev[2].record()
    hits = g2.contains(allkeys)
    ev[3].record()
    false_pos = g2.contains(probes)
    ev[4].record()
    g3 = g2.remove(allkeys[:half])
    s_remove = ckoo.LAST_UPDATE_STATS["remove_vmem"]
    ev[5].record()
    kept = g3.contains(allkeys[half:])
    ev[6].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = {s: ev[i].elapsed_time(ev[i + 1]) for i, s in enumerate(steps)}
    counted = dict(ckoo.LAUNCHES)
    if counted != {"contains_vmem": 3, "add_vmem": 2, "remove_vmem": 1}:
        raise AssertionError(f"cuckoo cell: launches {counted}")
    launches["cuckoo_contains"] = counted["contains_vmem"]
    launches["cuckoo_update"] = counted["add_vmem"] + counted["remove_vmem"]
    # invariants, in full
    fails1, fails2 = int(g1.insert_failures), int(g2.insert_failures)
    occ1 = int(F.occupied_slots(spec, g1.words))
    occ2 = int(F.occupied_slots(spec, g2.words))
    occ3 = int(F.occupied_slots(spec, g3.words))
    if occ1 != n1 - fails1 or occ2 != n1 + n2 - fails2:
        raise AssertionError(f"cuckoo cell: occupied {occ1}/{occ2} != sum "
                             f"ok {n1 - fails1}/{n1 + n2 - fails2}")
    # a failed insert leaves one fingerprint homeless (the kick chain's last
    # victim, maybe another key's): with no failure every key is found and
    # every removed key clears a slot; with f failures at most f keys of
    # the same fingerprint and bucket pair can miss
    missing = half - (occ2 - occ3)             # removes that found nothing
    neg, neg_kept = int((~hits).sum()), int((~kept).sum())
    if max(missing, neg, neg_kept) > fails2:
        raise AssertionError(f"cuckoo cell: {neg} false negatives, {missing}"
                             f" removes not found, {neg_kept} false negatives"
                             f" after the remove, for {fails2} failed inserts")
    plain_contains = functools.partial(ckoo.contains_plain, spec)
    e = errs["cuckoo_contains"]
    e = max(e, max_err(hits, contains_in_chunks(plain_contains, g2.words,
                                                allkeys)))
    e = max(e, max_err(false_pos, plain_contains(g2.words, probes)))
    e = max(e, max_err(kept, contains_in_chunks(plain_contains, g3.words,
                                                allkeys[half:])))
    errs["cuckoo_contains"] = e
    load = occ2 / spec.n_slots
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = F.fpr_cuckoo(spec.slot_bits, spec.slots_per_bucket, load)
    # the update against the plain version and the kernel at window 1 on
    # 2^18 keys into the full table
    sub1 = keys1[:CUCKOO_SUB]
    sub2 = gen_keys(CUCKOO_SUB // 4, 94)        # an insert at 0.9 kicks a lot
    checks = []
    for label, start, k, op in (("fresh add", F.init(spec, "cuda"), sub1,
                                 "add"),
                                ("add at load 0.9", g2.words, sub2, "add"),
                                ("remove at load 0.9", g2.words,
                                 allkeys[:CUCKOO_SUB], "remove")):
        t_p = time.perf_counter()
        (want, flags), reads, writes = plain_bucket_accesses(
            lambda: ckoo.update_plain(spec, start, k, None, op))
        t_p = time.perf_counter() - t_p
        cuckoo_windows(spec, start, k, None, op, F.CUCKOO_ADD_TILE, want,
                       flags, errs, windows=(ckoo.WINDOW, 1))
        if op == "remove" and int((~flags).sum()) > fails2:
            raise AssertionError("cuckoo cell: removes not found beyond the "
                                 "failed inserts")
        checks.append((label, k, start, op, reads, writes,
                       int((~flags).sum()), t_p))
    print(f"main cuckoo [{card}]: {spec} on {g2.backend}, "
          f"{f.nbytes / 2**20:.0f} MiB: add {n1} (load {occ1 / spec.n_slots:.4f}),"
          f" add {n2} (load {load:.4f}), contains {allkeys.shape[0]} + "
          f"{SUBSET} probes, remove {half}, contains {allkeys.shape[0] - half} "
          f"in {wall * 1e3:.1f} ms host clock; insert failures {fails1} / "
          f"{fails2}; occupied slots = sum ok; {neg} false negatives, "
          f"{missing} removes not found, {neg_kept} false negatives after "
          f"the remove (each at most the failures); every contains equal to "
          f"the plain version's in full; the update's words and flags at "
          f"window {ckoo.WINDOW} and 1 equal to the plain version's into the "
          f"full table: " + ", ".join(
              f"{c[0]} of {c[1].shape[0]} keys ({c[6]} failed)"
              for c in checks)
          + f"; FPR {fpr:.6f} at load {load:.4f}, {fpr / theory:.3f} x "
          f"fpr_cuckoo {theory:.6f}; launches {counted} (an update call "
          f"launches the order and the apply kernel)")
    print(f"time cuckoo main path [{card}] (Filter calls, CUDA events, one "
          f"run): " + ", ".join(f"{s} {v:.4f} ms" for s, v in step_ms.items()))
    load_ns = dependent_load_ns(spec.n_words * 4,
                                spec.n_words * 4 // spec.n_buckets)
    print(f"time dependent load [{card}]: {load_ns:.1f} ns a load, one "
          f"thread's chain through {spec.n_words * 4 >> 20} MiB in L2")
    print(f"cuckoo main path counters [{card}] (window {ckoo.WINDOW}, step "
          f"cap {ckoo.STEP_CAP}):")
    main_counters = {"add": counters_line(f"add {n1}", s_add, load_ns),
                     "add more": counters_line(f"add {n2}", s_more, load_ns),
                     "remove": counters_line(f"remove {half}", s_remove,
                                             load_ns)}
    # times: the kernels alone (the full-size updates one call each, on
    # restored state, beside the main path's own run), the plain version
    # and the bounds on 2^18 keys
    scratch = f.words.clone()
    t = {"add": time_restored_ms(
            lambda: ckoo.add_vmem(spec, scratch, keys1, None),
            scratch.zero_, "cuckoo add", 1, 1, warmup=0),
         "add more": time_restored_ms(
            lambda: ckoo.add_vmem(spec, scratch, keys2, None),
            lambda: scratch.copy_(g1.words), "cuckoo add more", 1, 1,
            warmup=0),
         "remove": time_restored_ms(
            lambda: ckoo.remove_vmem(spec, scratch, allkeys[:half], None),
            lambda: scratch.copy_(g2.words), "cuckoo remove", 1, 1,
            warmup=0),
         "contains": time_ms(lambda: ckoo.contains_vmem(spec, g2.words,
                                                        allkeys),
                             "cuckoo contains"),
         "Filter.contains": time_ms(lambda: g2.contains(allkeys),
                                    "cuckoo Filter.contains"),
         "contains sub": time_ms(lambda: ckoo.contains_vmem(
            spec, g2.words, torch.cat([keys1[: SUBSET // 2],
                                       probes[: SUBSET // 2]])),
            "cuckoo contains sub"),
         "contains plain": time_ms(lambda: ckoo.contains_plain(
            spec, g2.words, torch.cat([keys1[: SUBSET // 2],
                                       probes[: SUBSET // 2]])),
            "cuckoo contains plain", PLAIN_REPS, PLAIN_ROUNDS)}
    # the checks' updates again, the kernel alone on the same keys and
    # table (and at window 1), beside their counted accesses' bound, the
    # one-thread floor (those reads one after another) and the windowed
    # floor (the rounds' longest chains)
    upd = {}
    for label, k, start, op, reads, writes, failed, t_p in checks:
        fn = ckoo.add_vmem if op == "add" else ckoo.remove_vmem
        ms = time_restored_ms(lambda fn=fn, k=k: fn(spec, scratch, k, None),
                              lambda start=start: scratch.copy_(start),
                              f"cuckoo {label}", 1, 3, warmup=1)
        counters = ckoo.LAST_UPDATE_STATS[fn.__name__].read()
        ms_1 = time_restored_ms(
            lambda fn=fn, k=k: fn(spec, scratch, k, None, window=1),
            lambda start=start: scratch.copy_(start), f"cuckoo {label} w1",
            1, 1, warmup=0)
        b = cuckoo_update_bound_ms(spec, k.shape[0], reads, writes)
        upd[label] = {"n_keys": k.shape[0], "ms": ms, "window1_ms": ms_1,
                      "plain_ms": t_p * 1e3, "reads": reads,
                      "writes": writes, "failed": failed,
                      "bound_ms": b[0], "bound_by": b[1],
                      "one_thread_floor_ms": reads * load_ns * 1e-6,
                      "window_floor_ms": counters["chain_reads"] * load_ns
                      * 1e-6, "counters": counters}
    b_con = cuckoo_contains_bound_ms(spec, g2.words, torch.cat(
        [keys1[: SUBSET // 2], probes[: SUBSET // 2]]))
    b_con_full = cuckoo_contains_bound_ms(spec, g2.words, allkeys)
    for label, u in upd.items():
        c = u["counters"]
        print(f"time cuckoo {label} [{card}]: {u['n_keys']} keys "
              f"({u['failed']} failed): kernel {u['ms']:.4f} ms (median of "
              f"3 calls; window 1: {u['window1_ms']:.4f} ms), plain "
              f"{u['plain_ms']:.1f} ms host clock, {u['reads']} bucket "
              f"reads and {u['writes']} writes, bound {u['bound_ms']:.4f} ms "
              f"({u['bound_by']}, {u['bound_ms'] / u['ms']:.4%} of the "
              f"kernel); one-thread floor (reads x {load_ns:.1f} ns) "
              f"{u['one_thread_floor_ms']:.4f} ms; windowed floor "
              f"({c['rounds']} rounds, {c['chain_reads']} reads on their "
              f"longest chains) {u['window_floor_ms']:.4f} ms "
              f"({u['window_floor_ms'] / u['ms']:.1%} of the kernel); "
              f"{c['mean_committed']:.1f} keys a round, "
              f"{c['alone_keys']} finished alone")
    full_floor = {k: v["window_floor_ms"] for k, v in main_counters.items()}
    full_bound = cuckoo_cell_bounds(spec, {"add": n1, "add more": n2,
                                           "remove": half}, missing)
    print(f"time cuckoo update [{card}]: kernel add {t['add']:.4f} ms at "
          f"{n1} keys ({n1 / t['add'] / 1e3:.2f} Mops/s), add more "
          f"{t['add more']:.4f} ms at {n2} ({n2 / t['add more'] / 1e3:.2f} "
          f"Mops/s), remove {t['remove']:.4f} ms at {half} "
          f"({half / t['remove'] / 1e3:.2f} Mops/s) (one call each); "
          f"windowed floors " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                          full_floor.items())
          + "; bounds at one sector a key (a lower bound) " + ", ".join(
              f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in full_bound.items()))
    print(f"time cuckoo contains [{card}]: kernel {t['contains']:.4f} ms at "
          f"{allkeys.shape[0]} keys ({allkeys.shape[0] / t['contains'] / 1e3:.1f}"
          f" Mops/s), bound {b_con_full[0]:.4f} ms, Filter.contains "
          f"{t['Filter.contains']:.4f} ms; at {SUBSET} keys (half probes) "
          f"kernel {t['contains sub']:.4f} ms, plain {t['contains plain']:.4f}"
          f" ms, bound {b_con[0]:.4f} ms ({b_con[1]})")
    records["cuckoo_contains"] = {
        "name": "cuckoo_contains", "route": "cuda", "source": CUCKOO_SOURCE,
        "replaces": CUCKOO_REPLACES["cuckoo_contains"],
        "launches": launches["cuckoo_contains"],
        "max_abs_err": errs["cuckoo_contains"], "ms": t["contains sub"],
        "plain_ms": t["contains plain"], "bound_ms": b_con[0],
        "bound_by": b_con[1], "library_ms": None, "n_keys": SUBSET,
        "m_bits": spec.m_bits, "main_n_keys": allkeys.shape[0],
        "main_ms": t["contains"], "main_bound_ms": b_con_full[0],
        "api_ms": t["Filter.contains"]}
    at09 = upd["add at load 0.9"]          # the cell's regime, headline
    records["cuckoo_update"] = {
        "name": "cuckoo_update", "route": "cuda", "source": CUCKOO_SOURCE,
        "replaces": CUCKOO_REPLACES["cuckoo_update"],
        "design": "cuckoo_order_kernel + cuckoo_apply_kernel (windowed: "
                  "speculate, validate, commit in order)",
        "kernels_a_call": 2,
        "launches": launches["cuckoo_update"],
        "max_abs_err": errs["cuckoo_update"], "ms": at09["ms"],
        "plain_ms": at09["plain_ms"], "bound_ms": at09["bound_ms"],
        "bound_by": at09["bound_by"], "library_ms": None,
        "n_keys": at09["n_keys"], "m_bits": spec.m_bits,
        "window": ckoo.WINDOW, "step_cap": ckoo.STEP_CAP,
        "one_thread_floor_ms": at09["one_thread_floor_ms"],
        "window_floor_ms": at09["window_floor_ms"], "load_ns": load_ns,
        "checks": upd, "main_add_ms": t["add"],
        "main_add_more_ms": t["add more"], "main_remove_ms": t["remove"],
        "main_counters": main_counters, "main_bound_ms": {
            k: v[0] for k, v in full_bound.items()}, "api_step_ms": step_ms,
        "insert_failures": fails2, "fpr": fpr, "fpr_theory": theory}
    del g1, g2, g3, scratch, allkeys, keys1, keys2
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


CUCKOO_DRAM_N = 1 << 27        # keys of the DRAM cuckoo cell (load 0.5)
TOP_UP_S = 60.0                # smoke time the DRAM top-up to 0.9 may take


def phase_cuckoo_dram(errs: dict, records: dict, card: str,
                      l2_more_ms: float):
    """Phase 4e, the DRAM cuckoo cell: ``filter_for_n_items(2^27,
    bits_per_key=16, variant="cuckoo")`` (u16 x 4, 2^26 buckets, 512 MiB,
    2^27 words); add 2^27 keys (load 0.5), then, where 32 x the L2 cell's
    measured add from load 0.5 to 0.9 fits in ``TOP_UP_S``, add keys to
    load 0.9; contains of every key and of 2^22 probes, remove half,
    contains of the rest. The invariants of the L2 cell; every contains
    against the plain version in 2^22-key chunks; the update at the default
    window against the kernel at window 1 (the serial order; the plain
    update cannot hold a Python list of 2^28 slots) on 2^18 keys, into the
    empty table and into the load-0.5 table; counters of every update."""
    n = CUCKOO_DRAM_N
    f = api.filter_for_n_items(n, bits_per_key=16, variant="cuckoo",
                               device="cuda")
    spec = f.spec
    if (f.backend != "cuckoo" or spec.slot_bits != 16
            or spec.slots_per_bucket != 4 or spec.n_buckets != 1 << 26
            or f.nbytes != 512 << 20 or spec.n_words != 1 << 27
            or not ckoo.kernel_supported(spec)):
        raise AssertionError(f"cuckoo DRAM cell: {f}")
    estimate_s = 32 * l2_more_ms / 1e3
    top_up = estimate_s <= TOP_UP_S
    n_more = int(spec.n_slots * 0.9) - n if top_up else 0
    keys = gen_keys(n, 191)
    if top_up:
        keys = torch.cat([keys, gen_keys(n_more, 192)])
    probes = gen_keys(SUBSET, 193, probe=True)
    total = keys.shape[0]
    half = total // 2
    torch.cuda.synchronize()
    steps = ["add"] + (["add more"] if top_up else []) + [
        "contains", "contains probes", "remove", "contains rest"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
    snaps = {}
    ckoo.reset_launches()                  # this main path, counted
    t0 = time.perf_counter()
    ev[0].record()
    g = f.add(keys[:n])
    snaps["add"] = ckoo.LAST_UPDATE_STATS["add_vmem"]
    g1 = g
    i = 1
    if top_up:
        ev[i].record()
        g = g.add(keys[n:])
        snaps["add more"] = ckoo.LAST_UPDATE_STATS["add_vmem"]
        i += 1
    ev[i].record()
    hits = g.contains(keys)
    ev[i + 1].record()
    false_pos = g.contains(probes)
    ev[i + 2].record()
    g3 = g.remove(keys[:half])
    snaps["remove"] = ckoo.LAST_UPDATE_STATS["remove_vmem"]
    ev[i + 3].record()
    kept = g3.contains(keys[half:])
    ev[i + 4].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = {s: ev[j].elapsed_time(ev[j + 1]) for j, s in enumerate(steps)}
    counted = dict(ckoo.LAUNCHES)
    want_launches = {"contains_vmem": 3, "add_vmem": 1 + top_up,
                     "remove_vmem": 1}
    if counted != want_launches:
        raise AssertionError(f"cuckoo DRAM cell: launches {counted}")
    records["cuckoo_contains"]["launches"] += counted["contains_vmem"]
    fails1, fails = int(g1.insert_failures), int(g.insert_failures)
    occ1 = int(F.occupied_slots(spec, g1.words))
    occ2 = int(F.occupied_slots(spec, g.words))
    occ3 = int(F.occupied_slots(spec, g3.words))
    if occ1 != n - fails1 or occ2 != total - fails:
        raise AssertionError(f"cuckoo DRAM cell: occupied {occ1}/{occ2} != "
                             f"sum ok {n - fails1}/{total - fails}")
    missing = half - (occ2 - occ3)
    neg, neg_kept = int((~hits).sum()), int((~kept).sum())
    if max(missing, neg, neg_kept) > fails:
        raise AssertionError(f"cuckoo DRAM cell: {neg} false negatives, "
                             f"{missing} removes not found, {neg_kept} after "
                             f"the remove, for {fails} failed inserts")
    plain_contains = functools.partial(ckoo.contains_plain, spec)
    e = errs["cuckoo_contains"]
    e = max(e, max_err(hits, contains_in_chunks(plain_contains, g.words,
                                                keys)))
    e = max(e, max_err(false_pos, plain_contains(g.words, probes)))
    e = max(e, max_err(kept, contains_in_chunks(plain_contains, g3.words,
                                                keys[half:])))
    errs["cuckoo_contains"] = e
    load = occ2 / spec.n_slots
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = F.fpr_cuckoo(spec.slot_bits, spec.slots_per_bucket, load)
    # the default window against window 1, the serial order, on 2^18 keys
    sub = gen_keys(CUCKOO_SUB, 194)
    w1 = {}
    for label, start in (("fresh add", F.init(spec, "cuda")),
                         ("add at load 0.5", g1.words)):
        ev_w = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev_w[0].record()
        got, ok = ckoo.add_vmem(spec, start.clone(), sub, None)
        ev_w[1].record()
        counters = ckoo.LAST_UPDATE_STATS["add_vmem"].read()
        ev_w[2].record()
        want, want_ok = ckoo.add_vmem(spec, start.clone(), sub, None,
                                      window=1)
        ev_w[3].record()
        errs["cuckoo_update"] = max(errs["cuckoo_update"],
                                    max_err(got, want), max_err(ok, want_ok))
        w1[label] = {"ms": ev_w[0].elapsed_time(ev_w[1]),
                     "window1_ms": ev_w[2].elapsed_time(ev_w[3]),
                     "counters": counters}
        del got, want
    load_ns = dependent_load_ns(1 << 30, SECTOR, dram=True)
    print(f"main cuckoo DRAM [{card}]: {spec} on {g.backend}, "
          f"{f.nbytes / 2**20:.0f} MiB, {spec.n_words} words: add {n} "
          f"(load {occ1 / spec.n_slots:.4f})"
          + (f", add {n_more} (load {load:.4f})" if top_up else
             f"; no top-up to load 0.9: 32 x the L2 cell's add from 0.5 to "
             f"0.9 ({l2_more_ms:.1f} ms) is {estimate_s:.1f} s, past "
             f"{TOP_UP_S:.0f} s") +
          f"; contains {total} + {SUBSET} probes, remove {half}, contains "
          f"{total - half} in {wall:.1f} s host clock; insert failures "
          f"{fails1} / {fails}; occupied slots = sum ok; {neg} false "
          f"negatives, {missing} removes not found, {neg_kept} false "
          f"negatives after the remove; every contains equal to the plain "
          f"version's (2^22-key chunks); the update at window "
          f"{ckoo.WINDOW} equal to window 1 on {CUCKOO_SUB} keys, fresh "
          f"and into the load-0.5 table; FPR {fpr:.6f} at load {load:.4f} "
          f"({fpr / theory:.3f} x fpr_cuckoo); launches {counted}")
    print(f"time cuckoo DRAM main path [{card}] (Filter calls, CUDA events, "
          f"one run): " + ", ".join(f"{s} {v:.4f} ms"
                                    for s, v in step_ms.items()))
    print(f"time dependent load [{card}]: {load_ns:.1f} ns a load, one "
          f"thread's chain through 1024 MiB (DRAM)")
    print(f"cuckoo DRAM counters [{card}]:")
    counters = {k: counters_line(k, v, load_ns) for k, v in snaps.items()}
    sizes = {"add": n, "add more": n_more, "remove": half}
    bounds = cuckoo_cell_bounds(spec, {k: sizes[k] for k in snaps}, missing)
    print(f"time cuckoo DRAM update [{card}]: " + ", ".join(
        f"{k} {step_ms[k]:.4f} ms at {sizes[k]} keys "
        f"({sizes[k] / step_ms[k] / 1e3:.2f} Mops/s), bound at one sector a "
        f"key {bounds[k][0]:.4f} ms ({bounds[k][1]}, "
        f"{bounds[k][0] / step_ms[k]:.3%})" for k in snaps))
    for label, r in w1.items():
        print(f"time cuckoo DRAM {label} [{card}]: {CUCKOO_SUB} keys, "
              f"window {ckoo.WINDOW} {r['ms']:.4f} ms, window 1 "
              f"{r['window1_ms']:.4f} ms ({r['window1_ms'] / r['ms']:.1f}x), "
              f"{r['counters']['rounds']} rounds, "
              f"{r['counters']['mean_committed']:.1f} keys a round")
    # the three contains of the cell as kernels alone (rounds of calls),
    # their bounds, and the sector floor at the card's random-sector rate
    con = {"contains": (g.words, keys), "contains probes": (g.words, probes),
           "contains rest": (g3.words, keys[half:])}
    tk, cbound = {}, {}
    for label, (words, k) in con.items():
        tk[label] = time_ms(lambda words=words, k=k: ckoo.contains_vmem(
            spec, words, k), f"cuckoo DRAM {label}", 3, 3, warmup=1)
        cbound[label] = cuckoo_contains_bound_ms(spec, words, k)
    misses = primary_misses(spec, g.words, keys)
    rate = random_sector_rate(spec.n_words)
    s_floor = (total + misses) / rate * 1e3
    print(f"time cuckoo DRAM contains [{card}] (kernels alone, median of 3 "
          f"rounds of 3 calls): " + ", ".join(
              f"{k} {tk[k]:.4f} ms at {con[k][1].shape[0]} keys "
              f"({con[k][1].shape[0] / tk[k] / 1e3:.1f} Mops/s), bound "
              f"{cbound[k][0]:.4f} ms ({cbound[k][1]}, "
              f"{cbound[k][0] / tk[k]:.1%})" for k in tk)
          + f"; {misses} primary misses ({misses / total:.1%}); random "
          f"32-byte sectors of a {spec.n_words * 4 >> 20} MiB table "
          f"{rate / 1e9:.2f} G/s (calibrate_gather, this run); sector floor "
          f"of every key (a sector a key, one more a miss) {s_floor:.4f} ms "
          f"({s_floor / tk['contains']:.1%})")
    records["cuckoo_contains"]["dram"] = {
        "n_keys": total, "ms": tk,
        "bound_ms": {k: v[0] for k, v in cbound.items()},
        "primary_misses": misses, "random_sectors_per_s": rate,
        "sector_floor_ms": s_floor, "launches": counted["contains_vmem"]}
    records["cuckoo_update"]["dram"] = {
        "n_keys": n, "n_more": n_more, "top_up": top_up,
        "top_up_estimate_s": estimate_s, "m_bits": spec.m_bits,
        "step_ms": step_ms, "counters": counters, "window1": w1,
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "insert_failures": fails, "load": load, "fpr": fpr,
        "fpr_theory": theory, "load_ns": load_ns, "launches": counted}
    del f, g, g1, g3, keys, hits, kept
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


# members whose fingerprint a timing table holds in the alternate bucket
CUCKOO_ALT_SHARE = {0.5: 0.1, 0.9: 0.35}


def cuckoo_table_at(spec, load: float, members: torch.Tensor,
                    seed: int) -> torch.Tensor:
    """A table at ``load`` for profiling, made without the update (whose
    one-CTA apply takes seconds past L2): random non-zero fingerprints in
    a share ``load`` of the slots, then each member's fingerprint in a
    random lane of its primary bucket or, for ``CUCKOO_ALT_SHARE[load]``
    of them, of its alternate one (a member overwritten by a later one is
    then a probe). The contains' results do not depend on how a table was
    made."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    sb, spb = spec.slot_bits, spec.slots_per_bucket
    slots = torch.randint(1, 1 << sb, (spec.n_slots,), device="cuda",
                          generator=g)
    slots *= torch.rand((spec.n_slots,), device="cuda", generator=g) < load
    b1, fp, _ = F.cuckoo_hashes(spec, members)
    alt = torch.rand((b1.numel(),), device="cuda",
                     generator=g) < CUCKOO_ALT_SHARE[load]
    b = torch.where(alt, F.alt_bucket(spec, b1, fp), b1)
    lane = torch.randint(0, spb, (b1.numel(),), device="cuda", generator=g)
    slots[b * spb + lane] = fp
    return F.pack_slots(spec, slots.view(spec.n_buckets, spb)).view(-1)


def random_sector_rate(n_words: int) -> float:
    """Random 32-byte sectors a second the card reads from a table of
    n_words words (``calibrate.gather``: 2^27 hashed 4-byte reads, each its
    own sector; median of 3 rounds)."""
    table = kc.gather_table(n_words, "cuda")
    n, per = 1 << 22, 32
    out = torch.empty((n,), dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: kc.gather(table, out, per), "random sectors", 3, 3)
    del table, out
    return n * per / ms * 1e3


# ---------------------------------------------------------------------------
# The quotient filter (phases 3f, 4f and their times)
# ---------------------------------------------------------------------------

QUOTIENT_SOURCE = "src/repro_torch/kernels/csrc/quotient.cu"
QUOTIENT_REPLACES = {
    "quotient_contains": "src/repro/kernels/quotientfilter.py:51",
    "quotient_update": "src/repro/kernels/quotientfilter.py:90"}
QUOTIENT_KERNELS = {
    "quotient_contains": ["quotient_contains_kernel (walk)", "qf_tile_stats",
                          "qf_scan_tables", "bin8_count_kernel",
                          "bin_column_kernel", "bin_scan_kernel",
                          "bin8_scatter_kernel", "qf_contains_bin",
                          "qf_load_sample"],
    "quotient_update": ["qf_tile_stats", "qf_scan_tables", "qf_decode",
                        "qf_bin_count", "qf_bin_offsets", "qf_bin_scatter",
                        "qf_bin_sort", "qf_merge_tiles", "qf_merge",
                        "qf_positions", "qf_write"]}
# lowered knobs of phase 3f: 32-slot tiles (clusters span many), merge
# tiles of 7, 8 bins of at most 5 keys in shared memory (the rest sort in
# device memory)
QUOTIENT_LOW = dict(tile_slots=32, merge_tile=7, bin_bits=3, bin_cap=5)
# (slot_bits, r_bits, q_bits) of phase 3f
PHASE3F_QUOTIENT = ((8, 5, 12), (8, 2, 11), (16, 9, 11), (16, 13, 10),
                    (32, 20, 10), (32, 27, 4))


def quotient_spec(slot_bits: int, r_bits: int, q_bits: int) -> V.FilterSpec:
    return V.FilterSpec("quotient", (1 << q_bits) * slot_bits, 1,
                        slot_bits=slot_bits, r_bits=r_bits)


def quotient_wrapping(spec: V.FilterSpec, n: int, seed: int) -> torch.Tensor:
    """n keys homed in the top eighth of the slots: their clusters run past
    the last slot into slot 0."""
    cand = gen_keys(spec.n_slots * 32, seed)
    q = Q.split_fp(spec, Q.quotient_hashes(spec, cand))[0]
    return cand[q >= spec.n_slots * 7 // 8][:n].contiguous()


def quotient_check(spec, table, keys, valid, gone, probes, errs) -> tuple:
    """The update kernels (tiles 256, 2048 and the whole batch) and the
    contains kernel (both coop values) against their plain versions from
    ``table``: words and flags bit for bit. Returns (the added table, ok,
    kernel runs)."""
    runs = 0
    for tile in (256, 2048, None):
        want, ok = qf.update_plain(spec, table, keys, valid, "add", tile)
        got, got_ok = qf.add_vmem(spec, table.clone(), keys, valid,
                                  tile=tile)
        errs["quotient_update"] = max(errs["quotient_update"],
                                      max_err(got, want), max_err(got_ok, ok))
        runs += 1
    queries = torch.cat([keys, probes])
    hit = qf.contains_plain(spec, want, queries)
    for coop in ("none", "subtile"):
        errs["quotient_contains"] = max(
            errs["quotient_contains"],
            max_err(ops.quotient_contains(spec, want, queries, coop=coop),
                    hit))
        runs += 1
    runs += quotient_contains_paths(spec, want, queries, hit, errs)
    want_rm, found = qf.update_plain(spec, want, gone, None, "remove")
    got_rm, got_found = qf.remove_vmem(spec, want.clone(), gone, None)
    errs["quotient_update"] = max(errs["quotient_update"],
                                  max_err(got_rm, want_rm),
                                  max_err(got_found, found))
    return want, ok, runs + 1


# lowered bins, windows and caps of the binned contains: a quotient a bin
# (4096 bins of one slot's tile), 8-slot bins, 32-slot bins; windows of 4
# words, so runs cross the window's end and are read through __ldg
QUOTIENT_CONTAINS_LOW = (dict(bin_bits=0, window=4, cap=97),
                         dict(bin_bits=3, window=4, cap=1000),
                         dict(bin_bits=5))


def quotient_contains_paths(spec, table, queries, want, errs,
                            low=QUOTIENT_CONTAINS_LOW) -> int:
    """Both contains paths (the walk, binned) at the card's bins and binned
    at ``low`` bins, windows and caps, against ``want`` (the plain
    result). Returns the runs."""
    runs = 0
    for path in qf.CONTAINS_PATHS:
        errs["quotient_contains"] = max(
            errs["quotient_contains"],
            max_err(qf._launch_contains(spec, table, queries, path), want))
        runs += 1
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    for kw in low:
        ww = kw.get("window", qf.contains_window_words(spec, kw["bin_bits"]))
        if not qf.binned_fits(spec, kw["bin_bits"], ww, smem):
            continue
        errs["quotient_contains"] = max(
            errs["quotient_contains"],
            max_err(qf._launch_contains(spec, table, queries, "binned", **kw),
                    want))
        runs += 1
    return runs


def phase_quotient_kernels(errs: dict):
    """Phase 3f: u8/u16/u32 lanes over several remainder widths; loads 0.5,
    0.9 and 1.3 (past capacity) with 5 % duplicates (some three times), with
    and without a valid mask, then a second batch into the filled table;
    removes of half the batch, of repeats and of absent keys; clusters that
    wrap past the last slot; tiles 256, 2048 and the whole batch; both coop
    values and every contains path (the cluster walk, binned, the card's
    choice; binned at lowered bins, windows and caps): words, flags and
    results against the plain versions. Then the merge
    and resize wrappers against their plain versions and the update
    kernels' own build."""
    for i, geom in enumerate(PHASE3F_QUOTIENT):
        spec = quotient_spec(*geom)
        runs, refused = 0, 0
        probes = gen_keys(4000, 750 + i, probe=True)
        for load in (0.5, 0.9, 1.3):
            n = max(int(spec.n_slots * load), 1)
            keys = gen_keys(n, 760 + i)
            keys = torch.cat([keys, keys[: n // 20], keys[:3]])
            gone = torch.cat([keys[: keys.shape[0] // 2], keys[:30],
                              keys[:30], gen_keys(50, 770 + i, probe=True)])
            for vmask in (None, valid_mask(keys.shape[0], 780 + i)):
                table, ok, r = quotient_check(spec, Q.init(spec, "cuda"),
                                              keys, vmask, gone, probes, errs)
                runs += r
                if load > 1 and vmask is None:
                    refused += int((~ok).sum())
                    if int(Q.occupied_slots(spec, table)) != spec.n_slots - 1:
                        raise AssertionError(f"{spec}: not full past "
                                             f"capacity")
            more = gen_keys(max(spec.n_slots // 4, 1), 790 + i)
            runs += quotient_check(spec, table, more, None,
                                   more[::2].contiguous(), probes, errs)[2]
        wrapped = ""
        if spec.n_slots >= 1 << 10:
            keys = quotient_wrapping(spec, spec.n_slots // 4, 800 + i)
            table, _, r = quotient_check(spec, Q.init(spec, "cuda"), keys,
                                         None, keys[::3].contiguous(),
                                         probes, errs)
            runs += r
            if not int(Q.unpack_slots(spec, table)[0]) >> (
                    spec.slot_bits - 3) & 1:
                raise AssertionError(f"{spec}: no cluster wraps")
            wrapped = ", a wrapping cluster"
        torch.cuda.synchronize()
        print(f"quotient: {spec}: {runs} kernel runs equal to the plain "
              f"version (loads 0.5/0.9/1.3 with duplicates, masks, a second "
              f"batch, removes of absent keys{wrapped}; tiles 256/2048/"
              f"whole; both coop values; {refused} inserts refused past "
              f"capacity, matched flag for flag)")
    quotient_knob_checks(errs)
    # merge and resize on the card against their plain versions and the
    # tables the update kernels build
    for geom in ((8, 5, 14), (16, 9, 12), (32, 20, 11)):
        spec = quotient_spec(*geom)
        keys = gen_keys(int(spec.n_slots * 0.85), 810)
        half = keys.shape[0] // 2
        build = functools.partial(ops.quotient_add, spec,
                                  Q.init(spec, "cuda"))
        a, b, both = (build(keys[:half])[0], build(keys[half:])[0],
                      build(keys)[0])
        merged = qf.merge_vmem(spec, a, b)
        max_err(merged, qf.merge_plain(spec, a, b))
        max_err(merged, both)
        grown_spec = Q.spec_for_resize(spec, 2 * spec.m_bits)
        grown = qf.resize_vmem(spec, both, grown_spec)
        max_err(grown, qf.resize_plain(spec, both, grown_spec))
        max_err(grown, ops.quotient_add(grown_spec,
                                        Q.init(grown_spec, "cuda"),
                                        keys)[0])
        max_err(qf.resize_vmem(grown_spec, grown, spec), both)
        torch.cuda.synchronize()
        print(f"quotient: {spec}: merge of two half tables equal to the "
              f"plain merge and to the kernels' build of the whole stream, "
              f"resize to {grown_spec} equal to the plain resize and the "
              f"kernels' build there, and back")


def longest_cluster(spec, table) -> int:
    """Slots of the table's longest cluster (a run of slots in use, wrapping
    past the last slot)."""
    in_use = Q._fields(spec, Q.unpack_slots(spec, table))[3]
    if bool(in_use.all()):
        return spec.n_slots
    start = int(torch.argmax((~in_use).to(torch.int8)))
    rolled = torch.roll(in_use, -start).to(torch.int64)
    idx = torch.arange(spec.n_slots, device=table.device)
    last_empty = torch.cummax(torch.where(rolled == 0, idx, -1), 0).values
    return int((idx - last_empty).max())


def quotient_knob_checks(errs: dict):
    """Phase 3f, the update's schedule: at lowered knobs (32-slot tiles,
    merge tiles of 7, 8 bins sorted in shared memory up to 5 keys) every
    geometry's add, remove, merge and resize against the plain versions,
    with clusters longer than a tile; a key 40,000 times (a bin past the
    default cap: the device-memory sort, one run of 40,000 slots) added and
    removed; more passes than one (``KEY_BATCH`` lowered)."""
    longest = 0
    for i, geom in enumerate(PHASE3F_QUOTIENT):
        spec = quotient_spec(*geom)
        keys = gen_keys(int(spec.n_slots * 0.9), 860 + i)
        keys = torch.cat([keys, keys[: keys.shape[0] // 20]])
        vmask = valid_mask(keys.shape[0], 861 + i)
        e = errs["quotient_update"]
        for knobs in (QUOTIENT_LOW, dict(tile_slots=256, merge_tile=1000,
                                         bin_bits=0)):
            want, ok = qf.update_plain(spec, Q.init(spec, "cuda"), keys,
                                       vmask, "add")
            got, got_ok = qf.add_vmem(spec, Q.init(spec, "cuda"), keys,
                                      vmask, **knobs)
            e = max(e, max_err(got, want), max_err(got_ok, ok))
            gone = torch.cat([keys[::2], keys[:50],
                              gen_keys(40, 862 + i, probe=True)])
            want_rm, found = qf.update_plain(spec, want, gone, None,
                                             "remove")
            got_rm, got_found = qf.remove_vmem(spec, want.clone(), gone,
                                               None, **knobs)
            e = max(e, max_err(got_rm, want_rm), max_err(got_found, found))
            tk = {k: v for k, v in knobs.items()
                  if k in ("tile_slots", "merge_tile")}
            fit = keys[: spec.n_slots - 1]     # the union fits
            half = fit.shape[0] // 3
            a = qf.update_plain(spec, Q.init(spec, "cuda"), fit[:half],
                                None, "add")[0]
            b = qf.update_plain(spec, Q.init(spec, "cuda"), fit[half:],
                                None, "add")[0]
            max_err(qf.merge_vmem(spec, a, b, **tk),
                    qf.merge_plain(spec, a, b))
            if spec.r_bits > 1:
                grown = Q.spec_for_resize(spec, 2 * spec.m_bits)
                up = qf.resize_vmem(spec, want, grown, **tk)
                max_err(up, qf.resize_plain(spec, want, grown))
                max_err(qf.resize_vmem(grown, up, spec, **tk), want)
        errs["quotient_update"] = e
        longest = max(longest, longest_cluster(spec, want))
    if longest <= QUOTIENT_LOW["tile_slots"]:
        raise AssertionError(f"quotient: no cluster longer than a tile "
                             f"({longest} slots)")
    # one key past the default bin cap: the device-memory sort
    spec = quotient_spec(16, 9, 16)
    one = gen_keys(1, 870).repeat(40000, 1)
    keys = torch.cat([one, gen_keys(3000, 871)])
    keys = keys[torch.randperm(keys.shape[0], device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(872))]
    want, ok = qf.update_plain(spec, Q.init(spec, "cuda"), keys, None, "add")
    got, got_ok = qf.add_vmem(spec, Q.init(spec, "cuda"), keys, None)
    e = max(errs["quotient_update"], max_err(got, want), max_err(got_ok, ok))
    if longest_cluster(spec, got) < 40000:
        raise AssertionError("quotient: the repeated key is not one run")
    gone = one[:30000].contiguous()
    want_rm, found = qf.update_plain(spec, want, gone, None, "remove")
    got_rm, got_found = qf.remove_vmem(spec, want.clone(), gone, None)
    e = max(e, max_err(got_rm, want_rm), max_err(got_found, found))
    # several passes of the pipeline in one call
    saved = qf.KEY_BATCH
    qf.KEY_BATCH = 1000
    try:
        spec = quotient_spec(8, 5, 12)
        keys = gen_keys(3500, 873)
        want, ok = qf.update_plain(spec, Q.init(spec, "cuda"), keys, None,
                                   "add")
        got, got_ok = qf.add_vmem(spec, Q.init(spec, "cuda"), keys, None)
        e = max(e, max_err(got, want), max_err(got_ok, ok))
        passes = qf.LAST_PLAN["passes"]
    finally:
        qf.KEY_BATCH = saved
    errs["quotient_update"] = e
    torch.cuda.synchronize()
    print(f"quotient: the update's schedule at lowered knobs ({QUOTIENT_LOW}"
          f"; and 256-slot tiles, one bin) on every geometry equal to the "
          f"plain versions (add, remove, merge, resize up and back; longest "
          f"cluster {longest} slots); a key 40,000 times (one bin past the "
          f"cap of {qf.BIN_CAP}, sorted in device memory) added and 30,000 "
          f"removed; an add in {passes} passes")


def quotient_walk_sectors(spec, table, keys) -> int:
    """32-byte sectors the contains kernel's cluster walks read for
    ``keys``: one for a key whose home slot is unoccupied, else those of the
    slots from its cluster's start to the slot after its run."""
    n, sps = spec.n_slots, 256 // spec.slot_bits
    lanes = Q.unpack_slots(spec, table)
    occ, cont, shifted, in_use, _ = Q._fields(spec, lanes)
    anchor = Q._first(~in_use)
    rot = functools.partial(Q._rotated, anchor)
    occ_r, cont_r, shifted_r, in_use_r = (rot(occ), rot(cont), rot(shifted),
                                          rot(in_use))
    idx = torch.arange(n, device=table.device)
    start = torch.cummax(torch.where(~shifted_r, idx, -1), 0).values
    runs_upto = torch.cumsum((in_use_r & ~cont_r).to(torch.int64), 0)
    occ_upto = torch.cumsum(occ_r.to(torch.int64), 0)
    boundary = torch.where(~cont_r, idx, n).flip(0)
    next_boundary = torch.cummin(boundary, 0).values.flip(0)
    total = 0
    for chunk in keys.split(SUBSET):
        q = Q.split_fp(spec, Q.quotient_hashes(spec, chunk))[0]
        home = occ[q]
        rq = (q - anchor - 1) % n
        run = torch.searchsorted(runs_upto, occ_upto[rq])
        end = next_boundary[(run + 1).clamp(max=n - 1)]
        first = (start[rq] + anchor + 1) % n
        length = end.clamp(max=n - 1) - start[rq] + 1
        sectors = (first + length - 1) // sps - first // sps + 1
        total += int(torch.where(home, sectors, 1).sum())
    return total


def quotient_contains_bound_ms(spec, table, keys):
    """Least time of a contains: 8 B of key and 1 B of result a key, and the
    sectors its walk reads, at most the table once; 40 operations a key and
    4 a slot walked (two at most a sector, counted per sector)."""
    sectors = quotient_walk_sectors(spec, table, keys)
    n = keys.shape[0]
    nbytes = 9 * n + min(32 * sectors, spec.n_words * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (40 * n + 4 * sectors) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def quotient_update_bound_ms(spec, n: int):
    """Least time of an update: 8 B of key, 1 B of valid and 1 B of flag a
    key, the old table read once and the new one written once; 40
    operations a key for the hash and 8 a slot for the decode and rebuild."""
    nbytes = 10 * n + 2 * spec.n_words * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (40 * n + 8 * spec.n_slots) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def quotient_update_floor_ms(spec, n: int = 0, nb: int = 0, m0: int = 0,
                             m1: int = 0, tables: int = 1, out_spec=None,
                             key_bytes: int = 4) -> float:
    """The sorted-stream design's floor: the DRAM bytes its stages must
    move, at 3.35 TB/s. n keys read twice (count, scatter) and a flag
    written; nb admitted sort keys (an add's 4-byte fingerprint, a
    remove's 8-byte (fp, index)) written, sorted (read, written) and read
    by the merge; the m0 old fingerprints written by the decode and read by
    the merge; the m1 new ones written by the merge and read by the
    positions and the write; their positions written and read; each decoded
    table read twice (counts, decode) and the new table written once."""
    out_words = (out_spec or spec).n_words
    nbytes = (17 * n + 4 * key_bytes * nb + 8 * m0 + 12 * m1 + 8 * m1
              + 8 * tables * spec.n_words + 4 * out_words)
    return nbytes / HBM_BYTES_PER_S * 1e3


def quotient_contains_floor_ms(spec, n: int) -> float:
    """The binned contains' floor: the DRAM bytes its stages must move at
    3.35 TB/s: n keys read twice (count, scatter), an 8-byte slot a key
    written and read, a result written, the table read once and its tiles'
    (a tile a bin) five counts written."""
    tiles = spec.n_slots >> qf.contains_bin_bits(spec.q_bits)
    nbytes = 33 * n + 4 * spec.n_words + 20 * tiles
    return nbytes / HBM_BYTES_PER_S * 1e3


def batches(keys: torch.Tensor, batch: int) -> list:
    return list(keys.split(batch))


def phase_quotient_main(label: str, n: int, batch: int, errs: dict,
                        cells: dict, launches: dict, card: str):
    """Phase 4f, one cell: ``filter_for_n_items(n, variant="quotient")``;
    add to load 0.5, then to load 0.9, in batches of ``batch`` keys;
    contains of every key and of 2^22 probes; remove half, contains of the
    rest; merge of two tables of half the stream each; resize one step up,
    back down, and a shrink that would overflow. Every update's words and
    flags and every contains against the plain version in full, no false
    negative, occupied slots = successful inserts, merge = the build of the
    whole stream, the resizes = the plain layout at the other size."""
    f = api.filter_for_n_items(n, variant="quotient", device="cuda")
    spec = f.spec
    if f.backend != "quotient" or spec.slot_bits != 8 or spec.r_bits != 5:
        raise AssertionError(f"quotient {label} cell: {f}")
    n1, n_all = spec.n_slots // 2, int(spec.n_slots * 0.9)
    keys = gen_keys(n_all, 820 + spec.q_bits)
    probes = gen_keys(SUBSET, 830, probe=True)
    half = n_all // 2
    chunks = batches(keys[:n1], batch) + batches(keys[n1:], batch)
    extra = gen_keys(spec.n_slots - n_all + 4096, 840)
    torch.cuda.synchronize()
    qf.reset_launches()                    # the main path, counted
    t0 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
    ev[0].record()
    steps = [f]
    for chunk in chunks:
        steps.append(steps[-1].add(chunk))
    g2 = steps[-1]
    ev[1].record()
    hits = g2.contains(keys)
    main_plan = dict(qf.LAST_CONTAINS_PLAN)
    ev[2].record()
    false_pos = g2.contains(probes)
    ev[3].record()
    g3 = g2
    for chunk in batches(keys[:half], batch):
        g3 = g3.remove(chunk)
    kept = g3.contains(keys[half:])
    ev[4].record()
    fa, fb = f, f
    for chunk in batches(keys[:half], batch):
        fa = fa.add(chunk)
    for chunk in batches(keys[half:], batch):
        fb = fb.add(chunk)
    merged = fa.merge(fb)
    ev[5].record()
    grown = g2.resize(2 * spec.m_bits)
    ev[6].record()
    back = grown.resize(spec.m_bits)
    ev[7].record()
    over = grown
    for chunk in batches(extra, batch):
        over = over.add(chunk)
    ev[8].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(qf.LAUNCHES)
    n_rm = len(batches(keys[:half], batch))
    expected = {"contains_vmem": 3, "remove_vmem": n_rm,
                "add_vmem": len(chunks) + n_rm + len(batches(keys[half:],
                                                             batch))
                + len(batches(extra, batch)), "merge_vmem": 1,
                "resize_vmem": 2}
    if counted != expected:
        raise AssertionError(f"quotient {label} cell: launches {counted}, "
                             f"expected {expected}")
    main_path, sampled = main_plan["path"], main_plan["load"]
    true_load = int(Q.occupied_slots(spec, g2.words)) / spec.n_slots
    if (main_path != qf.contains_mode(
            spec, n_all, sampled, sbf.partition_smem_bytes(keys.device))
            or abs(sampled - true_load) > 0.02):
        raise AssertionError(f"quotient {label} cell: the contains of every "
                             f"key ran {main_path} at a sampled load "
                             f"{sampled} (the table's {true_load}), not the "
                             f"rule's path")
    launches["quotient_contains"] = (launches.get("quotient_contains", 0)
                                     + counted["contains_vmem"])
    # merge and resize launch the update kernels on decoded fingerprints
    launches["quotient_update"] = (launches.get("quotient_update", 0)
                                   + counted["add_vmem"]
                                   + counted["remove_vmem"]
                                   + counted["merge_vmem"]
                                   + counted["resize_vmem"])
    step_ms = {s: ev[i].elapsed_time(ev[i + 1]) for i, s in enumerate(
        ("add to 0.9", "contains", "contains probes",
         "remove half + contains rest", "two half builds + merge",
         "resize up", "resize down", "add past the shrink capacity"))}
    stored_over = int(Q.occupied_slots(grown.spec, over.words))
    try:
        over.resize(spec.m_bits)
    except ValueError as err:
        if "shrink" not in str(err):
            raise
    else:
        raise AssertionError(f"quotient {label} cell: a shrink of "
                             f"{stored_over} fingerprints was not refused")
    # every update against the plain version, words and flags in full
    e = errs["quotient_update"]
    for before, after, chunk in zip(steps, steps[1:], chunks):
        want, ok = qf.update_plain(spec, before.words, chunk, None, "add")
        e = max(e, max_err(after.words, want))
        if not bool(ok.all()):
            raise AssertionError(f"quotient {label} cell: an insert was "
                                 f"refused below capacity")
    prev, found_all = g2.words, 0
    for chunk in batches(keys[:half], batch):
        prev, found = qf.update_plain(spec, prev, chunk, None, "remove")
        found_all += int(found.sum())
    e = max(e, max_err(g3.words, prev))
    errs["quotient_update"] = e
    occ1 = int(Q.occupied_slots(spec, steps[len(batches(keys[:n1],
                                                        batch))].words))
    occ2 = int(Q.occupied_slots(spec, g2.words))
    occ3 = int(Q.occupied_slots(spec, g3.words))
    if (occ1, occ2, occ3, found_all, int(g2.insert_failures)) != (
            n1, n_all, n_all - half, half, 0):
        raise AssertionError(f"quotient {label} cell: occupied {occ1}/{occ2}/"
                             f"{occ3}, {found_all} of {half} removes found, "
                             f"{int(g2.insert_failures)} inserts refused")
    neg, neg_kept = int((~hits).sum()), int((~kept).sum())
    if neg or neg_kept:
        raise AssertionError(f"quotient {label} cell: {neg} / {neg_kept} "
                             f"false negatives")
    plain_contains = functools.partial(qf.contains_plain, spec)
    c = errs["quotient_contains"]
    c = max(c, max_err(hits, contains_in_chunks(plain_contains, g2.words,
                                                keys)))
    c = max(c, max_err(false_pos, plain_contains(g2.words, probes)))
    c = max(c, max_err(kept, contains_in_chunks(plain_contains, g3.words,
                                                keys[half:])))
    errs["quotient_contains"] = c
    # merge = the build of the whole stream and the plain merge; the resizes
    # = the plain layout
    max_err(merged.words, g2.words)
    max_err(merged.words, qf.merge_plain(spec, fa.words, fb.words))
    max_err(grown.words, qf.resize_plain(spec, g2.words, grown.spec))
    max_err(back.words, g2.words)
    load = occ2 / spec.n_slots
    fpr = float(false_pos.to(torch.float64).mean().item())
    theory = Q.fpr_quotient(spec.q_bits, spec.r_bits, load)
    print(f"main quotient {label} [{card}]: {spec} on {g2.backend}, "
          f"{f.nbytes / 2**20:.0f} MiB, batches of {batch}: add {n1} (load "
          f"0.5) and {n_all - n1} more (load {load:.4f}), contains {n_all} + "
          f"{SUBSET} probes, remove {half}, contains {n_all - half}, merge "
          f"of two half-stream tables, resize to {grown.spec} and back, a "
          f"shrink of {stored_over} fingerprints refused, in "
          f"{wall * 1e3:.1f} ms host clock; occupied slots = successful "
          f"inserts ({occ1}, {occ2}, {occ3}); no false negative; every "
          f"update's words and flags and every contains equal to the plain "
          f"version's in full; merge equal to the whole stream's table and "
          f"the plain merge, resizes equal to the plain resize and back; FPR "
          f"{fpr:.6f} at load {load:.4f}, {fpr / theory:.3f} x fpr_quotient "
          f"{theory:.6f}; launches {counted}, the contains of every key "
          f"{main_path}")
    print(f"time quotient {label} main path [{card}] (Filter calls, CUDA "
          f"events, one run): " + ", ".join(f"{s} {v:.4f} ms"
                                            for s, v in step_ms.items()))
    # times: the kernels on the main path's inputs (an update's table
    # restored before each call), and against the plain version on 2^22 keys
    sub = torch.cat([keys[: SUBSET // 2], probes[: SUBSET // 2]])
    fresh = keys[:SUBSET]
    scratch = f.words.clone()
    first, last, gone = chunks[0], chunks[-1], batches(keys[:half], batch)[0]
    last_in = steps[-2].words
    t = {"add first": time_restored_ms(
            lambda: qf.add_vmem(spec, scratch, first, None), scratch.zero_,
            f"quotient {label} add first"),
         "add last": time_restored_ms(
            lambda: qf.add_vmem(spec, scratch, last, None),
            lambda: scratch.copy_(last_in), f"quotient {label} add last"),
         "remove": time_restored_ms(
            lambda: qf.remove_vmem(spec, scratch, gone, None),
            lambda: scratch.copy_(g2.words), f"quotient {label} remove"),
         "add 2^22": time_restored_ms(
            lambda: qf.add_vmem(spec, scratch, fresh, None), scratch.zero_,
            f"quotient {label} add 2^22"),
         "add 2^22 plain": time_ms(
            lambda: qf.update_plain(spec, f.words, fresh, None, "add"),
            f"quotient {label} add plain", PLAIN_REPS, PLAIN_ROUNDS),
         "contains": time_ms(lambda: qf.contains_vmem(spec, g2.words, keys),
                             f"quotient {label} contains"),
         "Filter.contains": time_ms(lambda: g2.contains(keys),
                                    f"quotient {label} Filter.contains"),
         "contains sub": time_ms(lambda: qf.contains_vmem(spec, g2.words,
                                                          sub),
                                 f"quotient {label} contains sub"),
         "contains plain": time_ms(lambda: qf.contains_plain(spec, g2.words,
                                                             sub),
                                   f"quotient {label} contains plain",
                                   PLAIN_REPS, PLAIN_ROUNDS),
         "merge": time_ms(lambda: qf.merge_vmem(spec, fa.words, fb.words),
                          f"quotient {label} merge", 3, 3),
         "merge plain": time_ms(lambda: qf.merge_plain(spec, fa.words,
                                                       fb.words),
                                f"quotient {label} merge plain", 1, 3),
         "resize": time_ms(lambda: qf.resize_vmem(spec, g2.words,
                                                  grown.spec),
                           f"quotient {label} resize", 3, 3),
         "resize plain": time_ms(lambda: qf.resize_plain(spec, g2.words,
                                                         grown.spec),
                                 f"quotient {label} resize plain", 1, 3)}
    # the contains paths and the rule's at load 0.9 on the full batch, 2^22
    # and 2^16 keys, and at load 0.45 after the remove; the rule's path
    # and sampled load of each
    paths, rules = {}, {}
    for load_q, words, qkeys in ((0.9, g2.words, (keys, sub,
                                                  sub[: 1 << 16])),
                                 (0.45, g3.words, (keys[half:], sub))):
        for qk in qkeys:
            for path in QUOTIENT_RULE_PATHS:
                paths[(load_q, qk.shape[0], path)] = time_ms(
                    lambda qk=qk, path=path, words=words:
                    quotient_contains_on(spec, words, qk, path),
                    f"quotient {label} contains {load_q} {qk.shape[0]} "
                    f"{path}")
            rules[(load_q, qk.shape[0])] = (qf.LAST_CONTAINS_PLAN["path"],
                                            qf.LAST_CONTAINS_PLAN["load"])
    # the load sample a contains asks for once a table state: the kernel,
    # the copy back and the host's wait, on a table whose version moved

    def fresh_load():
        torch.autograd.graph.increment_version(g2.words)
        return qf.table_load(spec, g2.words)
    t_sample = time_ms(fresh_load, f"quotient {label} load sample")
    b = {"add first": quotient_update_bound_ms(spec, first.shape[0]),
         "add last": quotient_update_bound_ms(spec, last.shape[0]),
         "remove": quotient_update_bound_ms(spec, gone.shape[0]),
         "add 2^22": quotient_update_bound_ms(spec, SUBSET),
         "contains": quotient_contains_bound_ms(spec, g2.words, keys),
         "contains sub": quotient_contains_bound_ms(spec, g2.words, sub)}
    # the design's floor of each update (its streams' DRAM bytes)
    m_last = int(Q.occupied_slots(spec, last_in))
    n_g, n_f, n_l = gone.shape[0], first.shape[0], last.shape[0]
    floor = {"add first": quotient_update_floor_ms(spec, n_f, n_f, 0, n_f),
             "add last": quotient_update_floor_ms(spec, n_l, n_l, m_last,
                                                  m_last + n_l),
             "remove": quotient_update_floor_ms(spec, n_g, n_g, n_all,
                                                n_all - n_g, key_bytes=8),
             "add 2^22": quotient_update_floor_ms(spec, SUBSET, SUBSET, 0,
                                                  SUBSET),
             "merge": quotient_update_floor_ms(spec, 0, 0, n_all, n_all,
                                               tables=2),
             "resize": quotient_update_floor_ms(spec, 0, 0, n_all, n_all,
                                                out_spec=grown.spec)}
    # peak extra device memory of the first batch's add and of a remove:
    # the plan's workspace and the flags, nothing else (the bytes the call
    # requested; the allocator's blocks round them up, reported beside)
    peak = {}
    for what, call, restore, n_k in (
            ("add first", lambda: qf.add_vmem(spec, scratch, first, None),
             scratch.zero_, n_f),
            ("remove", lambda: qf.remove_vmem(spec, scratch, gone, None),
             lambda: scratch.copy_(g2.words), n_g)):
        restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()
        flags = call()[1]
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        used = (after["requested_bytes.all.peak"]
                - before["requested_bytes.all.current"])
        blocks = (after["allocated_bytes.all.peak"]
                  - before["allocated_bytes.all.current"])
        plan = dict(qf.LAST_PLAN)
        allowed = plan["workspace_bytes"] + n_k        # + the flags
        del flags
        if used > allowed + 512:
            raise AssertionError(f"quotient {label} {what}: peak extra "
                                 f"memory {used} B above the plan's "
                                 f"{allowed} B")
        peak[what] = {"peak_extra_bytes": used, "block_bytes": blocks,
                      "workspace_bytes": plan["workspace_bytes"],
                      "flags_bytes": n_k, "plan": plan}
    print(f"time quotient {label} update [{card}]: kernel add first batch "
          f"{t['add first']:.4f} ms ({first.shape[0]} keys into the empty "
          f"table), add last batch {t['add last']:.4f} ms ({last.shape[0]} "
          f"keys to load 0.9), remove {t['remove']:.4f} ms ({gone.shape[0]} "
          f"keys from load 0.9); bounds " + ", ".join(
              f"{k} {b[k][0]:.4f} ms ({b[k][0] / t[k]:.1%})"
              for k in ("add first", "add last", "remove"))
          + f"; {SUBSET} keys into the empty table: kernel "
          f"{t['add 2^22']:.4f} ms ({SUBSET / t['add 2^22'] / 1e3:.1f} "
          f"Mops/s), plain {t['add 2^22 plain']:.4f} ms, bound "
          f"{b['add 2^22'][0]:.4f} ms ({b['add 2^22'][1]}); one launch a "
          f"call")
    print(f"time quotient {label} contains paths [{card}] (walk / binned "
          f"/ the rule's): " + "; ".join(
              f"load {lq} {n_q} keys " + " / ".join(
                  f"{paths[(lq, n_q, p)]:.4f}" for p in QUOTIENT_RULE_PATHS)
              + f" ms (rule: {rules[(lq, n_q)][0]} at a sampled load of "
              f"{rules[(lq, n_q)][1]})" for lq, n_q in rules)
          + f"; the rule walks below {qf.LOAD_MIN_KEYS} keys without a "
          f"sample; the load sample (kernel, copy back, the host's wait) "
          f"{t_sample:.4f} ms, once a table state")
    # the binned contains of every key: its plan, peak extra memory and
    # design floor
    qf.contains_vmem(spec, g2.words, keys)
    torch.cuda.synchronize()
    cplan = dict(qf.LAST_CONTAINS_PLAN)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    res = qf.contains_vmem(spec, g2.words, keys)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    c_peak = (after["requested_bytes.all.peak"]
              - before["requested_bytes.all.current"] - res.numel())
    del res
    if c_peak > cplan["workspace_bytes"] + 512:
        raise AssertionError(f"quotient {label} contains: peak extra memory "
                             f"{c_peak} B above the plan's "
                             f"{cplan['workspace_bytes']} B")
    c_floor = quotient_contains_floor_ms(spec, n_all)
    print(f"time quotient {label} contains plan [{card}]: {cplan['path']}, "
          f"{cplan.get('n_bins')} bins of 2^{cplan.get('bin_bits')} "
          f"quotients, window {cplan.get('window_words')} words, "
          f"{cplan['batches']} batches of {cplan['batch_keys']} keys, "
          f"{cplan['chunks']} chunks; peak extra memory {c_peak} B besides "
          f"the result (the plan's workspace {cplan['workspace_bytes']} B); "
          f"design floor (keys twice, 8-byte slots written and read, the "
          f"table and its tiles once, results) {c_floor:.4f} ms, "
          f"{c_floor / t['contains']:.1%} of the kernel's "
          f"{t['contains']:.4f} ms")
    print(f"time quotient {label} merge and resize [{card}]: merge "
          f"{t['merge']:.4f} ms (plain {t['merge plain']:.4f} ms), resize to "
          f"{grown.spec} {t['resize']:.4f} ms (plain {t['resize plain']:.4f} "
          f"ms)")
    print(f"time quotient {label} design floor [{card}] (the streams' DRAM "
          f"bytes at 3.35 TB/s): " + ", ".join(
              f"{k} {v:.4f} ms ({v / t[k]:.1%} of the kernel's "
              f"{t[k]:.4f})" for k, v in floor.items()))
    print(f"memory quotient {label} [{card}]: " + "; ".join(
        f"{k}: peak extra {v['peak_extra_bytes']} B requested "
        f"({v['block_bytes']} B in the allocator's blocks), the plan's "
        f"workspace {v['workspace_bytes']} B + {v['flags_bytes']} B of flags "
        f"({v['plan']['n_bins']} bins of {v['plan']['bin_bits']} bits, "
        f"{v['plan']['table_tiles']} table tiles, {v['plan']['merge_tiles']} "
        f"merge tiles)" for k, v in peak.items()))
    print(f"time quotient {label} contains [{card}]: kernel "
          f"{t['contains']:.4f} ms at {n_all} keys, load 0.9 "
          f"({n_all / t['contains'] / 1e3:.1f} Mops/s), bound "
          f"{b['contains'][0]:.4f} ms ({b['contains'][0] / t['contains']:.1%}"
          f"), Filter.contains {t['Filter.contains']:.4f} ms; at {SUBSET} "
          f"keys (half probes) kernel {t['contains sub']:.4f} ms, plain "
          f"{t['contains plain']:.4f} ms, bound {b['contains sub'][0]:.4f} "
          f"ms ({b['contains sub'][1]})")
    floor["contains"] = c_floor
    peak["contains"] = {"peak_extra_bytes": c_peak,
                        "workspace_bytes": cplan["workspace_bytes"],
                        "plan": cplan}
    cells[label] = {"m_bits": spec.m_bits, "n_keys": n_all, "batch": batch,
                    "ms": t, "floor_ms": floor, "memory": peak,
                    "bound_ms": {k: v[0] for k, v in b.items()},
                    "bound_by": {k: v[1] for k, v in b.items()},
                    "step_ms": step_ms, "fpr": fpr, "fpr_theory": theory,
                    "contains_paths_ms": {f"load {lq} {n_q} {m}": ms
                                          for (lq, n_q, m), ms in
                                          paths.items()}}
    del steps, g2, g3, fa, fb, merged, grown, back, over, scratch, keys
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def quotient_records(cells: dict, errs: dict, launches: dict) -> dict:
    """The two kernel records of the kernels line: the 2^22-key columns of
    the DRAM-side cell, each cell's numbers beside them."""
    dram = cells["DRAM"]
    out = {}
    for name, ms in (("quotient_contains", "contains sub"),
                     ("quotient_update", "add 2^22")):
        out[name] = {
            "name": name, "route": "cuda", "source": QUOTIENT_SOURCE,
            "replaces": QUOTIENT_REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": dram["ms"][ms],
            "plain_ms": dram["ms"][("contains plain" if ms == "contains sub"
                                    else "add 2^22 plain")],
            "bound_ms": dram["bound_ms"][ms],
            "bound_by": dram["bound_by"][ms], "library_ms": None,
            "floor_ms": (dram["floor_ms"]["add 2^22"]
                         if name == "quotient_update" else None),
            "cuda_kernels": QUOTIENT_KERNELS[name],
            "n_keys": SUBSET, "m_bits": dram["m_bits"], "cells": cells}
    return out


QUOTIENT_RULE_Q = (23, 24, 25, 26, 27)
QUOTIENT_RULE_LOG2N = (16, 18, 20, 22, 24, 26)
QUOTIENT_RULE_LOADS = (0.5, 0.9)
MEMBER_SHARES = (0.0, 0.5, 1.0)


def mixed_keys(members: torch.Tensor, probes: torch.Tensor, n: int,
               share: float) -> torch.Tensor:
    """n keys: a ``share`` of them members (cycled where there are fewer),
    the rest probes."""
    m = int(n * share)
    reps = -(-m // max(members.shape[0], 1))
    return torch.cat([members.repeat(max(reps, 1), 1)[:m],
                      probes[:n - m]]).contiguous()


# the paths the rule sweep and the cells time: both paths forced, and the
# rule's (contains_vmem: the path at the load it samples)
QUOTIENT_RULE_PATHS = ("walk", "binned", "rule")


def quotient_contains_on(spec, words, keys, path: str) -> torch.Tensor:
    """The contains wrapper on ``path`` of ``QUOTIENT_RULE_PATHS``."""
    if path == "rule":
        return qf.contains_vmem(spec, words, keys)
    return qf.contains_vmem(spec, words, keys, path=path)


def call_ms(fn) -> float:
    """One call's time (ms) after one untimed call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return max(start.elapsed_time(end), 1e-3)


# Calls a timing round of the quotient rule sweep takes, at most: its walks
# at load 0.5 are host-bound calls of 0.02-0.05 ms whose rounds of REPS
# calls (0.5 ms) vary by 20-50 % with the host's hiccups
QUOTIENT_RULE_REPS = 200


def rule_reps(fns: dict) -> int:
    """Calls a timing round of the quotient rule sweep takes: about 10 ms
    of the fastest path's calls and at most about 50 ms of the slowest's,
    1 to ``QUOTIENT_RULE_REPS``."""
    ms = [call_ms(fn) for fn in fns.values()]
    return max(1, min(QUOTIENT_RULE_REPS, int(10 / min(ms)),
                      int(50 / max(ms))))


def phase_quotient_rule(card: str, errs: dict):
    """The quotient contains' path rule against both paths timed in turns
    (rounds of :func:`rule_reps` calls, each led by binned): 8-bit slots (r = 5; 4 at q27), q23 ... q27, tables at loads 0.5 and
    0.9, batches of 2^16 ... 2^26 keys of which a share of 0, 1/2 or 1 are
    members (the walk compares along a member's run; binned reads the bins
    a batch touches). Every path's results are equal at every point, the
    walk's equal to the plain version's on 2^16 keys, and binned at bins of
    a quarter the size (or the most bins) and half windows equal too. The
    rule's path (``contains_vmem``: the rule at the load it samples, kept
    while the table stays) is timed beside both, each through the wrapper:
    at each point it fails where it is slower than the faster path beyond
    the rounds' spread and by more than 5 % and 5 us, or where it ran
    another path than the rule gives at the sampled load. A point where
    it was the slower in the sweep's 3 rounds is timed again over
    ``COUNTING_RULE_RETIME_ROUNDS`` rounds, and judged by those."""
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    probes = gen_keys(1 << max(QUOTIENT_RULE_LOG2N), 36, probe=True)
    rows, wrong, checked, times, ran, retimed = [], [], 0, {}, {}, []
    for q_bits in QUOTIENT_RULE_Q:
        spec = quotient_spec(8, min(5, 31 - q_bits), q_bits)
        for load in QUOTIENT_RULE_LOADS:
            members = gen_keys(int(spec.n_slots * load), 4000 + q_bits)
            table = Q.init(spec, "cuda")
            for chunk in members.split(qf.KEY_BATCH):
                qf.add_vmem(spec, table, chunk, None)
            lb = max(qf.contains_bin_bits(q_bits) - 2,
                     q_bits - qf.LOG2_MAX_BINS)
            low = dict(bin_bits=lb, window=qf.contains_window_words(
                spec, lb) // 2 // 4 * 4)
            for log2n in QUOTIENT_RULE_LOG2N:
                n = 1 << log2n
                for share in MEMBER_SHARES:
                    keys = mixed_keys(members, probes, n, share)
                    fns = {p: (lambda p=p, keys=keys: quotient_contains_on(
                        spec, table, keys, p)) for p in QUOTIENT_RULE_PATHS}
                    got = {p: fn() for p, fn in fns.items()}
                    plan = qf.LAST_CONTAINS_PLAN
                    ran[(q_bits, log2n, load, share)] = (plan["path"],
                                                         plan["load"])
                    if plan["path"] != qf.contains_mode(spec, n,
                                                        plan["load"], smem):
                        wrong.append((q_bits, log2n, load, share,
                                      plan["path"], "not the rule's"))
                    got["low"] = qf._launch_contains(spec, table, keys,
                                                     "binned", **low)
                    for p in ("binned", "rule", "low"):
                        errs["quotient_contains"] = max(
                            errs["quotient_contains"],
                            max_err(got[p], got["walk"]))
                    if log2n == QUOTIENT_RULE_LOG2N[0]:
                        errs["quotient_contains"] = max(
                            errs["quotient_contains"],
                            max_err(got["walk"], qf.contains_plain(
                                spec, table, keys)))
                    checked += 4
                    del got
                    label = f"quotient rule q{q_bits} {load} 2^{log2n} {share}"
                    reps = rule_reps(fns)
                    t = time_turns(fns, label, reps, 3, lead="binned")
                    best = min(("walk", "binned"), key=lambda p: t[p])
                    if t["rule"] > t[best]:
                        first = (f"3 rounds: {t['rule']:.4f} against "
                                 f"{best} {t[best]:.4f}")
                        t = time_turns(fns, label, reps,
                                       COUNTING_RULE_RETIME_ROUNDS,
                                       lead="binned")
                        best = min(("walk", "binned"), key=lambda p: t[p])
                        retimed.append(
                            f"q{q_bits}/2^{log2n} {load}/{share} "
                            f"{t['rule']:.4f} against {best} "
                            f"{t[best]:.4f} ({first})")
                    times.setdefault((q_bits, log2n), {})[(load, share)] = t
                    if (t["rule"] > SPREAD[f"{label} {best}"][1]
                            and t["rule"] > 1.05 * t[best]
                            and t["rule"] - t[best] > 0.005):
                        wrong.append((q_bits, log2n, load, share,
                                      round(t["rule"], 4), best,
                                      round(t[best], 4)))
            del members, table
            torch.cuda.empty_cache()
    del probes
    for (q_bits, log2n), t in times.items():
        rows.append(f"q{q_bits}/2^{log2n} " + "; ".join(
            f"{load}/{share} " + "/".join(
                f"{v[p]:.4f}" for p in QUOTIENT_RULE_PATHS)
            + f" {ran[(q_bits, log2n, load, share)][0]}"
            for (load, share), v in t.items()))
    sampled = sorted({(q, load, round(x, 4))
                      for (q, _, load, _), (_, x) in ran.items()})
    print(f"quotient contains rule sweep [{card}] (q / keys: at each load / "
          f"member share walk / binned / the rule's ms, median of 3 rounds "
          f"in turns, and the rule's path): " + ", ".join(rows)
          + "; sampled loads (q, load, sample): " + ", ".join(
              f"q{q} {load} {x}" for q, load, x in sampled))
    print(f"quotient contains rule: timed again over "
          f"{COUNTING_RULE_RETIME_ROUNDS} rounds: "
          + ("; ".join(retimed) if retimed else "none"))
    if wrong:
        raise AssertionError(f"quotient contains rule: slower than the "
                             f"faster path beyond the rounds' spread by more "
                             f"than 5 % and 5 us, or not the rule's path, at "
                             f"(q, log2 n, load, share, ...) {wrong}")
    print(f"quotient contains rule: at each of {len(rows) * 6} points the "
          f"rule's path is no slower than the faster path beyond the "
          f"rounds' spread by more than 5 % and 5 us, and it is the rule's "
          f"at the sampled load; {checked} kernel results equal (every path, "
          f"binned at smaller bins and half windows, the walk against the "
          f"plain version at 2^{QUOTIENT_RULE_LOG2N[0]} keys)")


def profile_cbf(card: str):
    """``--profile``: device time by kernel (``torch.profiler``) of the
    binned cbf add and the binned contains in the two cbf cells (2^23 keys
    into 2^27 bits, 2^28 into 2^32, k = 11), the scatter's time among
    them."""
    for n, log2m in ((1 << 23, 27), (1 << 28, 32)):
        spec = V.FilterSpec("cbf", 1 << log2m, 11)
        words, keys = V.init(spec, "cuda"), gen_keys(n, 21)
        cbf.add_vmem(spec, words, keys, path="binned")
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            cbf.add_vmem(spec, words, keys, path="binned")
            torch.cuda.synchronize()
        rows = sorted(((getattr(e, "device_time_total", 0), e.count, e.key)
                       for e in prof.key_averages()), reverse=True)
        rows = [r for r in rows if r[0] > 0]
        print(f"profile cbf binned add [{card}] ({spec}, {n} keys, "
              f"{cbf.LAST_ADD_PLAN['batches']} batches): "
              + (", ".join(f"{k.split('::')[-1][:40]} x{c} "
                           f"{us / 1e3:.4f} ms" for us, c, k in rows)
                 + f"; device total {sum(r[0] for r in rows) / 1e3:.4f} ms"
                 if rows else "no device time recorded (not measured)"))
        with torch.profiler.profile(activities=acts) as prof:
            cbf.contains_vmem(spec, words, keys, path="binned")
            torch.cuda.synchronize()
        rows = sorted(((getattr(e, "device_time_total", 0), e.count, e.key)
                       for e in prof.key_averages()), reverse=True)
        rows = [r for r in rows if r[0] > 0]
        print(f"profile cbf binned contains [{card}] ({spec}, {n} keys, "
              f"{cbf.LAST_CONTAINS_PLAN['batches']} batches): "
              + (", ".join(f"{k.split('::')[-1][:40]} x{c} "
                           f"{us / 1e3:.4f} ms" for us, c, k in rows)
                 + f"; device total {sum(r[0] for r in rows) / 1e3:.4f} ms"
                 if rows else "no device time recorded (not measured)"))
        del words, keys
        torch.cuda.empty_cache()


def profile_cuckoo(card: str):
    """``--profile``: device time by kernel of the cuckoo contains in the
    two cells' shapes (u16 x 4; 16 MiB with 7,549,747 keys, 512 MiB with
    241,591,910 keys, tables at load 0.9 from ``cuckoo_table_at``)."""
    for cell, n_buckets, n in (("L2", 1 << 21, 7549747),
                               ("DRAM", 1 << 26, 241591910)):
        spec = cuckoo_spec(16, 4, n_buckets)
        members = gen_keys(min(n, 1 << 24), 852)
        table = cuckoo_table_at(spec, 0.9, members, 853)
        keys = mixed_keys(members, members, n, 1.0)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        ckoo.contains_vmem(spec, table, keys)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            ckoo.contains_vmem(spec, table, keys)
            torch.cuda.synchronize()
        print(f"profile cuckoo {cell} contains [{card}] ({spec}, load 0.9, "
              f"{n} keys): {profile_rows(prof)}", flush=True)
        del members, table, keys
        torch.cuda.empty_cache()


def profile_rows(prof) -> str:
    """A profile's kernels by device time, largest first, and the total."""
    rows = sorted(((getattr(e, "device_time_total", 0), e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    rows = [r for r in rows if r[0] > 0]
    if not rows:
        return "no device time recorded (not measured)"
    return (", ".join(f"{k.split('::')[-1][:40]} x{c} {us / 1e3:.4f} ms"
                      for us, c, k in rows)
            + f"; device total {sum(r[0] for r in rows) / 1e3:.4f} ms")


def profile_ring(card: str):
    """``--profile``: device time by kernel (``torch.profiler``) of the
    DRAM windowed cell's binned contains (2^26 keys against 4 generations
    of 2^30 bits) and of the DRAM partitioned sbf add at the fitting count
    (a 2^24-key batch into 2^32 bits, n_segments 4096, global path)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    G = 4
    spec = V.FilterSpec("sbf", 1 << 30, 8, block_bits=256)
    keys = gen_keys(1 << 26, 31)
    rings = torch.zeros((G, spec.n_words), dtype=torch.int32, device="cuda")
    for g, chunk in enumerate(keys.split(keys.shape[0] // G)):
        sbf.add_hbm(spec, rings[g], chunk)
    ring.ring_contains_hbm(spec, rings, keys, path="binned")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        ring.ring_contains_hbm(spec, rings, keys, path="binned")
        torch.cuda.synchronize()
    print(f"profile ring binned contains [{card}] ({G} x {spec}, "
          f"{keys.shape[0]} keys, {ring.LAST_CONTAINS_PLAN['batches']} "
          f"batches): {profile_rows(prof)}")
    del rings
    spec = V.FilterSpec("sbf", 1 << 32, 8, block_bits=256)
    words = V.init(spec, "cuda")
    part = ops._partition_device(spec, keys[:DRAM_BATCH], 4096, None)
    sbf.add_partitioned(spec, words, part.keys_by_seg, part.valid, 4096)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        sbf.add_partitioned(spec, words, part.keys_by_seg, part.valid, 4096)
        torch.cuda.synchronize()
    print(f"profile partitioned sbf add [{card}] ({spec}, {DRAM_BATCH} "
          f"keys, n_segments 4096, {sbf.LAST_PARTITIONED_PLAN['path']}): "
          f"{profile_rows(prof)}")
    del words, keys, part
    torch.cuda.empty_cache()


def profile_quotient(card: str):
    """``--profile``: device time by kernel (``torch.profiler``) of one
    update and one contains in each quotient cell's shapes (L2: q23, a
    2^22-key batch; DRAM-side: q26, a 2^24-key batch): an add and a remove
    on the table at load 0.5, the binned contains, the cluster walk and
    the rule's path on 2^22 keys and the rule's path on every stored key,
    at load 0.5 and after filling to load 0.9, the merge of that table with
    one of a batch and its resize up: each kernel by name."""
    for cell, n, batch_n in (("L2", 1 << 22, 1 << 22),
                             ("DRAM", 1 << 25, 1 << 24)):
        spec = Q.spec_for_n(n)
        keys = gen_keys(spec.n_slots // 2, 850)
        table = Q.init(spec, "cuda")
        for chunk in batches(keys, batch_n):
            ops.quotient_add(spec, table, chunk, inplace=True)
        batch, probes = gen_keys(batch_n, 851), keys[:SUBSET]
        half = ops.quotient_add(spec, Q.init(spec, "cuda"),
                                keys[:batch_n])[0]
        full, more = table.clone(), gen_keys(int(spec.n_slots * 0.4), 854)
        for chunk in batches(more, batch_n):
            ops.quotient_add(spec, full, chunk, inplace=True)
        stored = torch.cat([keys, more])
        calls = {"add": lambda: qf.add_vmem(spec, table.clone(), batch,
                                            None),
                 "remove": lambda: qf.remove_vmem(spec, table.clone(),
                                                  keys[:batch_n], None),
                 "contains binned 2^22": lambda: qf._launch_contains(
                     spec, table, probes, "binned"),
                 "contains walk 2^22": lambda: qf._launch_contains(
                     spec, table, probes, "walk"),
                 "contains rule 2^22": lambda: qf.contains_vmem(
                     spec, table, probes),
                 "contains every key": lambda: qf.contains_vmem(spec, table,
                                                                keys),
                 "contains every key at load 0.9": lambda: qf.contains_vmem(
                     spec, full, stored),
                 "merge": lambda: qf.merge_vmem(spec, table, half),
                 "resize up": lambda: qf.resize_vmem(
                     spec, table, Q.spec_for_resize(spec, 2 * spec.m_bits))}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for label, call in calls.items():
            call()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                call()
                torch.cuda.synchronize()
            rows = sorted(((getattr(e, "device_time_total", 0), e.count,
                            e.key) for e in prof.key_averages()),
                          reverse=True)
            rows = [r for r in rows if r[0] > 0]
            total = sum(r[0] for r in rows)
            print(f"profile quotient {cell} {label} [{card}] ({spec}, load "
                  f"0.5, {batch_n} keys): "
                  + (", ".join(f"{k[:40]} x{c} {us / 1e3:.4f} ms"
                               for us, c, k in rows[:16])
                     + f"; device total {total / 1e3:.4f} ms" if rows
                     else "no device time recorded (not measured)"),
                  flush=True)
        del keys, table, batch, probes, half, full, more, stored
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The calibration kernels, the tuner and the performance model (phases 3g,
# 4g)
# ---------------------------------------------------------------------------

CALIB_SOURCE = "src/repro_torch/kernels/csrc/calibrate.cu"
CALIB_REPLACES = "src/repro/perfmodel/calibrate.py:177"
L2_SWEEP_MIB = (8, 16, 24, 32, 40, 48, 64)
SWEEP_REPS, SWEEP_ROUNDS = 10, 3
MIB = 1 << 20


def checksum(t: torch.Tensor) -> int:
    """u32 sum of an int32 tensor's words."""
    return int(H.u32(t).sum().item()) & H.M32


def phase_calibrate_kernels(errs: dict):
    """The step kernel at g = 1, 16 and the measuring grid (words with the
    u32 wrap among them), and the chain and gather kernels at the probes'
    shapes and at small ragged ones, each against its plain version."""
    dev = torch.device("cuda")
    grid = PC.step_grid(dev)
    gen = torch.Generator(device="cuda").manual_seed(700)
    for g in (1, 16, grid):
        x = torch.randint(-(1 << 31), 1 << 31, (kc.BLOCK_ROWS * g,
                                                kc.BLOCK_COLS),
                          dtype=torch.int32, device="cuda", generator=gen)
        x[0, :4] = torch.tensor([-1, 0x7FFFFFFF, 0, -2], dtype=torch.int32)
        out = kc.step(x, torch.empty_like(x))
        errs["step"] = max(errs["step"], max_err(out, kc.step_plain(x)))
    sms = kc.sm_count(dev)
    width = (PC.CARD_GOPS_WAVES * sms * kc.blocks_per_sm("chain", dev)
             * kc.THREADS)
    sums = []
    for n, iters in ((width, 512), (kc.THREADS, PC.CARD_GOPS_ITERS),
                     (1000, 16)):
        out = kc.chain(torch.empty((n,), dtype=torch.int32, device="cuda"),
                       iters)
        errs["chain"] = max(errs["chain"], max_err(
            out, kc.chain_plain(n, iters, "cuda")))
        sums.append(f"chain {n} x {iters}: {checksum(out):#010x}")
    threads = sms * kc.blocks_per_sm("gather", dev) * kc.THREADS
    per = PC.CARD_RES_GATHERS // threads
    for words, n, p in ((PC.CARD_RES_TABLE_BYTES // 4, threads, per),
                        (1024, 1000, 3)):
        table = kc.gather_table(words, "cuda")
        out = kc.gather(table, torch.empty((n,), dtype=torch.int32,
                                           device="cuda"), p)
        errs["gather"] = max(errs["gather"], max_err(
            out, kc.gather_plain(table, n, p)))
        sums.append(f"gather {n} x {p} of {words} words: "
                    f"{checksum(out):#010x}")
    torch.cuda.synchronize()
    print(f"kernels: calibrate: step at g = 1, 16, {grid} equal to x + 1; "
          f"chain and gather equal to their plain versions, checksums "
          + "; ".join(sums))


def cell_spec(n: int, variant: str) -> V.FilterSpec:
    """The spec ``filter_for_n_items(n, bits_per_key=16, variant=variant,
    block_bits=256)`` sizes."""
    m = 1 << max(int(math.ceil(math.log2(n * 16))), 10)
    return V.FilterSpec(variant, m, V.snap_k(variant, m / n, 256), 256)


def depth_sweep(label: str, card: str, resolved: int, run) -> dict:
    """Time ``run(depth)`` at every depth of ``DMA_DEPTHS`` and at the
    depth the tuner resolves; print both."""
    t = {d: time_ms(lambda d=d: run(d), f"{label} depth={d}", SWEEP_REPS,
                    SWEEP_ROUNDS) for d in sbf.DMA_DEPTHS}
    best = min(t, key=t.get)
    slow = t[resolved] / t[best] - 1.0
    print(f"depth sweep {label} [{card}]: tuned depth {resolved} "
          f"{t[resolved]:.4f} ms; " + ", ".join(
              f"depth {d} {v:.4f} ms" for d, v in t.items())
          + f"; best depth {best}, tuned {slow:+.1%} against it"
          + (" (more than 5 % slower)" if slow > 0.05 else ""))
    return {"tuned_depth": resolved, "tuned_ms": t[resolved],
            "best_depth": best, "best_ms": t[best],
            "ms": {str(d): v for d, v in t.items()}}


def phase_depth_sweeps(card: str) -> dict:
    """Rows 3, 5, 13 and 16 at the DRAM cells' full size: each contains at
    every depth and at the depth ``ops`` resolves (``tune_plan``). Row 19
    takes no depth (its one-pass kernel keeps one key a group in
    flight)."""
    dev = torch.device("cuda")
    out = {}

    def resolved(spec, bank=1):
        return ops._resolve_depth(spec, "contains", None, DEFAULT_TILE,
                                  bank=bank, device=dev)

    # row 3: sbf, 2^28 keys into 2^32 bits
    spec = cell_spec(1 << 28, "sbf")
    keys = gen_keys(1 << 28, 1)
    words = sbf.add_hbm(spec, V.init(spec, "cuda"), keys)
    out["row 3"] = depth_sweep("row 3 sbf contains_hbm", card,
                               resolved(spec), lambda d: sbf.contains_hbm(
                                   spec, words, keys, depth=d))
    del words
    # row 5: sbf bank, 1024 members of 2^18 keys, 2^28 routed keys
    spec = cell_spec(1 << 18, "sbf")
    member = gen_members(1 << 28, BANK_MEMBERS, 52)
    bank = torch.zeros((BANK_MEMBERS, spec.n_words), dtype=torch.int32,
                       device="cuda")
    sbf._launch_bank_add(spec, bank, keys, member, None,
                         bank_geometry(spec, "add"))
    out["row 5"] = depth_sweep(
        "row 5 sbf bank_contains_vmem (DRAM)", card,
        resolved(spec, BANK_MEMBERS),
        lambda d: sbf._launch_bank_contains(
            spec, bank, keys, member,
            bank_geometry(spec, "contains", "DRAM", d)))
    del bank, member, keys
    torch.cuda.empty_cache()
    # row 13: countingbf, 2^26 keys into 512 MiB of counters
    spec = cell_spec(1 << 26, "countingbf")
    keys = gen_keys(1 << 26, 1)
    words = cnt.update_hbm(spec, V.init(spec, "cuda"), keys, None, "add")
    out["row 13"] = depth_sweep(
        "row 13 countingbf contains_hbm", card, resolved(spec),
        lambda d: cnt.contains_hbm(spec, words, keys, depth=d))
    del words
    # row 16: countingbf bank, 1024 members of 2^16 keys
    spec = cell_spec(1 << 16, "countingbf")
    member = gen_members(1 << 26, BANK_MEMBERS, 52)
    bank = torch.zeros((BANK_MEMBERS, spec.storage_words),
                       dtype=torch.int32, device="cuda")
    cnt.bank_update_vmem(spec, bank, keys, member, None, "add")
    out["row 16"] = depth_sweep(
        "row 16 countingbf bank_contains_vmem (DRAM)", card,
        resolved(spec, BANK_MEMBERS),
        lambda d: counting_bank_contains_at(spec, bank, keys, member, d))
    del bank, member, keys
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out


def phase_l2_sweep(card: str, depth_of) -> dict:
    """The L2 crossover: the sbf and countingbf contains through the L2
    schedule (``contains_vmem``, depth 1) and the DRAM schedule
    (``contains_hbm``) at every depth of ``DMA_DEPTHS``, on filters of 8-64
    MiB at 16 bits a key, querying the inserted keys. Power-of-two sizes
    run one filter; every size also runs a bank of 8 MiB members (the sizes
    in between have no single filter), through the bank kernel's two
    schedules. Two crossovers: against the DRAM schedule at the depth the
    tuner resolves (what the dispatch runs past ``L2_FILTER_BYTES``), and
    against it at its best depth."""
    t = {}
    for variant in ("sbf", "countingbf"):
        ratio = 4 if variant == "countingbf" else 1     # storage / bit bytes
        member = cell_spec(8 * MIB * 8 // 16 // ratio, variant)
        for mib in L2_SWEEP_MIB:
            if mib & (mib - 1) == 0:
                spec = cell_spec(mib * MIB * 8 // 16 // ratio, variant)
                n = spec.m_bits // 16
                keys = gen_keys(n, 60 + mib)
                if variant == "sbf":
                    words = sbf.add_vmem(spec, V.init(spec, "cuda"), keys)
                    l2 = functools.partial(sbf.contains_vmem, spec, words,
                                           keys)
                    dram = functools.partial(sbf.contains_hbm, spec, words,
                                             keys)
                else:
                    words = cnt.update_vmem(spec, V.init(spec, "cuda"), keys,
                                            None, "add")
                    l2 = functools.partial(cnt.contains_vmem, spec, words,
                                           keys)
                    dram = functools.partial(cnt.contains_hbm, spec, words,
                                             keys)
                label = f"{variant} {mib} MiB filter"
                t[label] = (
                    time_ms(l2, f"{label} L2", SWEEP_REPS, SWEEP_ROUNDS),
                    {d: time_ms(lambda d=d: dram(depth=d),
                                f"{label} DRAM depth={d}", SWEEP_REPS,
                                SWEEP_ROUNDS) for d in sbf.DMA_DEPTHS},
                    depth_of(spec, 1), mib)
                del words, keys
            B = mib // 8
            n = B * (member.m_bits // 16)
            keys, ids = gen_keys(n, 70 + mib), gen_members(n, B, 71 + mib)
            bank = torch.zeros((B, member.storage_words), dtype=torch.int32,
                               device="cuda")
            if variant == "sbf":
                sbf._launch_bank_add(member, bank, keys, ids, None,
                                     bank_geometry(member, "add"))
                l2 = functools.partial(
                    sbf._launch_bank_contains, member, bank, keys, ids,
                    bank_geometry(member, "contains", "L2"))

                def dram(d):
                    return sbf._launch_bank_contains(
                        member, bank, keys, ids,
                        bank_geometry(member, "contains", "DRAM", d))
            else:
                cnt.bank_update_vmem(member, bank, keys, ids, None, "add")
                l2 = functools.partial(counting_bank_contains_at, member,
                                       bank, keys, ids, 1)

                def dram(d):
                    return counting_bank_contains_at(member, bank, keys, ids,
                                                     d)
            label = f"{variant} {mib} MiB bank of {B}"
            t[label] = (
                time_ms(l2, f"{label} L2", SWEEP_REPS, SWEEP_ROUNDS),
                {d: time_ms(lambda d=d: dram(d), f"{label} DRAM depth={d}",
                            SWEEP_REPS, SWEEP_ROUNDS)
                 for d in sbf.DMA_DEPTHS},
                depth_of(member, B), mib)
            del bank, keys, ids
        torch.cuda.empty_cache()
    res = {}
    for label, (l2, dram, tuned, mib) in t.items():
        best = min(dram, key=dram.get)
        res[label] = {"l2": l2, "dram": dram[tuned], "tuned_depth": tuned,
                      "dram_best": dram[best], "best_depth": best,
                      "dram_by_depth": {str(d): v for d, v in dram.items()},
                      "mib": mib}
        print(f"l2 sweep [{card}]: {label}: L2 schedule {l2:.4f} ms; DRAM "
              f"schedule at the tuned depth {tuned} {dram[tuned]:.4f} ms "
              f"({l2 / dram[tuned]:.3f} x), at its best depth {best} "
              f"{dram[best]:.4f} ms ({l2 / dram[best]:.3f} x)")

    def crossover(key):
        ok = {mib: all(r["l2"] <= r[key] for r in res.values()
                       if r["mib"] == mib) for mib in L2_SWEEP_MIB}
        cross = 0
        for mib in L2_SWEEP_MIB:
            if not ok[mib]:
                break
            cross = mib
        return cross, [m for m in L2_SWEEP_MIB if ok[m]]

    cross, ok_tuned = crossover("dram")
    cross_best, ok_best = crossover("dram_best")
    print(f"l2 sweep [{card}]: against the DRAM schedule at the tuned depth "
          f"the L2 schedule is no slower at {ok_tuned} MiB, crossover "
          f"{cross} MiB; at its best depth no slower at {ok_best} MiB, "
          f"crossover {cross_best} MiB (ops.L2_FILTER_BYTES is "
          f"{ops.L2_FILTER_BYTES // MIB} MiB)")
    torch.cuda.synchronize()
    return {"crossover_mib": cross, "crossover_best_depth_mib": cross_best,
            "ms": res}


def clear_tuning(cache: Path) -> None:
    """Forget every plan: the lru caches and the disk cache."""
    tuning.tune_plan.cache_clear()
    tuning.tune_layout.cache_clear()
    PM.choose_coop.cache_clear()
    cache.unlink(missing_ok=True)


def phase_tuning_main(card: str, errs: dict, out: dict, records: dict,
                      crecords: dict, cache: Path) -> dict:
    """Phase 4g: the slice's main path, ``perfmodel.get_calibration(
    measure=True)``, ``core.tuning.tune_plan`` of the cells and
    ``api.tuned_options``, counted; each probe called on its own (finite
    and > 0); the plans in both modes; the depth sweeps; the
    speed-of-light fractions; the step kernel's times and bound."""
    dev = torch.device("cuda")
    cells = {"sbf L2": cell_spec(1 << 23, "sbf"),
             "sbf DRAM": cell_spec(1 << 28, "sbf"),
             "countingbf L2": cell_spec(1 << 22, "countingbf"),
             "countingbf DRAM": cell_spec(1 << 26, "countingbf")}
    clear_tuning(cache)
    torch.cuda.synchronize()

    kc.reset_launches()                    # the main path, counted
    t0 = time.perf_counter()
    calib = PM.get_calibration(measure=True, device=dev)
    plans = {(cell, op): tuning.tune_plan(
        spec, op, regime=ops._regime(spec, "auto"), device=dev)
        for cell, spec in cells.items() for op in ("contains", "add")}
    pinned = api.tuned_options(cells["sbf DRAM"], "contains", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kc.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"calibrate {name} was not launched on the "
                                 f"tuning main path")
    if not calib.measured or calib.backend != PC.backend_key(dev):
        raise AssertionError(f"calibration {calib}: a probe failed")
    defaults = PC.default_calibration(device=dev)
    for name in PC.PROBES:             # every constant from its probe
        v = getattr(calib, name)
        if not (math.isfinite(v) and v > 0) or v == getattr(defaults, name):
            raise AssertionError(f"calibration {name} = {v!r} is not a "
                                 f"measurement (default "
                                 f"{getattr(defaults, name)!r})")
    if (pinned.depth != plans[("sbf DRAM", "contains")].depth
            or pinned.layout != sbf.card_layout(cells["sbf DRAM"],
                                                "contains")):
        raise AssertionError(f"tuned_options {pinned} against "
                             f"{plans[('sbf DRAM', 'contains')]}")
    print(f"tuning main path [{card}]: get_calibration(measure=True), "
          f"{len(plans)} plans and tuned_options in {wall * 1e3:.1f} ms "
          f"host clock; launches {launches}")

    probes = {}
    for name, probe in PC.PROBES.items():
        t1 = time.perf_counter()
        v = float(probe(device=dev))
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"probe {name} returned {v}")
        probes[name] = (v, (time.perf_counter() - t1) * 1e3)
    grid = PC.step_grid(dev)
    units = {"bw_hbm_gbs": "GB/s", "bw_res_gbs": "GB/s", "gops": "Gop/s",
             "launch_us": "us", "step_us": "us"}
    for name, (v, ms) in probes.items():
        print(f"calibration [{card}]: {name} = {getattr(calib, name)!r} "
              f"{units[name]} (main path), {v!r} (the probe again, "
              f"{ms:.1f} ms host clock)")
    print(f"calibration [{card}]: step grid {grid} CTAs = "
          f"{PC.CARD_STEP_WAVES} waves x {kc.sm_count(dev)} SMs x "
          f"{kc.blocks_per_sm('step', dev)} CTAs an SM; "
          f"defaults {PC.default_calibration(device=dev)}")

    for (cell, op), plan in plans.items():
        measured = tuning.tune_plan(cells[cell], op,
                                    regime=ops._regime(cells[cell], "auto"),
                                    mode="measure", device=dev)
        print(f"plan {cell} {op} [{card}]: structural {plan.to_dict()}; "
              f"measure {measured.to_dict()}")

    sweeps = phase_depth_sweeps(card)

    def depth_of(spec, bank):
        return ops._resolve_depth(spec, "contains", None, DEFAULT_TILE,
                                  bank=bank, device=dev)

    l2 = phase_l2_sweep(card, depth_of)

    # measured Mops/s over the model's ceiling, rows 1-4 and 10-13
    sol = {}
    rows = [(1, records["contains_vmem"], "sbf L2", "contains"),
            (2, records["add_vmem"], "sbf L2", "add"),
            (3, records["contains_hbm"], "sbf DRAM", "contains"),
            (4, records["add_hbm"], "sbf DRAM", "add"),
            (10, crecords["update_vmem"], "countingbf L2", "add"),
            (11, crecords["contains_vmem"], "countingbf L2", "contains"),
            (12, crecords["update_hbm"], "countingbf DRAM", "add"),
            (13, crecords["contains_hbm"], "countingbf DRAM", "contains")]
    for row, rec, cell, op in rows:
        spec, plan = cells[cell], plans[(cell, op)]
        n = rec["main_n_keys"]
        cfg = dict(probe=plan.probe, coop=plan.coop, mix=plan.mix,
                   depth=plan.depth)
        ceiling = PM.ceiling_mops(spec, op, ops._regime(spec, "auto"),
                                  n_keys=n, calib=calib, **cfg)
        mops = n / rec["main_ms"] / 1e3
        sol[row] = mops / ceiling
        extra = ""
        if row in (3, 13):
            tuned = sweeps[f"row {row}"]["tuned_ms"]
            extra = (f"; at the tuned depth {n / tuned / 1e3:.1f} Mops/s, "
                     f"{n / tuned / 1e3 / ceiling:.3f}")
        print(f"speed of light row {row} {cell} {op} [{card}]: "
              f"{RU.fmt_rate(mops * 1e6, 'ops/s')} measured at {n} keys, "
              f"ceiling_mops {ceiling:.1f}, fraction {sol[row]:.3f}{extra}")

    # row 24: the step kernel at the measuring grid, and measure_step_us
    x = torch.zeros((kc.BLOCK_ROWS * grid, kc.BLOCK_COLS), dtype=torch.int32,
                    device="cuda")
    y = torch.empty_like(x)
    one = torch.zeros((kc.BLOCK_ROWS, kc.BLOCK_COLS), dtype=torch.int32,
                      device="cuda")
    one_out = torch.empty_like(one)
    t = {"step": time_ms(lambda: kc.step(x, y), "step"),
         "step 1": time_ms(lambda: kc.step(one, one_out), "step 1"),
         "plain": time_ms(lambda: kc.step_plain(x), "step plain"),
         "library": time_ms(lambda: torch.add(x, 1, out=y), "step library")}
    t0 = time.perf_counter()
    step_us = PC.measure_step_us(device=dev)
    t_probe = (time.perf_counter() - t0) * 1e3
    nbytes = 2 * x.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = x.numel() / OPS_PER_S * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
    cta_ns = 2 * kc.BLOCK_ROWS * kc.BLOCK_COLS * 4 / HBM_BYTES_PER_S * 1e9
    lo, hi = SPREAD["step"]
    print(f"time row 24 step [{card}]: kernel {t['step']:.4f} ms (rounds "
          f"{lo:.4f}-{hi:.4f}) at g = {grid} ({nbytes / MIB:.0f} MiB moved), "
          f"bound {bound:.4f} ms ({by}), {bound / t['step']:.1%} of it; one "
          f"CTA {t['step 1']:.4f} ms a call in a run of calls (launch- and "
          f"host-bound; its bound {cta_ns:.2f} ns); plain {t['plain']:.4f} ms, torch.add "
          f"{t['library']:.4f} ms; measure_step_us {t_probe:.2f} ms host "
          f"clock, step_us {step_us * 1e3:.3f} ns against {cta_ns:.3f} ns "
          f"of DRAM traffic a CTA")
    out["step"] = {
        "name": "calibrate_step", "route": "cuda", "source": CALIB_SOURCE,
        "replaces": CALIB_REPLACES, "launches": launches["step"],
        "max_abs_err": errs["step"], "ms": t["step"], "plain_ms": t["plain"],
        "bound_ms": bound, "bound_by": by, "library_ms": t["library"],
        "grid": grid, "one_cta_ms": t["step 1"], "step_us": step_us,
        "measure_step_us_ms": t_probe, "chain_launches": launches["chain"],
        "gather_launches": launches["gather"],
        "chain_max_abs_err": errs["chain"],
        "gather_max_abs_err": errs["gather"]}
    del x, y
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"calibration": calib.to_dict(),
            "probes": {k: v for k, (v, _) in probes.items()},
            "plans": {f"{c} {o}": p.to_dict() for (c, o), p in plans.items()},
            "depth_sweeps": sweeps, "l2_sweep": l2,
            "speed_of_light": sol}


# ---------------------------------------------------------------------------
# Phase 5: the filter service on the card
# ---------------------------------------------------------------------------

SERVICE_TENANTS = 64           # the main cell's bank: 64 sbf members
SERVICE_N_PER = 1 << 20        # keys a member is sized for: 2 MiB a member
SERVICE_BATCH = 1 << 16        # the static flush shape
SERVICE_BURST = 1 << 14        # requests a submit_many call
SERVICE_REQUESTS = 1 << 21     # adds, then as many contains
SERVICE_QUOTA = 1 << 12        # pending requests a tenant: tenant 0 passes it
SERVICE_CKPT = ROOT / "build" / "repro_torch" / "service_ckpt"


class VirtualClock:
    """The service clock of a replayable run: a burst a second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def service_of(bank, max_batch: int, clock, **policy) -> "S.FilterService":
    from repro_torch.telemetry import TelemetryConfig
    cfg = S.ServiceConfig(max_batch=max_batch, flush_deadline=4.0,
                          admission=S.AdmissionPolicy(**policy),
                          telemetry=TelemetryConfig(max_spans=1 << 17))
    return S.FilterService(bank, cfg, clock=clock)


def on_flushes(svc, each) -> None:
    """Call ``each(op)`` after every flush of ``svc`` (the smoke's own
    hook: it keeps each flush's words and results for the comparisons)."""
    inner = svc._flush_op

    def flush(op: str, trigger: str) -> None:
        inner(op, trigger)
        each(op)

    svc._flush_op = flush


def drive(svc, clock, op: str, keys, tenants, maint=None, step0: int = 0
          ) -> np.ndarray:
    """``op`` requests in bursts through ``submit_many``, ``pump()`` after
    each (and a maintenance tick), the virtual clock a burst a second;
    returns the seq ids."""
    seqs = []
    for i, first in enumerate(range(0, keys.shape[0], SERVICE_BURST)):
        clock.t = float(step0 + i)
        seqs.append(svc.submit_many(op, keys[first:first + SERVICE_BURST],
                                    tenants[first:first + SERVICE_BURST]))
        svc.pump()
        if maint is not None:
            maint.tick(svc, step0 + i + 1)
    return np.concatenate(seqs)


def service_flushes(svc, log: list) -> None:
    """Keep each flush's outcome in ``log``: the filter after an add (the
    update returned new words) and the results of a contains."""
    def each(op):
        if op == "contains":
            log.append(("contains", svc.take_results()))
        else:
            log.append((op, svc.filt))
    on_flushes(svc, each)


def compare_flushes(svc, log: list, label: str) -> list:
    """Hold each flush of ``svc`` against ``log``'s in order: the same op,
    words bit for bit, the same results; returns the checked indices."""
    seen = []

    def each(op):
        i = len(seen)
        if i >= len(log) or log[i][0] != op:
            raise AssertionError(f"{label}: flush {i} is a {op}, the card "
                                 f"run's a {log[i][0] if i < len(log) else '-'}")
        if op == "contains":
            if svc.take_results() != log[i][1]:
                raise AssertionError(f"{label}: flush {i}'s results differ")
        elif not torch.equal(svc.filt.words, log[i][1].words.to(
                svc.filt.device)):
            raise AssertionError(f"{label}: words after flush {i} differ")
        seen.append(i)
    on_flushes(svc, each)
    return seen


def span_stats(svc) -> dict:
    """Real-clock flush latencies and the shares of launch, sync and the
    rest (the tracer's clock is the real one in the timed run)."""
    tr = svc.telemetry.tracer
    flush = np.asarray([e["dur"] for e in tr.spans("service.flush")])
    part = {k: sum(e["dur"] for e in tr.spans(f"service.flush.{k}"))
            for k in ("pad", "launch", "sync", "results")}
    total = float(flush.sum())
    return {"flushes": int(flush.size),
            "p50_ms": float(np.percentile(flush, 50, method="inverted_cdf"))
            * 1e3,
            "p99_ms": float(np.percentile(flush, 99, method="inverted_cdf"))
            * 1e3,
            "launch_share": part["launch"] / total,
            "sync_share": part["sync"] / total,
            "rest_share": 1.0 - (part["launch"] + part["sync"]) / total}


def host_ms(fn, reps: int = 20) -> float:
    """Median wall time of ``fn`` (which waits for the card itself)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_service_main(card: str) -> dict:
    """The main cell at real size: a bank of 64 sbf tenants, each sized
    for 2^20 keys at 16 bits a key (2 MiB a member, 128 MiB a bank, past
    the 50 MB L2), flushes of 2^16; 2^21 adds (tenant 0 a quarter of them,
    past its quota of pending requests), then 2^21 contains (half keys that
    were added and admitted, half fresh), in bursts of 2^14 on a virtual
    clock. Timed on the card's kernels, then run again on the plain engine
    on the card (``torch``: the words stay on the card): every flush's
    words and results, the seq ids and the shed counts must be equal, and
    no admitted key may be missed."""
    rng = np.random.RandomState(5001)
    n = SERVICE_REQUESTS
    keys = H.random_u64x2(n, seed=5001)
    tenants = np.where(rng.rand(n) < 0.25, 0, rng.randint(
        1, SERVICE_TENANTS, n)).astype(np.int64)
    bank = api.filter_for_n_items(SERVICE_N_PER, bits_per_key=16,
                                  bank=SERVICE_TENANTS, device="cuda")
    policy = dict(queue_limit=1 << 18, tenant_quota=SERVICE_QUOTA)
    clock = VirtualClock()
    svc = service_of(bank, SERVICE_BATCH, clock, **policy)
    svc.telemetry.tracer.clock = time.perf_counter   # real-clock spans
    log = []
    service_flushes(svc, log)
    sbf.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    add_seqs = drive(svc, clock, "add", keys, tenants)
    svc.drain()
    t_add = time.perf_counter() - t0
    admitted = add_seqs >= 0
    fresh = H.probe_u64x2(n // 2, seed=5002)
    pick = rng.choice(np.nonzero(admitted)[0], n // 2, replace=False)
    q_keys = np.concatenate([keys[pick], fresh])
    q_ten = np.concatenate([tenants[pick], rng.randint(
        0, SERVICE_TENANTS, n // 2)]).astype(np.int64)
    order = rng.permutation(n)
    q_keys, q_ten = q_keys[order], q_ten[order]
    member = order < n // 2
    t1 = time.perf_counter()
    q_seqs = drive(svc, clock, "contains", q_keys, q_ten,
                   step0=n // SERVICE_BURST)
    svc.drain()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = dict(sbf.LAUNCHES)
    results = {}
    for op, out in log:
        if op == "contains":
            results.update(out)
    got = np.asarray([results[int(s)] for s in q_seqs])
    if not (q_seqs >= 0).all() or not got[member].all():
        raise AssertionError("service main cell: a false negative on an "
                             "admitted add, or a contains shed")
    n_add = sum(1 for op, _ in log if op == "add")
    n_con = len(log) - n_add
    if (launches["bank_add_vmem"] != n_add
            or launches["bank_contains_vmem"] != n_con
            or sum(launches.values()) != n_add + n_con):
        raise AssertionError(f"service main cell: launches {launches} for "
                             f"{n_add} add and {n_con} contains flushes")
    spans = span_stats(svc)
    shed = svc.admission.shed_by_tenant.copy()
    counts = dict(svc.admission.shed_counts)
    if counts["quota"] == 0 or shed[1:].sum() != 0:
        raise AssertionError(f"service main cell: shed {counts}, "
                             f"{int(shed[1:].sum())} outside tenant 0")
    # the plain engine on the card, the same stream
    clock2 = VirtualClock()
    plain = service_of(bank.replace(backend="torch"), SERVICE_BATCH, clock2,
                       **policy)
    checked = compare_flushes(plain, log, "service main cell (plain)")
    t2 = time.perf_counter()
    p_add = drive(plain, clock2, "add", keys, tenants)
    plain.drain()
    p_q = drive(plain, clock2, "contains", q_keys, q_ten,
                step0=n // SERVICE_BURST)
    plain.drain()
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t2
    if (len(checked) != len(log) or not np.array_equal(p_add, add_seqs)
            or not np.array_equal(p_q, q_seqs)
            or not np.array_equal(plain.admission.shed_by_tenant, shed)
            or plain.admission.shed_counts != counts
            or not torch.equal(plain.filt.words, svc.filt.words)):
        raise AssertionError("service main cell: the plain engine's run "
                             "differs (seqs, shed counts or words)")
    fill_ms = host_ms(lambda: S.member_fill(svc.filt), 10)
    clone_ms = time_ms(lambda: svc.filt.words.clone(), "service clone", 10, 3)
    ids = torch.from_numpy(tenants[:SERVICE_BATCH].astype(np.int32)).cuda()
    check_ms = host_ms(lambda: P.check_ids(ids, SERVICE_TENANTS))
    add_ms = time_ms(lambda: svc.filt.add(
        torch.from_numpy(keys[:SERVICE_BATCH].view(np.int32)).cuda(),
        tenants=ids), "service routed add", 10, 3)
    out = {"card": card, "engine": svc.filt.backend,
           "bank_bytes": svc.filt.nbytes, "tenants": SERVICE_TENANTS,
           "max_batch": SERVICE_BATCH, "requests": 2 * n,
           "flushes": len(log), "add_flushes": n_add,
           "contains_flushes": n_con,
           "requests_per_s": 2 * n / t_all, "flushes_per_s": len(log) / t_all,
           "add_phase_s": t_add, "contains_phase_s": t_all - t_add,
           **spans, "member_fill_ms": fill_ms,
           "health_refreshes": len(log) // S.AdmissionPolicy().health_every,
           "bank_clone_ms": clone_ms, "routed_id_check_ms": check_ms,
           "routed_add_call_ms": add_ms, "shed": counts,
           "admitted_adds": int(admitted.sum()),
           "launches": {k: v for k, v in launches.items() if v},
           "plain_run_s": t_plain}
    print(f"service main cell [{card}]: {out['engine']} bank of "
          f"{SERVICE_TENANTS} sbf x {bank.spec} ({out['bank_bytes']} B), "
          f"flushes of {SERVICE_BATCH}: {2 * n} requests in {t_all:.3f} s "
          f"({out['requests_per_s']:.0f} requests/s, "
          f"{out['flushes_per_s']:.1f} flushes/s; {n_add} add and {n_con} "
          f"contains flushes), flush latency p50 {spans['p50_ms']:.4f} ms "
          f"p99 {spans['p99_ms']:.4f} ms (real clock), shares launch "
          f"{spans['launch_share']:.3f} sync {spans['sync_share']:.3f} rest "
          f"{spans['rest_share']:.3f}; member_fill {fill_ms:.4f} ms a "
          f"refresh; bank clone {clone_ms:.4f} ms, routed id check "
          f"{check_ms:.4f} ms, a routed add call {add_ms:.4f} ms; shed "
          f"{counts} (tenant 0 only), {out['admitted_adds']} adds admitted; "
          f"launches {out['launches']}; plain engine run {t_plain:.2f} s, "
          f"every flush's words and results, seqs and shed counts equal")
    return out


def small_pass(card: str, label: str, make, policy: dict, maint_cfg, steps,
               max_batch, mid=None, launches=()):
    """One service pass on a small bank, on the card and then on the CPU
    (the plain versions): ``steps`` is a list of per-step request lists
    [(op, keys, tenants)]; ``mid(svc)`` runs after the middle step (a live
    change such as grow_bank). Every flush's words and results, the seq
    ids, shed counts, maintenance events, final words and engine state and
    the deterministic metrics must be equal. ``launches`` names (module,
    wrapper) pairs that the card run must have launched."""
    runs = []
    for device in ("cuda", "cpu"):
        clock = VirtualClock()
        svc = service_of(make(device), max_batch, clock, **policy)
        maint = S.MaintenanceLoop(maint_cfg) if maint_cfg else None
        log = []
        if device == "cuda":
            for mod, _ in launches:
                mod.reset_launches()
            service_flushes(svc, log)
        else:
            checked = compare_flushes(svc, runs[0]["log"], label)
        seqs = []
        for i, reqs in enumerate(steps):
            clock.t = float(i)
            for op, keys, tenants in reqs:
                seqs.append(svc.submit_many(op, keys, tenants))
            svc.pump()
            if maint is not None:
                maint.tick(svc, i + 1)
            if mid is not None and i == len(steps) // 2:
                mid(svc)
        svc.drain()
        if device == "cuda":
            torch.cuda.synchronize()
            got = {f"{mod.__name__.split('.')[-1]}.{w}": mod.LAUNCHES[w]
                   for mod, w in launches}
        runs.append({"log": log, "seqs": np.concatenate(seqs),
                     "shed": svc.admission.shed_by_tenant.copy(),
                     "events": maint.events if maint else [],
                     "words": svc.filt.words.cpu(),
                     "state": (svc.filt.state.cpu()
                               if isinstance(svc.filt.state, torch.Tensor)
                               else svc.filt.state),
                     "metrics": svc.telemetry.registry.snapshot_state(
                         deterministic_only=True),
                     "spec": svc.filt.spec, "svc": svc})
    card_name = card
    card, cpu = runs
    same_state = (torch.equal(card["state"], cpu["state"])
                  if isinstance(card["state"], torch.Tensor)
                  else card["state"] == cpu["state"])
    if (len(checked) != len(card["log"])
            or not np.array_equal(card["seqs"], cpu["seqs"])
            or not np.array_equal(card["shed"], cpu["shed"])
            or card["events"] != cpu["events"] or card["spec"] != cpu["spec"]
            or not torch.equal(card["words"], cpu["words"]) or not same_state
            or card["metrics"] != cpu["metrics"]):
        raise AssertionError(f"service {label}: the card's run differs from "
                             f"the plain versions'")
    missing = [k for k, v in got.items() if v == 0]
    if missing:
        raise AssertionError(f"service {label}: no launch of {missing}")
    print(f"service {label} [{card_name}]: {len(card['log'])} flushes, "
          f"{int((card['seqs'] >= 0).sum())} admitted of "
          f"{card['seqs'].size}, shed {dict(card['svc'].admission.shed_counts)}"
          f", maintenance {[e['kind'] for e in card['events']]}; launches "
          f"{got}; every flush, seqs, shed counts, words, state and metrics "
          f"equal to the plain versions")
    return card["svc"], got


def service_steps(rng, n_steps: int, n: int, tenants: int, ops, seed: int):
    """Per-step request lists: each step's ``ops`` ("add" of fresh keys,
    "remove" of half the last step's adds, "contains" of the last adds and
    probes), tenants uniform."""
    steps, last = [], None
    for i in range(n_steps):
        keys = H.random_u64x2(n, seed=seed + i)
        ten = rng.randint(0, tenants, n).astype(np.int64)
        reqs = []
        for op in ops:
            if op == "add":
                reqs.append(("add", keys, ten))
            elif op == "remove" and last is not None:
                reqs.append(("remove", last[0][: n // 2], last[1][: n // 2]))
            elif op == "contains":
                probe = H.probe_u64x2(n // 2, seed=seed + 1000 + i)
                reqs.append(("contains", np.concatenate([keys[: n // 2],
                                                         probe]),
                             np.concatenate([ten[: n // 2],
                                             ten[n // 2:]])))
        steps.append(reqs)
        last = (keys, ten)
    return steps


def phase_service_engines(card: str) -> dict:
    """The other engines behind the service at small sizes, each against
    its plain versions: a counting bank with removes and the decay cadence,
    a windowed bank with the advance cadence, a cuckoo bank pushed past its
    load (admission sheds adds on insert failures), a quotient bank grown
    in place by ``grow_capacity``, and ``grow_bank`` on a live service."""
    rng = np.random.RandomState(5100)
    out = {}
    steps = service_steps(rng, 8, 1 << 12, 16, ("add", "remove", "contains"),
                          5100)
    _, out["counting"] = small_pass(
        card,
        "counting bank (16 x 2^14 keys, removes, decay every 3 ticks)",
        lambda d: api.filter_for_n_items(1 << 14, variant="countingbf",
                                         bank=16, device=d),
        {}, S.MaintenanceConfig(decay_every=3), steps, 1 << 12,
        launches=[(cnt, "bank_update_vmem"), (cnt, "bank_contains_vmem"),
                  (cnt, "decay")])
    steps = service_steps(rng, 8, 1 << 12, 16, ("add", "contains"), 5200)
    _, out["windowed"] = small_pass(
        card,
        "windowed bank (16 x 2^14 keys, 4 generations, advance every 2)",
        lambda d: api.filter_for_n_items(1 << 14, generations=4, bank=16,
                                         device=d),
        {}, S.MaintenanceConfig(advance_every=2), steps, 1 << 12,
        launches=[(sbf, "add_vmem"), (ring, "ring_contains_vmem")])
    steps = service_steps(rng, 6, 1 << 11, 8, ("add", "contains"), 5300)
    svc, out["cuckoo"] = small_pass(
        card, "cuckoo bank (8 x 2^10 slots, pushed past its load)",
        lambda d: api.make_filter_bank(8, variant="cuckoo", m_bits=1 << 13,
                                       device=d),
        {"health_every": 1}, None, steps, 1 << 10,
        launches=[(ckoo, "add_vmem"), (ckoo, "contains_vmem")])
    if svc.admission.shed_counts["health"] == 0:
        raise AssertionError("service cuckoo pass: no add shed on insert "
                             "failures")
    steps = service_steps(rng, 12, 1 << 8, 8, ("add", "contains"), 5400)
    svc, out["quotient"] = small_pass(
        card, "quotient bank (8 members grown in place by grow_capacity)",
        lambda d: api.filter_for_n_items(200, variant="quotient",
                                         target_fpr=1e-3, bank=8, device=d),
        {"health_every": 1}, S.MaintenanceConfig(resize_every=1), steps,
        1 << 8, launches=[(qf, "add_vmem"), (qf, "resize_vmem"),
                          (qf, "contains_vmem")])
    if svc.filt.spec.m_bits == api.filter_for_n_items(
            200, variant="quotient", target_fpr=1e-3, device="cpu"
            ).spec.m_bits:
        raise AssertionError("service quotient pass: the bank never grew")
    steps = service_steps(rng, 8, 1 << 12, 8, ("add", "contains"), 5500)
    steps[5].append(("add", H.random_u64x2(1 << 11, seed=5599),
                     rng.randint(8, 12, 1 << 11).astype(np.int64)))
    svc, out["grow_bank"] = small_pass(
        card,
        "sbf bank grown 8 -> 12 members on a live service (grow_bank)",
        lambda d: api.filter_for_n_items(1 << 14, bank=8, device=d),
        {}, None, steps, 1 << 12,
        mid=lambda s: S.reshard_service(s, bank=12),
        launches=[(sbf, "bank_add_vmem"), (sbf, "bank_contains_vmem")])
    if svc.filt.bank_shape != (12,):
        raise AssertionError(f"grow_bank pass: bank {svc.filt.bank_shape}")
    return out


def phase_service_recovery(card: str) -> dict:
    """The recovery drill on the card: ``ServiceDriver`` over a seeded
    stream (adds and contains of 4096 requests a step into a bank of 16
    sbf members, flushes of 2^13, a flush-barrier checkpoint every 3
    steps, written in the background), once clean and once with a
    ``SimulatedFailure`` at step 7: restored from the last checkpoint and
    replayed, the final words, every flush's results and the deterministic
    counter snapshot must equal the clean run's."""
    import shutil

    tenants = 16

    def stream_fn(step):
        rng = np.random.RandomState(5600 + step)
        out = []
        for op in ("add", "contains"):
            keys = rng.randint(0, 2 ** 31, (4096, 2)).astype(np.uint32)
            out.append((op, keys, rng.randint(0, tenants, 4096)))
        return out

    runs = {}
    for name, fail_at in (("clean", None), ("failed", 7)):
        ckpt_dir = SERVICE_CKPT / name
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        bank = api.filter_for_n_items(1 << 16, bank=tenants, device="cuda")
        svc = service_of(bank, 1 << 13, VirtualClock())
        maint = S.MaintenanceLoop(S.MaintenanceConfig(
            checkpoint_every=3, ckpt_dir=str(ckpt_dir)))
        fired = []

        def hook(step, fail_at=fail_at, fired=fired):
            if fail_at is not None and step == fail_at and not fired:
                fired.append(step)
                raise SimulatedFailure(f"injected at step {step}")

        drv = S.ServiceDriver(svc, stream_fn, maint,
                              S.ServiceDriverConfig(virtual_dt=1.0),
                              failure_hook=hook)
        results = {}
        feed = drv._feed

        def fed(step, feed=feed, svc=svc, results=results):
            feed(step)
            results.update(svc.take_results())

        drv._feed = fed
        t0 = time.perf_counter()
        final = drv.run(12)
        torch.cuda.synchronize()
        results.update(drv.service.take_results())
        runs[name] = {"final": final, "drv": drv, "results": results,
                      "s": time.perf_counter() - t0}
    clean, failed = runs["clean"], runs["failed"]
    kinds = [e["kind"] for e in failed["drv"].events]
    reg = [r["drv"].service.telemetry.registry.snapshot_state(
        deterministic_only=True) for r in (clean, failed)]
    if (kinds.count("failure") != 1 or "restore" not in kinds
            or failed["final"].device.type != "cuda"
            or not torch.equal(clean["final"].words, failed["final"].words)
            or clean["results"] != failed["results"] or reg[0] != reg[1]):
        raise AssertionError(f"service recovery drill: events {kinds}; the "
                             f"replay differs from the clean run")
    restore = next(e for e in failed["drv"].events if e["kind"] == "restore")
    out = {"restored_step": restore["step"],
           "recovery_s": failed["drv"].recovery_times[0],
           "clean_s": clean["s"], "failed_s": failed["s"],
           "results": len(clean["results"])}
    print(f"service recovery drill [{card}]: failure at step 7, restored at "
          f"step {out['restored_step']} from the flush-barrier checkpoint on "
          f"the card, replayed; recovery {out['recovery_s'] * 1e3:.1f} ms; "
          f"final words, {out['results']} results and the deterministic "
          f"counters equal to the clean run's (clean {clean['s']:.2f} s, "
          f"with the failure {failed['s']:.2f} s)")
    return out


def phase_service(card: str) -> dict:
    """Phase 5: the port's filter service on the card (the main cell, the
    other engines, the recovery drill)."""
    t0 = time.perf_counter()
    out = {"main": phase_service_main(card)}
    out["engines"] = phase_service_engines(card)
    out["recovery"] = phase_service_recovery(card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"service: {json.dumps(out, default=str)}")
    return out


def quotient_phases(card: str, lap) -> dict:
    """Phases 3f and 4f and the quotient contains' rule sweep; returns the
    two kernel records."""
    qerrs = {"quotient_contains": 0, "quotient_update": 0}
    phase_quotient_kernels(qerrs)
    lap("phase 3f")
    qcells, qlaunches = {}, {}
    phase_quotient_main("L2", 1 << 22, 1 << 22, qerrs, qcells, qlaunches,
                        card)
    phase_quotient_main("DRAM", 1 << 25, 1 << 24, qerrs, qcells, qlaunches,
                        card)
    lap("phase 4f")
    phase_quotient_rule(card, qerrs)
    lap("quotient contains rule")
    return quotient_records(qcells, qerrs, qlaunches)


def contains_phases(card: str, lap, laps: list) -> int:
    """``--contains``: the phases of the quotient and cuckoo filters alone
    (3f, 4f and the quotient contains' rule sweep; 3e cuckoo and 4e cuckoo
    in both cells), for work on those kernels; prints the two contains
    records."""
    qrecords = quotient_phases(card, lap)
    kerrs = {"cuckoo_contains": 0, "cuckoo_update": 0}
    phase_cuckoo_kernels(kerrs)
    lap("phase 3e cuckoo")
    krecords, klaunches = {}, {}
    phase_cuckoo_main(kerrs, krecords, klaunches, card)
    phase_cuckoo_dram(kerrs, krecords, card,
                      krecords["cuckoo_update"]["main_add_more_ms"])
    krecords["cuckoo_contains"]["max_abs_err"] = kerrs["cuckoo_contains"]
    lap("phase 4e cuckoo")
    print(f"smoke phases: {', '.join(laps)}")
    print(json.dumps({"kernels": [krecords["cuckoo_contains"],
                                  qrecords["quotient_contains"]]},
                     default=str))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = t_lap = time.perf_counter()
    laps = []

    def lap(name: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        laps.append(f"{name} {now - t_lap:.1f} s")
        t_lap = now

    # the tuner's and the calibration's caches: fresh files in the build
    # directory, so that no plan or constant comes from an earlier run
    cache = ROOT / "build" / "repro_torch" / "smoke_cache"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_TUNING_CACHE"] = str(cache / "tuning.json")
    os.environ["REPRO_CALIB_CACHE"] = str(cache / "calibration.json")
    for path in cache.iterdir():
        path.unlink()
    card, kind, count = phase_device()
    phase_build()
    lap("device and build")
    if sys.argv[1:] == ["--profile"]:
        profile_cbf(card)
        profile_quotient(card)
        profile_cuckoo(card)
        profile_ring(card)
        return 0
    if sys.argv[1:] == ["--contains"]:
        return contains_phases(card, lap, laps)
    if sys.argv[1:] == ["--service"]:
        phase_service(card)
        lap("phase 5 service")
        print(f"smoke phases: {', '.join(laps)}")
        return 0
    errs = {k: 0 for k in sbf.LAUNCHES}
    cerrs = {k: 0 for k in cnt.LAUNCHES}
    berrs = {k: 0 for k in cbf.LAUNCHES}
    rerrs = {k: 0 for k in ring.LAUNCHES}
    phase_kernels(errs)
    phase_counting_kernels(cerrs)
    phase_cbf_kernels(berrs)
    phase_ring_kernels(rerrs)
    phase_bank_kernels(errs, cerrs)
    phase_generic_banks(card, B=8)
    lap("phases 3-3d")
    records, launches = {}, {}
    phase_main("L2", 1 << 23, errs, records, launches, card)
    phase_main("DRAM", 1 << 28, errs, records, launches, card)
    phase_card_rule(card)
    crecords, claunches = {}, {}
    phase_counting_main("L2", 1 << 22, cerrs, crecords, claunches, card)
    phase_counting_main("DRAM", 1 << 26, cerrs, crecords, claunches, card)
    phase_counting_rule(card)
    brecords, blaunches = {}, {}
    phase_cbf_main("L2", 1 << 23, berrs, brecords, blaunches, card)
    phase_cbf_main("DRAM", 1 << 28, berrs, brecords, blaunches, card)
    phase_cbf_rule(card)
    for kernel, rec in brecords.items():
        rec.update(launches=blaunches[kernel], max_abs_err=berrs[kernel])
    wrecords, wlaunches = {}, {}
    phase_windowed_main("L2", 1 << 22, rerrs, wrecords, wlaunches, card)
    phase_windowed_main("DRAM", 1 << 26, rerrs, wrecords, wlaunches, card)
    phase_ring_rule(card)
    for kernel, rec in wrecords.items():
        rec.update(launches=wlaunches[kernel], max_abs_err=rerrs[kernel])
    print(f"windowed main path launches of the blocked add kernels: "
          f"add_vmem {wlaunches['windowed add_vmem']} (L2 cell), "
          f"add_hbm {wlaunches['windowed add_hbm']} (DRAM cell)")
    bkrecords, bklaunches = {}, {}
    phase_bank_main("sbf", "L2", 1 << 13, 1 << 23, errs, bkrecords,
                    bklaunches, card)
    phase_bank_main("sbf", "DRAM", 1 << 18, 1 << 28, errs, bkrecords,
                    bklaunches, card)
    for kernel, rec in bkrecords.items():
        rec.update(launches=bklaunches[kernel], max_abs_err=errs[kernel])
    cbkrecords, cbklaunches = {}, {}
    phase_bank_main("countingbf", "L2", 1 << 12, 1 << 22, cerrs, cbkrecords,
                    cbklaunches, card)
    phase_bank_main("countingbf", "DRAM", 1 << 16, 1 << 26, cerrs,
                    cbkrecords, cbklaunches, card)
    for kernel, rec in cbkrecords.items():
        rec.update(launches=cbklaunches[kernel], max_abs_err=cerrs[kernel])
    generic = phase_generic_banks(card, B=64, time_it=True)
    print(f"generic bank path at B = 64: {json.dumps(generic)}")
    lap("phases 4-4d")
    perrs = {"add_partitioned": 0, "update_partitioned": 0}
    kerrs = {"cuckoo_contains": 0, "cuckoo_update": 0}
    phase_partitioned_kernels(perrs)
    phase_cuckoo_kernels(kerrs)
    lap("phase 3e")
    precords, plaunches = {}, {}
    phase_partitioned_main("sbf", "L2", 1 << 23, perrs, precords, plaunches,
                           card)
    phase_partitioned_main("sbf", "DRAM", 1 << 28, perrs, precords,
                           plaunches, card)
    phase_partitioned_main("countingbf", "L2", 1 << 22, perrs, precords,
                           plaunches, card)
    phase_partitioned_main("countingbf", "DRAM", 1 << 26, perrs, precords,
                           plaunches, card)
    for kernel, rec in precords.items():
        rec.update(launches=plaunches[kernel], max_abs_err=perrs[kernel])
    lap("phase 4e partitioned")
    krecords, klaunches = {}, {}
    phase_cuckoo_main(kerrs, krecords, klaunches, card)
    lap("phase 4e cuckoo")
    phase_cuckoo_dram(kerrs, krecords, card,
                      krecords["cuckoo_update"]["main_add_more_ms"])
    krecords["cuckoo_update"]["max_abs_err"] = kerrs["cuckoo_update"]
    krecords["cuckoo_contains"]["max_abs_err"] = kerrs["cuckoo_contains"]
    lap("phase 4e cuckoo DRAM")
    qrecords = quotient_phases(card, lap)
    gerrs = {k: 0 for k in kc.LAUNCHES}
    phase_calibrate_kernels(gerrs)
    lap("phase 3g")
    grecords = {}
    tuned = phase_tuning_main(card, gerrs, grecords, records, crecords,
                              Path(os.environ["REPRO_TUNING_CACHE"]))
    (cache.parent / "smoke_tuning.json").write_text(json.dumps(
        {"card": card, **tuned}, indent=1))
    lap("phase 4g")
    phase_service(card)
    lap("phase 5 service")
    print(f"smoke phases: {', '.join(laps)}")
    print(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f} "
          f"s, the build included")
    print(json.dumps({"kernels": [records[k] for k in
                                  ("contains_vmem", "add_vmem",
                                   "contains_hbm", "add_hbm")]
                      + [crecords[k] for k in ("update_vmem", "contains_vmem",
                                               "update_hbm", "contains_hbm",
                                               "decay")]
                      + [brecords[k] for k in cbf.LAUNCHES]
                      + [wrecords[k] for k in ring.LAUNCHES]
                      + [bkrecords["bank_contains_vmem"],
                         bkrecords["bank_add_vmem"],
                         cbkrecords["bank_update_vmem"],
                         cbkrecords["bank_contains_vmem"]]
                      + [precords["add_partitioned"],
                         precords["update_partitioned"],
                         krecords["cuckoo_contains"],
                         krecords["cuckoo_update"],
                         qrecords["quotient_contains"],
                         qrecords["quotient_update"]]
                      + [grecords["step"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
