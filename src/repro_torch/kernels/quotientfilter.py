"""Counting quotient filter kernels for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.quotientfilter``; the wrappers keep the JAX
names, so each row of the kernel table maps one to one:

============= =================================== ==========================
wrapper       replaces (repro/kernels/            CUDA kernels
              quotientfilter.py)                  (csrc/quotient.cu)
============= =================================== ==========================
contains_vmem contains_vmem                       quotient_contains_kernel,
                                                  or the binned contains
add_vmem      add_vmem (_update_vmem, op add)     quotient_update, add
remove_vmem   remove_vmem (_update_vmem, op       quotient_update, remove
              remove)
============= =================================== ==========================

The JAX package runs these kernels only on a table that fits VMEM and sends
a larger one to its jnp reference; here one kernel set serves every size,
as ``kernels.ops`` dispatches it. ``coop`` is validated and both values run
the same contains kernels. The contains has two paths on the card with the
same results: the cluster walk (one thread a key) and the binned contains
(the keys grouped by bin of quotients, each bin tested against the slots
that hold its runs, staged in shared memory; ``quotient.cu`` gives the
design). :func:`choose_contains_path`, a pure rule of the batch, the
table and its load fitted to a sweep of both paths on the H100, picks
one; :func:`table_load` samples the load on the card and keeps it on the
table tensor until the table changes. ``LAST_CONTAINS_PLAN`` keeps the
last card call's :func:`contains_plan`; :func:`contains_binned_model` runs the binned
path's stages in plain PyTorch for tests. A binned call's workspace is
bounded by the card's free memory (:func:`cap_for_memory`). The tile-wide
early exit has nothing to skip in either path.

The update is a sorted-stream rebuild (``quotient.cu`` describes its
eleven kernels): the batch's admitted fingerprints sorted by a counting
sort into bins and a sort of each bin in shared memory; the old table decoded, tile
by tile, into its stored fingerprints in order; the two streams merged
(add) or matched (remove); each element's new slot from a max-plus scan;
each table tile's words put together in shared memory and stored once.
Every array it makes is indexed by element (sized by the table's capacity
``n_slots - 1`` or by the batch) or by tile, bin or CTA, never by slot.
The update wrappers take the JAX ``tile``: the table and flags are the
same for every tile (``core.quotient``), so the plain version chunks the
batch by it and the CUDA update rebuilds the table once a pass of at most
``KEY_BATCH`` keys, whatever the tile. :func:`update_stream_model` runs
the same stages (tiles, carries, bins, merge tiles, anchor) in plain
PyTorch for tests; ``bin_bits``, ``bin_cap``, ``tile_slots`` and
``merge_tile`` are private knobs of the wrappers (tests and the smoke;
``ops`` never passes them).

``merge_vmem`` and ``resize_vmem`` are not ports of TPU kernels (the JAX
package computes merge and resize outside Pallas): on the card they run the
update's decode, merge, position and write stages on the decoded streams
(merge: two decoded streams; resize: one, re-split into the new q and r, so
no sort); their plain versions are ``core.quotient``'s.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]``, the
table ``(n_words,)`` and ``valid`` ``(n,)`` uint8 or bool (or ``None``:
every key valid). For CPU tensors a wrapper runs its plain version; for
CUDA tensors it launches its kernels or raises. The update wrappers change
the table in place and return ``(table, flags)``. ``LAUNCHES`` counts
wrapper calls that launched their kernels (one a call, whose stream is the
walk, or the binned contains: 2 + 5 kernels a batch; 11 update kernels a
pass, 10 for a merge or 7 for a resize); ``LAST_PLAN``
keeps the last card call's :func:`update_plan`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import quotient as Q
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.cbf import free_device_bytes
from repro_torch.kernels.sbf import (COOPS, _on_cuda, _raise_on,
                                     device_scope, partition_smem_bytes,
                                     raw_stream)

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}
SLOT_BITS = (8, 16, 32)        # lane widths with a kernel instance
MAX_Q_BITS = 29                # positions carry 2 flag bits in a u32

# The contains (quotient.cu). Paths on the card: the cluster walk or the
# binned contains.
CONTAINS_PATHS = ("walk", "binned")
LOG2_MAX_BINS = 13             # 8192 bins: 32 KiB of histogram
LOG2_ONE_PASS_BINS = 12        # bins the scatter stages in one pass
MAX_TEST_SMEM = 200 << 10      # a test CTA's shared memory, at most
CONTAINS_BIN_BITS = 12         # quotients a bin (log2), at least
SECTOR_SLOTS = 4               # 8-byte slots of a 32-byte sector
FILLER = (1 << 64) - 1         # a slot that pads a run
# Keys an internal batch of the binned contains holds: each key stores its
# result byte at random, so a batch's results should stay in L2
CONTAINS_KEY_CAP = 1 << 25
# Device memory a binned call leaves free beside its workspace where the
# workspace at the cap did not fit
WORKSPACE_MARGIN = 1 << 28
# The path rule's cost model (ms, n keys, a table of n_slots at `load`),
# fitted to a sweep of both paths in turns on an H100 80GB HBM3 at 700 W
# (chip_smoke.py phase_quotient_rule: 8-bit slots, q23 ... q27, loads 0.5
# and 0.9, 2^16 ... 2^26 keys, none, half or all of them members):
#   walk   = WALK_TAIL_MS / (1 - load) + WALK_KEY_NS * n / (1 - load)^2
#   binned = BINNED_FIXED_MS + BINNED_SLOT_NS * n_slots + BINNED_KEY_NS * n
# A linear-probing cluster grows as 1 / (1 - load): the walk's longest one
# sets its tail, and a key walks 1 / (1 - load)^2 slots on average; binned
# reads the table once (the tile pass, each bin's window) and moves each
# key through its slots. At load 0.5 the walk wins at every size.
WALK_TAIL_MS = 0.02
WALK_KEY_NS = 0.0051
BINNED_FIXED_MS = 0.071
BINNED_SLOT_NS = 0.0077
BINNED_KEY_NS = 0.040
# Below this many keys the walk runs without a load sample (the sweep's
# smallest batch)
LOAD_MIN_KEYS = 1 << 16
# Slots the load sample reads (quotient.cu kSampleRuns x kSampleSlots): the
# whole table up to this size
LOAD_SAMPLE_SLOTS = 128 * 2048

# The sorted-stream update (quotient.cu). Each knob is private: ops passes
# none of them.
TILE_SLOTS = 4096              # slots of a table tile (decode and write)
MERGE_TILE = 4096              # merged elements a CTA takes (merge, positions)
KEY_CHUNKS = 256               # most CTAs of the key stages (count, scatter)
BIN_KEYS = 4096                # keys a bin holds on average, at most
BIN_CAP = 8192                 # keys a bin sorts in shared memory (96 KiB
#                                with its index and sub-bucket arrays: two
#                                CTAs an SM); a larger bin sorts in device
#                                memory
MAX_BIN_BITS = 12              # 4096 bins: chunks x bins open sectors in L2
KEY_BATCH = 1 << 24            # keys a pass of the update takes
SENTINEL = 0xFFFFFFFF          # "no element" in the tile-start tables

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0, "remove_vmem": 0,
            "merge_vmem": 0, "resize_vmem": 0}
# update_plan of the last update, merge or resize on the card
LAST_PLAN: dict = {}
# contains_plan of the last contains on the card
LAST_CONTAINS_PLAN: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_supported(spec: FilterSpec) -> bool:
    """Quotient specs the CUDA kernels serve: u8/u16/u32 lanes and at most
    2^29 slots."""
    return (spec.is_quotient and spec.slot_bits in SLOT_BITS
            and spec.q_bits <= MAX_Q_BITS)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def contains_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                   coop: str = "none") -> torch.Tensor:
    """Plain version of ``contains_vmem``: (n,) bool."""
    if coop == "subtile":
        return Q.quotient_contains_coop(spec, table, keys)
    return Q.quotient_contains(spec, table, keys)


def update_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor], op: str,
                 tile: Optional[int] = None):
    """Plain version of ``add_vmem`` / ``remove_vmem``: (new table, flags
    (n,) bool); ``table`` is not modified."""
    _check_op(op)
    fn = Q.quotient_add if op == "add" else Q.quotient_remove
    return fn(spec, table, keys, valid=valid, tile=tile)


merge_plain = Q.quotient_merge         # plain version of merge_vmem
resize_plain = Q.quotient_resize       # plain version of resize_vmem


# ---------------------------------------------------------------------------
# The update's plan: bins, tiles and workspace
# ---------------------------------------------------------------------------

def bin_bits_for(n: int, p_bits: int) -> int:
    """Bins (2^b, by the fingerprint's top b bits) of an n-key pass: the
    fewest that hold at most ``BIN_KEYS`` keys each on average."""
    b = 0
    while (n >> b) > BIN_KEYS and b < min(p_bits, MAX_BIN_BITS):
        b += 1
    return b


def _r256(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


KINDS = ("add", "remove", "merge", "resize")


def update_plan(spec: FilterSpec, n: int = 0, kind: str = "add", *,
                new_spec: Optional[FilterSpec] = None,
                bin_bits: Optional[int] = None, bin_cap: int = BIN_CAP,
                tile_slots: int = TILE_SLOTS,
                merge_tile: int = MERGE_TILE) -> dict:
    """What an update pass of n keys (``kind`` add or remove), a merge or
    a resize runs: its tiles, bins and ``workspace_bytes``, the device
    memory the call allocates besides the table it returns and the flags
    (``quotient.cu``'s ``Layout`` carves the same regions, 256-byte
    aligned, and refuses a smaller workspace; the total is rounded up to
    the allocator's 512 bytes). The element streams hold at most the
    table's capacity, ``n_slots - 1`` fingerprints."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r} not in {KINDS}")
    if tile_slots < 32 or tile_slots & (tile_slots - 1) or tile_slots > 4096:
        raise ValueError(f"tile_slots={tile_slots} must be a power of two "
                         f"in [32, 4096]")
    if not 1 <= merge_tile <= 4096:
        raise ValueError(f"merge_tile={merge_tile} must be in [1, 4096]")
    if not 1 <= bin_cap <= BIN_CAP:
        raise ValueError(f"bin_cap={bin_cap} must be in [1, {BIN_CAP}]")
    dst = new_spec or spec
    cap = spec.n_slots - 1
    nt = max(spec.n_slots // min(tile_slots, spec.n_slots),
             dst.n_slots // min(tile_slots, dst.n_slots))
    update = kind in OPS
    nk = min(n, KEY_BATCH) if update else 0
    if update:
        bb = bin_bits_for(nk, spec.fingerprint_bits) if bin_bits is None \
            else bin_bits
        if not 0 <= bb <= min(spec.fingerprint_bits, MAX_BIN_BITS):
            raise ValueError(f"bin_bits={bb} must be in [0, "
                             f"{min(spec.fingerprint_bits, MAX_BIN_BITS)}]")
    else:
        bb = 0
    n_bins = (1 << bb) if update else 0
    merged = cap + (nk if update else cap if kind == "merge" else 0)
    merge_tiles = max(-(-merged // merge_tile), 1)
    pos_tiles = max(-(-cap // merge_tile), 1)
    regions = ([512] + [_r256(4 * nt)] * 5 + [_r256(4 * (nt + 1))] * 2
               + [_r256(4 * KEY_CHUNKS * update),
                  _r256(4 * KEY_CHUNKS * n_bins), _r256(4 * (n_bins + 1)
                                                        * update),
                  _r256(8 * merge_tiles), _r256(8 * pos_tiles),
                  _r256(24 * merge_tiles),
                  _r256(4 * cap), _r256(4 * cap * (kind == "merge")),
                  _r256(4 * cap), _r256(8 * nk)])
    return {"kind": kind, "n_keys": n, "pass_keys": nk,
            "passes": -(-n // KEY_BATCH) if update else 1,
            "bin_bits": bb if update else None, "n_bins": n_bins,
            "bin_cap": bin_cap, "tile_slots": tile_slots,
            "merge_tile": merge_tile, "table_tiles": nt,
            "merge_tiles": merge_tiles, "pos_tiles": pos_tiles,
            "workspace_bytes": -(-sum(regions) // 512) * 512}


# ---------------------------------------------------------------------------
# The update's stages in plain PyTorch (tests): update_stream_model
# ---------------------------------------------------------------------------

def _cumx(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum (int64)."""
    x = x.to(torch.int64)
    return torch.cumsum(x, 0) - x


def _model_decode(spec: FilterSpec, table: torch.Tensor, ts: int) -> dict:
    """Stages 1-3: per-tile counts (in use, run starts, occupied, first
    empty, first slot a continuation), the one-block scan (m0, D, the first
    empty slot a0, W = run starts less occupied slots before a0, the start
    s_W of the first run homed at or before a0), and the decode of each
    tile: a slot's run has absolute rank x (run starts up to it, less one;
    a wrapped run from the end is D - 1), its home the occupied slot of
    rank (x - W) mod D (each tile walks the occupied bits from the tile
    that holds its first rank), and it goes to place (in use before it
    less in use before s_W) mod m0 of the sorted stream."""
    n_sl, r = spec.n_slots, spec.r_bits
    ts = min(ts, n_sl)
    nt = n_sl // ts
    lanes = Q.unpack_slots(spec, table)
    occ, cont, _, in_use, rem = Q._fields(spec, lanes)
    run = in_use & ~cont
    U, R, O = (a.view(nt, ts).sum(1) for a in (in_use, run, occ))
    Uex, Rex, Oex = _cumx(U), _cumx(R), _cumx(O)
    m0, D = int(U.sum()), int(R.sum())
    empty = (~in_use).view(nt, ts)
    has = empty.any(1)
    if bool(has.any()):
        t0 = int(torch.argmax(has.to(torch.int8)))
        e = int(torch.argmax(empty[t0].to(torch.int8)))
        a0 = t0 * ts + e
        sl = slice(t0 * ts, a0)                # the scan loads a0's tile
        uexa = int(Uex[t0]) + int(in_use[sl].sum())
        rexa = int(Rex[t0]) + int(run[sl].sum())
        oexa = int(Oex[t0]) + int(occ[sl].sum())
    else:                                      # no empty slot: as jnp.argmax
        a0 = uexa = rexa = oexa = 0
    W = rexa - oexa
    if W < rexa:                               # the W-th run start's tile
        tw = int(torch.searchsorted(Rex, torch.tensor(W), right=True)) - 1
        starts = run[tw * ts:(tw + 1) * ts].nonzero().flatten()
        s_w = tw * ts + int(starts[W - int(Rex[tw])])
        base = int(Uex[tw]) + int(in_use[tw * ts:s_w].sum())
    else:
        base = uexa
    fps = torch.zeros((m0,), dtype=torch.int64)
    for t in range(nt):
        sl = slice(t * ts, (t + 1) * ts)
        if int(U[t]) == 0:
            continue
        cf = int(bool(in_use[t * ts]) and bool(cont[t * ts]))
        # qtab: the homes of ranks o_lo .. o_lo + K - 1 (mod D); K = D + 1
        # only in a one-tile table whose wrapped run ends and starts in it
        K = min(int(R[t]) + cf, D)
        o_lo = (int(Rex[t]) - cf - W) % D
        qtab = torch.full((K,), -1, dtype=torch.int64)
        u = int(torch.searchsorted(Oex, torch.tensor(o_lo), right=True)) - 1
        covered = int(Oex[u]) + int(O[u]) - o_lo
        while True:
            slots = occ[u * ts:(u + 1) * ts].nonzero().flatten() + u * ts
            i = (int(Oex[u]) + torch.arange(slots.numel()) - o_lo) % D
            keep = i < K
            qtab[i[keep]] = slots[keep]
            if covered >= K:
                break
            u = (u + 1) % nt
            covered += int(O[u])
        assert int(qtab.min()) >= 0, "the walk left a home unset"
        iu = in_use[sl]
        inc = torch.cumsum(run[sl].to(torch.int64), 0)
        i = (inc - 1 + cf)[iu]
        q = qtab[i % D]
        idx = (int(Uex[t]) + _cumx(iu)[iu] - base) % m0
        fps[idx] = (q << r) | rem[sl][iu]
    return {"fps": fps, "m0": m0, "D": D, "a0": a0, "W": W, "base": base}


def _model_keys(spec: FilterSpec, keys: torch.Tensor, valid, op: str,
                room: int, bin_bits: int, bin_cap: int):
    """Stages 4-7: admission (add: the first ``room`` valid keys), flags of
    the keys that are not matched later, and the admitted (fingerprint,
    index) pairs in order: bins by the fingerprint's top bits, each sorted
    by (fp, index) (in shared memory up to ``bin_cap`` keys, else in
    device memory; the same order)."""
    n = keys.shape[0]
    fp = Q.quotient_hashes(spec, keys)
    v = _as_valid_model(n, valid)
    if op == "add":
        admitted = v & (torch.cumsum(v.to(torch.int64), 0) <= room)
        flags = admitted | ~v
    else:
        admitted = v
        flags = ~v
    idx = admitted.nonzero().flatten()
    shift = spec.fingerprint_bits - bin_bits
    b = fp[idx] >> shift
    counts = torch.bincount(b, minlength=1 << bin_bits)
    big = int((counts > bin_cap).sum())
    key = (fp[idx] << 32) | idx
    srt = torch.sort(key).values               # bins by top bits: key order
    return srt >> 32, srt & 0xFFFFFFFF, flags, big


def _as_valid_model(n: int, valid) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=torch.bool)
    return torch.as_tensor(valid).to(torch.bool).cpu()


def _split(o: torch.Tensor, b: torch.Tensor, d: int) -> int:
    """Merge path: O elements among the first d merged (O first on ties)."""
    lo, hi = max(0, d - b.numel()), min(d, o.numel())
    while lo < hi:
        mid = (lo + hi) // 2
        if int(b[d - 1 - mid]) < int(o[mid]):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _model_merge(spec: FilterSpec, o: torch.Tensor, bf: torch.Tensor,
                 bi: torch.Tensor, op: str, tm: int, flags):
    """Stage 8: merge tiles of ``tm`` merged elements along merge-path
    splits. Add keeps every element; remove drops an old copy whose rank
    in its group is below the group's requests and finds a request whose
    rank is below the group's stored copies (the first and last group of
    a tile by searches over the whole streams, the others inside the
    tile), the kept copies placed by the tiles' carried counts. Each
    element is an anchor candidate: (k - q, q - 1), its new index k and
    quotient q >= 1. Returns (new stream, anchor key)."""
    n_sl, r = spec.n_slots, spec.r_bits
    L = o.numel() + bf.numel()
    out, carry = [], 0
    best = None
    for d0 in range(0, L, tm):
        d1 = min(d0 + tm, L)
        i0, i1 = _split(o, bf, d0), _split(o, bf, d1)
        j0, j1 = d0 - i0, d1 - i1
        so, sb = o[i0:i1], bf[j0:j1]
        if op == "add":
            pos_o = torch.arange(so.numel()) + torch.searchsorted(sb, so)
            pos_b = torch.arange(sb.numel()) + torch.searchsorted(
                so, sb, right=True)
            tile = torch.empty((d1 - d0,), dtype=torch.int64)
            tile[pos_o], tile[pos_b] = so, sb
            kept = tile
        else:
            vals = torch.cat([so, sb])
            f_first, f_last = int(vals.min()), int(vals.max())
            ft, lt = torch.tensor([f_first]), torch.tensor([f_last])
            g_lbo = int(torch.searchsorted(o, ft))
            g_lbb = int(torch.searchsorted(bf, ft))
            g_ubo = int(torch.searchsorted(o, lt, right=True))
            g_ubb = int(torch.searchsorted(bf, lt, right=True))

            def bounds(f):
                lbo = torch.where(f == f_first, g_lbo,
                                  i0 + torch.searchsorted(so, f))
                lbb = torch.where(f == f_first, g_lbb,
                                  j0 + torch.searchsorted(sb, f))
                ubo = torch.where(f == f_last, g_ubo, i0 + torch.searchsorted(
                    so, f, right=True))
                ubb = torch.where(f == f_last, g_ubb, j0 + torch.searchsorted(
                    sb, f, right=True))
                return lbo, lbb, ubo, ubb
            lbo, lbb, _, ubb = bounds(so)
            keep = (i0 + torch.arange(so.numel()) - lbo) >= (ubb - lbb)
            lbo, lbb, ubo, _ = bounds(sb)
            found = (j0 + torch.arange(sb.numel()) - lbb) < (ubo - lbo)
            flags[bi[j0:j1]] = found
            kept = so[keep]
        k = carry + torch.arange(kept.numel())
        q = kept >> r
        cand = q >= 1
        if bool(cand.any()):
            keyv = ((k - q + n_sl) << 32) | (q - 1)
            m = int(keyv[cand].min())
            best = m if best is None else min(best, m)
        out.append(kept)
        carry += kept.numel()
    ns = torch.cat(out) if out else torch.zeros((0,), dtype=torch.int64)
    return ns, best


def _anchor(best, m1: int, n_sl: int):
    """(A, sA): the anchor slot and the new index of the first element
    homed past it, from the tiles' least candidate and (m1 - N, N - 1)."""
    key = (m1 << 32) | (n_sl - 1)
    if best is not None:
        key = min(key, best)
    a = key & 0xFFFFFFFF
    s = (key >> 32) - n_sl + a + 1
    return a, (s if s < m1 else 0)


def _model_positions(spec: FilterSpec, ns: torch.Tensor, a: int, s_a: int,
                     tm: int, ts: int):
    """Stage 9: in rotated order (from just past the anchor), tiles of
    ``tm`` elements with a carried max (``pos_j = j + cummax(u_j - j)``):
    each element's slot with its continuation and shifted bits, and the
    first element at or past each table tile's rotated start, by position
    (Fp) and by home (Fq). Returns (pos, cont, shifted, Fp, Fq)."""
    n_sl, r = spec.n_slots, spec.r_bits
    m1 = ns.numel()
    ts = min(ts, n_sl)
    nt = n_sl // ts
    fp_, fq_ = ([SENTINEL] * nt for _ in range(2))
    jj = torch.arange(m1)
    u = ((ns[(jj + s_a) % max(m1, 1)] >> r) - a - 1) % n_sl
    pos = torch.empty((m1,), dtype=torch.int64)
    carry = -(1 << 30)
    for j0 in range(0, m1, tm):
        v = u[j0:j0 + tm] - jj[j0:j0 + tm]
        m = torch.cummax(torch.clamp(v, min=carry), 0).values
        pos[j0:j0 + tm] = jj[j0:j0 + tm] + m
        carry = int(m[-1])
    c = (-a - 1) % ts                          # rotated tile starts c + k ts

    def mark(table, vals):
        prev = -1
        for j in range(m1):
            hi = int(vals[j])
            k = 0 if prev < c else (prev - c) // ts + 1
            while k < nt and c + k * ts <= hi:
                w = ((c + k * ts + a + 1) % n_sl) // ts
                table[w] = j
                k += 1
            prev = hi
    mark(fp_, pos)
    mark(fq_, u)
    cont = torch.zeros((m1,), dtype=torch.bool)
    if m1 > 1:
        cont[1:] = u[1:] == u[:-1]
    return pos, cont, pos != u, fp_, fq_


def _model_write(spec: FilterSpec, ns, pos, cont, shifted, fp_, fq_, a: int,
                 s_a: int, ts: int) -> torch.Tensor:
    """Stage 10: each table tile's lanes put together from the element
    ranges that Fp and Fq give it (a tile that holds the rotated start
    takes two ranges), then stored once."""
    n_sl, r = spec.n_slots, spec.r_bits
    occ_m, cont_m, shift_m, rem_m = Q._meta_masks(spec)
    m1 = ns.numel()
    ts = min(ts, n_sl)
    nt = n_sl // ts
    lanes = torch.zeros((n_sl,), dtype=torch.int64)
    jj = torch.arange(m1)
    fps_rot = ns[(jj + s_a) % max(m1, 1)]

    def ranges(table, w):
        x = (w * ts - a - 1) % n_sl
        f0 = m1 if table[w] == SENTINEL else table[w]
        nxt = table[(w + 1) % nt]
        f1 = m1 if nxt == SENTINEL else nxt
        if x + ts > n_sl:                      # the tile holds rotated 0
            return [(f0, m1), (0, f1)]
        return [(f0, m1 if x + ts == n_sl else f1)]
    for w in range(nt):
        tile = torch.zeros((ts,), dtype=torch.int64)
        for lo, hi in ranges(fp_, w):
            sl = slice(lo, hi)
            slot = (pos[sl] + a + 1) % n_sl - w * ts
            assert bool(((slot >= 0) & (slot < ts)).all())
            tile[slot] |= ((fps_rot[sl] & rem_m)
                           | torch.where(cont[sl], cont_m, 0)
                           | torch.where(shifted[sl], shift_m, 0))
        for lo, hi in ranges(fq_, w):
            q = fps_rot[lo:hi] >> r
            assert bool(((q >= w * ts) & (q < (w + 1) * ts)).all())
            tile[q - w * ts] |= occ_m
        lanes[w * ts:(w + 1) * ts] = tile
    return Q.pack_slots(spec, lanes)


def _model_rebuild(spec, o, bf, bi, op, flags, tm, ts):
    ns, best = _model_merge(spec, o, bf, bi, op, tm, flags)
    a, s_a = _anchor(best, ns.numel(), spec.n_slots)
    pos, cont, shifted, fp_, fq_ = _model_positions(spec, ns, a, s_a, tm, ts)
    return _model_write(spec, ns, pos, cont, shifted, fp_, fq_, a, s_a, ts)


def update_stream_model(spec: FilterSpec, table: torch.Tensor,
                        keys: torch.Tensor, valid=None, op: str = "add",
                        *, bin_bits: Optional[int] = None,
                        bin_cap: int = BIN_CAP, tile_slots: int = TILE_SLOTS,
                        merge_tile: int = MERGE_TILE, stats: dict = None):
    """The CUDA update's schedule in plain PyTorch, for tests: (new words,
    flags). The same table tiles and their carries, the same bins (a bin
    over ``bin_cap`` keys counted in ``stats["big_bins"]``), merge tiles,
    anchor and tile-start tables as ``quotient.cu``, in passes of
    ``KEY_BATCH`` keys. ``table`` is not modified."""
    _check_op(op)
    keys, table = keys.cpu(), table.cpu()
    n = keys.shape[0]
    flags_all = []
    for first in range(0, max(n, 1), KEY_BATCH):
        kb = keys[first:first + KEY_BATCH]
        vb = None if valid is None else torch.as_tensor(valid).cpu()[
            first:first + KEY_BATCH]
        plan = update_plan(spec, kb.shape[0], op, bin_bits=bin_bits,
                           bin_cap=bin_cap, tile_slots=tile_slots,
                           merge_tile=merge_tile)
        dec = _model_decode(spec, table, tile_slots)
        room = max(spec.n_slots - 1 - dec["m0"], 0)
        bf, bi, flags, big = _model_keys(spec, kb, vb, op, room,
                                         plan["bin_bits"], bin_cap)
        if stats is not None:
            stats["big_bins"] = stats.get("big_bins", 0) + big
        table = _model_rebuild(spec, dec["fps"], bf, bi, op, flags,
                               merge_tile, tile_slots)
        flags_all.append(flags)
        if n == 0:
            break
    return table, torch.cat(flags_all)[:n]


def merge_stream_model(spec: FilterSpec, table_a: torch.Tensor,
                       table_b: torch.Tensor, *, tile_slots: int = TILE_SLOTS,
                       merge_tile: int = MERGE_TILE) -> torch.Tensor:
    """merge_vmem's schedule in plain PyTorch: both tables decoded, the two
    streams merged as an add, then positions and the write."""
    a = _model_decode(spec, table_a.cpu(), tile_slots)["fps"]
    b = _model_decode(spec, table_b.cpu(), tile_slots)["fps"]
    return _model_rebuild(spec, a, b, torch.zeros_like(b), "add", None,
                          merge_tile, tile_slots)


def resize_stream_model(spec: FilterSpec, table: torch.Tensor,
                        new_spec: FilterSpec, *, tile_slots: int = TILE_SLOTS,
                        merge_tile: int = MERGE_TILE) -> torch.Tensor:
    """resize_vmem's schedule in plain PyTorch: the stream decoded with the
    old q/r split and rebuilt with the new one (same order, no sort)."""
    o = _model_decode(spec, table.cpu(), tile_slots)["fps"]
    empty = torch.zeros((0,), dtype=torch.int64)
    return _model_rebuild(new_spec, o, empty, empty, "add", None,
                          merge_tile, tile_slots)


# ---------------------------------------------------------------------------
# The contains: its paths, plan, rule and the binned path's model
# ---------------------------------------------------------------------------

def contains_bin_bits(q_bits: int) -> int:
    """Quotients a bin of the binned contains (log2): at least
    2^CONTAINS_BIN_BITS (the whole table where it is smaller), more where
    the table would have more than 2^LOG2_ONE_PASS_BINS bins (the scatter
    then stages every bin at once), and up to 2^LOG2_MAX_BINS bins where a
    test CTA's shared memory would pass MAX_TEST_SMEM."""
    b = max(q_bits - LOG2_ONE_PASS_BINS, min(q_bits, CONTAINS_BIN_BITS))
    if contains_test_smem(b, (1 << b) * 3 // 2 // 4 + 4) > MAX_TEST_SMEM:
        b = max(q_bits - LOG2_MAX_BINS, min(q_bits, CONTAINS_BIN_BITS))
    return b


def contains_window_words(spec: FilterSpec, bin_bits: int) -> int:
    """Table words a test CTA stages: the bin's slots and half as many
    again (runs homed in the bin spill past its end), from the 4-word
    boundary at or before its first slot; at most the table."""
    spw = spec.slots_per_word
    slots = (1 << bin_bits) * 3 // 2
    words = -(-slots // spw) + 4
    return min(-(-words // 4) * 4, spec.n_words)


def contains_test_smem(bin_bits: int, window_words: int) -> int:
    """Dynamic shared memory of a test CTA (quotient.cu
    contains_test_smem): the window, the bin's occupied bits (by slot of
    the window, one word more) and their prefix, its runs' starts."""
    b = 1 << bin_bits
    return 4 * (window_words + 2 * (-(-b // 32) + 1) + b)


def binned_fits(spec: FilterSpec, bin_bits: int, window_words: int,
                smem_bytes: int) -> bool:
    """Whether the binned kernels take this table, bin and window."""
    return (0 <= bin_bits <= spec.q_bits
            and spec.q_bits - bin_bits <= LOG2_MAX_BINS
            and spec.n_words % 4 == 0
            and 4 <= window_words <= spec.n_words and window_words % 4 == 0
            and contains_test_smem(bin_bits, window_words) <= smem_bytes)


@functools.lru_cache(maxsize=None)
def _binned_fits_at(q_bits: int, slot_bits: int, r_bits: int,
                    smem_bytes: int) -> bool:
    """Whether the binned kernels take the table at the card's bins (kept:
    a contains asks it every call)."""
    spec = FilterSpec("quotient", (1 << q_bits) * slot_bits, 1,
                      slot_bits=slot_bits, r_bits=r_bits)
    bb = contains_bin_bits(q_bits)
    return binned_fits(spec, bb, contains_window_words(spec, bb), smem_bytes)


def choose_contains_path(n: int, q_bits: int, slot_bits: int,
                         smem_bytes: int, load: Optional[float] = None,
                         r_bits: int = 1) -> str:
    """The contains' path on the card, a pure function of the batch (n
    keys), the table (2^q_bits slots of slot_bits, at ``load``) and the
    card's shared memory a CTA: the walk below ``LOAD_MIN_KEYS`` keys or
    where the binned kernels do not take the table, else the path the
    cost model (``WALK_*``, ``BINNED_*``) finds faster at that load (None:
    the walk). The rule cannot see the share of members. The path never
    changes a result."""
    if (n < LOAD_MIN_KEYS or load is None
            or not _binned_fits_at(q_bits, slot_bits, r_bits, smem_bytes)):
        return "walk"
    free = max(1.0 - load, 1e-3)
    walk = WALK_TAIL_MS / free + WALK_KEY_NS * 1e-6 * n / (free * free)
    binned = (BINNED_FIXED_MS + BINNED_SLOT_NS * 1e-6 * (1 << q_bits)
              + BINNED_KEY_NS * 1e-6 * n)
    return "binned" if binned < walk else "walk"


def contains_plan(spec: FilterSpec, n: int, path: str,
                  bin_bits: Optional[int] = None,
                  cap: int = CONTAINS_KEY_CAP, chunks: int = 1,
                  window: Optional[int] = None) -> dict:
    """What a contains of n keys runs: ``path``, ``bin_bits`` (quotients a
    bin, log2), ``n_bins``, ``tile_slots`` and ``table_tiles`` (the tile
    pass, a tile a bin), ``window_words`` (a test CTA's staged
    words), ``test_smem``, ``batches`` and ``batch_keys`` (internal
    batches), ``chunks`` (the bin stages' CTAs, the card's) and
    ``workspace_bytes`` (quotient.cu ContainsLayout: the scalars, five
    tile arrays, the chunks' counts, the bins' starts and ends, a batch's
    8-byte slots with each chunk's run in a bin padded to 4 slots; each
    region 256-byte aligned). The walk takes no workspace; the (n,) result
    is not workspace."""
    if path not in CONTAINS_PATHS:
        raise ValueError(f"path must be one of {CONTAINS_PATHS}, not "
                         f"{path!r}")
    if path == "walk":
        return {"path": path, "bin_bits": None, "n_bins": 0,
                "batches": int(n > 0), "batch_keys": n, "chunks": 0,
                "window_words": 0, "workspace_bytes": 0}
    bb = contains_bin_bits(spec.q_bits) if bin_bits is None else bin_bits
    if not 0 <= bb <= spec.q_bits or spec.q_bits - bb > LOG2_MAX_BINS:
        raise ValueError(f"no binned contains for {spec} in bins of 2^{bb} "
                         f"quotients")
    if spec.n_words % 4:
        raise ValueError(f"the binned contains takes tables of a multiple "
                         f"of 4 words, not {spec}")
    ww = contains_window_words(spec, bb) if window is None else window
    if not (4 <= ww <= spec.n_words and ww % 4 == 0):
        raise ValueError(f"window={ww} words must be a multiple of 4 in "
                         f"[4, {spec.n_words}]")
    if not 1 <= cap <= 1 << 31:
        raise ValueError(f"a batch must hold 1 .. 2^31 keys, not {cap}")
    ts = 1 << bb                          # a tile a bin
    nt = spec.n_slots // ts
    n_bins = 1 << (spec.q_bits - bb)
    batch_keys = min(n, cap)
    regions = ([_r256(8 * 16)] + [_r256(4 * nt)] * 5
               + [_r256(4 * chunks * n_bins), _r256(4 * n_bins),
                  _r256(4 * n_bins),
                  _r256(8 * (batch_keys + 3 * chunks * n_bins))])
    return {"path": path, "bin_bits": bb, "n_bins": n_bins,
            "tile_slots": ts, "table_tiles": nt, "window_words": ww,
            "test_smem": contains_test_smem(bb, ww),
            "batches": -(-n // cap), "batch_keys": batch_keys,
            "chunks": chunks, "workspace_bytes": sum(regions)}


def cap_for_memory(spec: FilterSpec, n: int, bin_bits: int, cap: int,
                   chunks: int, window: int, free_bytes: int) -> int:
    """The largest cap, ``cap`` halved as often as needed, whose binned
    plan's workspace fits ``free_bytes`` less ``WORKSPACE_MARGIN``. A
    smaller cap only adds internal batches, so the results stay the same.
    Raises ``MemoryError`` where a batch of one key does not fit."""
    room = free_bytes - WORKSPACE_MARGIN
    while cap >= 1:
        if contains_plan(spec, n, "binned", bin_bits, cap, chunks,
                         window)["workspace_bytes"] <= room:
            return cap
        cap //= 2
    raise MemoryError(f"no binned quotient workspace for {n} keys fits "
                      f"{free_bytes} B of free device memory")


def contains_binned_model(spec: FilterSpec, table: torch.Tensor,
                          keys: torch.Tensor,
                          bin_bits: Optional[int] = None,
                          cap: int = CONTAINS_KEY_CAP, chunks: int = 132,
                          window: Optional[int] = None) -> tuple:
    """The binned contains' stages in plain PyTorch, for tests: ((n,) bool,
    plan, stats). The tile pass (each tile's exclusive counts of run
    starts and occupied slots, D runs, W = run starts less occupied slots
    before the first empty slot); per internal batch of ``cap`` keys cut
    into ``chunks`` ranges, each key's slot (fingerprint, index) in its
    bin's slice (:func:`cbf.slot_runs_model`, 4 slots a sector); then each
    touched bin [Q0, Q0 + B): its homes' first occupied rank k0 and the run
    starts before Q0 read off the tiles, skip = (k0 + W - R(Q0)) mod D,
    the (skip + j)-th run start at or past Q0 (cyclically) the start of the
    bin's j-th run, a key's run the one of its home's rank in the bin, its
    remainder compared along the run. ``stats`` counts the bins whose scan
    went past the window (``scan_spills``) and the keys whose compare read
    a slot past it (``compare_spills``): the kernel reads those through
    __ldg, and the result is the same."""
    from repro_torch.kernels.cbf import chunk_of_model, slot_runs_model
    table, keys = table.cpu(), keys.cpu()
    n = keys.shape[0]
    plan = contains_plan(spec, n, "binned", bin_bits, cap, chunks, window)
    bb, ts, n_bins = plan["bin_bits"], plan["tile_slots"], plan["n_bins"]
    n_sl, r, spw = spec.n_slots, spec.r_bits, spec.slots_per_word
    B = 1 << bb
    lanes = Q.unpack_slots(spec, table)
    occ, cont, _, in_use, rem = Q._fields(spec, lanes)
    run = in_use & ~cont
    nt = n_sl // ts
    rex = _cumx(run.view(nt, ts).sum(1))
    oex = _cumx(occ.view(nt, ts).sum(1))
    d = int(run.sum())
    empty = ~in_use
    if bool(empty.any()):
        a0 = int(torch.argmax(empty.to(torch.int8)))
        w = int(run[:a0].sum()) - int(occ[:a0].sum())
    else:                                      # qf_scan_tables: W = 0
        w = 0
    run_starts = run.nonzero().flatten()
    win_slots = plan["window_words"] * spw
    out = torch.zeros((n,), dtype=torch.bool)
    stats = {"bins_tested": 0, "scan_spills": 0, "compare_spills": 0}
    for first in range(0, n, cap):
        batch = keys[first:first + cap]
        nb = batch.shape[0]
        fp = Q.quotient_hashes(spec, batch)
        cell = (fp >> (r + bb)) * chunks + chunk_of_model(nb, chunks)
        slot, total, owner = slot_runs_model(cell, n_bins, chunks,
                                             SECTOR_SLOTS)
        work = torch.full((total,), -1, dtype=torch.int64)
        work[slot] = torch.arange(nb)
        live = work >= 0
        for j in torch.unique(owner[live]).tolist():
            idx = work[live & (owner == j)]
            stats["bins_tested"] += 1
            if d == 0:
                continue                       # an empty table: all False
            q0 = j << bb
            k0, r0 = int(oex[q0 // ts]), int(rex[q0 // ts])
            skip = (k0 + w - r0) % d
            homes = occ[q0:q0 + B]
            nocc = int(homes.sum())
            starts = run_starts[(r0 + skip + torch.arange(nocc)) % d]
            ws = ((q0 // spw) & ~3) * spw
            past = (starts - q0) % n_sl >= win_slots - (q0 - ws)
            stats["scan_spills"] += int(bool(past.any()))
            q = fp[idx] >> r
            want = fp[idx] & ((1 << r) - 1)
            hit = torch.zeros((idx.numel(),), dtype=torch.bool)
            open_ = occ[q]
            rank = torch.cumsum(homes.to(torch.int64), 0) - 1
            s = starts[rank[(q - q0)[open_]]] if nocc else q[open_]
            at = torch.zeros_like(q)
            at[open_] = s
            spilled = torch.zeros_like(open_)
            first_step = True
            while bool(open_.any()):
                lane_rem = rem[at]
                spilled |= open_ & ((at - ws) % n_sl >= win_slots)
                if not first_step:             # past the run's end
                    open_ &= cont[at]
                done = open_ & (lane_rem >= want)
                hit |= done & (lane_rem == want)
                open_ &= ~done
                at = (at + 1) % n_sl
                first_step = False
            stats["compare_spills"] += int(spilled.sum())
            out[first + idx] = hit
    return out, plan, stats


# ---------------------------------------------------------------------------
# Layout checks and launches
# ---------------------------------------------------------------------------

def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op={op!r} not in {OPS}")


def _check_layout(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  valid=None) -> bool:
    """Validate the tensors of a call: True for CUDA tensors, False for CPU
    tensors; ``ValueError`` otherwise."""
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    on_cuda = _on_cuda(table, keys)
    if table.numel() != spec.n_words:
        raise ValueError(f"table has {table.numel()} words, spec "
                         f"{spec.n_words}")
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
    if not on_cuda:
        return False
    if not kernel_supported(spec):
        raise ValueError(f"the CUDA quotient kernels serve u8/u16/u32 lanes "
                         f"and at most 2^{MAX_Q_BITS} slots, not {spec}")
    if not (keys.is_contiguous() and table.is_contiguous()):
        raise ValueError("keys and table words must be contiguous")
    if keys.data_ptr() % 8 or table.data_ptr() % 4:
        raise ValueError("keys must be 8-byte and words 4-byte aligned")
    return True


def _geometry(spec: FilterSpec):
    return spec.q_bits, spec.r_bits, spec.slot_bits, Q.FP_SALT


def _stream(device: torch.device) -> int:
    return raw_stream(device)


def _workspace(plan: dict, device) -> torch.Tensor:
    # freed when the call returns: the caching allocator orders its reuse
    # after these kernels on the same stream
    return torch.empty((plan["workspace_bytes"],), dtype=torch.uint8,
                       device=device)


def _keep_plan(plan: dict) -> None:
    LAST_PLAN.clear()
    LAST_PLAN.update(plan)


def _launch_update(spec, table, keys, valid, op: str, *, bin_bits=None,
                   bin_cap=BIN_CAP, tile_slots=TILE_SLOTS,
                   merge_tile=MERGE_TILE, key_chunks=0):
    """The update kernels on ``keys`` (n, 2), in passes of ``KEY_BATCH``
    keys; ``table`` is rebuilt in place. Returns flags."""
    from repro_torch.kernels._build import library
    dev = table.device
    n = keys.shape[0]
    flags = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return flags
    if valid is not None:
        valid = valid.contiguous().view(torch.uint8)
    plan = update_plan(spec, n, op, bin_bits=bin_bits, bin_cap=bin_cap,
                       tile_slots=tile_slots, merge_tile=merge_tile)
    work = _workspace(plan, dev)
    lib = library()
    with torch.cuda.device(dev):
        for first in range(0, n, KEY_BATCH):
            nb = min(KEY_BATCH, n - first)
            err = lib.quotient_update(
                keys[first:].data_ptr(),
                None if valid is None else valid[first:].data_ptr(),
                table.data_ptr(), flags[first:].data_ptr(), nb,
                *_geometry(spec), _OP_CODE[op], work.data_ptr(),
                plan["workspace_bytes"], tile_slots, merge_tile,
                plan["bin_bits"], bin_cap, key_chunks, _stream(dev))
            _raise_on(err, f"quotient {op}")
    _keep_plan(plan)
    return flags


@functools.lru_cache(maxsize=None)
def _chunks_on(index: int, q_bits: int, bin_bits: int) -> int:
    from repro_torch.kernels._build import library
    with torch.cuda.device(index):
        chunks = library().quotient_binned_chunks(q_bits, bin_bits)
    if chunks < 1:
        raise ValueError(f"no binned quotient kernels for 2^{q_bits} slots "
                         f"in bins of 2^{bin_bits} quotients on cuda:{index}")
    return chunks


def binned_chunks(spec: FilterSpec, bin_bits: int, device) -> int:
    """The bin stages' CTAs on a CUDA ``device`` (the scatter's CTAs that
    fill the card), which size the workspace."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _chunks_on(index, spec.q_bits, bin_bits)


def _contains_workspace(nbytes: int, device) -> torch.Tensor:
    """A binned call's workspace (a test substitutes a fake). Freed when
    the call returns: the caching allocator orders its reuse after the
    call's kernels on the same stream."""
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def _version(table: torch.Tensor) -> Optional[int]:
    """The table's version counter (in-place writes bump it), None for a
    tensor without one (made under ``torch.inference_mode``)."""
    try:
        return table._version
    except RuntimeError:
        return None


def table_load(spec: FilterSpec, table: torch.Tensor) -> float:
    """The CUDA table's load from a sample on the card (``qf_load_sample``:
    the slots in use of 128 runs of at most 2048 slots spread over the
    table), read back to the host once (a synchronisation) and kept on the
    tensor until its version counter moves (an in-place torch op, or an
    update wrapper of this module). A load kept past a write that bypassed
    both only picks a slower path: the result never depends on it."""
    return _table_rule(spec, table)[0]


def binned_from(spec: FilterSpec, load: float, smem_bytes: int):
    """The fewest keys from which :func:`choose_contains_path` runs binned
    on ``spec``'s table at ``load`` (it is monotone in n), or None."""
    def binned(n):
        return choose_contains_path(n, spec.q_bits, spec.slot_bits,
                                    smem_bytes, load, spec.r_bits) == "binned"
    lo, hi = LOAD_MIN_KEYS, 1 << 40
    if not binned(hi):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if binned(mid) else (mid + 1, hi)
    return lo


def _table_rule(spec: FilterSpec, table: torch.Tensor) -> tuple:
    """(load, :func:`binned_from` at it) of a CUDA table: the rule's
    inputs, worked out once a table state and kept on the tensor (a
    contains asks them every call)."""
    version = _version(table)
    kept = getattr(table, "_quotient_rule", None)
    if (version is not None and kept is not None and kept[0] == version
            and (kept[1] is spec or kept[1] == spec)):
        return kept[2]
    used, sampled = _sample_load(spec, table)
    load = used / sampled
    rule = (load, binned_from(spec, load, partition_smem_bytes(table.device)))
    if version is not None:
        table._quotient_rule = (version, spec, rule)
    return rule


def _sample_load(spec: FilterSpec, table: torch.Tensor) -> tuple:
    """(slots in use, slots sampled) of ``qf_load_sample`` on the card."""
    from repro_torch.kernels._build import library
    out = torch.zeros((2,), dtype=torch.int64, device=table.device)
    with torch.cuda.device(table.device):
        err = library().quotient_load_sample(
            table.data_ptr(), spec.q_bits, spec.slot_bits, out.data_ptr(),
            _stream(table.device))
    _raise_on(err, "quotient load sample")
    return tuple(out.tolist())


def _card_contains_plan(spec: FilterSpec, table: torch.Tensor, n: int,
                        device, path, bin_bits, cap: int, window) -> tuple:
    """(plan, cap, workspace) of a contains on the card: the rule's path
    (from the table's load where the batch is large enough to ask it)
    unless one is given; for the binned path the bins, window and
    workspace, allocated. Where the allocation fails the cap drops to
    :func:`cap_for_memory`'s from half the cap that failed, until the
    workspace allocates; ``MemoryError`` where none does."""
    load = None
    if path is None:
        path = "walk"
        if n >= LOAD_MIN_KEYS:
            load, first = _table_rule(spec, table)
            if first is not None and n >= first:
                path = "binned"
    if path == "walk":
        return dict(contains_plan(spec, n, path), load=load), cap, None
    bb = contains_bin_bits(spec.q_bits) if bin_bits is None else bin_bits
    ww = contains_window_words(spec, bb) if window is None else window
    chunks = binned_chunks(spec, bb, device)
    while True:
        plan = contains_plan(spec, n, path, bb, cap, chunks, ww)
        plan["load"] = load
        try:
            return plan, cap, _contains_workspace(plan["workspace_bytes"],
                                                  device)
        except torch.cuda.OutOfMemoryError:
            cap = cap_for_memory(spec, n, bb, cap // 2, chunks, ww,
                                 free_device_bytes(device))


def _launch_contains(spec, table, keys, path: Optional[str] = None, *,
                     bin_bits: Optional[int] = None,
                     cap: int = CONTAINS_KEY_CAP,
                     window: Optional[int] = None) -> torch.Tensor:
    """The contains kernels on the card: ``path`` (the walk or binned) or,
    None, the rule's path."""
    from repro_torch.kernels._build import library
    if path is not None and path not in CONTAINS_PATHS:
        raise ValueError(f"path must be one of {CONTAINS_PATHS}, not "
                         f"{path!r}")
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    plan, cap, work = _card_contains_plan(spec, table, n, keys.device, path,
                                          bin_bits, cap, window)
    if plan["path"] != "walk" and table.data_ptr() % 16:
        raise ValueError("the binned contains takes 16-byte aligned words")
    lib = library()
    with device_scope(keys.device):
        err = lib.quotient_contains(
            keys.data_ptr(), table.data_ptr(), out.data_ptr(), n,
            *_geometry(spec), CONTAINS_PATHS.index(plan["path"]),
            None if work is None else work.data_ptr(),
            plan["workspace_bytes"], plan["bin_bits"] or 0,
            plan["window_words"], cap, max(plan["chunks"], 1),
            _stream(keys.device))
    _raise_on(err, "contains_vmem")
    LAST_CONTAINS_PLAN.clear()
    LAST_CONTAINS_PLAN.update(plan)
    return out


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def contains_mode(spec: FilterSpec, n: int, load: Optional[float],
                  smem_bytes: int = 227 * 1024) -> str:
    """:func:`choose_contains_path` for an n-key batch into ``spec``'s
    table at ``load`` on a card with ``smem_bytes`` of shared memory a CTA
    (the H100's 227 KiB by default)."""
    return choose_contains_path(n, spec.q_bits, spec.slot_bits, smem_bytes,
                                load, spec.r_bits)


def contains_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  coop: str = "none", *, path: Optional[str] = None,
                  bin_bits: Optional[int] = None,
                  cap: int = CONTAINS_KEY_CAP,
                  window: Optional[int] = None) -> torch.Tensor:
    """Bulk run-scan membership. (n,) bool. On the card the path is
    :func:`choose_contains_path`'s at the table's load
    (:func:`table_load`); the private arguments (tests and the smoke;
    ``ops`` never passes them): ``path``, ``bin_bits`` (quotients a
    bin, log2), ``cap`` (keys an internal batch) and ``window`` (table
    words a test CTA stages)."""
    if coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS}")
    if not _check_layout(spec, table, keys):
        return contains_plain(spec, table, keys, coop)
    out = _launch_contains(spec, table, keys, path, bin_bits=bin_bits,
                           cap=cap, window=window)
    if keys.shape[0]:
        LAUNCHES["contains_vmem"] += 1
    return out


def _update(name: str, spec, table, keys, valid, op: str,
            tile: Optional[int], knobs: dict):
    if tile is not None and tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    if not _check_layout(spec, table, keys, valid):
        new, flags = update_plain(spec, table, keys, valid, op, tile)
        return table.copy_(new), flags
    flags = _launch_update(spec, table, keys, valid, op, **knobs)
    if keys.shape[0]:
        LAUNCHES[name] += 1
        if _version(table) is not None:   # a kept load (table_load) goes
            torch.autograd.graph.increment_version(table)      # stale
    return table, flags


def add_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
             valid: Optional[torch.Tensor], tile: Optional[int] = None,
             **knobs):
    """Bulk insert, a sorted-stream rebuild; updates ``table`` in place.
    Returns (table, ok): ``ok[i]`` is False when the table had no room left
    for key i (the first ``n_slots - 1 - stored`` valid keys are admitted).
    ``knobs`` (``bin_bits``, ``bin_cap``, ``tile_slots``, ``merge_tile``,
    ``key_chunks``: the key stages' CTAs, 0 for one an SM) are private."""
    return _update("add_vmem", spec, table, keys, valid, "add", tile, knobs)


def remove_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                valid: Optional[torch.Tensor], tile: Optional[int] = None,
                **knobs):
    """Bulk delete, one fingerprint copy a key; updates ``table`` in place.
    Returns (table, found)."""
    return _update("remove_vmem", spec, table, keys, valid, "remove", tile,
                   knobs)


def _check_tables(spec: FilterSpec, *tables: torch.Tensor) -> bool:
    """True for CUDA tables (each of ``spec``'s size, the spec one the
    kernels serve), False for CPU tables."""
    if not spec.is_quotient:
        raise ValueError(f"{spec} is not a quotient spec")
    devices = {t.device for t in tables}
    if len(devices) != 1:
        raise ValueError(f"tables on {sorted(map(str, devices))}")
    for t in tables:
        if t.ndim != 1 or t.dtype != torch.int32 or t.numel() != spec.n_words:
            raise ValueError(f"a table must be ({spec.n_words},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tables[0].device.type == "cpu":
        return False
    if tables[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tables[0].device}")
    if not kernel_supported(spec):
        raise ValueError(f"the CUDA quotient kernels serve u8/u16/u32 lanes "
                         f"and at most 2^{MAX_Q_BITS} slots, not {spec}")
    return True


def merge_vmem(spec: FilterSpec, table_a: torch.Tensor,
               table_b: torch.Tensor, *, tile_slots: int = TILE_SLOTS,
               merge_tile: int = MERGE_TILE) -> torch.Tensor:
    """Union of two same-spec tables (a new table): both decoded, the two
    streams merged and written. The caller checks the capacity."""
    if not _check_tables(spec, table_a, table_b):
        return merge_plain(spec, table_a, table_b)
    from repro_torch.kernels._build import library
    plan = update_plan(spec, 0, "merge", tile_slots=tile_slots,
                       merge_tile=merge_tile)
    dev = table_a.device
    out = torch.empty_like(table_a)
    work = _workspace(plan, dev)
    with torch.cuda.device(dev):
        err = library().quotient_merge(
            table_a.contiguous().data_ptr(), table_b.contiguous().data_ptr(),
            out.data_ptr(), spec.q_bits, spec.r_bits, spec.slot_bits,
            work.data_ptr(), plan["workspace_bytes"], tile_slots, merge_tile,
            _stream(dev))
    _raise_on(err, "quotient merge")
    _keep_plan(plan)
    LAUNCHES["merge_vmem"] += 1
    return out


def resize_vmem(spec: FilterSpec, table: torch.Tensor, new_spec: FilterSpec,
                *, tile_slots: int = TILE_SLOTS,
                merge_tile: int = MERGE_TILE) -> torch.Tensor:
    """The table re-slotted into ``new_spec`` (same p = q + r): its decoded
    stream, in the same order, written with the new q/r split. The caller
    checks a shrink's capacity."""
    if not (new_spec.is_quotient
            and new_spec.fingerprint_bits == spec.fingerprint_bits):
        raise ValueError(f"resize conserves p = q + r: {spec} -> {new_spec}")
    if not _check_tables(spec, table):
        return resize_plain(spec, table, new_spec)
    if not kernel_supported(new_spec):
        raise ValueError(f"the CUDA quotient kernels do not serve {new_spec}")
    from repro_torch.kernels._build import library
    plan = update_plan(spec, 0, "resize", new_spec=new_spec,
                       tile_slots=tile_slots, merge_tile=merge_tile)
    dev = table.device
    out = torch.empty((new_spec.n_words,), dtype=torch.int32, device=dev)
    work = _workspace(plan, dev)
    with torch.cuda.device(dev):
        err = library().quotient_resize(
            table.contiguous().data_ptr(), out.data_ptr(), spec.q_bits,
            spec.r_bits, new_spec.q_bits, new_spec.r_bits, spec.slot_bits,
            work.data_ptr(), plan["workspace_bytes"], tile_slots, merge_tile,
            _stream(dev))
    _raise_on(err, "quotient resize")
    _keep_plan(plan)
    LAUNCHES["resize_vmem"] += 1
    return out
