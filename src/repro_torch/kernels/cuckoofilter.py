"""Cuckoo fingerprint filter kernels for Hopper, and their plain PyTorch
versions.

Counterpart of ``repro.kernels.cuckoofilter``; the wrappers keep the JAX
names, so each row of the kernel table maps one to one:

============= =================================== ==========================
wrapper       replaces (repro/kernels/            CUDA kernels
              cuckoofilter.py)                    (csrc/cuckoo.cu)
============= =================================== ==========================
contains_vmem contains_vmem                       cuckoo_contains_kernel
add_vmem      add_vmem (_update_vmem, op add)     cuckoo_order_kernel, then
                                                  cuckoo_apply_kernel, add
remove_vmem   remove_vmem (_update_vmem, op       the same, remove
              remove)
============= =================================== ==========================

The JAX package runs these kernels only on a table that fits VMEM and sends
a larger one to its jnp reference; here one kernel pair serves every size
(a table in L2 or in DRAM), as ``kernels.ops`` dispatches it. ``coop`` is
validated and both values run the same contains kernel, which loads a
key's alternate bucket only when its primary bucket misses (the result of
either value). The update wrappers take the update's ``tile``: the tiles
of ``tile`` keys over the batch, each stably sorted by primary bucket and
applied key by key, fix the words (``core.fingerprint``); the kernels keep
that order. The first sorts every tile at once; the second, one CTA,
applies the order in windows of at most ``window`` keys (speculate
against the committed table, validate, commit the keys before the first
conflict; a key whose chain outgrows the round finishes alone once it is
first; ``csrc/cuckoo.cu`` gives the design). :func:`update_windowed` is
the plain model of that schedule, round for round; the tests hold it, and
its counters, against the plain update and the kernel.

Wrappers take ``int32`` tensors: keys ``(n, 2)`` holding ``[hi, lo]``, the
table ``(n_words,)`` and ``valid`` ``(n,)`` uint8 or bool (or ``None``:
every key valid). For CPU tensors a wrapper runs its plain version; for
CUDA tensors it launches its kernels or raises. The update wrappers change
the table in place and return ``(table, flags)``. ``LAUNCHES`` counts
wrapper calls that launched (an update call launches two kernels);
``LAST_UPDATE_STATS`` keeps each update wrapper's last counters on the card,
read only by :meth:`UpdateStats.read`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import fingerprint as F
from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.kernels.sbf import COOPS, _on_cuda, _raise_on

OPS = ("add", "remove")
_OP_CODE = {"add": 0, "remove": 1}
# (slot_bits, slots_per_bucket) pairs with a kernel instance
INSTANCES = ((8, 4), (8, 8), (8, 16), (16, 2), (16, 4), (16, 8), (16, 16))
MAX_TILE = 8192                # keys a tile of the update kernel holds
# The windowed apply (csrc/cuckoo.cu). A round takes at most WINDOW keys
# (one a thread of the CTA) and at least MIN_WINDOW: the window halves
# after a round in which a key was capped and doubles after one that
# committed it whole. A key may make STEP_CAP bucket reads in a round's
# speculation (the longest chain: two buckets and 64 kicks) and
# OVERLAY_SLOTS / window word writes, at most MAX_OVERLAY. The window's
# written-bucket set (HASH_SLOTS) takes HASH_BUDGET overlay writes, and the
# chains finished alone in a round ALONE_MAX set entries each within
# ALONE_ROOM.
WINDOW = 1024                  # csrc kMaxWindow
MIN_WINDOW = 256               # csrc kMinWindow
STEP_CAP = 2 + F.CUCKOO_MAX_KICKS
OVERLAY_SLOTS = 16384
MAX_OVERLAY = 72
HASH_SLOTS = 8192
HASH_BUDGET = 4096
ALONE_MAX = MAX_OVERLAY + 2 + F.CUCKOO_MAX_KICKS
ALONE_ROOM = HASH_SLOTS * 3 // 4 - HASH_BUDGET
# the apply kernel's counters, in the order of its int64 (8,) tensor
STATS = ("rounds", "conflict_rounds", "capped_rounds", "alone_keys",
         "min_committed", "max_committed", "chain_reads", "reads")

# Kernel launches per wrapper (a launch adds one; the plain path adds none).
LAUNCHES = {"contains_vmem": 0, "add_vmem": 0, "remove_vmem": 0}
# update wrapper -> UpdateStats of its last launch
LAST_UPDATE_STATS: dict = {}


@dataclasses.dataclass(frozen=True)
class UpdateStats:
    """The counters of one update launch: ``counters`` stays on the card
    until :meth:`read` (which synchronises) is called."""
    n: int
    tile: int
    window: int
    step_cap: int
    counters: torch.Tensor

    def read(self) -> dict:
        """``STATS`` as ints, and ``mean_committed`` (keys a round)."""
        out = dict(zip(STATS, self.counters.tolist()))
        out["mean_committed"] = self.n / out["rounds"]
        return out


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_supported(spec: FilterSpec) -> bool:
    """Cuckoo specs the CUDA kernels serve: a (slot_bits, slots_per_bucket)
    pair of ``INSTANCES`` and fewer than 2^31 table words."""
    return (spec.variant == "cuckoo"
            and (spec.slot_bits, spec.slots_per_bucket) in INSTANCES
            and spec.n_words < 1 << 31)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def contains_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                   coop: str = "none") -> torch.Tensor:
    """Plain version of ``contains_vmem``: (n,) bool."""
    if coop == "subtile":
        return F.cuckoo_contains_coop(spec, table, keys)
    return F.cuckoo_contains(spec, table, keys)


def update_plain(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                 valid: Optional[torch.Tensor], op: str,
                 tile: int = F.CUCKOO_ADD_TILE):
    """Plain version of ``add_vmem`` / ``remove_vmem``: (new table, flags
    (n,) bool); ``table`` is not modified. Sequential, on a host copy of
    the table."""
    _check_op(op)
    fn = F.cuckoo_add if op == "add" else F.cuckoo_remove
    return fn(spec, table, keys, valid=valid, tile=tile)


class _Chain:
    """One key's chain in :func:`update_windowed`, resumable between
    steps (``csrc/cuckoo.cu`` ``Chain``); ``overlay`` maps the buckets it
    wrote to their slots, ``nlog`` counts its writes."""

    def __init__(self, b1: int, fp: int, rng: int, orig: int):
        self.b1 = self.b = b1
        self.fp = self.f = fp
        self.r, self.orig = rng, orig
        self.last = self.kicks = self.stage = self.reads = self.nlog = 0
        self.done = self.ok = fp == 0              # an invalid key: a no-op
        self.capped = False
        self.overlay = {}
        self.seen = set()                          # buckets it read


def _step(spec: FilterSpec, c: _Chain, read, write, op: str) -> None:
    """One step of a chain: read bucket ``c.b``, then place (or clear),
    move to the alternate bucket, kick, or end (``chain_step``)."""
    slots = read(c.b)
    c.reads += 1
    c.last = c.b
    want = 0 if op == "add" else c.f
    if want in slots:
        slots[slots.index(want)] = c.f if op == "add" else 0
        write(c.b, slots)
        c.done = c.ok = True
    elif c.stage == 0:
        c.stage = 1
        c.b = F.alt_bucket(spec, c.b, c.f)
    elif op == "remove" or c.kicks == F.CUCKOO_MAX_KICKS:
        c.done, c.ok = True, False
    else:
        lg_spb = V._log2i(spec.slots_per_bucket)
        v = 0 if lg_spb == 0 else c.r >> (32 - lg_spb)
        victim, slots[v] = slots[v], c.f
        write(c.b, slots)
        c.f = victim
        c.b = F.alt_bucket(spec, c.b, c.f)
        c.r = (c.r * F.LCG_MUL + F.LCG_ADD) & 0xFFFFFFFF
        c.kicks += 1


def _apply_order(spec: FilterSpec, keys: torch.Tensor, valid, tile: int):
    """The order kernel's output: (b1, fp or 0 for an invalid key, victim
    stream, original index) by position: tiles of ``tile`` keys, each
    stably sorted by b1."""
    n = keys.shape[0]
    b1, fp, rng = F.cuckoo_hashes(spec, keys)
    b1, fp, rng, v = F._lists(b1, fp, rng, F._as_valid(n, valid,
                                                        keys.device))
    order = []
    for c in range(0, n, tile):
        order.extend(sorted(range(c, min(c + tile, n)), key=b1.__getitem__))
    return [(b1[i], fp[i] if v[i] else 0, rng[i], i) for i in order]


def update_windowed(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                    valid: Optional[torch.Tensor], op: str,
                    tile: int = F.CUCKOO_ADD_TILE, window: int = WINDOW,
                    step_cap: int = STEP_CAP, counters: bool = True):
    """Plain model of the kernels' windowed apply, round for round: (new
    table, flags (n,) bool, counters as :meth:`UpdateStats.read` gives
    them). Same words and flags as :func:`update_plain`; ``table`` is not
    modified. A model for the tests, on a host copy of the table.

    With ``counters=False`` a round speculates only up to the key that
    ends it (the same rounds, words and flags, faster); ``chain_reads``
    and ``reads``, which count every key of the window, are then left out.
    """
    _check_op(op)
    _check_schedule(tile, window, step_cap)
    n = keys.shape[0]
    spb = spec.slots_per_bucket
    slots = F._table_list(spec, table)
    order = _apply_order(spec, keys, valid, tile)
    flags = [True] * n
    st = dict.fromkeys(STATS, 0)
    st["min_committed"] = n

    def bucket(b):
        return slots[b * spb:(b + 1) * spb]

    def store(b, s):
        slots[b * spb:(b + 1) * spb] = s

    # a key's speculation is kept from round to round while no commit
    # writes a bucket it read and the window stays (the kernel runs it
    # again, to the same end)
    spec_of = {}
    win = window
    min_win = min(window, MIN_WINDOW)

    def speculate(p):
        if p in spec_of:
            return spec_of[p]
        c = spec_of[p] = _Chain(*order[p])
        cap = min(OVERLAY_SLOTS // win, MAX_OVERLAY)

        def read(b):
            c.seen.add(b)
            return list(c.overlay[b]) if b in c.overlay else bucket(b)

        def write(b, s):
            c.overlay[b] = list(s)
            c.nlog += 1

        while not c.done:
            if c.reads == step_cap or c.nlog == cap:
                c.capped = True
                break
            _step(spec, c, read, write, op)
        return c

    extra = [0, 0]                           # alone: chains, their reads

    def finish_alone(c, pos, writer):
        """Store the chain's overlay, run the rest of it on the table; its
        writes enter ``writer`` as position ``pos``'s. Returns the set
        entries it inserted (one an overlay write, one a direct write)."""
        before, inserts = c.reads, c.nlog

        def write(b, s):
            nonlocal inserts
            store(b, s)
            writer[b] = min(writer.get(b, pos), pos)
            inserts += 1

        for b, s in c.overlay.items():
            store(b, s)
            writer[b] = min(writer.get(b, pos), pos)
        c.overlay, c.nlog, c.capped = {}, 0, False
        while not c.done:
            _step(spec, c, bucket, write, op)
        extra[0] += 1
        extra[1] += c.reads - before
        return inserts

    base = 0
    while base < n:
        cnt = min(win, n - base)
        # the kernel speculates every key before key 0 goes on alone
        chains = [speculate(base + j) for j in range(cnt if counters else 1)]
        spec_reads = [c.reads for c in chains]
        writer = {}                          # bucket -> lowest writer
        alone = alone_inserts = 0
        if chains[0].capped:                 # key 0 finishes on the table
            alone_inserts = finish_alone(chains[0], 0, writer)
            alone = 1
        changed = set(writer)
        # validate in order: a key is checked against the writes of the
        # keys before it, the hash budget is a prefix sum by position; a
        # capped key that read no earlier write finishes alone and the
        # window goes on past it, while the set has room
        first, reason, total = cnt, None, 0
        for j in range(cnt):
            if j == len(chains):
                chains.append(speculate(base + j))
                spec_reads.append(chains[j].reads)
            c = chains[j]
            total += 0 if c.capped else c.nlog
            over = not c.capped and total > HASH_BUDGET
            if not (c.capped or over):
                for b in c.overlay:
                    writer[b] = min(writer.get(b, j), j)
            conflict = False
            if c.reads:
                seen = {c.b1, c.last, *c.overlay}
                if c.reads > 1:
                    seen.add(F.alt_bucket(spec, c.b1, c.fp))
                conflict = any(writer.get(b, j) < j for b in seen)
            if (conflict or over or c.capped
                    and alone_inserts + ALONE_MAX > ALONE_ROOM):
                first = j
                reason = "conflict" if conflict else "budget"
                break
            if c.capped:
                wrote = {}
                alone_inserts += finish_alone(c, j, wrote)
                for b, w in wrote.items():
                    writer[b] = min(writer.get(b, w), w)
                changed.update(wrote)
                alone += 1
            else:
                for b, s in c.overlay.items():     # commit
                    store(b, s)
                changed.update(c.overlay)
            flags[c.orig] = c.ok
        st["rounds"] += 1
        if reason:
            st["conflict_rounds" if reason == "conflict"
               else "capped_rounds"] += 1
        st["min_committed"] = min(st["min_committed"], first)
        st["max_committed"] = max(st["max_committed"], first)
        st["chain_reads"] += max(spec_reads)
        st["reads"] += sum(spec_reads)
        base += first
        if alone or reason == "budget":
            new_win = max(min_win, win // 2)
        elif first == win:
            new_win = min(window, 2 * win)
        else:
            new_win = win
        if new_win != win:
            win, spec_of = new_win, {}
        else:
            spec_of = {p: c for p, c in spec_of.items()
                       if p >= base and not c.seen & changed}
    st["alone_keys"] = extra[0]
    st["chain_reads"] += extra[1]
    st["reads"] += extra[1]
    if not counters:
        del st["chain_reads"], st["reads"]
    if n:
        st["mean_committed"] = n / st["rounds"]
    return (F._table_tensor(spec, slots, table),
            torch.tensor(flags, dtype=torch.bool, device=table.device), st)


# ---------------------------------------------------------------------------
# Layout checks and launches
# ---------------------------------------------------------------------------

def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op={op!r} not in {OPS}")


def _check_schedule(tile: int, window: int, step_cap: int) -> None:
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile={tile}: the update kernel takes tiles of 1 "
                         f"to {MAX_TILE} keys")
    if not 1 <= window <= WINDOW:
        raise ValueError(f"window={window}: the apply kernel takes windows "
                         f"of 1 to {WINDOW} keys")
    if step_cap < 1:
        raise ValueError(f"step_cap={step_cap} must be >= 1")


def _check_layout(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  valid=None) -> bool:
    """Validate the tensors of a call: True for CUDA tensors, False for CPU
    tensors; ``ValueError`` otherwise."""
    if spec.variant != "cuckoo":
        raise ValueError(f"{spec} is not a cuckoo spec")
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
        raise ValueError(f"the CUDA cuckoo kernels serve (slot_bits, "
                         f"slots_per_bucket) in {INSTANCES}, not {spec}")
    if not (keys.is_contiguous() and table.is_contiguous()):
        raise ValueError("keys and table words must be contiguous")
    if keys.data_ptr() % 8 or table.data_ptr() % 16:
        raise ValueError("keys must be 8-byte and words 16-byte aligned")
    return True


def _geometry(spec: FilterSpec):
    return (spec.n_buckets - 1, V._log2i(spec.n_buckets), spec.slot_bits,
            spec.slots_per_bucket, F.FP_SALT, F.ALT_SALT)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_update(name: str, spec, table, keys, valid, op: str, tile: int,
                   window: int, step_cap: int):
    from repro_torch.kernels._build import library
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{name}: batches of fewer than 2^31 keys, got {n}")
    flags = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return table, flags
    if valid is not None:
        valid = valid.contiguous().view(torch.uint8)
    order = torch.empty((n, 4), dtype=torch.int32, device=keys.device)
    counters = torch.empty((len(STATS),), dtype=torch.int64,
                           device=keys.device)
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.cuckoo_update(
            keys.data_ptr(), None if valid is None else valid.data_ptr(),
            table.data_ptr(), flags.data_ptr(), order.data_ptr(),
            counters.data_ptr(), n, tile, window, step_cap,
            *_geometry(spec), _OP_CODE[op], _stream(keys.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    LAST_UPDATE_STATS[name] = UpdateStats(n, tile, window, step_cap,
                                          counters)
    return table, flags


# ---------------------------------------------------------------------------
# The three wrappers
# ---------------------------------------------------------------------------

def contains_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                  coop: str = "none") -> torch.Tensor:
    """Bulk two-bucket membership, one launch. (n,) bool."""
    if coop not in COOPS:
        raise ValueError(f"coop={coop!r} not in {COOPS}")
    if not _check_layout(spec, table, keys):
        return contains_plain(spec, table, keys, coop)
    from repro_torch.kernels._build import library
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.cuckoo_contains(keys.data_ptr(), table.data_ptr(),
                                  out.data_ptr(), n, *_geometry(spec),
                                  _stream(keys.device))
    _raise_on(err, "contains_vmem")
    LAUNCHES["contains_vmem"] += 1
    return out


def _update(name: str, spec, table, keys, valid, op: str, tile: int,
            window: Optional[int], step_cap: Optional[int]):
    window = WINDOW if window is None else window
    step_cap = STEP_CAP if step_cap is None else step_cap
    _check_schedule(tile, window, step_cap)
    if not _check_layout(spec, table, keys, valid):
        new, flags = update_plain(spec, table, keys, valid, op, tile)
        return table.copy_(new), flags
    return _launch_update(name, spec, table, keys, valid, op, tile, window,
                          step_cap)


def add_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
             valid: Optional[torch.Tensor], tile: int = F.CUCKOO_ADD_TILE,
             *, window: Optional[int] = None,
             step_cap: Optional[int] = None):
    """Ordered bulk insert in tiles of ``tile`` keys; updates ``table`` in
    place. Returns (table, ok): ``ok[i]`` is False when key i's kick chain
    ran out. ``window`` and ``step_cap`` (default ``WINDOW``,
    ``STEP_CAP``) set the apply kernel's schedule, for tests and
    measurements; the words do not depend on them, and ``ops`` never
    passes them."""
    return _update("add_vmem", spec, table, keys, valid, "add", tile, window,
                   step_cap)


def remove_vmem(spec: FilterSpec, table: torch.Tensor, keys: torch.Tensor,
                valid: Optional[torch.Tensor],
                tile: int = F.CUCKOO_ADD_TILE, *,
                window: Optional[int] = None,
                step_cap: Optional[int] = None):
    """Ordered bulk delete, one slot a key; updates ``table`` in place.
    Returns (table, found). ``window`` and ``step_cap`` as in
    :func:`add_vmem`."""
    return _update("remove_vmem", spec, table, keys, valid, "remove", tile,
                   window, step_cap)
