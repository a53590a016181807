#!/usr/bin/env python3
"""Time this tree's blocked add and contains, its cuckoo update, its
classical (cbf) add and contains, its quotient update, its partitioned
blocked add and counting update and its windowed ring contains against
another checkout's, in turns, on one NVIDIA card.

    git archive <commit> | (mkdir -p build/other && tar -x -C build/other)
    python3 tools/bloom_ab.py build/other \
        [--only bloom|cuckoo|cbf|quotient|partitioned|counting|ring]

Blocked filters: the other checkout's ``src/repro_torch/kernels/csrc/
bloom.cu`` must have the one-thread-a-key C interface, ``bloom_contains(
keys, words, out, salts, n, block_mask, s, phi, depth, variant, k, z, log2g,
stream)`` and ``bloom_add(keys, words, salts, n, block_mask, s, variant, k,
z, log2g, stream)``. The script builds that file with this tree's nvcc
flags, then, in the main path's two sbf cells (B = 256, k = 8: 2^23 keys
into 16 MiB and 2^28 keys into 512 MiB, as ``filter_for_n_items(n,
bits_per_key=16)`` makes them), checks that the other kernels, this tree's
Θ = 1 and ``sbf.card_layout``'s Θ give the same words and results, and
times, in turns (CUDA events; median and the rounds' range):

* the add of the keys into the filter;
* the contains of the added keys (L2: depth 1; DRAM: depths 1, 2 and 8);
* the contains of as many probes, most of them negatives, where the early
  exit of a key at its first missing load acts (L2: depth 1; DRAM: the
  depth ``ops`` resolves).

Cuckoo: the other checkout's ``cuckoo.cu`` must have the windowed
update's and the one-pass contains' C interfaces, ``cuckoo_update(keys,
valid, table, flags, order, stats, n, tile, window, step_cap, bucket_mask,
lg_buckets, slot_bits, spb, fp_salt, alt_salt, op, stream)`` and
``cuckoo_contains(keys, table, out, n, bucket_mask, lg_buckets, slot_bits,
spb, fp_salt, alt_salt, stream)``. In the cuckoo cell of ``chip_smoke.py``
(``filter_for_n_items(2^22, bits_per_key=16, variant="cuckoo")``, u16 x 4,
16 MiB, the smoke's keys) the script checks that both updates give the
same words and flags, then times them in turns, one call each on a
restored table: the add of 2^22 keys into the empty table, the add of
3,355,443 more (load 0.5 to 0.9), the remove of half of them and the add
of 2^16 keys at load 0.9; and prints this tree's counters of each. Then,
there and in the DRAM cell (2^27 keys into 512 MiB, topped up to load
0.9 as the smoke does), it checks that both trees' contains give the same
results and times them in turns: the contains of every key and of 2^22
probes, the other's one-pass kernel against this tree's wrapper and its
kernel through ctypes, as the other's (20 calls a round in L2, 3 in
DRAM).

Classical filter: the other checkout's ``cbf.cu`` must have the one-pass
add's and contains' C interfaces, ``cbf_add(keys, words, salts, n, log2m,
k, stream)`` and ``cbf_contains(keys, words, out, salts, n, log2m, k,
stream)``. In the two cbf cells of ``chip_smoke.py``
(``filter_for_n_items(n, bits_per_key=16, variant="cbf")``, k = 11: 2^23
keys into 2^27 bits and 2^28 keys into 2^32 bits, the smoke's keys) the
script checks that the other add, this tree's add on the path its rule
picks and on the other path give the same words, then times the three adds
of the keys into the filter in turns; then the same for the contains of
the keys and of 2^22 probes (results equal).

Partitioned blocked add: the other checkout's ``bloom.cu`` must have
``bloom_add_partitioned(keys, valid, words, salts, n_segments, capacity,
seg_words, block_mask, s, variant, k, z, log2g, shared, stream)`` (shared:
1 where a segment fits shared memory, as its wrapper passed). In the two
sbf cells of ``chip_smoke.py`` (B = 256, k = 8: 2^23 keys into 16 MiB;
2^28 keys into 512 MiB, a 2^24-key batch) and at n_segments 8, the
fitting count and 2, 4, 8 and 16 times it, the script checks that the
other add, this tree's add on its rule's path and on the other path give
the same words, then times in turns (10 rounds, one call each on restored
words) the other kernel and this tree's kernel of the rule's plan, both
called through ctypes, and this tree's wrapper on both paths, and prints
this tree's plan. A single call's time includes what the host spends
before the launch, so the wrapper's Python shows in L2-sized calls.

Partitioned counting update: the other checkout's ``counting.cu`` must have
``counting_update_partitioned(keys, valid, counters, salts, n_segments,
capacity, seg_cwords, block_mask, s, k, op, path, stream)``, where the
other's path flag is what its wrapper passed (1 where a segment fits
shared memory). In the two countingbf cells of ``chip_smoke.py`` (2^22 keys
into 32 MiB; 2^26 keys into 512 MiB, a 2^24-key batch) and at n_segments 8,
the fitting count (the smallest whose segment fits shared memory) and 2, 4,
8 and 16 times it, the script checks that both trees' updates give the
same counters (add of the batch, remove of it), then times the add and the
remove in turns, one call each on restored counters.

Counting update and contains: the other checkout's ``counting.cu`` must
have the one-thread-a-key C interfaces, ``counting_update(keys, valid,
counters, salts, n, block_mask, s, k, op, stream)``, ``counting_contains(
keys, counters, out, salts, n, block_mask, s, phi, depth, k, stream)`` and
their bank forms (``counting_bank_update`` / ``counting_bank_contains``, +
member ids and the member's words). In the two countingbf cells of
``chip_smoke.py`` (2^22 keys into 32 MiB, 2^26 keys into 512 MiB) and its
two bank cells (1024 members, 2^22 and 2^26 routed keys; member ids
uniform, and again skewed: half of the keys on member 0) the script checks
that both trees' add, remove of half and contains give the same counters
and results (this tree's on both update paths), then times in turns the
add and the remove on the other tree, on this tree's rule's path and on
both of its paths forced (6 rounds of 10 calls in L2, 3 in DRAM, queued
back to back on counters restored before each call, outside its events)
and the contains at depths 1 and 8 (the other's depth capped at 64 / s,
as its wrapper did; this tree's wrappers at ``countingbf.card_layout``),
and prints this tree's path and geometry. Both trees' bank calls skip the
wrapper's member range check.

Quotient filter: the other checkout's ``quotient.cu`` must have the
sorted-stream update's C interfaces (``quotient_update``,
``quotient_merge``, ``quotient_resize``, as this tree's) and the table
pass contains', ``quotient_contains(keys, table, out, n, lg_slots, r_bits,
slot_bits, fp_salt, mode, ws_slots, aggs, n_aggs, scal, stream)`` (mode 0
the walk, 1 the table pass, 2 the card's choice). In the two quotient
cells of ``chip_smoke.py`` (``filter_for_n_items(n, variant="quotient")``:
q23 + r5 in u8 lanes, 8 MiB, batches of 2^22; q26 + r5, 64 MiB, batches
of 2^24; keys to load 0.9) the script checks that both trees give the
same words and flags, then times in turns, one call each on a restored
table: the first batch's add into the empty table, the last batch's add
(to load 0.9), the remove of a batch at load 0.9 and the add of 2^22 keys
into the empty table (this tree's through its wrapper and, as the other's,
through ctypes), the merge of two tables of half the keys each and the
resize one step up; and the contains of every key at load 0.9 and of
2^22 keys (half of them probes): the other's wrapper's mode against this
tree's rule's path (at the load it samples) and each of its paths forced
(results equal first; 20 calls a round, 5 in the DRAM-side cell).

Ring contains: the other checkout's ``ring.cu`` must have the
one-thread-a-key C interface, ``ring_contains(keys, rings, out, salts, n,
n_words, n_gen, block_mask, s, depth, variant, k, z, log2g, stream)``
(depth at most 4). In the two windowed cells of ``chip_smoke.py``
(``filter_for_n_items(W, bits_per_key=16, block_bits=256,
generations=4)``, five batches of W/4 keys with an advance after each of
the first four: W = 2^22, a 32 MiB ring, and W = 2^26, 512 MiB) the script
checks that the other kernel and this tree's contains on its rule's path
and on both paths forced give the same results for the live keys, the
retired batch and W fresh probes, then times in turns: the other at depth
1 and at the depth its wrapper ran for ``ops``' resolved depth (L2: depth
1), both called through ctypes; this tree's wrapper on its rule's path,
on the one-pass path and on the binned path; and this tree's one-pass
kernel through ctypes, as the other's (6 rounds of 20 calls in L2, 3 in
DRAM).

It prints the card's name and power limit first.
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import fingerprint as F  # noqa: E402
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import quotient as Q  # noqa: E402
from repro_torch.core import variants as V  # noqa: E402
from repro_torch.kernels import _build, cbf, ops, ring, sbf  # noqa: E402
from repro_torch.kernels import countingbf as cnt  # noqa: E402
from repro_torch.kernels import cuckoofilter as ckoo  # noqa: E402
from repro_torch.kernels import quotientfilter as qf  # noqa: E402
from repro_torch.kernels.sbf import DEFAULT_TILE  # noqa: E402


VP, LL, U32, I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                  ctypes.c_int)


def build_other(checkout: Path, name: str = "bloom") -> ctypes.CDLL:
    """The other checkout's ``csrc/<name>.cu``, built with this tree's
    flags."""
    src = checkout / f"src/repro_torch/kernels/csrc/{name}.cu"
    out = ROOT / "build" / f"{name}_ab_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    print(f"build: {src} in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(out))
    if name == "bloom":
        if hasattr(lib, "bloom_contains"):       # the one-thread interface
            lib.bloom_contains.argtypes = [VP, VP, VP, VP, LL, U32] + [
                I] * 7 + [VP]
            lib.bloom_add.argtypes = [VP, VP, VP, LL, U32] + [I] * 5 + [VP]
        lib.bloom_add_partitioned.argtypes = [VP, VP, VP, VP, LL, LL, U32,
                                              U32] + [I] * 6 + [VP]
    elif name == "ring":
        lib.ring_contains.argtypes = [VP, VP, VP, VP, LL, LL, I, U32] + [
            I] * 6 + [VP]
    elif name == "cbf":
        lib.cbf_add.argtypes = [VP, VP, VP, LL, I, I, VP]
        lib.cbf_contains.argtypes = [VP, VP, VP, VP, LL, I, I, VP]
    elif name == "counting":
        lib.counting_update_partitioned.argtypes = [VP, VP, VP, VP, LL, LL,
                                                    U32, U32, I, I, I, I, VP]
    elif name == "quotient":
        for fn in ("quotient_update", "quotient_merge", "quotient_resize"):
            getattr(lib, fn).argtypes = _build.ENTRY_POINTS[fn][1]
        lib.quotient_contains.argtypes = [VP, VP, VP, LL, I, I, I, U32, I,
                                          VP, VP, LL, VP, VP]
    else:
        lib.cuckoo_update.argtypes = _build.ENTRY_POINTS["cuckoo_update"][1]
        lib.cuckoo_contains.argtypes = [VP, VP, VP, LL, U32, I, I, I, U32,
                                        U32, VP]
    for fn in ("quotient_update", "quotient_merge", "quotient_resize",
               "quotient_contains", "cuckoo_update", "cuckoo_contains"):
        if hasattr(lib, fn):
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def gen_keys(n: int, seed: int, probe: bool = False) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 32, (n, 2), dtype=torch.int64, device="cuda",
                      generator=g)
    x[:, 0] = (x[:, 0] | (1 << 31)) if probe else (x[:, 0] & 0x7FFFFFFF)
    return H.to_i32(x).contiguous()


def turns(fns: dict, reps: int, rounds: int = 6) -> dict:
    """Median and range (ms a call) of each call, run in turns: each round
    runs them in order, then the next one reversed."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    per = {k: [] for k in fns}
    for r in range(rounds):
        for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[key]()
            end.record()
            torch.cuda.synchronize()
            per[key].append(start.elapsed_time(end) / reps)
    return {k: (sorted(v)[len(v) // 2], min(v), max(v))
            for k, v in per.items()}


def turns_restored(fns: dict, restore, rounds: int = 4) -> dict:
    """Like :func:`turns` for calls that change their state, one call
    each: ``restore()`` runs before every call, outside its events."""
    per = {k: [] for k in fns}
    for r in range(rounds):
        for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            restore()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[key]()
            end.record()
            torch.cuda.synchronize()
            per[key].append(start.elapsed_time(end))
    return {k: (sorted(v)[len(v) // 2], min(v), max(v))
            for k, v in per.items()}


def turns_queued(fns: dict, restore, reps: int, rounds: int = 6) -> dict:
    """Like :func:`turns_restored`, with ``reps`` calls a round queued
    back to back (each after its ``restore()``, outside its events), as a
    caller's loop issues them: a call's host work overlaps the card's work
    on the one before, as in ``chip_smoke.py``'s timings."""
    for fn in fns.values():
        restore()
        fn()
    torch.cuda.synchronize()
    per = {k: [] for k in fns}
    for r in range(rounds):
        for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
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
    return {k: (sorted(v)[len(v) // 2], min(v), max(v))
            for k, v in per.items()}


def show(label: str, res: dict) -> None:
    print(label + ": " + ", ".join(
        f"{k} {m:.4f} ms [{lo:.4f}-{hi:.4f}]" for k, (m, lo, hi) in
        res.items()), flush=True)


def cuckoo_main(checkout: Path) -> None:
    other = build_other(checkout, "cuckoo")
    stream = torch.cuda.current_stream().cuda_stream
    f = api.filter_for_n_items(1 << 22, bits_per_key=16, variant="cuckoo",
                               device="cuda")
    spec = f.spec
    keys1, keys2 = gen_keys(1 << 22, 91), gen_keys(3355443, 92)
    allkeys = torch.cat([keys1, keys2])
    sub = gen_keys(1 << 16, 94)

    def other_update(table, keys, op):
        n = keys.shape[0]
        flags = torch.empty(n, dtype=torch.bool, device="cuda")
        order = torch.empty((n, 4), dtype=torch.int32, device="cuda")
        stats = torch.empty(len(ckoo.STATS), dtype=torch.int64,
                            device="cuda")
        err = other.cuckoo_update(keys.data_ptr(), None, table.data_ptr(),
                                  flags.data_ptr(), order.data_ptr(),
                                  stats.data_ptr(), n, F.CUCKOO_ADD_TILE,
                                  ckoo.WINDOW, ckoo.STEP_CAP,
                                  *ckoo._geometry(spec), ckoo._OP_CODE[op],
                                  stream)
        assert err == 0, err
        return table, flags

    def this_update(table, keys, op):
        fn = ckoo.add_vmem if op == "add" else ckoo.remove_vmem
        return fn(spec, table, keys, None)

    empty = F.init(spec, "cuda")
    half_load = this_update(empty.clone(), keys1, "add")[0]
    full_load = this_update(half_load.clone(), keys2, "add")[0]
    scratch = empty.clone()
    for label, start, keys, op in (
            ("fresh add", empty, keys1, "add"),
            ("add 0.5 -> 0.9", half_load, keys2, "add"),
            ("remove", full_load, allkeys[: allkeys.shape[0] // 2],
             "remove"),
            ("add 2^16 at 0.9", full_load, sub, "add")):
        a, fa = other_update(start.clone(), keys, op)
        b, fb = this_update(start.clone(), keys, op)
        if not (torch.equal(a, b) and torch.equal(fa, fb)):
            raise AssertionError(f"cuckoo {label}: words or flags differ")
        res = turns_restored({
            "other": lambda k=keys, o=op: other_update(scratch, k, o),
            "this": lambda k=keys, o=op: this_update(scratch, k, o)},
            lambda s=start: scratch.copy_(s))
        name = "add_vmem" if op == "add" else "remove_vmem"
        show(f"cuckoo {label} ({keys.shape[0]} keys; words and flags equal)",
             res)
        counters = ckoo.LAST_UPDATE_STATS[name].read()
        print(f"  this tree's counters: {counters}; other / this "
              f"{res['other'][0] / res['this'][0]:.2f}x", flush=True)
    cuckoo_contains_turns(other, "L2", spec, full_load, allkeys, 20)
    del f, empty, half_load, full_load, scratch, keys1, keys2, allkeys
    torch.cuda.empty_cache()
    # the DRAM cell, as chip_smoke.py phase_cuckoo_dram builds it
    f = api.filter_for_n_items(1 << 27, bits_per_key=16, variant="cuckoo",
                               device="cuda")
    spec = f.spec
    keys = torch.cat([gen_keys(1 << 27, 191), gen_keys(
        int(spec.n_slots * 0.9) - (1 << 27), 192)])
    g = f.add(keys[: 1 << 27]).add(keys[1 << 27:])
    cuckoo_contains_turns(other, "DRAM", spec, g.words, keys, 3)


def cuckoo_contains_turns(other, label, spec, table, keys, reps) -> None:
    """The other's contains against this tree's, on every key and on 2^22
    probes: results checked equal first, then timed in turns, this tree's
    through its wrapper and, as the other's, its kernel through ctypes."""
    stream = torch.cuda.current_stream().cuda_stream

    def kernel(lib, k):
        out = torch.empty(k.shape[0], dtype=torch.bool, device="cuda")
        err = lib.cuckoo_contains(k.data_ptr(), table.data_ptr(),
                                  out.data_ptr(), k.shape[0],
                                  *ckoo._geometry(spec), stream)
        assert err == 0, err
        return out

    for what, k in (("every key", keys),
                    ("2^22 probes", gen_keys(1 << 22, 193, probe=True))):
        fns = {"other": lambda k=k: kernel(other, k),
               "this": lambda k=k: ckoo.contains_vmem(spec, table, k),
               "this kernel": lambda k=k: kernel(_build.library(), k)}
        want = fns["other"]()
        for key, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"cuckoo {label} contains {what}: "
                                     f"{key} differs")
        res = turns(fns, reps)
        show(f"cuckoo {label} contains {what} ({k.shape[0]} keys, "
             f"{spec.n_words * 4 >> 20} MiB; results equal)", res)
        print(f"  other / this {res['other'][0] / res['this'][0]:.2f}x, "
              f"other / this kernel "
              f"{res['other'][0] / res['this kernel'][0]:.2f}x", flush=True)


def cbf_main(checkout: Path) -> None:
    other = build_other(checkout, "cbf")
    stream = torch.cuda.current_stream().cuda_stream
    salts = sbf._salts(torch.device("cuda")).data_ptr()
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    for regime, n in (("L2", 1 << 23), ("DRAM", 1 << 28)):
        f = api.filter_for_n_items(n, bits_per_key=16, variant="cbf",
                                   device="cuda")
        spec = f.spec
        keys = gen_keys(n, 21)
        rule = cbf.choose_path(n, spec.m_bits, spec.k, smem)
        alt = "binned" if rule == "one-pass" else "one-pass"

        def other_add(words):
            err = other.cbf_add(keys.data_ptr(), words.data_ptr(), salts, n,
                                V._log2i(spec.m_bits), spec.k, stream)
            assert err == 0, err
            return words

        want = other_add(f.words.clone())
        for path in (None, alt):
            got = cbf.add_vmem(spec, f.words.clone(), keys, path=path)
            if not torch.equal(got, want):
                raise AssertionError(f"cbf {regime} add ({path or rule}) "
                                     f"differs from the other checkout's")
            if path is None:
                plan = dict(cbf.LAST_ADD_PLAN)
            del got
        acc = want
        res = turns({
            "other": lambda: other_add(acc),
            f"this ({rule})": lambda: cbf.add_vmem(spec, acc, keys),
            f"this {alt}": lambda: cbf.add_vmem(spec, acc, keys, path=alt)},
            20 if regime == "L2" else 3)
        show(f"cbf {regime} add ({spec}, {n} keys; words equal; the rule's "
             f"plan {plan})", res)
        print(f"  other / this {res['other'][0] / res[f'this ({rule})'][0]:.2f}"
              f"x", flush=True)
        words = want
        probes = gen_keys(1 << 22, 22, probe=True)
        for label, q in (("keys", keys), ("2^22 probes", probes)):
            rule = cbf.choose_contains_path(q.shape[0], spec.m_bits, spec.k,
                                            smem)
            alt = "binned" if rule == "one-pass" else "one-pass"

            def other_contains(q=q):
                out = torch.empty(q.shape[0], dtype=torch.bool,
                                  device="cuda")
                err = other.cbf_contains(q.data_ptr(), words.data_ptr(),
                                         out.data_ptr(), salts, q.shape[0],
                                         V._log2i(spec.m_bits), spec.k,
                                         stream)
                assert err == 0, err
                return out

            want_hits = other_contains()
            for path in (None, alt):
                if not torch.equal(cbf.contains_vmem(spec, words, q,
                                                     path=path), want_hits):
                    raise AssertionError(f"cbf {regime} contains "
                                         f"({path or rule}) differs")
                if path is None:
                    plan = dict(cbf.LAST_CONTAINS_PLAN)
            res = turns({
                "other": other_contains,
                f"this ({rule})": lambda q=q: cbf.contains_vmem(spec, words,
                                                                q),
                f"this {alt}": lambda q=q, a=alt: cbf.contains_vmem(
                    spec, words, q, path=a)},
                20 if regime == "L2" or q is probes else 3)
            show(f"cbf {regime} contains of {q.shape[0]} {label} ({spec}; "
                 f"results equal; the rule's plan {plan})", res)
            print(f"  other / this "
                  f"{res['other'][0] / res[f'this ({rule})'][0]:.2f}x",
                  flush=True)
        del f, keys, want, acc, words, probes
        torch.cuda.empty_cache()


def partitioned_add_main(checkout: Path) -> None:
    """The sbf partitioned add of the other checkout against this tree's,
    on its rule's path and on the other path, in the two sbf cells."""
    other = build_other(checkout, "bloom")
    stream = torch.cuda.current_stream().cuda_stream
    salts = sbf._salts(torch.device("cuda")).data_ptr()
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    for regime, n, batch in (("L2", 1 << 23, 1 << 23),
                             ("DRAM", 1 << 28, 1 << 24)):
        f = api.filter_for_n_items(n, bits_per_key=16, block_bits=256,
                                   device="cuda")
        spec = f.spec
        first = gen_keys(n, 82)[:batch]
        fit = 1
        while spec.n_words * 4 // fit > smem:
            fit *= 2
        for n_seg in (8, fit, 2 * fit, 4 * fit, 8 * fit, 16 * fit):
            part = ops._partition_device(spec, first, n_seg, None)
            seg_words = spec.n_words // n_seg
            shared = int(seg_words * 4 <= smem)

            def other_add(words, part=part, n_seg=n_seg,
                          seg_words=seg_words, shared=shared):
                err = other.bloom_add_partitioned(
                    part.keys_by_seg.data_ptr(), part.valid.data_ptr(),
                    words.data_ptr(), salts, n_seg, part.keys_by_seg.shape[1],
                    seg_words, spec.n_blocks - 1, spec.s, 0, spec.k, spec.z,
                    0, shared, stream)
                assert err == 0, err
                return words

            def this_add(words, path=None, part=part, n_seg=n_seg):
                return sbf.add_partitioned(spec, words, part.keys_by_seg,
                                           part.valid, n_seg,
                                           l2_resident=regime == "L2",
                                           path=path)

            want = other_add(V.init(spec, "cuda"))
            got = this_add(V.init(spec, "cuda"))
            plan = dict(sbf.LAST_PARTITIONED_PLAN)
            alt = "global" if plan["path"] == "shared" else "shared"
            lib = _build.library()

            def this_kernel(words, part=part, n_seg=n_seg,
                            seg_words=seg_words, plan=plan):
                err = lib.bloom_add_partitioned(
                    part.keys_by_seg.data_ptr(), part.valid.data_ptr(),
                    words.data_ptr(), salts, n_seg, part.keys_by_seg.shape[1],
                    seg_words, spec.n_blocks - 1, spec.s, plan["theta"], 0,
                    spec.k, spec.z, 0, int(plan["path"] == "shared"),
                    stream)
                assert err == 0, err
                return words

            if not torch.equal(this_kernel(V.init(spec, "cuda")), want):
                raise AssertionError(f"partitioned sbf {regime} n_segments "
                                     f"{n_seg}: this kernel's words differ")
            fns = {"other": lambda: other_add(scratch),
                   f"this ({plan['path']})": lambda: this_add(scratch),
                   f"this {plan['path']} kernel": lambda: this_kernel(
                       scratch)}
            if alt == "global" or shared:
                if not torch.equal(this_add(V.init(spec, "cuda"), alt),
                                   want):
                    raise AssertionError(f"partitioned sbf {regime} "
                                         f"n_segments {n_seg} {alt} differs")
                fns[f"this {alt}"] = lambda: this_add(scratch, alt)
            if not torch.equal(got, want):
                raise AssertionError(f"partitioned sbf {regime} n_segments "
                                     f"{n_seg}: words differ")
            scratch = V.init(spec, "cuda")
            res = turns_restored(fns, scratch.zero_, rounds=10)
            show(f"partitioned sbf {regime} add of {batch} keys, n_segments "
                 f"{n_seg} (other {'shared' if shared else 'global'}; this "
                 f"tree's plan {plan}; words equal)", res)
            mine = res[f"this ({plan['path']})"][0]
            kern = res[f"this {plan['path']} kernel"][0]
            print(f"  other / this {res['other'][0] / mine:.2f}x; kernels "
                  f"through ctypes, other / this "
                  f"{res['other'][0] / kern:.2f}x", flush=True)
            del part, want, got, scratch
        del f, first
        torch.cuda.empty_cache()


def ring_main(checkout: Path) -> None:
    """The windowed ring contains of the other checkout (one thread a key)
    against this tree's wrappers, in the two windowed cells."""
    other = build_other(checkout, "ring")
    stream = torch.cuda.current_stream().cuda_stream
    salts = sbf._salts(torch.device("cuda")).data_ptr()
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    for regime, window in (("L2", 1 << 22), ("DRAM", 1 << 26)):
        G = 4
        f = api.filter_for_n_items(window, bits_per_key=16, block_bits=256,
                                   generations=G, device="cuda")
        spec = f.spec
        batches = [gen_keys(window // G, 31 + i) for i in range(G + 1)]
        for i, b in enumerate(batches):
            f = f.add(b)
            if i < G:
                f = f.advance()
        rings = f.words
        wrapper = (ring.ring_contains_vmem if regime == "L2"
                   else ring.ring_contains_hbm)
        depth = 1 if regime == "L2" else ops._resolve_depth(
            spec, "contains", None, DEFAULT_TILE, device=rings.device)
        kw = {} if regime == "L2" else {"depth": depth}
        args = (spec.n_blocks - 1, spec.s)
        for label, q in (("live keys", torch.cat(batches[1:])),
                         ("retired keys", batches[0]),
                         ("fresh probes", gen_keys(window, 40, probe=True))):
            n = q.shape[0]
            out = torch.empty(n, dtype=torch.bool, device="cuda")

            def other_contains(d, q=q, out=out, n=n):
                err = other.ring_contains(q.data_ptr(), rings.data_ptr(),
                                          out.data_ptr(), salts, n,
                                          spec.n_words, G, *args, min(d, 4),
                                          0, spec.k, spec.z, 0, stream)
                assert err == 0, err
                return out

            want = other_contains(depth).clone()
            rule = ring.choose_contains_path(n, spec.n_words, G, spec.s,
                                             smem, regime == "L2")
            geo = ring.contains_geometry(spec)
            lib = _build.library()

            def this_kernel(q=q, out=out, n=n, geo=geo):
                err = lib.ring_contains(q.data_ptr(), rings.data_ptr(),
                                        out.data_ptr(), salts, n,
                                        spec.n_words, G, *args, geo.theta,
                                        0, spec.k, spec.z, 0, stream)
                assert err == 0, err
                return out

            fns = {f"other d{min(depth, 4)}": lambda: other_contains(depth),
                   "other d1": lambda: other_contains(1),
                   f"this ({rule})": lambda q=q: wrapper(spec, rings, q,
                                                         **kw),
                   "this one-pass": lambda q=q: wrapper(
                       spec, rings, q, path="one-pass", **kw),
                   "this binned": lambda q=q: wrapper(spec, rings, q,
                                                      path="binned", **kw),
                   "this one-pass kernel": this_kernel}
            for name, fn in fns.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"ring {regime} {label}: {name} "
                                         f"differs")
            wrapper(spec, rings, q, **kw)
            plan = dict(ring.LAST_CONTAINS_PLAN)
            res = turns(fns, 20 if regime == "L2" else 3)
            show(f"ring {regime} contains of {n} {label} ({G} x {spec}; "
                 f"results equal; the rule's plan {plan})", res)
            mine = res[f"this ({rule})"][0]
            print(f"  other d{min(depth, 4)} / this "
                  f"{res[f'other d{min(depth, 4)}'][0] / mine:.2f}x, "
                  f"other d1 / this {res['other d1'][0] / mine:.2f}x",
                  flush=True)
            del out, want
        del f, batches, rings
        torch.cuda.empty_cache()


def partitioned_main(checkout: Path) -> None:
    partitioned_add_main(checkout)
    other = build_other(checkout, "counting")
    stream = torch.cuda.current_stream().cuda_stream
    salts = sbf._salts(torch.device("cuda")).data_ptr()
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    for regime, n, batch in (("L2", 1 << 22, 1 << 22),
                             ("DRAM", 1 << 26, 1 << 24)):
        f = api.filter_for_n_items(n, bits_per_key=16, variant="countingbf",
                                   block_bits=256, device="cuda")
        spec = f.spec
        first = gen_keys(n, 81)[:batch]
        fit = 1
        while spec.storage_words * 4 // fit > smem:
            fit *= 2
        for n_seg in (8, fit, 2 * fit, 4 * fit, 8 * fit, 16 * fit):
            part = ops._partition_device(spec, first, n_seg, None)
            seg_cwords = spec.storage_words // n_seg
            shared = int(seg_cwords * 4 <= smem)

            def other_update(words, op, part=part, n_seg=n_seg,
                             seg_cwords=seg_cwords, shared=shared):
                err = other.counting_update_partitioned(
                    part.keys_by_seg.data_ptr(), part.valid.data_ptr(),
                    words.data_ptr(), salts, n_seg, part.keys_by_seg.shape[1],
                    seg_cwords, spec.n_blocks - 1, spec.s, spec.k,
                    cnt._OP_CODE[op], shared, stream)
                assert err == 0, err
                return words

            def this_update(words, op, part=part, n_seg=n_seg):
                return cnt.update_partitioned(spec, words, part.keys_by_seg,
                                              part.valid, n_seg, op)

            added = this_update(V.init(spec, "cuda"), "add")
            plan = dict(cnt.LAST_PARTITIONED_PLAN)
            removed = this_update(added.clone(), "remove")
            if not (torch.equal(other_update(V.init(spec, "cuda"), "add"),
                                added)
                    and torch.equal(other_update(added.clone(), "remove"),
                                    removed)):
                raise AssertionError(f"partitioned {regime} n_segments "
                                     f"{n_seg}: counters differ")
            scratch = added.clone()
            for op, start in (("add", V.init(spec, "cuda")),
                              ("remove", added)):
                res = turns_restored({
                    "other": lambda op=op: other_update(scratch, op),
                    "this": lambda op=op: this_update(scratch, op)},
                    lambda s=start: scratch.copy_(s), rounds=10)
                show(f"partitioned countingbf {regime} {op} of {batch} keys, "
                     f"n_segments {n_seg} (other "
                     f"{'shared' if shared else 'global'}, this "
                     f"{plan['path']}; counters equal)", res)
                print(f"  other / this "
                      f"{res['other'][0] / res['this'][0]:.2f}x", flush=True)
            del part, added, removed, scratch
        del f, first
        torch.cuda.empty_cache()


def counting_main(checkout: Path) -> None:
    """The counting update and contains of the other checkout (one thread a
    key: ``counting_update``, ``counting_contains`` and their bank forms)
    against this tree's wrappers, in both countingbf cells and both bank
    cells."""
    other = build_other(checkout, "counting")
    other.counting_update.argtypes = [VP, VP, VP, VP, LL, U32, I, I, I, VP]
    other.counting_contains.argtypes = [VP, VP, VP, VP, LL, U32, I, I, I, I,
                                        VP]
    other.counting_bank_update.argtypes = [VP, VP, VP, VP, VP, LL,
                                           ctypes.c_ulonglong, U32, I, I, I,
                                           VP]
    other.counting_bank_contains.argtypes = [VP, VP, VP, VP, VP, LL,
                                             ctypes.c_ulonglong, U32, I, I,
                                             I, I, VP]
    stream = torch.cuda.current_stream().cuda_stream
    salts = sbf._salts(torch.device("cuda")).data_ptr()
    for label, n_per, n, bank in (("L2", 1 << 22, 1 << 22, 0),
                                  ("DRAM", 1 << 26, 1 << 26, 0),
                                  ("bank L2", 1 << 12, 1 << 22, 1024),
                                  ("bank L2 skewed", 1 << 12, 1 << 22, 1024),
                                  ("bank DRAM", 1 << 16, 1 << 26, 1024),
                                  ("bank DRAM skewed", 1 << 16, 1 << 26,
                                   1024)):
        f = api.filter_for_n_items(n_per, bits_per_key=16,
                                   variant="countingbf", block_bits=256,
                                   device="cuda", bank=bank or None)
        spec = f.spec
        keys = gen_keys(n, 11)
        member = None
        if bank:                            # chip_smoke.gen_members' ids
            gen = torch.Generator(device="cuda").manual_seed(52)
            member = torch.randint(0, bank, (n,), dtype=torch.int32,
                                   device="cuda", generator=gen)
            if "skewed" in label:
                member[torch.rand(n, device="cuda", generator=gen) < 0.5] = 0
        half = n // 2
        l2 = "L2" in label
        # the other wrappers' schedules: L2 phi 4 at depth 1, DRAM phi 4 at
        # min(depth, 64 // s)

        def other_update(words, op, nk):
            if bank:
                err = other.counting_bank_update(
                    keys.data_ptr(), member.data_ptr(), None,
                    words.data_ptr(), salts, nk, spec.storage_words,
                    spec.n_blocks - 1, spec.s, spec.k, cnt._OP_CODE[op],
                    stream)
            else:
                err = other.counting_update(
                    keys.data_ptr(), None, words.data_ptr(), salts, nk,
                    spec.n_blocks - 1, spec.s, spec.k, cnt._OP_CODE[op],
                    stream)
            assert err == 0, err
            return words

        # this tree's bank calls without the wrapper's member range check
        # (a host sync), as the other's are called
        def this_update(words, op, nk, path=None):
            if bank:
                return cnt._launch_update("bank_update_vmem", spec, words,
                                          keys[:nk], None, op, member[:nk],
                                          path=path)
            fn = cnt.update_vmem if l2 else cnt.update_hbm
            return fn(spec, words, keys[:nk], None, op, path=path)

        def other_contains(words, depth):
            out = torch.empty(n, dtype=torch.bool, device="cuda")
            d = min(depth, max(1, 64 // spec.s))
            if bank:
                err = other.counting_bank_contains(
                    keys.data_ptr(), member.data_ptr(), words.data_ptr(),
                    out.data_ptr(), salts, n, spec.storage_words,
                    spec.n_blocks - 1, spec.s, 4, d, spec.k, stream)
            else:
                err = other.counting_contains(
                    keys.data_ptr(), words.data_ptr(), out.data_ptr(), salts,
                    n, spec.n_blocks - 1, spec.s, 4, d, spec.k, stream)
            assert err == 0, err
            return out

        def this_contains(words, depth):
            if bank:
                return cnt._launch_contains(
                    "bank_contains_vmem", spec, words, keys,
                    cnt.contains_geometry(spec, cnt.card_layout(spec), depth),
                    member)
            if l2 and depth == 1:
                return cnt.contains_vmem(spec, words, keys)
            return cnt.contains_hbm(spec, words, keys, depth=depth)

        empty = torch.zeros_like(f.words)
        added = this_update(empty.clone(), "add", n)
        plan = dict(cnt.LAST_UPDATE_PLAN["bank_update_vmem" if bank else
                                         ("update_vmem" if l2
                                          else "update_hbm")])
        removed = this_update(added.clone(), "remove", half)
        if not (torch.equal(other_update(empty.clone(), "add", n), added)
                and torch.equal(other_update(added.clone(), "remove", half),
                                removed)):
            raise AssertionError(f"counting {label}: counters differ")
        for path in cnt.UPDATE_PATHS:
            got = this_update(empty.clone(), "add", n, path)
            if not (torch.equal(got, added) and torch.equal(
                    this_update(got, "remove", half, path), removed)):
                raise AssertionError(f"counting {label}: this tree's {path} "
                                     f"counters differ")
        del got
        scratch = added.clone()
        for op, start, nk in (("add", empty, n), ("remove", added, half)):
            fns = {"other": lambda op=op, nk=nk: other_update(scratch, op,
                                                              nk),
                   "this": lambda op=op, nk=nk: this_update(scratch, op, nk)}
            for path in cnt.UPDATE_PATHS:
                fns[f"this {path}"] = (lambda op=op, nk=nk, path=path:
                                       this_update(scratch, op, nk, path))
            res = turns_queued(fns, lambda s=start: scratch.copy_(s),
                               reps=10 if l2 else 3)
            show(f"counting {label} {op} of {nk} keys (this: {plan['path']};"
                 f" counters equal)", res)
            print(f"  other / this {res['other'][0] / res['this'][0]:.2f}x",
                  flush=True)
        for depth in (1, 8):
            if not torch.equal(other_contains(added, depth),
                               this_contains(added, depth)):
                raise AssertionError(f"counting {label} contains: results "
                                     f"differ")
            res = turns({"other": lambda d=depth: other_contains(added, d),
                         "this": lambda d=depth: this_contains(added, d)},
                        reps=20 if l2 else 5)
            geo = cnt.LAST_GEOMETRY["bank_contains_vmem" if bank else
                                    ("contains_vmem" if l2 and depth == 1
                                     else "contains_hbm")]
            show(f"counting {label} contains of {n} keys at depth {depth} "
                 f"(this: {geo}; results equal)", res)
            print(f"  other / this {res['other'][0] / res['this'][0]:.2f}x",
                  flush=True)
        del f, keys, member, empty, added, removed, scratch
        torch.cuda.empty_cache()


class OtherQuotient:
    """The other checkout's quotient update, merge, resize and contains,
    called as its wrappers called them (workspace and scratch allocated
    each call)."""

    def __init__(self, lib, stream):
        self.lib, self.stream = lib, stream

    def update(self, spec, table, keys, op):
        n = keys.shape[0]
        flags = torch.empty(n, dtype=torch.bool, device="cuda")
        plan = qf.update_plan(spec, n, op)
        work = torch.empty(plan["workspace_bytes"], dtype=torch.uint8,
                           device="cuda")
        for first in range(0, n, qf.KEY_BATCH):
            nb = min(qf.KEY_BATCH, n - first)
            err = self.lib.quotient_update(
                keys[first:].data_ptr(), None, table.data_ptr(),
                flags[first:].data_ptr(), nb, *qf._geometry(spec),
                qf._OP_CODE[op], work.data_ptr(), plan["workspace_bytes"],
                qf.TILE_SLOTS, qf.MERGE_TILE, plan["bin_bits"], qf.BIN_CAP,
                0, self.stream)
            assert err == 0, err
        return table, flags

    def merge(self, spec, a, b):
        plan = qf.update_plan(spec, 0, "merge")
        out = torch.empty_like(a)
        work = torch.empty(plan["workspace_bytes"], dtype=torch.uint8,
                           device="cuda")
        err = self.lib.quotient_merge(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), spec.q_bits,
            spec.r_bits, spec.slot_bits, work.data_ptr(),
            plan["workspace_bytes"], qf.TILE_SLOTS, qf.MERGE_TILE,
            self.stream)
        assert err == 0, err
        return out

    def resize(self, spec, table, new_spec):
        plan = qf.update_plan(spec, 0, "resize", new_spec=new_spec)
        out = Q.init(new_spec, "cuda")
        work = torch.empty(plan["workspace_bytes"], dtype=torch.uint8,
                           device="cuda")
        err = self.lib.quotient_resize(
            table.data_ptr(), out.data_ptr(), spec.q_bits, spec.r_bits,
            new_spec.q_bits, new_spec.r_bits, spec.slot_bits,
            work.data_ptr(), plan["workspace_bytes"], qf.TILE_SLOTS,
            qf.MERGE_TILE, self.stream)
        assert err == 0, err
        return out

    def contains(self, spec, table, keys):
        """The other wrapper's contains: the walk below n_slots / 16 keys,
        else the card's choice between the walk and the table pass."""
        n = keys.shape[0]
        mode = 2 if n * 16 >= spec.n_slots else 0
        out = torch.empty(n, dtype=torch.bool, device="cuda")
        n_aggs = max(-(-spec.n_slots // 4096), 1)
        ws = torch.empty(3 * spec.n_slots, dtype=torch.int32, device="cuda")
        aggs = torch.empty(n_aggs, dtype=torch.int64, device="cuda")
        scal = torch.empty(8, dtype=torch.int64, device="cuda")
        err = self.lib.quotient_contains(
            keys.data_ptr(), table.data_ptr(), out.data_ptr(), n,
            *qf._geometry(spec), mode, ws.data_ptr(), aggs.data_ptr(),
            n_aggs, scal.data_ptr(), self.stream)
        assert err == 0, err
        return out


def quotient_main(checkout: Path) -> None:
    other = OtherQuotient(build_other(checkout, "quotient"),
                          torch.cuda.current_stream().cuda_stream)
    # this tree's update kernels called as the other's are (the same C
    # interface): the wrapper's own host work is not in their times
    mine = OtherQuotient(_build.library(),
                         torch.cuda.current_stream().cuda_stream)
    for label, n, batch in (("L2", 1 << 22, 1 << 22),
                            ("DRAM", 1 << 25, 1 << 24)):
        f = api.filter_for_n_items(n, variant="quotient", device="cuda")
        spec = f.spec
        n1, n_all = spec.n_slots // 2, int(spec.n_slots * 0.9)
        keys = gen_keys(n_all, 820 + spec.q_bits)
        chunks = list(keys[:n1].split(batch)) + list(keys[n1:].split(batch))
        empty = Q.init(spec, "cuda")
        table = empty.clone()
        for chunk in chunks[:-1]:
            qf.add_vmem(spec, table, chunk, None)
        before_last = table.clone()
        full = qf.add_vmem(spec, table, chunks[-1], None)[0]
        half = n_all // 2
        a = qf.add_vmem(spec, empty.clone(), keys[:half], None)[0]
        b = qf.add_vmem(spec, empty.clone(), keys[half:], None)[0]
        grown = Q.spec_for_resize(spec, 2 * spec.m_bits)
        gone = keys[:half].split(batch)[0]
        scratch = empty.clone()
        for what, start, ks, op in (
                ("add first", empty, chunks[0], "add"),
                ("add last", before_last, chunks[-1], "add"),
                ("remove", full, gone, "remove"),
                ("add 2^22", empty, keys[: 1 << 22], "add")):
            x, fx = other.update(spec, start.clone(), ks, op)
            fn = qf.add_vmem if op == "add" else qf.remove_vmem
            y, fy = fn(spec, start.clone(), ks, None)
            if not (torch.equal(x, y) and torch.equal(fx, fy)):
                raise AssertionError(f"quotient {label} {what}: words or "
                                     f"flags differ")
            del x, fx, y, fy
            res = turns_restored({
                "other": lambda k=ks, o=op: other.update(spec, scratch, k, o),
                "this": lambda k=ks, f=fn: f(spec, scratch, k, None),
                "this (ctypes)": lambda k=ks, o=op: mine.update(
                    spec, scratch, k, o)},
                lambda s=start: scratch.copy_(s), rounds=6)
            show(f"quotient {label} {what} ({spec}, {ks.shape[0]} keys; "
                 f"words and flags equal)", res)
            print(f"  other / this {res['other'][0] / res['this'][0]:.2f}x",
                  flush=True)
        if not (torch.equal(other.merge(spec, a, b), qf.merge_vmem(spec, a, b))
                and torch.equal(other.resize(spec, full, grown),
                                qf.resize_vmem(spec, full, grown))):
            raise AssertionError(f"quotient {label}: merge or resize differ")
        for what, fns in (
                ("merge", {"other": lambda: other.merge(spec, a, b),
                           "this": lambda: qf.merge_vmem(spec, a, b)}),
                ("resize up", {
                    "other": lambda: other.resize(spec, full, grown),
                    "this": lambda: qf.resize_vmem(spec, full, grown)})):
            res = turns(fns, 3)
            show(f"quotient {label} {what} ({spec}; words equal)", res)
            print(f"  other / this {res['other'][0] / res['this'][0]:.2f}x",
                  flush=True)
        sub = torch.cat([keys[: 1 << 21], gen_keys(1 << 21, 830,
                                                   probe=True)])
        for what, k in (("every key", keys), ("2^22 keys", sub)):
            fns = {"other": lambda k=k: other.contains(spec, full, k),
                   "this": lambda k=k: qf.contains_vmem(spec, full, k),
                   **{f"this {m}": (lambda k=k, m=m: qf._launch_contains(
                       spec, full, k, m)) for m in qf.CONTAINS_PATHS}}
            want = fns["other"]()
            for key, fn in fns.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"quotient {label} contains {what}:"
                                         f" {key} differs")
            res = turns(fns, 20 if label == "L2" else 5)
            show(f"quotient {label} contains {what} ({k.shape[0]} keys at "
                 f"load 0.9; results equal; this tree's rule: "
                 f"{qf.LAST_CONTAINS_PLAN['path']} at the sampled load "
                 f"{qf.LAST_CONTAINS_PLAN['load']})", res)
            print(f"  other / this {res['other'][0] / res['this'][0]:.2f}x",
                  flush=True)
        del f, keys, chunks, empty, table, before_last, full, a, b, scratch
        torch.cuda.empty_cache()


def main(checkout: Path, only: str = "") -> int:
    if not torch.cuda.is_available():
        print("bloom_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.library()
    for name, run in (("cuckoo", cuckoo_main), ("bloom", bloom_main),
                      ("cbf", cbf_main), ("quotient", quotient_main),
                      ("partitioned", partitioned_main),
                      ("counting", counting_main), ("ring", ring_main)):
        if only in ("", name):
            run(checkout)
    return 0


def bloom_main(checkout: Path) -> None:
    other = build_other(checkout)
    stream = torch.cuda.current_stream().cuda_stream
    salts = sbf._salts(torch.device("cuda")).data_ptr()

    for regime, n in (("L2", 1 << 23), ("DRAM", 1 << 28)):
        f = api.filter_for_n_items(n, bits_per_key=16, variant="sbf",
                                   block_bits=256, device="cuda")
        spec = f.spec
        args = (spec.n_blocks - 1, spec.s, 0, spec.k, spec.z, 0)
        add_name, con_name = (("add_vmem", "contains_vmem") if regime == "L2"
                              else ("add_hbm", "contains_hbm"))
        keys = gen_keys(n, 1)
        probes = gen_keys(n, 2, probe=True)
        out = torch.empty(n, dtype=torch.bool, device="cuda")

        def other_add(words):
            err = other.bloom_add(keys.data_ptr(), words.data_ptr(), salts,
                                  n, args[0], *args[1:], stream)
            assert err == 0, err
            return words

        def other_contains(words, q, depth):
            err = other.bloom_contains(q.data_ptr(), words.data_ptr(),
                                       out.data_ptr(), salts, n, args[0],
                                       spec.s, sbf.MAX_VEC, depth, *args[2:],
                                       stream)
            assert err == 0, err
            return out

        def ours(op, theta, depth=1):
            layout = (sbf.card_layout(spec, op) if theta is None
                      else sbf.Layout(theta, 1 if op == "add"
                                      else sbf.MAX_VEC))
            return sbf.launch_geometry(spec, op, layout, depth)

        rule = {op: ours(op, None).theta for op in ("add", "contains")}
        words = other_add(f.words.clone())
        for theta in (1, rule["add"]):
            got = sbf._launch_add(add_name, spec, f.words.clone(), keys,
                                  ours("add", theta))
            if not torch.equal(got, words):
                raise AssertionError(f"{regime} add Θ={theta} differs")
        depths = (1,) if regime == "L2" else (1, 2, 8)
        for q in (keys, probes):
            for d in depths:
                want = other_contains(words, q, d).clone()
                for theta in (1, rule["contains"]):
                    got = sbf._launch_contains(con_name, spec, words, q,
                                               ours("contains", theta, d))
                    if not torch.equal(got, want):
                        raise AssertionError(f"{regime} contains Θ={theta} "
                                             f"depth {d} differs")
        print(f"{regime}: {spec}, {n} keys: words and results of the other "
              f"checkout, Θ = 1 and card_layout's Θ equal", flush=True)

        reps = 20 if regime == "L2" else 4
        acc = words.clone()
        show(f"{regime} add", turns({
            "other": lambda: other_add(acc),
            "theta=1": lambda: sbf._launch_add(add_name, spec, acc, keys,
                                               ours("add", 1)),
            f"theta={rule['add']}": lambda: sbf._launch_add(
                add_name, spec, acc, keys, ours("add", None))}, reps))
        fns = {}
        for d in depths:
            fns[f"other d{d}"] = (lambda d=d: other_contains(words, keys, d))
            for theta in (1, rule["contains"]):
                geo = ours("contains", theta, d)
                fns[f"theta={theta} d{geo.depth}"] = (
                    lambda geo=geo: sbf._launch_contains(con_name, spec,
                                                         words, keys, geo))
        show(f"{regime} contains", turns(fns, reps))
        d = 1 if regime == "L2" else ops._resolve_depth(
            spec, "contains", None, DEFAULT_TILE, device=keys.device)
        show(f"{regime} probes (depth {d})", turns({
            "other": lambda: other_contains(words, probes, d),
            "theta=1": lambda: sbf._launch_contains(
                con_name, spec, words, probes, ours("contains", 1, d)),
            f"theta={rule['contains']}": lambda: sbf._launch_contains(
                con_name, spec, words, probes, ours("contains", None, d))},
            reps))
        del f, keys, probes, out, words, acc
        torch.cuda.empty_cache()


if __name__ == "__main__":
    args = sys.argv[1:]
    only = ""
    if len(args) == 3 and args[1] == "--only" and args[2] in (
            "bloom", "cuckoo", "cbf", "quotient", "partitioned",
            "counting", "ring"):
        only = args[2]
        args = args[:1]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(Path(args[0]), only))
