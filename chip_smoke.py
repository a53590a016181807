#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without printing a result:

1. device: the card's name and power limit (``nvidia-smi``), and the count;
2. build: compile ``src/repro_torch/kernels/csrc/bloom.cu`` and time it;
3. every kernel wrapper against its plain PyTorch version on the card, at
   m = 2^20 bits and 65537 keys, for six blocked specs and every value of
   the schedule axes; words and results must be equal bit for bit, and the
   FPR measured on 2^20 probes must lie within 0.5-2.0x theory;
4. the main path, ``repro_torch.api.filter_for_n_items(...)`` then
   ``Filter.add`` / ``Filter.contains``, at an L2-resident size (2^23 keys,
   2^27 bits) and a DRAM-resident size (2^28 keys, 2^32 bits): no false
   negatives, an FPR on 2^22 probes equal to the plain version's (its ratio
   to theory is printed), kernel words equal to the plain version's on a
   2^22-key subset into an empty full-size filter, and every wrapper of the
   regime launched during the main path;
5. times with CUDA events (warm-up, then 20 repetitions), printed with the
   card's name and power limit, and one JSON line with a record per kernel.

The last line is ``{"ok": true, "device": {...}}``. Needs one CUDA card; the
script exits non-zero where there is none, or where the repository's
``src/`` is missing beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import variants as V  # noqa: E402
from repro_torch.kernels import _build, sbf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12              # non-tensor peak (fp32 rate, the guide's table)
REPS = 20                      # calls per timing round
ROUNDS = 5                     # timing rounds; the median is reported
SUBSET = 1 << 22               # keys of the kernel-vs-plain comparison
SOURCE = "src/repro_torch/kernels/csrc/bloom.cu"
REPLACES = {"contains_vmem": "src/repro/kernels/sbf.py:311",
            "add_vmem": "src/repro/kernels/sbf.py:348",
            "contains_hbm": "src/repro/kernels/sbf.py:503",
            "add_hbm": "src/repro/kernels/sbf.py:537"}

PHASE3_SPECS = [
    V.FilterSpec("sbf", 1 << 20, 16, block_bits=256),
    V.FilterSpec("sbf", 1 << 20, 16, block_bits=512),
    V.FilterSpec("sbf", 1 << 20, 32, block_bits=1024),
    V.FilterSpec("bbf", 1 << 20, 8, block_bits=256),
    V.FilterSpec("rbbf", 1 << 20, 4),
    V.FilterSpec("csbf", 1 << 20, 8, block_bits=512, z=2),
]


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


def bound_ms(spec: V.FilterSpec, n: int, op: str):
    """Least time for the work: max(bytes / memory rate, ops / peak rate).
    Bytes: 8 per key, 1 per result (contains), and min(m/8, B/8 per key) of
    filter read, written again for add."""
    filt = min(spec.m_bits // 8, spec.block_bits // 8 * n)
    nbytes = 8 * n + (n + filt if op == "contains" else 2 * filt)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops_per_key(spec, op) / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    _build.library()
    print(f"build: {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    spills = [ln for ln in _build.build_log().splitlines()
              if "spill" in ln and not ln.strip().startswith("ptxas info    : "
                                                             "Function")]
    n_spill = sum(1 for ln in spills if " 0 bytes spill stores" not in ln)
    print(f"build: {len(spills)} kernel instances, {n_spill} with spills")
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
        if i == 0:                                    # ragged tails
            for m in (1, 255, 257):
                w = sbf.add_plain(spec, V.init(spec, "cuda"), keys[:m])
                got = sbf.add_vmem(spec, V.init(spec, "cuda"), keys[:m],
                                   sbf.default_layout(spec, "add"))
                errs["add_vmem"] = max(errs["add_vmem"], max_err(got, w))
                got = sbf.add_hbm(spec, V.init(spec, "cuda"), keys[:m])
                errs["add_hbm"] = max(errs["add_hbm"], max_err(got, w))
                c = sbf.contains_plain(spec, w, queries[:m])
                got = sbf.contains_vmem(spec, w, queries[:m], lay)
                errs["contains_vmem"] = max(errs["contains_vmem"],
                                            max_err(got, c))
                got = sbf.contains_hbm(spec, w, queries[:m])
                errs["contains_hbm"] = max(errs["contains_hbm"],
                                           max_err(got, c))
                runs += 4
        fpr = float(sbf.contains_vmem(
            spec, want_words, gen_keys(1 << 20, 300 + i, probe=True), lay
        ).to(torch.float64).mean().item())
        theory = V.fpr_theory(spec, n)
        if not 0.5 * theory <= fpr <= 2.0 * theory:
            raise AssertionError(f"{spec}: FPR {fpr} outside 0.5-2.0 x "
                                 f"theory {theory}")
        torch.cuda.synchronize()
        print(f"kernels: {spec}: {runs} kernel runs equal to the plain "
              f"version ({n} keys, {n} probes); FPR {fpr:.6f} = "
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
    # The measured FPR must be the plain version's on the same probes. Its
    # ratio to theory is printed, not bounded: at this load the reference's
    # two xxh32 streams are dependent and the FPR exceeds theory (PERF.md).
    fpr = float(false_pos.to(torch.float64).mean().item())
    fpr_plain = float(sbf.contains_plain(spec, g.words, probes)
                      .to(torch.float64).mean().item())
    if fpr != fpr_plain:
        raise AssertionError(f"{regime}: FPR {fpr} != plain {fpr_plain}")
    theory = g.fpr_theory(n)
    print(f"main {regime}: {spec} on {g.backend}, {n} keys, "
          f"{g.nbytes / 2**20:.0f} MiB filter: add+contains+probe "
          f"{wall * 1e3:.1f} ms host clock, no false negatives, FPR "
          f"{fpr:.6f} = plain, {fpr / theory:.3f} x theory {theory:.6f}, "
          f"launches {counted}")

    # kernel against the plain version on a subset, full-size filter
    sub = keys[:SUBSET]
    lay_add = sbf.default_layout(spec, "add")
    lay_con = sbf.default_layout(spec, "contains")

    def run_add(words, k):
        if regime == "L2":
            return sbf.add_vmem(spec, words, k, lay_add)
        return sbf.add_hbm(spec, words, k)

    def run_contains(words, q):
        if regime == "L2":
            return sbf.contains_vmem(spec, words, q, lay_con)
        return sbf.contains_hbm(spec, words, q)

    want_words = sbf.add_plain(spec, V.init(spec, "cuda"), sub)
    got_words = run_add(V.init(spec, "cuda"), sub)
    errs[add_name] = max(errs[add_name], max_err(got_words, want_words))
    queries = torch.cat([sub[: SUBSET // 2], probes[: SUBSET // 2]])
    want = sbf.contains_plain(spec, want_words, queries)
    errs[contains_name] = max(errs[contains_name],
                              max_err(run_contains(want_words, queries), want))
    del got_words
    torch.cuda.synchronize()
    print(f"main {regime}: kernel words and results equal the plain "
          f"version's on {SUBSET} keys into an empty {spec}")

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
    for name, op in ((add_name, "add"), (contains_name, "contains")):
        t_full, t_sub, t_plain = t[op], t[f"{op} sub"], t[f"{op} plain"]
        b_full, by_full = bound_ms(spec, n, op)
        b_sub, by_sub = bound_ms(spec, SUBSET, op)
        lo, hi = SPREAD[f"{regime} {op}"]
        print(f"time {regime} {op} [{card}]: kernel {t_full:.4f} ms "
              f"(rounds {lo:.4f}-{hi:.4f}; {n / t_full / 1e3:.1f} Mops/s) "
              f"at {n} keys, bound {b_full:.4f} ms ({by_full}), "
              f"{b_full / t_full:.1%} of it; Filter.{op} "
              f"{t[f'Filter.{op}']:.4f} ms; at {SUBSET} keys kernel "
              f"{t_sub:.4f} ms, plain {t_plain:.4f} ms, bound {b_sub:.4f} ms")
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t_sub, "plain_ms": t_plain,
            "bound_ms": b_sub, "bound_by": by_sub, "library_ms": None,
            "n_keys": SUBSET, "m_bits": spec.m_bits, "main_n_keys": n,
            "main_ms": t_full, "main_bound_ms": b_full,
            "api_ms": t[f"Filter.{op}"]}
    # the schedule axis each contains wrapper acts on, at full size
    if regime == "L2":
        sweep = {f"phi={p}": time_ms(lambda p=p: sbf.contains_vmem(
            spec, g.words, keys, sbf.Layout(1, p)), f"L2 phi={p}")
            for p in (1, 2, 4, 8)}
    else:
        sweep = {f"depth={d}": time_ms(lambda d=d: sbf.contains_hbm(
            spec, g.words, keys, depth=d), f"DRAM depth={d}")
            for d in sbf.DMA_DEPTHS}
    print(f"time {regime} {contains_name} sweep [{card}]: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sweep.items()))
    del g, f, keys, words, sub_words, want_words
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card, name, count = phase_device()
    phase_build()
    errs = {k: 0 for k in sbf.LAUNCHES}
    phase_kernels(errs)
    records, launches = {}, {}
    phase_main("L2", 1 << 23, errs, records, launches, card)
    phase_main("DRAM", 1 << 28, errs, records, launches, card)
    print(json.dumps({"kernels": [records[k] for k in
                                  ("contains_vmem", "add_vmem",
                                   "contains_hbm", "add_hbm")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
