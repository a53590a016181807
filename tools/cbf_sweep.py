#!/usr/bin/env python3
"""Time the classical filter's two add paths and its two contains paths in
turns over filter and batch sizes on one NVIDIA card, and print the
crossovers that ``cbf.BINNED_MIN_POSITIONS`` and
``cbf.CONTAINS_BINNED_MIN_POSITIONS`` hold.

    python3 tools/cbf_sweep.py [add|contains] [log2 m ...]

For k = 11 (the cbf cells' k), filters of 2^23, 2^25, 2^27 ... 2^32 bits and
batches of 2^14 ... 2^28 keys (every power of two from 2^17 to 2^23 where
the filter has 2^27 bits or more, every other one elsewhere), the script
adds the keys into an empty filter on the one-pass and the binned path,
in turns (CUDA events; median and range of 3 rounds), and prints, per
filter size, the last batch where one-pass won and the first where binned
did, beside the rule's choice. Then, in the two cbf cells of
``chip_smoke.py`` (2^23 keys into 2^27 bits, 2^28 into 2^32), it times
one-pass and the binned add in bins of 2^19 and 2^20 bits in turns, with
the binned add's device time by kernel (``torch.profiler``).

The contains sweep takes the same filter and batch sizes: each filter is
filled to its design load (m / 16 keys, as ``filter_for_n_items(n,
bits_per_key=16)`` sizes it), and a batch of n keys holds a share of 0,
1/2 or 1 of added keys, the rest keys never added: the one-pass kernel's
early exit acts on the keys never added, and the binned test kernel
stores a miss for them. It times both paths at the three shares in turns
and prints, per filter size and share, the same crossovers beside the
contains rule's choice; then, in the DRAM cell (2^28 added keys into 2^32
bits), one-pass against the binned contains at caps of 2^29 ... 2^26
probes a batch (``cbf.CONTAINS_POSITION_CAP`` is 2^27) at each share,
with its device time by kernel. With no argument the script runs both
sweeps; log2 m values after ``contains`` restrict its sweep to those
filters:

    python3 tools/cbf_sweep.py contains 29 30 31 32

It prints the card's name and power limit first.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import variants as V  # noqa: E402
from repro_torch.kernels import _build, cbf, sbf  # noqa: E402

K = 11
LOG2M = (23, 25, 27, 28, 29, 30, 31, 32)


def gen_keys(n: int, seed: int, probe: bool = False) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 32, (n, 2), dtype=torch.int64, device="cuda",
                      generator=g)
    x[:, 0] = (x[:, 0] | (1 << 31)) if probe else (x[:, 0] & 0x7FFFFFFF)
    return H.to_i32(x).contiguous()


def sizes_for(log2m: int) -> list:
    return sorted(set(range(14, 29, 2)) | (set(range(17, 24))
                                           if log2m >= 27 else set()))


def turns(fns: dict, rounds: int = 3) -> dict:
    """Median, min and max (ms a call) of each call, in turns; the repeats
    a round keep a round near 20 ms."""
    first = next(iter(fns.values()))
    first()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    first()
    end.record()
    torch.cuda.synchronize()
    reps = max(1, min(20, int(20 / max(start.elapsed_time(end), 1e-3))))
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    per = {key: [] for key in fns}
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
    return {key: (sorted(ts)[len(ts) // 2], min(ts), max(ts))
            for key, ts in per.items()}


def fmt(res: dict) -> str:
    return ", ".join(f"{key} {m:.4f} [{lo:.4f}-{hi:.4f}]"
                     for key, (m, lo, hi) in res.items())


def sweep(keys: torch.Tensor, smem: int) -> None:
    for log2m in LOG2M:
        spec = V.FilterSpec("cbf", 1 << log2m, K)
        words = V.init(spec, "cuda")
        last_one, first_binned = None, None
        for log2n in sizes_for(log2m):
            sub = keys[: 1 << log2n]
            res = turns({p: (lambda p=p: cbf.add_vmem(spec, words, sub,
                                                       path=p))
                         for p in cbf.PATHS})
            faster = min(cbf.PATHS, key=lambda p: res[p][0])
            if faster == "one-pass":
                last_one = log2n
            elif first_binned is None:
                first_binned = log2n
            rule = cbf.choose_path(1 << log2n, 1 << log2m, K, smem)
            print(f"sweep m 2^{log2m} n 2^{log2n}: {fmt(res)}; faster "
                  f"{faster}, rule {rule}", flush=True)
        print(f"crossover m 2^{log2m}: one-pass last faster at n = 2^"
              f"{last_one}, binned first faster at n = 2^{first_binned}; "
              f"the rule's least positions "
              f"{cbf.BINNED_MIN_POSITIONS.get(log2m)}", flush=True)
        del words
        torch.cuda.empty_cache()


def cells(keys: torch.Tensor) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for log2m, n in ((27, 1 << 23), (32, 1 << 28)):
        spec = V.FilterSpec("cbf", 1 << log2m, K)
        words, sub = V.init(spec, "cuda"), keys[:n]
        fns = {"one-pass": lambda: cbf.add_vmem(spec, words, sub,
                                                path="one-pass")}
        for b in (19, 20):
            fns[f"binned b={b}"] = (lambda b=b: cbf.add_vmem(
                spec, words, sub, path="binned", bin_bits=b))
        print(f"cell m 2^{log2m} n {n}: {fmt(turns(fns))}", flush=True)
        for b in (19, 20):
            with torch.profiler.profile(activities=acts) as prof:
                cbf.add_vmem(spec, words, sub, path="binned", bin_bits=b)
                torch.cuda.synchronize()
            rows = sorted(((getattr(e, "device_time_total", 0), e.count,
                            e.key) for e in prof.key_averages()),
                          reverse=True)
            print(f"  binned b={b} by kernel: " + ", ".join(
                f"{k.split('::')[-1][:28]} x{c} {us / 1e3:.4f} ms"
                for us, c, k in rows if us > 0), flush=True)
        del words
        torch.cuda.empty_cache()


SHARES = (0.0, 0.5, 1.0)          # member shares of a batch's keys


def mixed(keys: torch.Tensor, probes: torch.Tensor, added: int, n: int,
          share: float) -> torch.Tensor:
    """n keys: the first ``share`` of them taken from the ``added`` keys
    of the filter (repeated where there are fewer), the rest keys never
    added."""
    members = int(n * share)
    pool = keys[:added]
    reps = -(-members // added)
    return torch.cat([pool.repeat(reps, 1)[:members], probes[: n - members]])


def contains_sweep(keys: torch.Tensor, probes: torch.Tensor, smem: int,
                   log2ms: tuple = LOG2M) -> None:
    for log2m in log2ms:
        spec = V.FilterSpec("cbf", 1 << log2m, K)
        words = cbf.add_vmem(spec, V.init(spec, "cuda"),
                             keys[: 1 << (log2m - 4)])
        last_one = {s: None for s in SHARES}
        first_binned = {s: None for s in SHARES}
        for log2n in sizes_for(log2m):
            qs = {s: mixed(keys, probes, 1 << (log2m - 4), 1 << log2n, s)
                  for s in SHARES}
            res = turns({f"{p} s={s}": (lambda p=p, s=s: cbf.contains_vmem(
                spec, words, qs[s], path=p))
                for s in SHARES for p in cbf.PATHS})
            faster = {}
            for s in SHARES:
                faster[s] = min(cbf.PATHS, key=lambda p: res[f"{p} s={s}"][0])
                if faster[s] == "one-pass":
                    last_one[s] = log2n
                elif first_binned[s] is None:
                    first_binned[s] = log2n
            rule = cbf.choose_contains_path(1 << log2n, 1 << log2m, K, smem)
            print(f"contains sweep m 2^{log2m} n 2^{log2n}: {fmt(res)}; "
                  f"faster " + ", ".join(f"s={s} {faster[s]}" for s in SHARES)
                  + f"; rule {rule}", flush=True)
            del qs
        for s in SHARES:
            print(f"contains crossover m 2^{log2m} member share {s}: one-pass "
                  f"last faster at n = 2^{last_one[s]}, binned first faster "
                  f"at n = 2^{first_binned[s]}", flush=True)
        print(f"contains rule m 2^{log2m}: least probes "
              f"{cbf.CONTAINS_BINNED_MIN_POSITIONS.get(log2m)}", flush=True)
        del words
        torch.cuda.empty_cache()
    contains_cell(keys, probes)


def contains_cell(keys: torch.Tensor, probes: torch.Tensor) -> None:
    """The DRAM cell (2^28 added keys into 2^32 bits): one-pass against the
    binned contains at several caps, at each member share, with the binned
    contains' device time by kernel at the shares' ends."""
    spec = V.FilterSpec("cbf", 1 << 32, K)
    n = keys.shape[0]
    words = cbf.add_vmem(spec, V.init(spec, "cuda"), keys)
    caps = (1 << 29, 1 << 28, 1 << 27, 1 << 26)
    for s in SHARES:
        q = mixed(keys, probes, n, n, s)
        fns = {"one-pass": lambda: cbf.contains_vmem(spec, words, q,
                                                     path="one-pass")}
        for c in caps:
            fns[f"binned cap 2^{c.bit_length() - 1}"] = (
                lambda c=c: cbf.contains_vmem(spec, words, q, path="binned",
                                              cap=c))
        print(f"contains cell m 2^32 n {n} member share {s}: "
              f"{fmt(turns(fns))}", flush=True)
        if s == 0.5:
            continue
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for c in (caps[0], caps[2]):
            with torch.profiler.profile(activities=acts) as prof:
                cbf.contains_vmem(spec, words, q, path="binned", cap=c)
                torch.cuda.synchronize()
            rows = sorted(((getattr(e, "device_time_total", 0), e.count,
                            e.key) for e in prof.key_averages()),
                          reverse=True)
            print(f"  binned contains cap 2^{c.bit_length() - 1} share {s} "
                  f"by kernel: " + ", ".join(
                      f"{k.split('::')[-1][:28]} x{cnt} {us / 1e3:.4f} ms"
                      for us, cnt, k in rows if us > 0), flush=True)
        del q
    del words
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("cbf_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.library()
    keys = gen_keys(1 << 28, 31)
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    which = [a for a in sys.argv[1:] if not a.isdigit()] or ["add",
                                                               "contains"]
    log2ms = tuple(int(a) for a in sys.argv[1:] if a.isdigit()) or LOG2M
    if "add" in which:
        sweep(keys, smem)
        cells(keys)
    if "contains" in which:
        contains_sweep(keys, gen_keys(1 << 28, 32, probe=True), smem, log2ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
