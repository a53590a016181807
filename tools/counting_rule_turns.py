#!/usr/bin/env python3
"""Time the counting update's one-pass and binned paths in turns near the
rule's smallest boundary, over several independent runs, on one NVIDIA
card, and print where each run found each path faster beside the rule's
choice (``countingbf.BINNED_KEYS``).

    python3 tools/counting_rule_turns.py [runs] [bytes LO-HI] [keys LO-HI]

For counters of 2^LO ... 2^HI bytes (default 20-24; B = 256, k = 8, as in
``chip_smoke.py``'s rule sweep) and batches of 2^LO ... 2^HI keys
(default 18-21), each
run adds the keys into zeroed counters on both paths, in turns (CUDA
events around each call, the counters zeroed outside them; the median of
9 rounds, each the mean of a few calls). ``runs`` (default 5) repeats
the whole sweep, so the spread between runs shows beside the spread of
the rounds. It prints the card's name and power limit first, then a line
per size with every run's one-pass / binned medians, the runs each path
won and the rule's path.
"""
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import variants as V  # noqa: E402
from repro_torch.kernels import countingbf as cnt  # noqa: E402
from repro_torch.kernels import sbf  # noqa: E402

LOG2_BYTES = "20-24"             # default sweep: log2 bytes, log2 keys
LOG2_KEYS = "18-21"
ROUNDS = 9


def gen_keys(n: int, seed: int) -> torch.Tensor:
    """``chip_smoke.gen_keys``' insert keys: n seeded (n, 2) int32 [hi, lo]
    keys on the card, the top bit of hi clear."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 32, (n, 2), dtype=torch.int64, device="cuda",
                      generator=gen)
    x[:, 0] &= 0x7FFFFFFF
    return H.to_i32(x).contiguous()


def turns(fns: dict, restore, reps: int) -> dict:
    """{path: (median, lowest, highest) ms} over ROUNDS rounds, the order
    of the paths reversed every other round."""
    for fn in fns.values():
        restore()
        fn()
    torch.cuda.synchronize()
    per = {key: [] for key in fns}
    for r in range(ROUNDS):
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
            per[key].append(sum(a.elapsed_time(b) for a, b in events)
                            / reps)
    return {k: (sorted(v)[len(v) // 2], min(v), max(v))
            for k, v in per.items()}


def log2_range(arg: str) -> range:
    """``"LO-HI"`` as the range LO ... HI, both ends included."""
    lo, hi = (int(x) for x in arg.split("-"))
    return range(lo, hi + 1)


def main(runs: int, log2_bytes: range, log2_keys: range) -> int:
    if not torch.cuda.is_available():
        print("counting_rule_turns: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    smem = sbf.partition_smem_bytes(torch.device("cuda"))
    keys = gen_keys(1 << max(log2_keys), 31)
    res = {}
    for run in range(runs):
        for log2b in log2_bytes:
            spec = V.FilterSpec("countingbf", 1 << (log2b + 1), 8,
                                block_bits=256)
            words = V.init(spec, "cuda")
            for log2n in log2_keys:
                sub = keys[: 1 << log2n]
                fns = {p: (lambda p=p: cnt._launch_update(
                    "update_hbm", spec, words, sub, None, "add", path=p))
                    for p in cnt.UPDATE_PATHS}
                res.setdefault((log2b, log2n), []).append(
                    turns(fns, words.zero_, reps=10))
            del words
    for (log2b, log2n), per_run in sorted(res.items()):
        spec = V.FilterSpec("countingbf", 1 << (log2b + 1), 8,
                            block_bits=256)
        rule = cnt.choose_update_path(1 << log2n, spec.storage_words,
                                      spec.counter_row_words, smem)
        wins = {p: sum(r[p][0] < min(r[q][0] for q in r if q != p)
                       for r in per_run) for p in cnt.UPDATE_PATHS}
        print(f"2^{log2b} B / 2^{log2n} keys: rule {rule}; runs (one-pass "
              f"/ binned ms, median [rounds' range]): " + ", ".join(
                  " / ".join(f"{r[p][0]:.4f} [{r[p][1]:.4f}-{r[p][2]:.4f}]"
                             for p in cnt.UPDATE_PATHS) for r in per_run)
              + "; won " + ", ".join(f"{p} {w} of {runs}"
                                     for p, w in wins.items()), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:] + [None] * 3
    sys.exit(main(int(args[0] or 5), log2_range(args[1] or LOG2_BYTES),
                  log2_range(args[2] or LOG2_KEYS)))
