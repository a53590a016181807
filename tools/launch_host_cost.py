#!/usr/bin/env python3
"""Measure what a small batch's call costs on the host, beside its time on
the card, for the two rule sweeps that time host-bound calls in turns
(``chip_smoke.py``'s ``phase_counting_rule`` and ``phase_quotient_rule``),
on one NVIDIA card.

    python3 tools/launch_host_cost.py [--counting]

(``--counting``: the plumbing and the counting update only, with the
binned call's host time split into its parts; only the bloom and counting
libraries are built.) It prints the card's name and power limit first, then:

- the host time a call of the launch plumbing: ``torch.cuda.current_stream``,
  ``sbf.raw_stream``, ``torch.cuda.device`` and ``sbf.device_scope`` on the
  current device, a small ``torch.empty`` on the card;
- for the counting update at 2^19 keys into 2^20 ... 2^24 counter bytes
  (B = 256, k = 8): each path's host time a call (enqueued behind a
  sleeping kernel, so the card never waits for the host), its time on the
  card alone (20 calls behind a sleeping kernel, CUDA events around each),
  and both in turns as the rule sweep times them (two runs of 9 rounds);
- for the quotient contains at q26 and q27 (8-bit slots, r = 5 / 4), load
  0.5 and 0.9, 2^16 and 2^18 keys (half members): the walk through the
  wrapper, the rule's path and the walk again, each round's time (ms a
  call) in turns with and without the binned path run between the rounds,
  so a state the binned path leaves shows as a change between rounds.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import quotient as Q  # noqa: E402
from repro_torch.core import variants as V  # noqa: E402
from repro_torch.kernels import _build, sbf  # noqa: E402
from repro_torch.kernels import countingbf as cnt  # noqa: E402
from repro_torch.kernels import quotientfilter as qf  # noqa: E402

SLEEP_CYCLES = 1_000_000_000     # a sleeping kernel the host enqueues behind


def host_us(fn, calls: int) -> float:
    """Host time (us) a call of ``fn``, enqueued behind a sleeping kernel."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def card_ms(fn, restore, calls: int = 20) -> float:
    """Median time (ms) on the card of a call, all enqueued behind a
    sleeping kernel (CUDA events around each call)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES // 2)
    events = []
    for _ in range(calls):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in events)[calls // 2]


def rounds(fns: dict, reps: int, n_rounds: int = 9) -> dict:
    """Each call's time (ms a call) in each of ``n_rounds`` rounds of
    ``reps`` calls, in turns (in order, then reversed), after
    ``chip_smoke.warm_calls(reps)`` untimed calls."""
    per = {k: [] for k in fns}
    for r in range(n_rounds):
        for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            for _ in range(cs.warm_calls(reps)):
                fns[key]()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fns[key]()
            b.record()
            torch.cuda.synchronize()
            per[key].append(round(a.elapsed_time(b) / reps, 4))
    return per


def plumbing(dev: torch.device) -> None:
    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def device_scope():
        with sbf.device_scope(dev):
            pass

    pieces = {
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "sbf.raw_stream": lambda: sbf.raw_stream(dev),
        "torch.cuda.device": device_ctx,
        "sbf.device_scope": device_scope,
        "torch.empty 280 KB": lambda: torch.empty((70000,),
                                                  dtype=torch.int32,
                                                  device=dev),
    }
    print("host us a call: " + ", ".join(
        f"{k} {host_us(fn, 2000):.2f}" for k, fn in pieces.items()),
        flush=True)


def counting(dev: torch.device) -> None:
    keys = cs.gen_keys(1 << 19, 31)
    for log2b in range(20, 25):
        spec = V.FilterSpec("countingbf", 1 << (log2b + 1), 8,
                            block_bits=256)
        words = V.init(spec, "cuda")
        fns = {p: (lambda p=p: cnt._launch_update(
            "update_hbm", spec, words, keys, None, "add", path=p))
            for p in cnt.UPDATE_PATHS}
        host = {p: host_us(fn, 100) for p, fn in fns.items()}
        card = {p: card_ms(fn, words.zero_) for p, fn in fns.items()}
        turns = [cs.time_restored_turns(fns, words.zero_,
                                        f"host cost 2^{log2b} {i}", 20, 9)
                 for i in range(2)]
        rule = cnt.choose_update_path(1 << 19, spec.storage_words,
                                      spec.counter_row_words,
                                      sbf.partition_smem_bytes(dev))
        print(f"counting 2^{log2b} B / 2^19 keys (one-pass / binned): host "
              f"{host['one-pass']:.2f} / {host['binned']:.2f} us a call, "
              f"card {card['one-pass']:.4f} / {card['binned']:.4f} ms, in "
              f"turns " + ", ".join(f"{t['one-pass']:.4f} / "
                                    f"{t['binned']:.4f}" for t in turns)
              + f" ms; the rule's path {rule}", flush=True)
        del words


def binned_parts(dev: torch.device) -> None:
    """The host time of a binned counting update at 2^19 keys into 2^23 B
    by part: the whole wrapper call, the wrapper with its C entry stubbed
    (Python alone), the workspace's allocation, and the C entry alone (its
    geometry checks and launches) on a kept workspace; one-pass beside."""
    spec = V.FilterSpec("countingbf", 1 << 24, 8, block_bits=256)
    words = V.init(spec, "cuda")
    keys = cs.gen_keys(1 << 19, 31)
    lib = _build.library()
    real = {p: getattr(lib, f) for p, f in (
        ("binned", "counting_update_binned"), ("one-pass", "counting_update"))}

    def call(path):
        return cnt._launch_update("update_hbm", spec, words, keys, None,
                                  "add", path=path)

    calls = 40                 # a binned call's launches stay queued
    whole = {p: host_us(lambda p=p: call(p), calls) for p in real}
    stubbed = {}
    for p, name in (("binned", "counting_update_binned"),
                    ("one-pass", "counting_update")):
        setattr(lib, name, lambda *a: 0)
        try:
            stubbed[p] = host_us(lambda p=p: call(p), calls)
        finally:
            setattr(lib, name, real[p])
    smem = sbf.partition_smem_bytes(dev)
    plan, cap, work = cnt._binned_call(spec, keys.shape[0], 1, dev, None,
                                       cnt.UPDATE_KEY_CAP, smem)
    alloc = host_us(lambda: cnt._workspace(plan["workspace_bytes"], dev),
                    calls)
    ptrs = (keys.data_ptr(), None, None, words.data_ptr(),
            cnt._salts(dev).data_ptr())
    stream = cnt._stream(dev)
    c_binned = host_us(lambda: real["binned"](
        *ptrs, work.data_ptr(), keys.shape[0], plan["total_rows"],
        spec.n_blocks - 1, spec.s, spec.k, 0, plan["bin_row_bits"], cap,
        plan["chunks"], stream), calls)
    c_one = host_us(lambda: real["one-pass"](
        *ptrs, keys.shape[0], spec.storage_words, spec.n_blocks - 1, spec.s,
        spec.k, 0, stream), calls)
    print(f"counting 2^23 B / 2^19 keys host time by part (us a call, "
          f"binned / one-pass): whole call {whole['binned']:.2f} / "
          f"{whole['one-pass']:.2f}, Python with the C entry stubbed "
          f"{stubbed['binned']:.2f} / {stubbed['one-pass']:.2f}, workspace "
          f"allocation {alloc:.2f} / -, C entry alone {c_binned:.2f} / "
          f"{c_one:.2f} ({plan['n_bins']} bins, column and scan "
          f"{plan['column_scan']})", flush=True)
    del words, work


def quotient() -> None:
    probes = cs.gen_keys(1 << 18, 36, probe=True)
    for q_bits in (26, 27):
        spec = cs.quotient_spec(8, min(5, 31 - q_bits), q_bits)
        for load in (0.5, 0.9):
            members = cs.gen_keys(int(spec.n_slots * load), 4000 + q_bits)
            table = Q.init(spec, "cuda")
            for chunk in members.split(qf.KEY_BATCH):
                qf.add_vmem(spec, table, chunk, None)
            for log2n in (16, 18):
                keys = cs.mixed_keys(members, probes, 1 << log2n, 0.5)
                fns = {p: (lambda p=p, keys=keys: cs.quotient_contains_on(
                    spec, table, keys, p)) for p in cs.QUOTIENT_RULE_PATHS}
                fns["walk again"] = (lambda keys=keys: qf.contains_vmem(
                    spec, table, keys, path="walk"))
                reps = cs.rule_reps({p: fns[p]
                                     for p in cs.QUOTIENT_RULE_PATHS})
                host = host_us(fns["walk"], 200)
                label = (f"quotient q{q_bits} load {load} 2^{log2n} keys "
                         f"(host {host:.2f} us a walk call, {reps} calls a "
                         f"round)")
                for name, order in (("binned between rounds", fns),
                                    ("no binned", {k: fns[k] for k in (
                                        "walk", "rule", "walk again")})):
                    per = rounds(order, reps)
                    print(f"{label}, {name}: " + "; ".join(
                        f"{k} median {sorted(v)[len(v) // 2]} rounds {v}"
                        for k, v in per.items() if k != "binned"),
                        flush=True)
            del members, table
            torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_host_cost: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    only_counting = sys.argv[1:] == ["--counting"]
    if only_counting:
        _build.SOURCES = ("bloom", "counting")
        _build.ENTRY_POINTS = {k: v for k, v in _build.ENTRY_POINTS.items()
                               if v[0] in _build.SOURCES}
    _build.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    plumbing(dev)
    if only_counting:
        binned_parts(dev)
    counting(dev)
    if not only_counting:
        quotient()
    return 0


if __name__ == "__main__":
    sys.exit(main())
