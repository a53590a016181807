#!/usr/bin/env python3
"""Time this tree's blocked add and contains against another checkout's, in
turns, on one NVIDIA card.

    git archive <commit> | (mkdir -p build/other && tar -x -C build/other)
    python3 tools/bloom_ab.py build/other

The other checkout's ``src/repro_torch/kernels/csrc/bloom.cu`` must have the
one-thread-a-key C interface, ``bloom_contains(keys, words, out, salts, n,
block_mask, s, phi, depth, variant, k, z, log2g, stream)`` and
``bloom_add(keys, words, salts, n, block_mask, s, variant, k, z, log2g,
stream)``. The script builds that file with this tree's nvcc flags, then, in
the main path's two sbf cells (B = 256, k = 8: 2^23 keys into 16 MiB and
2^28 keys into 512 MiB, as ``filter_for_n_items(n, bits_per_key=16)`` makes
them), checks that the other kernels, this tree's Θ = 1 and
``sbf.card_layout``'s Θ give the same words and results, and times, in
turns (CUDA events; median and the rounds' range):

* the add of the keys into the filter;
* the contains of the added keys (L2: depth 1; DRAM: depths 1, 2 and 8);
* the contains of as many probes, most of them negatives, where the early
  exit of a key at its first missing load acts (L2: depth 1; DRAM: the
  depth ``ops`` resolves).

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
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.kernels import _build, ops, sbf  # noqa: E402
from repro_torch.kernels.sbf import DEFAULT_TILE  # noqa: E402


def build_other(checkout: Path) -> ctypes.CDLL:
    src = checkout / "src/repro_torch/kernels/csrc/bloom.cu"
    out = ROOT / "build" / "bloom_ab_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    print(f"build: {src} in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(out))
    vp, ll, u32, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                      ctypes.c_int)
    lib.bloom_contains.argtypes = [vp, vp, vp, vp, ll, u32] + [i] * 7 + [vp]
    lib.bloom_add.argtypes = [vp, vp, vp, ll, u32] + [i] * 5 + [vp]
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


def show(label: str, res: dict) -> None:
    print(label + ": " + ", ".join(
        f"{k} {m:.4f} ms [{lo:.4f}-{hi:.4f}]" for k, (m, lo, hi) in
        res.items()), flush=True)


def main(checkout: Path) -> int:
    if not torch.cuda.is_available():
        print("bloom_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    other = build_other(checkout)
    _build.library()
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
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(Path(sys.argv[1])))
