"""Measured machine calibration for the filter performance model.

Counterpart of ``repro.perfmodel.calibrate``. The model
(:mod:`repro_torch.perfmodel.model`) produces machine-independent resource
counts; this module supplies the five machine constants that turn counts
into wall time:

* ``bw_hbm_gbs`` — streaming device-memory bandwidth (GB/s): one float32
  sum over an array far larger than the last-level cache (1 GiB on a card,
  20x the H100's 50 MB L2; an int32 sum accumulates in int64 and does not
  stream at the memory's rate);
* ``bw_res_gbs`` — resident gather bandwidth (GB/s), 4 useful bytes a
  gather: on a card the resident tier is the L2, so the gather kernel reads
  random words of a 16 MiB table with indices it hashes itself;
* ``gops`` — u32 ALU rate (Gop/s): the chain kernel's dependent
  multiply-adds on a full card of resident threads, 2 ops a step;
* ``launch_us`` — host time of one tiny op followed by
  ``torch.cuda.synchronize()``;
* ``step_us`` — per grid-step cost: the step kernel's time at ``g`` CTAs
  less its time at one, over ``g - 1``, with ``g`` at least 64 full waves
  of resident CTAs, so that it is the amortised cost of one more CTA.

The probes time with CUDA events on a card (best of ``reps`` after a
warm-up; ``launch_us`` by the host clock) and with ``time.perf_counter`` on
the CPU, where each probe runs its kernel's plain version at the JAX
probe's size.

The backend key is the device: ``"cpu"``, or ``"cuda:"`` and
``torch.cuda.get_device_name``, so a CPU calibration never answers for a
card and one card's never for another. ``get_calibration()`` is cheap by
default: the disk-cached measurement for the device if there is one, else
the per-backend defaults; it measures only when asked (``measure=True`` or
``REPRO_CALIB_MEASURE=1``) and then stores the result
(``REPRO_CALIB_CACHE``, default ``~/.cache/repro_torch/calibration.json``;
its keys start with ``repro_torch|``, so a file shared with the JAX
package never hands one package's entry to the other).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings

import torch

from repro_torch import resolve_device
from repro_torch.kernels import calibrate as K

_SCHEMA = 1
KEY_PREFIX = "repro_torch"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One device's practical speed-of-light constants (see module doc)."""

    backend: str
    bw_hbm_gbs: float
    bw_res_gbs: float
    gops: float
    launch_us: float
    step_us: float
    measured: bool = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = _SCHEMA
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        if int(d.get("schema", 0)) != _SCHEMA:
            raise ValueError(f"calibration schema {d.get('schema')!r}")
        return cls(backend=str(d["backend"]),
                   bw_hbm_gbs=float(d["bw_hbm_gbs"]),
                   bw_res_gbs=float(d["bw_res_gbs"]),
                   gops=float(d["gops"]),
                   launch_us=float(d["launch_us"]),
                   step_us=float(d["step_us"]),
                   measured=bool(d.get("measured", False)))


# Uncalibrated defaults. "cpu": the JAX package's CPU numbers, so that plans
# on the CPU are the JAX package's plans. "cuda": the main-path measurement
# of chip_smoke.py phase 4g on an NVIDIA H100 80GB HBM3, power limit
# 700.00 W (PERF.md).
_DEFAULTS = {
    "cpu": dict(bw_hbm_gbs=12.0, bw_res_gbs=40.0, gops=8.0,
                launch_us=50.0, step_us=150.0),
    "cuda": dict(bw_hbm_gbs=2951.40, bw_res_gbs=541.69, gops=32492.04,
                 launch_us=19.995, step_us=0.0024797),
}

# Probe sizes: the JAX probe's on the CPU; on a card as the module doc says.
CPU_HBM_BYTES = 1 << 25
CARD_HBM_BYTES = 1 << 30
CPU_RES_TABLE_BYTES, CPU_RES_GATHERS = 1 << 16, 1 << 20
CARD_RES_TABLE_BYTES, CARD_RES_GATHERS = 1 << 24, 1 << 28
CPU_RES_THREADS = 4096
CPU_GOPS_WIDTH, CPU_GOPS_ITERS = 1 << 13, 512
CARD_GOPS_WAVES, CARD_GOPS_ITERS = 4, 16384
CPU_STEP_GRID = 16
CARD_STEP_WAVES = 64


def backend_key(device=None) -> str:
    """``"cpu"``, or ``"cuda:<device name>"`` for a card."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name(dev)}"


def default_calibration(backend: str | None = None,
                        device=None) -> Calibration:
    """The defaults for ``backend`` (a :func:`backend_key`; default: the
    key of ``device``): the card family's numbers, else the CPU's."""
    b = backend or backend_key(device)
    base = _DEFAULTS.get(b.split(":")[0], _DEFAULTS["cpu"])
    return Calibration(backend=b, measured=False, **base)


def cache_path() -> str:
    return os.environ.get(
        "REPRO_CALIB_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "calibration.json"))


def _load_disk() -> dict:
    try:
        with open(cache_path()) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_disk(key: str, value: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _load_disk()
        data[key] = value
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                       # cache is an optimization, never an error


def _best_of(fn, device: torch.device, reps: int = 3) -> float:
    """Minimum seconds of ``fn()`` over ``reps`` runs after a warm-up: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_bw_hbm(n_bytes: int | None = None, device=None) -> float:
    """Streaming GB/s: one float32 sum over ``n_bytes`` (default 1 GiB on a
    card, 32 MiB on the CPU)."""
    dev = resolve_device(device)
    if n_bytes is None:
        n_bytes = CARD_HBM_BYTES if dev.type == "cuda" else CPU_HBM_BYTES
    x = torch.ones((n_bytes // 4,), dtype=torch.float32, device=dev)
    return n_bytes / _best_of(lambda: x.sum(), dev) / 1e9


def measure_bw_res(table_bytes: int | None = None,
                   n_gather: int | None = None, device=None) -> float:
    """Resident gather GB/s (4 bytes a gather) over a ``table_bytes`` table
    (default 16 MiB on a card: L2-resident; 64 KiB on the CPU). On a card
    one full wave of gather threads takes ``n_gather`` (default 2^28) reads
    between them."""
    dev = resolve_device(device)
    card = dev.type == "cuda"
    if table_bytes is None:
        table_bytes = CARD_RES_TABLE_BYTES if card else CPU_RES_TABLE_BYTES
    if n_gather is None:
        n_gather = CARD_RES_GATHERS if card else CPU_RES_GATHERS
    threads = (K.sm_count(dev) * K.blocks_per_sm("gather", dev) * K.THREADS
               if card else CPU_RES_THREADS)
    per_thread = max(n_gather // threads, 1)
    table = K.gather_table(table_bytes // 4, dev)
    out = torch.empty((threads,), dtype=torch.int32, device=dev)
    t = _best_of(lambda: K.gather(table, out, per_thread), dev)
    return 4.0 * threads * per_thread / t / 1e9


def measure_gops(width: int | None = None, iters: int | None = None,
                 device=None) -> float:
    """Dependent u32 multiply-add chains, Gop/s (2 ops a lane-step): on a
    card ``width`` threads (default 4 full waves) of ``iters`` (default
    16384) steps; on the CPU the JAX probe's 8192 x 512."""
    dev = resolve_device(device)
    card = dev.type == "cuda"
    if width is None:
        width = (CARD_GOPS_WAVES * K.sm_count(dev)
                 * K.blocks_per_sm("chain", dev) * K.THREADS
                 if card else CPU_GOPS_WIDTH)
    if iters is None:
        iters = CARD_GOPS_ITERS if card else CPU_GOPS_ITERS
    out = torch.empty((width,), dtype=torch.int32, device=dev)
    t = _best_of(lambda: K.chain(out, iters), dev)
    return 2.0 * width * iters / t / 1e9


def measure_launch_us(calls: int = 50, device=None) -> float:
    """Per-dispatch overhead: a tiny op and a synchronize, amortised."""
    dev = resolve_device(device)
    x = torch.zeros((8,), dtype=torch.int32, device=dev)

    def once():
        y = x + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return y

    once()
    t0 = time.perf_counter()
    for _ in range(calls):
        once()
    return (time.perf_counter() - t0) / calls * 1e6


def step_grid(device=None) -> int:
    """The step probe's grid: on a card ``CARD_STEP_WAVES`` (64) full waves
    of resident step CTAs (SMs x CTAs an SM), so that the difference to a
    one-CTA launch stands far above the events' resolution (at the JAX
    probe's 16, all CTAs run at once and the difference reads about 0); on
    the CPU the JAX probe's 16."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return CPU_STEP_GRID
    return CARD_STEP_WAVES * K.sm_count(dev) * K.blocks_per_sm("step", dev)


def measure_step_us(grid: int | None = None, device=None) -> float:
    """Per grid-step cost (us): the step kernel at ``grid`` CTAs (default
    :func:`step_grid`) less at one, over ``grid - 1``."""
    dev = resolve_device(device)
    grid = grid or step_grid(dev)

    def make(g):
        x = torch.zeros((K.BLOCK_ROWS * g, K.BLOCK_COLS), dtype=torch.int32,
                        device=dev)
        return x, torch.empty_like(x)

    x_many, o_many = make(grid)
    x_one, o_one = make(1)
    t_many = _best_of(lambda: K.step(x_many, o_many), dev, reps=5)
    t_one = _best_of(lambda: K.step(x_one, o_one), dev, reps=5)
    return max(t_many - t_one, 0.0) / (grid - 1) * 1e6


PROBES = {"bw_hbm_gbs": measure_bw_hbm, "bw_res_gbs": measure_bw_res,
          "gops": measure_gops, "launch_us": measure_launch_us,
          "step_us": measure_step_us}


def measure_calibration(device=None) -> Calibration:
    """Run every probe on ``device``. A probe that fails, or returns a
    value that is not finite and > 0, keeps the backend's default for its
    constant, as in the JAX package (a partly measured calibration beats
    none), with a warning; ``measured`` is true only when every constant
    came from its probe."""
    dev = resolve_device(device)
    b = backend_key(dev)
    base = dict(_DEFAULTS.get(b.split(":")[0], _DEFAULTS["cpu"]))
    failed = []
    for name, fn in PROBES.items():
        try:
            v = float(fn(device=dev))
        except Exception as e:         # keep the default for this constant
            failed.append(f"{name} ({e!r})")
            continue
        if math.isfinite(v) and v > 0:
            base[name] = v
        else:
            failed.append(f"{name} ({v!r})")
    if failed:
        warnings.warn(f"calibration probes failed on {b}, defaults kept: "
                      + ", ".join(failed))
    return Calibration(backend=b, measured=not failed, **base)


def get_calibration(measure: bool | None = None,
                    device=None) -> Calibration:
    """The calibration for ``device`` (default the card): the disk-cached
    measurement if one exists, else (``measure`` falsy) the defaults, else
    a fresh measurement, stored in the disk cache only when every probe
    succeeded."""
    dev = resolve_device(device)
    b = backend_key(dev)
    key = f"{KEY_PREFIX}|calib|{_SCHEMA}|{b}"
    cached = _load_disk().get(key)
    if cached is not None:
        try:
            return Calibration.from_dict(cached)
        except (KeyError, ValueError, TypeError):
            pass                   # stale/corrupt entry: fall through
    if measure is None:
        measure = os.environ.get("REPRO_CALIB_MEASURE", "") == "1"
    if not measure:
        return default_calibration(b)
    calib = measure_calibration(dev)
    if calib.measured:
        _store_disk(key, calib.to_dict())
    return calib
