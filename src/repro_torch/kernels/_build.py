"""Build the CUDA sources in ``csrc/`` with ``nvcc`` at first use and load
them with ctypes.

Each source ``csrc/<name>.cu`` becomes its own library
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout; the
hash covers every file under ``csrc/`` (sources and shared headers) and the
flags, so an edited source or header never loads a stale library. The
libraries that are missing are compiled together, one ``nvcc`` process per
source, and :func:`library` binds every entry point of ``ENTRY_POINTS`` in
one namespace. ``nvcc``'s output, including ``-Xptxas -v``'s register and
spill report, is kept beside each library as ``<library>.log``
(:func:`build_log`). A failed build raises; nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bloom", "bloom_contains", "bloom_bank_contains", "counting",
           "counting_contains", "cbf", "ring", "cuckoo", "quotient",
           "calibrate")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _ll, _ull, _u32, _i = (ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_ulonglong, ctypes.c_uint32, ctypes.c_int)
# extern "C" entry point -> (source, argument types); each returns an int
# error code (0: launched; see ``sbf._raise_on``)
ENTRY_POINTS = {
    # blocked filters: (s, theta, vec, depth, grid) of sbf.launch_geometry
    "bloom_contains": ("bloom_contains", [_vp, _vp, _vp, _vp, _ll, _u32, _i,
                                          _i, _i, _i, _u32, _i, _i, _i, _i,
                                          _vp]),
    "bloom_add": ("bloom", [_vp, _vp, _vp, _ll, _u32, _i, _i, _u32, _i, _i,
                            _i, _i, _vp]),
    # counting filters: member ids (null for one filter) and the words of
    # one member (c_ulonglong); the contains' (theta, vec, depth) of
    # countingbf.contains_geometry
    "counting_update": ("counting", [_vp, _vp, _vp, _vp, _vp, _ll, _ull, _u32,
                                     _i, _i, _i, _vp]),
    # + the workspace; (total rows, block mask, s, k, op, bin row bits,
    # keys a batch, chunks); the chunks of the card as (s, total rows, bin
    # row bits)
    "counting_update_binned": ("counting", [_vp, _vp, _vp, _vp, _vp, _vp,
                                            _ll, _u32, _u32, _i, _i, _i, _i,
                                            _ll, _i, _vp]),
    "counting_binned_chunks": ("counting", [_i, _u32, _i]),
    "counting_contains": ("counting_contains", [_vp, _vp, _vp, _vp, _vp, _ll,
                                                _ull, _u32, _i, _i, _i, _i,
                                                _i, _vp]),
    "counting_decay": ("counting", [_vp, _ll, _vp]),
    # bank forms: + member ids and the words of one member (c_ulonglong)
    "bloom_bank_contains": ("bloom_bank_contains",
                            [_vp, _vp, _vp, _vp, _vp, _ll, _ull, _u32, _i, _i,
                             _i, _i, _u32, _i, _i, _i, _i, _vp]),
    "bloom_bank_add": ("bloom", [_vp, _vp, _vp, _vp, _vp, _ll, _ull, _u32,
                                 _i, _i, _u32, _i, _i, _i, _i, _vp]),
    # sizes as log2 m: m_bits = 2^32 does not fit a c_uint32
    "cbf_contains": ("cbf", [_vp, _vp, _vp, _vp, _ll, _i, _i, _vp]),
    "cbf_add": ("cbf", [_vp, _vp, _vp, _ll, _i, _i, _vp]),
    # + the u32 workspace; (bin_bits, keys a batch, chunks); the chunks of
    # the card as (log2m, k, bin_bits, 1 for the contains' scatter)
    "cbf_add_binned": ("cbf", [_vp, _vp, _vp, _vp, _ll, _i, _i, _i, _ll, _i,
                               _vp]),
    "cbf_contains_binned": ("cbf", [_vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _i,
                                    _ll, _i, _vp]),
    "cbf_binned_chunks": ("cbf", [_i, _i, _i, _i]),
    # the ring's one-pass contains: (s, theta, variant, k, z, log2g); the
    # binned one: + the u32 workspace, (bin row bits, keys a batch,
    # chunks); the chunks of the card as (s, log2 blocks, bin row bits)
    "ring_contains": ("ring", [_vp, _vp, _vp, _vp, _ll, _ll, _i, _u32, _i,
                               _i, _i, _i, _i, _i, _vp]),
    "ring_contains_binned": ("ring", [_vp, _vp, _vp, _vp, _vp, _ll, _ll, _i,
                                      _u32, _i, _i, _i, _i, _i, _i, _ll, _i,
                                      _vp]),
    "ring_binned_chunks": ("ring", [_i, _i, _i]),
    # partitioned updates: (n_segments, capacity) slots, the segment's words,
    # a path flag (bloom: shared memory, after (s, theta, variant, k, z,
    # log2g); counting: the grouped kernel); bloom_partition_smem(device) is
    # the budget of both
    "bloom_add_partitioned": ("bloom", [_vp, _vp, _vp, _vp, _ll, _ll, _u32,
                                        _u32, _i, _i, _i, _i, _i, _i, _i,
                                        _vp]),
    "bloom_partition_smem": ("bloom", [_i]),
    # a card's L2 fetch granularity in bytes (read only)
    "bloom_l2_fetch_granularity": ("bloom", [_i]),
    "counting_update_partitioned": ("counting", [_vp, _vp, _vp, _vp, _ll,
                                                 _ll, _u32, _u32, _i, _i, _i,
                                                 _i, _vp]),
    "cuckoo_contains": ("cuckoo", [_vp, _vp, _vp, _ll, _u32, _i, _i, _i,
                                   _u32, _u32, _vp]),
    # + the order scratch and the counters; (tile, window, step cap)
    "cuckoo_update": ("cuckoo", [_vp, _vp, _vp, _vp, _vp, _vp, _ll, _i, _i,
                                 _i, _u32, _i, _i, _i, _u32, _u32, _i, _vp]),
    # the dependent-load latency probe behind the cuckoo update's floor
    "cuckoo_chase": ("cuckoo", [_vp, _ll, _vp, _vp]),
    # geometry as (log2 n_slots, r_bits, slot_bits, fingerprint salt);
    # the contains' scratch as (per-slot int32, scan sums, their count,
    # scalars)
    "quotient_contains": ("quotient", [_vp, _vp, _vp, _ll, _i, _i, _i, _u32,
                                       _i, _vp, _vp, _ll, _vp, _vp]),
    # the sorted-stream update: (..., op, workspace, its bytes, tile_slots,
    # merge_tile, bin_bits, bin_cap, key_chunks, stream); merge and resize
    # likewise
    "quotient_update": ("quotient", [_vp, _vp, _vp, _vp, _ll, _i, _i, _i,
                                     _u32, _i, _vp, _ll, _i, _i, _i, _i, _i,
                                     _vp]),
    "quotient_merge": ("quotient", [_vp, _vp, _vp, _i, _i, _i, _vp, _ll, _i,
                                    _i, _vp]),
    "quotient_resize": ("quotient", [_vp, _vp, _i, _i, _i, _i, _i, _vp, _ll,
                                     _i, _i, _vp]),
    # the performance model's calibration probes (kernels/calibrate.py)
    "calibrate_step": ("calibrate", [_vp, _vp, _ll, _vp]),
    "calibrate_chain": ("calibrate", [_vp, _ll, _i, _u32, _u32, _vp]),
    "calibrate_gather": ("calibrate", [_vp, _u32, _vp, _ll, _i, _vp]),
    "calibrate_blocks_per_sm": ("calibrate", [_i]),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in _CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(_CSRC).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build() -> list:
    """Compile the libraries of ``SOURCES`` that are not built yet, all at
    once; return their paths in the order of ``SOURCES``."""
    outs = [library_path(name) for name in SOURCES]
    todo = [(name, out) for name, out in zip(SOURCES, outs)
            if not out.exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for out, tmp, cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        Path(str(out) + ".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """nvcc's output for library ``name`` ('' if it was never built)."""
    log = Path(str(library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def library() -> types.SimpleNamespace:
    """Every entry point of ``ENTRY_POINTS``, bound with its argument types;
    the first call builds the libraries that are missing."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = {name: ctypes.CDLL(str(path))
                      for name, path in zip(SOURCES, build())}
            lib = types.SimpleNamespace()
            for symbol, (source, argtypes) in ENTRY_POINTS.items():
                fn = getattr(loaded[source], symbol)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                setattr(lib, symbol, fn)
            _lib = lib
        return _lib
