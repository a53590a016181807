"""Build ``csrc/bloom.cu`` with ``nvcc`` at first use and load it with ctypes.

The library goes to ``build/repro_torch/`` at the root of the checkout, named
by a hash of the source, so an edited source never loads a stale library.
``nvcc``'s output, including ``-Xptxas -v``'s register and spill report, is
kept beside it as ``<library>.log`` (:func:`build_log`). A failed build
raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "bloom.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"bloom-{digest}.so"


def build() -> Path:
    """Compile the library unless it is already built; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    Path(str(out) + ".log").write_text(log)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """nvcc's output for the current library ('' if it was never built)."""
    log = Path(str(library_path()) + ".log")
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, u32, i = (ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_uint32, ctypes.c_int)
            lib.bloom_contains.argtypes = [vp, vp, vp, vp, ll, u32, i, i, i,
                                           i, i, i, i, vp]
            lib.bloom_contains.restype = i
            lib.bloom_add.argtypes = [vp, vp, vp, ll, u32, i, i, i, i, i, vp]
            lib.bloom_add.restype = i
            _lib = lib
        return _lib
