"""ctypes binding to the native host-math library (``native/morl_native.cpp``).

PyTorch port of ``morl_baselines_tpu/utils/native.py``: exact WFG
hypervolume of logged fronts (the reference delegates it to pymoo,
common/performance_indicators.py:15) and the non-dominated mask of large host
archives (reference common/pareto.py:34-57), in C++ on the host.

The port builds its own copy of the library.  At first use, ``native/morl_native.cpp``
is compiled with the Makefile's flags into ``build/morl_torch_kernels/`` at
the repository root (gitignored), under a file name that carries a hash of
the source, so an edited source is never served by a stale build.  The
compiler writes a temporary file that ``os.replace`` moves into place, so
processes that build at once each see the whole library or none.  Nothing is
written to ``native/``.  A failed build raises with the compiler's output;
there is no fallback.  The functions return ``None`` only where the library
itself refuses: more than 64 objectives, or a negative return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "morl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "morl_torch_kernels"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]  # native/Makefile's, less its warnings

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path(build_dir: Path | None = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return (build_dir or BUILD_DIR) / f"libmorl_native_{digest}.so"


def compile_command(out: Path) -> list[str]:
    return [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(out), str(SOURCE)]


def build(build_dir: Path | None = None) -> tuple[Path, float]:
    """Compile the library unless it is built; returns (path, seconds spent compiling)."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(compile_command(tmp), capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            c_dp = ctypes.POINTER(ctypes.c_double)
            lib.morl_hv_exact.restype = ctypes.c_double
            lib.morl_hv_exact.argtypes = [c_dp, ctypes.c_int64, ctypes.c_int32, c_dp]
            lib.morl_pareto_mask.restype = ctypes.c_int64
            lib.morl_pareto_mask.argtypes = [c_dp, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
            lib.morl_hv_exact_batch.restype = None
            lib.morl_hv_exact_batch.argtypes = [c_dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, c_dp, c_dp]
            _lib = lib
        return _lib


def _as_c_doubles(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def hv_exact(points: np.ndarray, ref: np.ndarray) -> float | None:
    """Exact hypervolume (maximization) by the native WFG; None for d > 64."""
    lib = _load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    r = np.ascontiguousarray(ref, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != r.shape[0]:
        raise ValueError(f"points {pts.shape} incompatible with ref {r.shape}")
    out = lib.morl_hv_exact(_as_c_doubles(pts), pts.shape[0], pts.shape[1], _as_c_doubles(r))
    return None if out < 0 else float(out)


def hv_exact_batch(fronts: np.ndarray, ref: np.ndarray) -> np.ndarray | None:
    """Exact HV per front of a (B, N, d) stack; None where the library refuses."""
    lib = _load()
    pts = np.ascontiguousarray(fronts, dtype=np.float64)
    r = np.ascontiguousarray(ref, dtype=np.float64)
    b, n, d = pts.shape
    out = np.empty((b,), dtype=np.float64)
    lib.morl_hv_exact_batch(_as_c_doubles(pts), b, n, d, _as_c_doubles(r), _as_c_doubles(out))
    if np.any(out < 0):
        return None
    return out


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Non-dominated bool mask of (N, d) points, exact duplicates all kept."""
    lib = _load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, d = pts.shape
    mask = np.zeros((n,), dtype=np.uint8)
    lib.morl_pareto_mask(_as_c_doubles(pts), n, d, mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return mask.astype(bool)
