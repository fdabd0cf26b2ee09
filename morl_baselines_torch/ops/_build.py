"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled at first use
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/morl_torch_kernels/`` at the repository root, and loaded with ctypes.
The library's file name carries a hash of its source, so an edited source is
never served by a stale build.  ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for them; a failed build raises with the
compiler's output.  ``-Xptxas -v`` makes that output list each kernel's
registers, shared memory and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "morl_torch_kernels"
KERNELS = ("pareto_nd", "adam_step")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]  # fmt: skip

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Compile every missing library in parallel; return (seconds, compiler
    output) per name built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    built = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        built[name] = (time.perf_counter() - t0, out)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        lib = library_path(name)
        if not lib.exists():
            build((name,))
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]
