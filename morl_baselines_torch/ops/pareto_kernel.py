"""Pareto non-dominated mask: hand-written CUDA kernel, its plain version, dispatch.

The kernel (``csrc/pareto_nd.cu``) replaces the Pallas TPU kernel
``morl_baselines_tpu/ops/pareto_kernel.py::_nd_kernel`` (reached through
``non_dominated_mask_pallas``).  It computes the same mask: row i is dominated
if some valid row j is >= in every objective and > in at least one, or, with
``keep_duplicates=False``, if a valid row j < i is an exact duplicate; the
result is ``~dominated & valid``.  One thread owns a row, a 128-thread block a
row tile, and the block streams column tiles through shared memory; see the
source for the design.

What bounds it on an H100: about N^2 (3d + 2) compare and logic operations
against N (4d + 2) bytes moved, so operations.  A simple kernel that is right
comes first; tensor-core or TMA-style tuning is later work.

The JAX package launches its kernel only on a TPU and only for
N >= ``PALLAS_MIN_N = 100_000``, the size where the (N, N) jnp working set no
longer fits in TPU memory.  That threshold is a TPU memory cliff, not a speed
crossover, and is deliberately not carried over: here a CUDA tensor always
goes to the kernel and a CPU tensor to the plain mask.

NaN inputs are out of scope: the kernel and the plain versions treat every
comparison with NaN as false, which the JAX pair do not promise either.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.pareto import non_dominated_mask
from . import _build

MAX_D = 16


def non_dominated_mask_plain(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    keep_duplicates: bool = True,
    block_rows: int = 1024,
) -> torch.Tensor:
    """The kernel's function in plain torch, row-blocked so that (block_rows, N)
    masks, not (N, N), are materialized: 131072 rows fit in card memory.

    It repeats the kernel's arithmetic (row i against every valid column j) and
    is the reference the kernel is held against; nothing on the main path calls
    it when a card is present.
    """
    n = points.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    cols = points[None, :, :]
    col_idx = torch.arange(n, device=points.device)
    dominated = torch.empty((n,), dtype=torch.bool, device=points.device)
    for start in range(0, n, block_rows):
        rows = points[start : start + block_rows, None, :]
        ge = torch.all(cols >= rows, dim=-1)
        gt = torch.any(cols > rows, dim=-1)
        hit = gt
        if not keep_duplicates:
            row_idx = col_idx[start : start + block_rows, None]
            hit = gt | (col_idx[None, :] < row_idx)
        dominated[start : start + block_rows] = torch.any(ge & hit & valid[None, :], dim=-1)
    return valid & ~dominated


def non_dominated_mask_cuda(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    keep_duplicates: bool = True,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns the (N,) bool mask.

    ``points`` is a contiguous (N, d) float32 CUDA tensor with d <= 16 and
    ``valid`` a contiguous (N,) bool tensor on the same device.  Every launch
    adds one to ``non_dominated_mask_cuda.launches``.
    """
    if points.device.type != "cuda":
        raise ValueError(f"points must be a CUDA tensor, got {points.device}")
    if points.dtype != torch.float32 or points.dim() != 2 or not points.is_contiguous():
        raise ValueError(f"points must be contiguous (N, d) float32, got {points.dtype} {tuple(points.shape)}")
    n, d = points.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel supports 1 <= d <= {MAX_D}, got d={d}")
    if n >= 2**31:
        raise ValueError(f"the kernel indexes rows with int32, got N={n}")
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    if valid.device != points.device or valid.dtype != torch.bool or valid.shape != (n,) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous (N,) bool tensor on the points' device")
    out = torch.empty((n,), dtype=torch.bool, device=points.device)
    lib = _lib()
    err = lib.nd_mask_launch(
        points.data_ptr(),
        valid.data_ptr(),
        out.data_ptr(),
        n,
        d,
        0 if keep_duplicates else 1,
        points.device.index if points.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(points.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pareto_nd kernel launch failed: cudaError {err}")
    non_dominated_mask_cuda.launches += 1
    return out


non_dominated_mask_cuda.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("pareto_nd")
    if lib.nd_mask_launch.argtypes is None:
        lib.nd_mask_launch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.nd_mask_launch.restype = ctypes.c_int
    return lib


def non_dominated_mask_auto(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    keep_duplicates: bool = True,
) -> torch.Tensor:
    """A CUDA tensor goes to the kernel, a CPU tensor to ``core.pareto.non_dominated_mask``.

    ``DeviceParetoFront.add`` and ``evaluation.device_front_metrics`` prune
    through here.  The kernel takes contiguous float32; other inputs are
    converted first.
    """
    if points.device.type == "cuda":
        points = points.to(torch.float32).contiguous()
        if valid is not None:
            valid = valid.to(torch.bool).contiguous()
        return non_dominated_mask_cuda(points, valid, keep_duplicates)
    return non_dominated_mask(points, valid, keep_duplicates)
