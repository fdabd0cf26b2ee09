"""Pareto non-dominated mask: hand-written CUDA kernel, its plain version, dispatch.

The kernel (``csrc/pareto_nd.cu``) replaces the Pallas TPU kernel
``morl_baselines_tpu/ops/pareto_kernel.py::_nd_kernel`` (reached through
``non_dominated_mask_pallas``).  It computes the same mask: row i is dominated
if some valid row j is >= in every objective and > in at least one, or, with
``keep_duplicates=False``, if a valid row j < i is an exact duplicate; the
result is ``~dominated & valid``.  A warp owns a row tile (R rows a lane, in
registers) and one chunk of the column tiles, which it streams through a
cp.async ring in shared memory; ``nd_launch_plan`` splits every row tile's
columns into enough chunks to fill the card, and the last warp of a row tile
writes its output.  See the source for the design.

What bounds it on an H100: about (3d + 2) compare and logic operations for
each (row, column) pair the data needs (every pair, on a front) against
N (4d + 2) bytes moved, so operations.

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
import functools
from typing import NamedTuple

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


COL_TILE = 32  # columns per tile (csrc/pareto_nd.cu: COLS)
WARPS_PER_BLOCK = 4  # csrc/pareto_nd.cu: MAX_WARPS
SINGLE_BLOCK_MAX_N = 256  # up to here one block, one chunk: no scratch, no counter
MAX_CHUNK_TILES = 64  # a chunk spans at most 2048 columns
WARPS_PER_SM = 32  # work items to aim for per SM


class NDPlan(NamedTuple):
    """A launch of the kernel: ``row_tiles * n_chunks`` work items, one per warp.
    Item g (the warp's global index) takes row tile ``g % row_tiles`` against
    the column tiles ``[c * chunk_tiles, (c + 1) * chunk_tiles)`` of chunk
    ``c = g // row_tiles``."""

    row_tile: int  # rows per warp: 32 lanes x rows_per_thread(d)
    row_tiles: int
    col_tiles: int  # of COL_TILE columns
    n_chunks: int
    chunk_tiles: int
    warps_per_block: int
    blocks: int
    scratch_ints: int  # int32 zeros: a dominated flag per row, then an arrival counter per row tile


def rows_per_thread(d: int) -> int:
    """Rows a lane keeps in registers (csrc/pareto_nd.cu: rows_per_thread)."""
    return 4 if d <= 8 else 2


@functools.lru_cache(maxsize=1024)  # the wrapper asks once per call: keep the host's share small
def nd_launch_plan(n: int, d: int, sm_count: int) -> NDPlan:
    """The kernel's launch configuration for N >= 1 points in d objectives.

    Up to ``SINGLE_BLOCK_MAX_N`` rows, one block whose warps each scan every
    column (the main path's archive adds).  Above, every row tile's columns
    are split into chunks, enough that about ``WARPS_PER_SM`` items per SM
    exist and no chunk spans more than ``MAX_CHUNK_TILES`` tiles, so that the
    few row tiles that scan every column are spread over the whole card.
    """
    row_tile = 32 * rows_per_thread(d)
    row_tiles = -(-n // row_tile)
    col_tiles = -(-n // COL_TILE)
    if n <= SINGLE_BLOCK_MAX_N:
        want = 1
    else:
        want = max(-(-sm_count * WARPS_PER_SM // row_tiles), -(-col_tiles // MAX_CHUNK_TILES))
    chunk_tiles = -(-col_tiles // min(want, col_tiles))
    n_chunks = -(-col_tiles // chunk_tiles)  # no chunk is empty
    items = row_tiles * n_chunks
    warps = min(WARPS_PER_BLOCK, items)
    blocks = -(-items // warps)
    scratch = row_tiles * row_tile + row_tiles if n_chunks > 1 else 0
    return NDPlan(row_tile, row_tiles, col_tiles, n_chunks, chunk_tiles, warps, blocks, scratch)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def non_dominated_mask_cuda(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    keep_duplicates: bool = True,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns the (N,) bool mask.

    ``points`` is a contiguous (N, d) float32 CUDA tensor with d <= 16 and
    ``valid`` a contiguous (N,) bool tensor on the same device, at an address
    that is a multiple of 4 bytes.  Every launch adds one to
    ``non_dominated_mask_cuda.launches``; N = 0 launches nothing.
    """
    if points.device.type != "cuda":
        raise ValueError(f"points must be a CUDA tensor, got {points.device}")
    if points.dtype != torch.float32 or points.dim() != 2 or not points.is_contiguous():
        raise ValueError(f"points must be contiguous (N, d) float32, got {points.dtype} {tuple(points.shape)}")
    n, d = points.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel supports 1 <= d <= {MAX_D}, got d={d}")
    if n >= 2**30:
        raise ValueError(f"the kernel indexes rows with int32, got N={n}")
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    if valid.device != points.device or valid.dtype != torch.bool or valid.shape != (n,) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous (N,) bool tensor on the points' device")
    if valid.data_ptr() % 4:
        raise ValueError("valid must start at a 4-byte-aligned address (the kernel copies it 4 bytes at a time)")
    out = torch.empty((n,), dtype=torch.bool, device=points.device)
    if n == 0:
        return out
    index = points.device.index if points.device.index is not None else torch.cuda.current_device()
    plan = nd_launch_plan(n, d, _sm_count(index))
    scratch = torch.zeros(plan.scratch_ints, dtype=torch.int32, device=points.device) if plan.scratch_ints else None
    err = _lib().nd_mask_launch(
        points.data_ptr(),
        valid.data_ptr(),
        out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        n,
        d,
        0 if keep_duplicates else 1,
        *plan[:7],
        index,
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
        lib.nd_mask_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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
            if valid.data_ptr() % 4:  # a view into another tensor: the kernel wants 4-byte alignment
                valid = valid.clone()
        return non_dominated_mask_cuda(points, valid, keep_duplicates)
    return non_dominated_mask(points, valid, keep_duplicates)
