"""Batched Pareto-dominance operations on torch tensors.

PyTorch port of ``morl_baselines_tpu/core/pareto.py``.  Convention:
**maximization** everywhere.  Dynamic-size point sets are a fixed-capacity
``(N, d)`` tensor plus a boolean ``valid`` mask of shape ``(N,)``.

The host helpers (``filter_pareto_dominated``, ``get_non_dominated_inds``)
compare in float32, as the JAX package does with x64 off, except where
``filter_pareto_dominated`` hands a large archive to the native mask, which
compares in float64, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import native


def pareto_dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True iff ``a`` Pareto-dominates ``b`` (>= everywhere, > somewhere);
    broadcasts over leading dims."""
    return torch.all(a >= b, dim=-1) & torch.any(a > b, dim=-1)


def strict_pareto_dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True iff ``a`` > ``b`` in every objective (reference pareto.py:29-31)."""
    return torch.all(a > b, dim=-1)


def batched_pareto_dominates(a: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``pareto_dominates(a, p)`` for each row p of ``points``."""
    return pareto_dominates(a[None, :], points)


def lorenz_vector(points: torch.Tensor, lmbda: float = 1.0) -> torch.Tensor:
    """Lorenz transform: cumulative sum of the ascending-sorted objectives.

    x Lorenz-dominates y iff lorenz(x) Pareto-dominates lorenz(y) (LCN,
    reference lcn.py:26-45); ``lmbda`` < 1 interpolates toward the plain
    objectives: ``lmbda * lorenz + (1 - lmbda) * points``.
    """
    lz = torch.cumsum(torch.sort(points, dim=-1).values, dim=-1)
    return lmbda * lz + (1.0 - lmbda) * points


def lorenz_dominates(a: torch.Tensor, b: torch.Tensor, lmbda: float = 1.0) -> torch.Tensor:
    return pareto_dominates(lorenz_vector(a, lmbda), lorenz_vector(b, lmbda))


def non_dominated_mask(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    keep_duplicates: bool = True,
) -> torch.Tensor:
    """Boolean mask of Pareto-non-dominated rows of ``points``.

    The plain O(N^2 d) pairwise comparison, materializing (N, N) masks.
    ``points`` may be (..., N, d), one set per leading index, and ``valid``
    may carry leading batch dimensions (..., N) over either; invalid rows are
    absent and always reported dominated.  ``keep_duplicates=False`` keeps only
    the first valid occurrence of each group of exact duplicates.

    Returns (..., N) bool, True where the row is valid and non-dominated.
    """
    n = points.shape[-2]
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    # dom[i, j] = point i dominates point j
    a, b = points[..., :, None, :], points[..., None, :, :]
    ge = torch.all(a >= b, dim=-1)
    gt = torch.any(a > b, dim=-1)
    dom = ge & gt & valid[..., :, None]
    mask = valid & ~torch.any(dom, dim=-2)
    if not keep_duplicates:
        eq = torch.all(a == b, dim=-1)
        eq = eq & valid[..., :, None] & valid[..., None, :]
        # first valid occurrence of each duplicate group survives: lowest i with eq[i, j]
        first = torch.argmax(eq.to(torch.uint8), dim=-2)
        mask = mask & (first == torch.arange(n, device=points.device))
    return mask


def non_dominated_count(points: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Number of non-dominated rows (cardinality, a 0-d tensor on the points' device)."""
    return torch.sum(non_dominated_mask(points, valid))


def filter_pareto_dominated(points: np.ndarray, keep_duplicates: bool = True) -> np.ndarray:
    """Host-side compacting filter (reference pareto.py:60-73 semantics).

    Archives of 256 rows or more with duplicates kept go through the native
    O(N^2 d) mask (``utils/native.py``, float64), as in the JAX package.
    """
    points = np.asarray(points)
    if len(points) == 0:
        return points
    if keep_duplicates and len(points) >= 256:
        return points[native.pareto_mask(points)]
    mask = non_dominated_mask(torch.as_tensor(points, dtype=torch.float32), keep_duplicates=keep_duplicates)
    return points[mask.numpy()]


def filter_convex_dominated(points: np.ndarray) -> np.ndarray:
    """Keep only the points of the convex coverage set (CCS).

    A point is convex-dominated iff some convex combination of the other
    non-dominated points weakly dominates it (by 1e-9); one scipy ``linprog``
    feasibility problem per point decides it, as in the JAX package (the
    reference uses scipy's ConvexHull, pareto.py:76-93).
    """
    from scipy.optimize import linprog

    points = np.asarray(points, dtype=np.float64)
    nd = filter_pareto_dominated(points, keep_duplicates=False)
    n = nd.shape[0]
    if n <= 2:
        return nd
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        others = nd[np.arange(n) != i]
        # alpha >= 0, sum alpha = 1, others^T alpha >= nd[i] + 1e-9 feasible -> convex-dominated
        res = linprog(
            c=np.zeros(n - 1),
            A_ub=-others.T,
            b_ub=-nd[i] - 1e-9,
            A_eq=np.ones((1, n - 1)),
            b_eq=np.array([1.0]),
            bounds=[(0, 1)] * (n - 1),
            method="highs",
        )
        keep[i] = res.status != 0
    return nd[keep]


def get_non_dominated_inds(points: np.ndarray) -> np.ndarray:
    """Indices of non-dominated rows, host-side (reference pareto.py:128-146)."""
    mask = non_dominated_mask(torch.as_tensor(np.asarray(points), dtype=torch.float32))
    return np.flatnonzero(mask.numpy())
