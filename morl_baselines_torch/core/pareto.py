"""Batched Pareto-dominance operations on torch tensors.

PyTorch port of ``morl_baselines_tpu/core/pareto.py``.  Convention:
**maximization** everywhere.  Dynamic-size point sets are a fixed-capacity
``(N, d)`` tensor plus a boolean ``valid`` mask of shape ``(N,)``.

The host helpers (``filter_pareto_dominated``, ``get_non_dominated_inds``)
compare in float32, as the JAX package does with x64 off.
"""

from __future__ import annotations

import numpy as np
import torch


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


def filter_pareto_dominated(points: np.ndarray, keep_duplicates: bool = True) -> np.ndarray:
    """Host-side compacting filter (reference pareto.py:60-73 semantics)."""
    points = np.asarray(points)
    if len(points) == 0:
        return points
    mask = non_dominated_mask(torch.as_tensor(points, dtype=torch.float32), keep_duplicates=keep_duplicates)
    return points[mask.numpy()]


def get_non_dominated_inds(points: np.ndarray) -> np.ndarray:
    """Indices of non-dominated rows, host-side (reference pareto.py:128-146)."""
    mask = non_dominated_mask(torch.as_tensor(np.asarray(points), dtype=torch.float32))
    return np.flatnonzero(mask.numpy())
