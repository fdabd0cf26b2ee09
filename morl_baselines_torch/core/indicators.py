"""MORL performance indicators — batched torch ops plus an exact host path.

PyTorch port of ``morl_baselines_tpu/core/indicators.py`` (reference
morl_baselines/common/performance_indicators.py:15-128):

- ``hypervolume_2d`` / ``hypervolume_3d``: exact sort-and-sweep on the
  tensor's device; ``hypervolume_small_exact`` (inclusion–exclusion, any d,
  N <= 20) and ``hypervolume_mc`` (Monte-Carlo, any d) for PQL's action
  sets; ``hypervolume``: exact WFG on the host, by the native C++ library
  (``utils/native.py``), the port's own numpy copy beyond 64 objectives.
- ``expected_utility`` (EUM), ``maximum_utility_loss`` (MUL),
  ``cardinality``, ``igd``, ``sparsity``: tensor reductions over
  (front, weights).

Maximization throughout; dynamic fronts are (N, d) + valid mask.  Inputs are
cast to float32, as the JAX package computes them with x64 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import native
from .pareto import non_dominated_mask


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Hypervolume
# ---------------------------------------------------------------------------


def hypervolume_2d(front, ref_point, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact 2-objective hypervolume on the front's device.

    Clips points to the ref box, collapses dominated/invalid points onto the
    ref point (zero contribution), sorts by the first objective, and sums the
    staircase area.  ``front`` (..., N, 2) and ``valid`` (..., N) broadcast
    over their leading dims: one HV per set.
    """
    front = _f32(front)
    ref = _f32(ref_point, front.device)
    if valid is None:
        valid = torch.ones(front.shape[:-1], dtype=torch.bool, device=front.device)
    nd = non_dominated_mask(front, valid)
    pts = torch.where(nd[..., None], torch.maximum(front, ref), ref)
    order = torch.argsort(pts[..., 0], dim=-1, stable=True)
    x = torch.gather(pts[..., 0], -1, order)
    y = torch.gather(pts[..., 1], -1, order)
    # sorted by x ascending, non-dominated points have y descending; guard
    # duplicates in x with the running max of y from the right
    y_rightmax = torch.cummax(y.flip(-1), dim=-1).values.flip(-1)
    x_prev = torch.cat([ref[0].expand(*x.shape[:-1], 1), x[..., :-1]], dim=-1)
    area = (x - x_prev) * (y_rightmax - ref[1])
    return torch.clamp(area, min=0.0).sum(dim=-1)


def hypervolume_3d(front, ref_point, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact 3-objective hypervolume on the front's device.

    Slab sweep over the third objective: sort points by obj-2 descending; the
    slab between consecutive z-values contributes (z_i - z_next) times the 2-D
    hypervolume of the points at or above that z (a prefix of the order), all
    N staircases in one batched ``hypervolume_2d``.  ``front`` (..., N, 3) and
    ``valid`` (..., N) broadcast over their leading dims: one HV per set.
    """
    front = _f32(front)
    ref = _f32(ref_point, front.device)
    n = front.shape[-2]
    if valid is None:
        valid = torch.ones(front.shape[:-1], dtype=torch.bool, device=front.device)
    # collapse invalid points onto ref: zero volume, sorted last
    pts = torch.where(valid[..., None], torch.maximum(front, ref), ref)
    order = torch.argsort(-pts[..., 2], dim=-1, stable=True)
    pts = torch.gather(pts, -2, order[..., None].expand(*order.shape, 3))
    z = pts[..., 2]
    z_next = torch.cat([z[..., 1:], ref[2].expand(*z.shape[:-1], 1)], dim=-1)
    idx = torch.arange(n, device=front.device)
    prefix = idx[None, :] <= idx[:, None]  # (i, j): j in the prefix of i
    hv2 = hypervolume_2d(pts[..., None, :, :2], ref[:2], prefix)  # (..., N)
    return torch.sum(torch.clamp(z - z_next, min=0.0) * hv2, dim=-1)


def hypervolume_small_exact(front, ref_point, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact hypervolume at any d for small N (N <= 20), on the front's device.

    Inclusion–exclusion over the union of boxes [ref, p_i]:
        HV = Σ_{∅≠S⊆points} (−1)^{|S|+1} · vol([ref, min_{i∈S} p_i])
    as one dense (2^N − 1, N) subset-mask computation.  Invalid points
    collapse onto the ref (an empty box in every subset holding them).
    ``front`` may be (..., N, d) with ``valid`` (..., N): one HV per set.
    """
    front = _f32(front)
    ref = _f32(ref_point, front.device)
    n = front.shape[-2]
    if n > 20:
        raise ValueError(f"inclusion-exclusion HV is for small capacity-bounded sets, got N={n}")
    if valid is None:
        valid = torch.ones(front.shape[:-1], dtype=torch.bool, device=front.device)
    pts = torch.where(valid[..., None], torch.maximum(front, ref), ref)
    subsets = torch.arange(1, 2**n, device=front.device)
    member = ((subsets[:, None] >> torch.arange(n, device=front.device)[None, :]) & 1).bool()  # (2^n-1, n)
    # min over the selected points per dim; non-members at +inf
    sel = torch.where(member[:, :, None], pts[..., None, :, :], torch.inf)
    mins = torch.min(sel, dim=-2).values  # (..., 2^n-1, d)
    vols = torch.prod(torch.clamp(mins - ref, min=0.0), dim=-1)
    sign = torch.where(member.sum(dim=1) % 2 == 1, 1.0, -1.0)
    return torch.sum(sign * vols, dim=-1)


def hypervolume_mc(
    front, ref_point, gen: torch.Generator, valid: torch.Tensor | None = None, n_samples: int = 16384
) -> torch.Tensor:
    """Monte-Carlo hypervolume estimate at any d, on the front's device.

    Samples uniformly in the bounding box [ref, max(front)] and measures the
    dominated fraction.  ``front`` may be (..., N, d) with ``valid`` (..., N);
    every set is measured with the same uniforms (common random numbers),
    drawn from ``gen`` on the front's device.
    """
    front = _f32(front)
    ref = _f32(ref_point, front.device)
    if valid is None:
        valid = torch.ones(front.shape[:-1], dtype=torch.bool, device=front.device)
    pts = torch.where(valid[..., None], torch.maximum(front, ref), ref)
    hi = torch.max(pts, dim=-2).values  # (..., d)
    box = torch.prod(torch.clamp(hi - ref, min=0.0), dim=-1)
    u = torch.rand((n_samples, front.shape[-1]), generator=gen, device=front.device)
    samples = ref + u * (hi - ref)[..., None, :]  # (..., S, d)
    # sample s is covered iff some valid point p >= s
    ge = torch.all(pts[..., None, :, :] >= samples[..., :, None, :], dim=-1)  # (..., S, N)
    covered = torch.any(ge & valid[..., None, :], dim=-1)
    return box * torch.mean(covered.to(torch.float32), dim=-1)


def _hv_wfg(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact hypervolume, host numpy, WFG exclusive-volume recursion.

    Maximization: volume of the union of boxes [ref, p].  Fine for fronts up
    to a few hundred points, d <= ~7.
    """
    pts = np.asarray(points, dtype=np.float64)
    pts = np.maximum(pts, ref)
    # drop points that add no volume
    pts = pts[np.all(pts > ref, axis=-1)]
    if len(pts) == 0:
        return 0.0
    # sort by first objective descending helps the limit-prune
    pts = pts[np.argsort(-pts[:, 0])]

    def prune(p: np.ndarray) -> np.ndarray:
        if len(p) <= 1:
            return p
        keep = np.ones(len(p), dtype=bool)
        earlier = np.arange(len(p))
        for i in range(len(p)):
            if not keep[i]:
                continue
            # an earlier exact copy counts as dominating: a copy adds no volume, but each
            # one kept doubles the recursion below it
            dom = np.all(p >= p[i], axis=-1) & (np.any(p > p[i], axis=-1) | (earlier < i))
            dom[~keep] = False
            if dom.any():
                keep[i] = False
        return p[keep]

    def hv(p: np.ndarray) -> float:
        if len(p) == 0:
            return 0.0
        if len(p) == 1:
            return float(np.prod(p[0] - ref))
        if p.shape[1] == 2:
            # exact 2-D staircase
            q = p[np.argsort(-p[:, 0])]
            total, ymax = 0.0, ref[1]
            for x, y in q:
                if y > ymax:
                    total += (x - ref[0]) * (y - ymax)
                    ymax = y
            return float(total)
        total = 0.0
        for i in range(len(p)):
            vol = float(np.prod(p[i] - ref))
            rest = np.minimum(p[i + 1 :], p[i])
            rest = rest[np.all(rest > ref, axis=-1)]
            total += vol - hv(prune(rest))
        return total

    return hv(prune(pts))


def hypervolume(front, ref_point, valid=None) -> float:
    """Exact hypervolume on the host (reference performance_indicators.py:15).

    Accepts numpy arrays or tensors; applies the valid mask.  The native C++
    WFG (``utils/native.py``) computes it, as in the JAX package; the Python
    WFG only where the library refuses (more than 64 objectives).
    """
    if isinstance(front, torch.Tensor):
        front = front.detach().cpu().numpy()
    if isinstance(valid, torch.Tensor):
        valid = valid.detach().cpu().numpy()
    front = np.asarray(front, dtype=np.float64)
    ref = np.asarray(ref_point, dtype=np.float64)
    if valid is not None:
        front = front[np.asarray(valid)]
    if len(front) == 0:
        return 0.0
    out = native.hv_exact(front, ref)
    return _hv_wfg(front, ref) if out is None else out


# ---------------------------------------------------------------------------
# Utility-based indicators
# ---------------------------------------------------------------------------


def expected_utility(front, weights, valid: torch.Tensor | None = None) -> torch.Tensor:
    """EUM: mean over weights of max over front of w·v (reference :71-91)."""
    front = _f32(front)
    weights = _f32(weights, front.device)
    scal = weights @ front.T  # (W, N)
    if valid is not None:
        scal = torch.where(valid[None, :], scal, -torch.inf)
    return torch.mean(torch.max(scal, dim=-1).values)


def maximum_utility_loss(front, reference_front, weights, valid: torch.Tensor | None = None) -> torch.Tensor:
    """MUL: max over weights of (best ref-front utility − best front utility).

    Reference performance_indicators.py:108-128.
    """
    front = _f32(front)
    ref_front = _f32(reference_front, front.device)
    weights = _f32(weights, front.device)
    best = torch.max(weights @ ref_front.T, dim=-1).values
    scal = weights @ front.T
    if valid is not None:
        scal = torch.where(valid[None, :], scal, -torch.inf)
    got = torch.max(scal, dim=-1).values
    return torch.max(best - got)


def cardinality(front, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Number of (valid, non-dominated) points (reference :94-105)."""
    return torch.sum(non_dominated_mask(_f32(front), valid)).to(torch.float32)


def igd(front, reference_front, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted generational distance (reference :28-39): mean over reference
    points of the distance to the nearest front point."""
    front = _f32(front)
    ref_front = _f32(reference_front, front.device)
    d2 = torch.sum((ref_front[:, None, :] - front[None, :, :]) ** 2, dim=-1)
    if valid is not None:
        d2 = torch.where(valid[None, :], d2, torch.inf)
    return torch.mean(torch.sqrt(torch.min(d2, dim=-1).values))


def sparsity(front, valid: torch.Tensor | None = None) -> torch.Tensor:
    """PGMORL sparsity metric (reference :42-68): mean squared gap between
    consecutive sorted values per objective.  Invalid rows collapse onto the
    per-objective min and the sum is divided by (valid count - 1)."""
    front = _f32(front)
    n = front.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=front.device)
    m = torch.sum(valid)
    lo = torch.min(torch.where(valid[:, None], front, torch.inf), dim=0).values
    pts = torch.where(valid[:, None], front, lo[None, :])
    srt = torch.sort(pts, dim=0).values
    gaps = torch.sum((srt[1:] - srt[:-1]) ** 2)
    return torch.where(m > 1, gaps / (m - 1).clamp(min=1), torch.zeros((), device=front.device))
