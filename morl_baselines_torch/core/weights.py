"""Weight-vector (preference simplex) generation.

PyTorch port of ``morl_baselines_tpu/core/weights.py`` (reference
morl_baselines/common/weights.py:10-58).  Random sampling draws from an
explicit ``torch.Generator`` on the generator's device.  The deterministic
equally-spaced set is host numpy, copied from the JAX package so that its
output is bitwise the same: Riesz s-energy minimization on the simplex from a
deterministic Das–Dennis + farthest-point initialization (pymoo's "energy"
reference directions minimize the same objective).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def random_weights(
    gen: torch.Generator,
    dim: int,
    n: int | None = None,
    dist: str = "dirichlet",
    dtype=torch.float32,
) -> torch.Tensor:
    """Sample weight vectors on the positive simplex (reference weights.py:10-35).

    dist="dirichlet": flat Dirichlet (uniform on the simplex), as normalized
    Exp(1) draws.  dist="gaussian": |N(0,1)| normalized to sum 1.
    """
    shape = (dim,) if n is None else (n, dim)
    if dist == "dirichlet":
        g = torch.empty(shape, device=gen.device).exponential_(generator=gen)
    elif dist == "gaussian":
        g = torch.randn(shape, generator=gen, device=gen.device).abs()
    else:
        raise ValueError(f"unknown dist {dist!r}")
    return (g / g.sum(dim=-1, keepdim=True)).to(dtype)


@lru_cache(maxsize=32)
def _das_dennis(dim: int, n_partitions: int) -> np.ndarray:
    """All compositions of n_partitions into dim non-negative parts / n_partitions."""
    if dim == 1:
        return np.array([[1.0]])
    out = []

    def rec(prefix, remaining, slots):
        if slots == 1:
            out.append(prefix + [remaining])
            return
        for k in range(remaining + 1):
            rec(prefix + [k], remaining - k, slots - 1)

    rec([], n_partitions, dim)
    return np.asarray(out, dtype=np.float64) / float(n_partitions)


def _project_simplex(x: np.ndarray) -> np.ndarray:
    """Row-wise Euclidean projection onto the unit simplex (sort algorithm)."""
    n, d = x.shape
    u = np.sort(x, axis=-1)[:, ::-1]
    css = np.cumsum(u, axis=-1) - 1.0
    idx = np.arange(1, d + 1, dtype=np.float64)
    cond = u - css / idx > 0
    rho = d - np.argmax(cond[:, ::-1], axis=-1) - 1  # last True per row
    theta = css[np.arange(n), rho] / (rho + 1.0)
    return np.maximum(x - theta[:, None], 0.0)


def _riesz_energy_minimize(pts: np.ndarray, s: float, iters: int = 3000) -> np.ndarray:
    """Minimize the Riesz s-energy sum_{i<j} 1/d_ij^s of a point set on the
    simplex by projected gradient descent with per-point normalized steps."""
    x = pts.astype(np.float64).copy()
    n = len(x)
    if n < 2:
        return x
    # step sizes relative to the target spacing ~ diameter / n^(1/(d-1))
    base = 0.2 * np.sqrt(2.0) / max(n - 1, 1) if x.shape[1] == 2 else 0.2 / n ** (1.0 / max(x.shape[1] - 1, 1))
    for t in range(iters):
        diff = x[:, None, :] - x[None, :, :]
        d2 = np.einsum("ijk,ijk->ij", diff, diff)
        np.fill_diagonal(d2, np.inf)
        # dE/dx_i = -s * sum_j d_ij^{-(s+2)} (x_i - x_j); descend => push apart
        coef = d2 ** (-(s + 2.0) / 2.0)
        grad = -(coef[:, :, None] * diff).sum(axis=1)
        grad -= grad.mean(axis=-1, keepdims=True)  # stay in the simplex plane
        gnorm = np.sqrt((grad**2).sum(axis=-1, keepdims=True)) + 1e-30
        lr = base * (1.0 - t / iters)
        x = _project_simplex(x - lr * grad / gnorm)
    return x


@lru_cache(maxsize=32)
def equally_spaced_weights(dim: int, n: int, seed: int = 42) -> np.ndarray:
    """~n equally spaced weights on the simplex (reference weights.py:38-49).

    Host-side and lru_cached (callers must not write into the result); fully
    deterministic for a given (dim, n).  ``seed`` is kept for API parity.
    """
    p = 1
    while len(_das_dennis(dim, p)) < n:
        p += 1
    pts = _das_dennis(dim, p)
    if len(pts) != n:
        # farthest-point subsample, starting at the first extremum
        chosen = [0]
        d2 = np.sum((pts - pts[0]) ** 2, axis=-1)
        for _ in range(n - 1):
            nxt = int(np.argmax(d2))
            chosen.append(nxt)
            d2 = np.minimum(d2, np.sum((pts - pts[nxt]) ** 2, axis=-1))
        pts = pts[np.sort(np.asarray(chosen))]
    return _riesz_energy_minimize(pts, s=float(dim * dim), iters=3000)


def extrema_weights(dim: int) -> np.ndarray:
    """The dim one-hot corner weights (reference weights.py:52-58)."""
    return np.eye(dim, dtype=np.float64)
