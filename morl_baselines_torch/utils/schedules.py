"""Schedules and small math utilities.

PyTorch port of ``morl_baselines_tpu/utils/schedules.py`` (reference
common/utils.py:10-49).  The step of a schedule is a host integer in the port,
so the schedule is evaluated on the host, in float32 as the JAX package does.
"""

from __future__ import annotations

import numpy as np


def linearly_decaying_value(initial: float, decay_period: float, step, warmup_steps: float, final: float) -> float:
    """DQN-style linear decay (reference utils.py:10-33), computed in float32."""
    f32 = np.float32
    steps_left = f32(decay_period + warmup_steps) - f32(step)
    bonus = f32(initial - final) * steps_left / f32(decay_period)
    return float(np.clip(bonus + f32(final), f32(min(initial, final)), f32(max(initial, final))))


def unique_tol(arrays: list[np.ndarray], tol: float = 1e-4) -> list[np.ndarray]:
    """Dedup a list of vectors up to tolerance (reference utils.py:35-47)."""
    out: list[np.ndarray] = []
    for a in arrays:
        if not any(np.allclose(a, b, atol=tol) for b in out):
            out.append(np.asarray(a))
    return out


def nearest_neighbors(weights: np.ndarray, k: int) -> np.ndarray:
    """Index matrix of k nearest weight vectors (reference utils.py:71-107, MORL/D)."""
    w = np.asarray(weights)
    d = np.linalg.norm(w[:, None, :] - w[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=-1)[:, :k]
