"""Inputs the benchmark makes from ``--seed`` and hands to the program and the reference alike."""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def derive(seed: int, salt: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed (splitmix64)."""
    z = (seed + 0x9E3779B97F4A7C15 * (salt + 1)) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def make_params(shapes: dict, seed: int, device) -> dict:
    """Q-net leaves from one normal draw on ``device``: kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2), all float32."""
    gen = torch.Generator(device).manual_seed(derive(seed, 0))
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    z = torch.randn((total,), generator=gen, device=device)
    out, off = {}, 0
    for name, (shape, fan_in) in shapes.items():
        k = math.prod(shape)
        x = z[off : off + k].view(shape)
        off += k
        if fan_in == "scale":
            out[name] = 1.0 + 0.1 * x
        elif fan_in is None:
            out[name] = 0.1 * x
        else:
            out[name] = x / math.sqrt(fan_in)
    return out


def support_weights(dim: int, m: int, seed: int) -> np.ndarray:
    """A full weight support of ``m`` rows: the ``dim`` corners, then flat
    Dirichlet draws at least 1e-3 apart from every earlier row (float32)."""
    rng = np.random.default_rng(derive(seed, 1))
    rows = list(np.eye(dim, dtype=np.float32))
    while len(rows) < m:
        w = rng.dirichlet(np.ones(dim)).astype(np.float32)
        if min(np.abs(w - r).max() for r in rows) > 1e-3:
            rows.append(w)
    return np.stack(rows[:m])
