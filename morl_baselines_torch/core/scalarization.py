"""Scalarization (utility) functions u(r, w) on torch tensors, batched.

PyTorch port of ``morl_baselines_tpu/core/scalarization.py`` (reference
morl_baselines/common/scalarization.py:7-41).  The Tchebicheff utopian point
is explicit state, as in the JAX package, so a tabular agent keeps it beside
its Q-table.
"""

from __future__ import annotations

import torch


def weighted_sum(reward: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w·r, broadcasting over leading batch dims (reference scalarization.py:7-17)."""
    return torch.sum(reward * w, dim=-1)


def tchebicheff(reward: torch.Tensor, w: torch.Tensor, utopian: torch.Tensor) -> torch.Tensor:
    """-max_i w_i * |utopian_i - r_i|  (maximization form, scalarization.py:20-41).

    A utopian entry of -inf gives -inf, or NaN where its weight is 0; both
    propagate through the max, as ``jnp.max`` does.
    """
    return -torch.max(w * torch.abs(utopian - reward), dim=-1).values


def update_utopian(utopian: torch.Tensor, reward: torch.Tensor, tau: float = 0.5) -> torch.Tensor:
    """Auto-adapting utopian point: element-wise max of seen rewards + tau.

    ``reward`` may be batched; the max runs over every leading dim
    (scalarization.py:27-38).
    """
    r_max = reward if reward.dim() == 1 else reward.reshape(-1, reward.shape[-1]).max(dim=0).values
    return torch.where(r_max > utopian, r_max + tau, utopian)
