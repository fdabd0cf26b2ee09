"""Fruit Tree Navigation — batched torch MO env (6 objectives).

PyTorch port of ``morl_baselines_tpu/envs/fruit_tree.py``, the counterpart of
MO-Gymnasium's ``fruit-tree-v0`` (Yang et al., 2019).  A full binary tree of
depth ``depth`` (5, 6 or 7); from the root the agent goes left (0) or right
(1) each step; each leaf holds a 6-dim nutrient vector, the reward on arrival
there, zeros elsewhere.  The leaf table is drawn from a fixed seed on the
positive part of the unit 6-sphere, scaled by 10 (the port's own copy of
``_make_fruits``, numpy).

``pareto_front(gamma)`` is exact: every policy reaches one leaf after
``depth`` steps and earns its vector discounted by ``gamma**(depth-1)``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut


@lru_cache(maxsize=8)
def _make_fruits(depth: int, seed: int = 7) -> np.ndarray:
    """(2**depth, 6) leaf rewards on the positive unit 6-sphere, scaled x10."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(2**depth, 6))) + 1e-3
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return (10.0 * x).astype(np.float32)


class FruitTreeState(NamedTuple):
    level: torch.Tensor  # (N,) int32 in [0, depth] (and beyond, if stepped after the leaf)
    index: torch.Tensor  # (N,) int32 node index within the level


class FruitTree(MOEnv):
    reward_dim = 6
    name = "fruit-tree-v0"

    def __init__(self, depth: int = 6):
        if depth not in (5, 6, 7):
            raise ValueError(f"depth must be 5, 6 or 7, got {depth}")
        self.depth = depth
        self.max_episode_steps = depth
        self.observation_space = Box(low=(0.0, 0.0), high=(float(depth), float(2**depth - 1)))
        self.action_space = Discrete(2)
        self._fruits: dict[torch.device, torch.Tensor] = {}

    @property
    def num_states(self) -> int:  # nodes of the full binary tree
        return 2 ** (self.depth + 1) - 1

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        return (2.0 ** obs[..., 0] - 1.0 + obs[..., 1]).long()

    def _table(self, device: torch.device) -> torch.Tensor:
        if device not in self._fruits:
            self._fruits[device] = torch.as_tensor(_make_fruits(self.depth), device=device)
        return self._fruits[device]

    @staticmethod
    def _obs(state: FruitTreeState) -> torch.Tensor:
        return torch.stack([state.level, state.index], dim=-1).to(torch.float32)

    def reset(self, n: int, gen: torch.Generator):
        z = torch.zeros((n,), dtype=torch.int32, device=gen.device)
        state = FruitTreeState(z, z.clone())
        return state, self._obs(state)

    def step(self, state: FruitTreeState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        fruits = self._table(state.level.device)
        level = state.level + 1
        index = state.index * 2 + action.to(torch.int32)
        at_leaf = level >= self.depth
        leaf = fruits[torch.clamp(index, 0, 2**self.depth - 1).long()]
        reward = torch.where(at_leaf[:, None], leaf, 0.0)
        new_state = FruitTreeState(level, index)
        return StepOut(new_state, self._obs(new_state), reward, at_leaf, torch.zeros_like(at_leaf))

    def pareto_front(self, gamma: float) -> np.ndarray:
        from ..core.pareto import filter_pareto_dominated

        fruits = np.asarray(_make_fruits(self.depth), dtype=np.float64) * gamma ** (self.depth - 1)
        return filter_pareto_dominated(fruits, keep_duplicates=False)
