"""Fishwood — batched torch ESR micro-env (2 objectives: fish, wood).

PyTorch port of ``morl_baselines_tpu/envs/fishwood.py``, the counterpart of
MO-Gymnasium's ``fishwood-v0`` (Roijers et al., 2018).  The agent is at the
river (0) or in the woods (1); the action chooses where to be this step; at
the river it catches a fish w.p. ``fish_proba`` -> reward (1, 0), in the
woods it gathers wood w.p. ``wood_proba`` -> (0, 1).  Episodes last
``max_episode_steps`` (200).  The canonical ESR utility is
min(fish, wood // 2) applied to the *episode return*.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import Box, Discrete, MOEnv, StepOut


class FishwoodState(NamedTuple):
    location: torch.Tensor  # (N,) int32: 0 river, 1 woods
    t: torch.Tensor  # (N,) int32


class Fishwood(MOEnv):
    reward_dim = 2
    name = "fishwood-v0"
    num_states = 2

    def __init__(self, fish_proba: float = 0.25, wood_proba: float = 0.65, max_episode_steps: int = 200):
        self.fish_proba = fish_proba
        self.wood_proba = wood_proba
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(0.0,), high=(1.0,))
        self.action_space = Discrete(2)

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        return obs[..., 0].long()

    def reset(self, n: int, gen: torch.Generator):
        state = FishwoodState(
            torch.ones((n,), dtype=torch.int32, device=gen.device), torch.zeros((n,), dtype=torch.int32, device=gen.device)
        )
        return state, state.location.to(torch.float32)[:, None]

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """One uniform per env: the catch draw (``jax.random.uniform(key)``, fishwood.py:52)."""
        return torch.rand((n,), generator=gen, device=gen.device)

    def step(self, state: FishwoodState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        loc = action.to(torch.int32)  # act = destination
        river = loc == 0
        p = torch.where(river, self.fish_proba, self.wood_proba)
        success = (noise < p).to(torch.float32)
        reward = torch.stack([torch.where(river, success, 0.0), torch.where(loc == 1, success, 0.0)], dim=-1)
        t = state.t + 1
        return StepOut(
            FishwoodState(loc, t),
            loc.to(torch.float32)[:, None],
            reward,
            torch.zeros_like(river),
            t >= self.max_episode_steps,
        )


def fishwood_utility(vec_return: torch.Tensor) -> torch.Tensor:
    """ESR utility min(fish, wood // 2) (reference examples/eupg_fishwood.py:15-22)."""
    return torch.minimum(vec_return[..., 0], torch.div(vec_return[..., 1], 2.0, rounding_mode="floor"))
