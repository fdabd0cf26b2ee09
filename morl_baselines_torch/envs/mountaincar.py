"""MO Mountain Car (discrete, 3 objectives) and continuous (2 objectives), batched on torch.

PyTorch port of ``morl_baselines_tpu/envs/mountaincar.py``, the counterparts
of MO-Gymnasium's ``mo-mountaincar-v0`` (objectives: time penalty, reverse
penalty, forward penalty) and ``mo-mountaincarcontinuous-v0`` (time/goal,
fuel penalty).  Classic Moore dynamics as branch-free tensor ops; both are
deterministic given the action.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import Box, Discrete, MOEnv, StepOut


class MCState(NamedTuple):
    position: torch.Tensor  # (N,)
    velocity: torch.Tensor  # (N,)
    t: torch.Tensor  # (N,) int32


def _reset(n: int, gen: torch.Generator) -> MCState:
    dev = gen.device
    pos = -0.6 + 0.2 * torch.rand((n,), generator=gen, device=dev)
    return MCState(pos, torch.zeros((n,), device=dev), torch.zeros((n,), dtype=torch.int32, device=dev))


def _obs(s: MCState) -> torch.Tensor:
    return torch.stack([s.position, s.velocity], dim=1)


def _move(state: MCState, push: torch.Tensor):
    """One Moore step under the force term ``push``: (position, velocity)."""
    velocity = torch.clamp(state.velocity + push + torch.cos(3.0 * state.position) * (-0.0025), -0.07, 0.07)
    position = torch.clamp(state.position + velocity, -1.2, 0.6)
    velocity = torch.where((position <= -1.2) & (velocity < 0), 0.0, velocity)
    return position, velocity


class MOMountainCar(MOEnv):
    """Discrete 3-action mountain car; rewards (time, reverse, forward) all in {-1, 0}."""

    reward_dim = 3
    name = "mo-mountaincar-v0"

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(-1.2, -0.07), high=(0.6, 0.07))
        self.action_space = Discrete(3)

    def reset(self, n: int, gen: torch.Generator):
        s = _reset(n, gen)
        return s, _obs(s)

    def step(self, state: MCState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        action = action.to(torch.int32)
        position, velocity = _move(state, (action.to(torch.float32) - 1.0) * 0.001)
        terminated = (position >= 0.5) & (velocity >= 0.0)
        reward = torch.stack(
            [
                torch.full_like(position, -1.0),  # time penalty
                torch.where(action == 0, -1.0, 0.0),  # reverse penalty
                torch.where(action == 2, -1.0, 0.0),  # forward penalty
            ],
            dim=1,
        )
        t = state.t + 1
        new = MCState(position, velocity, t)
        return StepOut(new, _obs(new), reward, terminated, t >= self.max_episode_steps)


class MOMountainCarContinuous(MOEnv):
    """Continuous-force mountain car; rewards (time/goal, fuel penalty)."""

    reward_dim = 2
    name = "mo-mountaincarcontinuous-v0"

    def __init__(self, max_episode_steps: int = 999):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(-1.2, -0.07), high=(0.6, 0.07))
        self.action_space = Box(low=(-1.0,), high=(1.0,))

    def reset(self, n: int, gen: torch.Generator):
        s = _reset(n, gen)
        return s, _obs(s)

    def step(self, state: MCState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        force = torch.clamp(action.to(torch.float32).reshape(-1), -1.0, 1.0)
        position, velocity = _move(state, force * 0.0015)
        terminated = (position >= 0.45) & (velocity >= 0.0)
        reward = torch.stack([torch.where(terminated, 100.0, -1.0), -0.1 * force * force], dim=1)
        t = state.t + 1
        new = MCState(position, velocity, t)
        return StepOut(new, _obs(new), reward, terminated, t >= self.max_episode_steps)
