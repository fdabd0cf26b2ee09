"""Water Reservoir (dam control) — batched torch continuous MO env.

PyTorch port of ``morl_baselines_tpu/envs/water_reservoir.py``, the
companion of MO-Gymnasium's ``water-reservoir-v0``: a dam with stochastic
inflows whose action releases water each day.  Two objectives,

    r = [ -flooding excess   (storage above the flooding threshold),
          -demand deficit    (release short of the downstream demand) ]

Dynamics: s' = s + inflow - release, inflow ~ N(40, 10) truncated at 0,
release clipped to [0, s + inflow]; demand 50, flooding threshold 100,
100-day episodes, uniform initial storage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import Box, MOEnv, StepOut

_DEMAND = 50.0
_FLOOD = 100.0
_INFLOW_MEAN = 40.0
_INFLOW_STD = 10.0
_S_MAX = 200.0


class DamState(NamedTuple):
    storage: torch.Tensor  # (N,)
    t: torch.Tensor  # (N,) int32


class WaterReservoir(MOEnv):
    """Action in [-1, 1], mapped to a release fraction in [0, 1] of _S_MAX per day."""

    reward_dim = 2
    name = "water-reservoir-v0"

    def __init__(self, max_episode_steps: int = 100):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(0.0,), high=(2.0 * _S_MAX,))
        self.action_space = Box(low=(-1.0,), high=(1.0,))

    def _obs(self, s: DamState) -> torch.Tensor:
        return s.storage[:, None]

    def reset(self, n: int, gen: torch.Generator):
        s0 = torch.rand((n,), generator=gen, device=gen.device) * (_S_MAX * 0.8)
        s = DamState(s0, torch.zeros((n,), dtype=torch.int32, device=gen.device))
        return s, self._obs(s)

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """(n,) standard normals for the inflow."""
        return torch.randn((n,), generator=gen, device=gen.device)

    def step(self, state: DamState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        a = torch.clamp(action.to(torch.float32).reshape(-1), -1.0, 1.0)
        release_frac = (a + 1.0) / 2.0
        inflow = torch.clamp(_INFLOW_MEAN + _INFLOW_STD * noise, min=0.0)
        available = state.storage + inflow
        release = torch.minimum(torch.clamp(release_frac * _S_MAX, min=0.0), available)
        storage = torch.clamp(available - release, 0.0, _S_MAX * 2.0)
        reward = torch.stack(
            [-torch.clamp(storage - _FLOOD, min=0.0), -torch.clamp(_DEMAND - release, min=0.0)], dim=1
        )
        t = state.t + 1
        new = DamState(storage, t)
        done = torch.zeros_like(t, dtype=torch.bool)
        return StepOut(new, self._obs(new), reward, done, t >= self.max_episode_steps)
