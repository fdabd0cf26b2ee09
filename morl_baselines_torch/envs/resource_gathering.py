"""Resource Gathering — batched torch MO env (3 objectives: enemy, gold, gem).

PyTorch port of ``morl_baselines_tpu/envs/resource_gathering.py``, the
counterpart of MO-Gymnasium's ``resource-gathering-v0`` (Barrett &
Narayanan, 2008), one of the reference's known-Pareto-front envs.  5x5
grid; the agent starts at home (4, 2), can pick up gold at (0, 2) and a gem
at (1, 4); enemy cells (0, 3) and (2, 2) attack with probability 0.1,
sending the agent home empty-handed with reward (-1, 0, 0) and ending the
episode; returning home with resources gives (0, gold, gem) and ends it.
The attack draw of a step is ``sample_noise``'s (n,) uniforms.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut

_HOME = (4, 2)
_GOLD = (0, 2)
_GEM = (1, 4)
_ENEMIES = ((0, 3), (2, 2))
# 0=up 1=down 2=left 3=right
_DROW = np.array([-1, 1, 0, 0], dtype=np.int32)
_DCOL = np.array([0, 0, -1, 1], dtype=np.int32)


class RGState(NamedTuple):
    row: torch.Tensor  # (N,) int32
    col: torch.Tensor
    has_gold: torch.Tensor  # (N,) bool
    has_gem: torch.Tensor
    t: torch.Tensor  # (N,) int32


class ResourceGathering(MOEnv):
    reward_dim = 3
    name = "resource-gathering-v0"
    num_states = 100  # 25 cells x 4 resource-carry combos

    def __init__(self, enemy_proba: float = 0.1, max_episode_steps: int = 100):
        self.enemy_proba = enemy_proba
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(0.0,) * 4, high=(4.0, 4.0, 1.0, 1.0))
        self.action_space = Discrete(4)
        self._consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def _moves(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        if device not in self._consts:
            self._consts[device] = (torch.as_tensor(_DROW, device=device), torch.as_tensor(_DCOL, device=device))
        return self._consts[device]

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        """(row * 5 + col) + 25 * (gold + 2 gem) of each obs (..., 4), int64."""
        cell = obs[..., 0] * 5 + obs[..., 1]
        carry = obs[..., 2] + 2.0 * obs[..., 3]
        return (cell + 25.0 * carry).long()

    def _obs(self, s: RGState) -> torch.Tensor:
        return torch.stack([s.row, s.col, s.has_gold, s.has_gem], dim=-1).to(torch.float32)

    def reset(self, n: int, gen: torch.Generator):
        dev = gen.device
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        s = RGState(
            torch.full((n,), _HOME[0], dtype=torch.int32, device=dev),
            torch.full((n,), _HOME[1], dtype=torch.int32, device=dev),
            no,
            no.clone(),
            torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        return s, self._obs(s)

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """(n,) uniforms: the attack draw (``jax.random.uniform(key)``, resource_gathering.py:77)."""
        return torch.rand((n,), generator=gen, device=gen.device)

    def step(self, state: RGState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        drow, dcol = self._moves(state.row.device)
        action = action.long().reshape(-1)
        row = torch.clamp(state.row + drow[action], 0, 4)
        col = torch.clamp(state.col + dcol[action], 0, 4)
        on_enemy = torch.zeros_like(state.has_gold)
        for er, ec in _ENEMIES:
            on_enemy = on_enemy | ((row == er) & (col == ec))
        attacked = on_enemy & (noise < self.enemy_proba)

        has_gold = state.has_gold | ((row == _GOLD[0]) & (col == _GOLD[1]))
        has_gem = state.has_gem | ((row == _GEM[0]) & (col == _GEM[1]))
        at_home = (row == _HOME[0]) & (col == _HOME[1])
        delivered = at_home & (state.has_gold | state.has_gem)

        zero = torch.zeros_like(row, dtype=torch.float32)
        carried = torch.stack([zero, state.has_gold.to(torch.float32), state.has_gem.to(torch.float32)], dim=-1)
        attack = torch.stack([zero - 1.0, zero, zero], dim=-1)
        reward = torch.where(attacked[:, None], attack, torch.where(delivered[:, None], carried, 0.0))
        # an attack sends the agent home and drops its resources
        row = torch.where(attacked, _HOME[0], row)
        col = torch.where(attacked, _HOME[1], col)
        has_gold = has_gold & ~(attacked | delivered)
        has_gem = has_gem & ~(attacked | delivered)
        t = state.t + 1
        new = RGState(row, col, has_gold, has_gem, t)
        return StepOut(new, self._obs(new), reward, attacked | delivered, t >= self.max_episode_steps)

    def pareto_front(self, gamma: float) -> np.ndarray:
        """The JAX package's front from the canonical routes: gem only (safe, 8
        steps), gold by the safe detour (10), both (12), and the risky gold route
        through the enemy at (2, 2) with its expected returns at ``enemy_proba``."""
        from ..core.pareto import filter_pareto_dominated

        def disc(t):
            return gamma ** (t - 1)

        q = 1.0 - self.enemy_proba
        surv = q * q  # the risky route passes the enemy cell twice
        pts = [
            [0.0, 0.0, disc(8)],
            [0.0, disc(10), 0.0],
            [0.0, disc(12), disc(12)],
            [-(1 - surv) * disc(3), surv * disc(8), 0.0],
        ]
        return filter_pareto_dominated(np.asarray(pts, dtype=np.float64))
