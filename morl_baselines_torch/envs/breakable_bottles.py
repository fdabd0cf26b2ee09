"""Breakable Bottles — batched torch 3-objective low-impact gridworld.

PyTorch port of ``morl_baselines_tpu/envs/breakable_bottles.py``, the
companion of MO-Gymnasium's ``breakable-bottles-v0`` (Vamplew et al.): a
5-cell corridor with a bottle source at cell 0 and a destination at cell 4.
The agent picks up bottles (carrying at most two); while carrying two there
is a 10% chance per move of dropping one in the current cell, and dropped
bottles break.  Delivering two bottles ends the episode.  Objectives:

    r = [ time penalty (-1 per step),
          delivery reward (+25 on completing the 2-bottle delivery),
          impact penalty (-1 per bottle newly broken) ]

The drop draw of a step is ``sample_noise``'s (n,) uniforms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import Box, Discrete, MOEnv, StepOut

_N_CELLS = 5
_MAX_CARRY = 2
_DROP_PROB = 0.1


class BottlesState(NamedTuple):
    loc: torch.Tensor  # (N,) int32, 0..4
    carrying: torch.Tensor  # (N,) int32, 0..2
    delivered: torch.Tensor  # (N,) int32, 0..2
    dropped: torch.Tensor  # (N, 5) int32 bottles broken per cell
    t: torch.Tensor  # (N,) int32


class BreakableBottles(MOEnv):
    """Actions: 0 left, 1 right, 2 pick up (at the source)."""

    reward_dim = 3
    name = "breakable-bottles-v0"
    num_states = _N_CELLS * (_MAX_CARRY + 1) * 3 * 2  # loc x carry x delivered x any-broken

    def __init__(self, max_episode_steps: int = 100):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(
            low=(0.0, 0.0, 0.0, 0.0),
            high=(float(_N_CELLS - 1), float(_MAX_CARRY), 2.0, float(max_episode_steps)),
        )
        self.action_space = Discrete(3)

    def _obs(self, s: BottlesState) -> torch.Tensor:
        return torch.stack([s.loc, s.carrying, s.delivered, s.dropped.sum(dim=-1, dtype=torch.int32)], dim=-1).to(
            torch.float32
        )

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        """(((loc * 3 + carrying) * 3 + delivered) * 2 + any broken) of each obs (..., 4), int64."""
        loc, carry, deliv = (obs[..., i].long() for i in range(3))
        broken = (obs[..., 3] > 0).long()
        return ((loc * (_MAX_CARRY + 1) + carry) * 3 + deliv) * 2 + broken

    def reset(self, n: int, gen: torch.Generator):
        dev = gen.device
        z = torch.zeros((n,), dtype=torch.int32, device=dev)
        s = BottlesState(z, z.clone(), z.clone(), torch.zeros((n, _N_CELLS), dtype=torch.int32, device=dev), z.clone())
        return s, self._obs(s)

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """(n,) uniforms: the drop draw (``jax.random.uniform(key, ())``, breakable_bottles.py:86)."""
        return torch.rand((n,), generator=gen, device=gen.device)

    def step(self, state: BottlesState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        action = action.reshape(-1)
        move = torch.where(action == 0, -1, torch.where(action == 1, 1, 0)).to(torch.int32)
        loc = torch.clamp(state.loc + move, 0, _N_CELLS - 1)
        # pickup only at the source, up to the carry limit
        can_pick = (action == 2) & (state.loc == 0) & (state.carrying < _MAX_CARRY)
        carrying = state.carrying + can_pick.to(torch.int32)
        # moving with two bottles risks dropping one where it lands; a clipped move at the boundary does not count
        drops = (loc != state.loc) & (carrying == _MAX_CARRY) & (noise < _DROP_PROB)
        carrying = carrying - drops.to(torch.int32)
        dropped = state.dropped.scatter_add(1, loc.long()[:, None], drops.to(torch.int32)[:, None])
        # delivery at the destination
        at_dest = loc == _N_CELLS - 1
        delivered = torch.clamp(state.delivered + torch.where(at_dest, carrying, 0), 0, 2)
        carrying = torch.where(at_dest, 0, carrying)
        done = delivered >= 2
        reward = torch.stack(
            [torch.full_like(noise, -1.0), torch.where(done, 25.0, 0.0), -drops.to(torch.float32)], dim=-1
        )
        t = state.t + 1
        new = BottlesState(loc, carrying, delivered, dropped, t)
        return StepOut(new, self._obs(new), reward, done, t >= self.max_episode_steps)
