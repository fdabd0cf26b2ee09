"""Minecart — batched torch MO env (3 objectives: ore1, ore2, fuel).

PyTorch port of ``morl_baselines_tpu/envs/minecart.py``, the counterpart of
MO-Gymnasium's ``minecart-v0`` / ``minecart-deterministic-v0`` (Abels et al.,
2019; BASELINE Envelope config, ref_point [0, 0, -200]).

A cart starts at the home port in the top-left corner of the unit square,
drives under momentum + rotation control to one of 5 mines on an arc, mines a
mixture of two ores (stochastic amounts unless ``deterministic``), and sells
on returning home.  Rewards: (ore1 sold, ore2 sold, fuel consumed<0).
Actions (6): 0=mine, 1=left, 2=right, 3=accelerate, 4=brake, 5=none.
Observation (7): x, y, speed, sin(angle), cos(angle), cargo1, cargo2.
All dynamics are branch-free float32 tensor ops over the N envs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut

# --- geometry ---------------------------------------------------------------
_HOME = np.array([0.0, 0.0], dtype=np.float32)
_HOME_RADIUS = 0.15
_MINE_RADIUS = 0.14
_N_MINES = 5
_MINE_ANGLES = np.deg2rad(np.linspace(15.0, 75.0, _N_MINES)).astype(np.float32)
_MINE_POS = np.stack([0.7 * np.cos(_MINE_ANGLES), 0.7 * np.sin(_MINE_ANGLES)], axis=-1)
# ore means: interpolate ore1-rich -> ore2-rich across the arc
_t = np.linspace(0.0, 1.0, _N_MINES, dtype=np.float32)
_MINE_MEANS = np.stack([0.65 * (1 - _t) + 0.05 * _t, 0.05 * (1 - _t) + 0.65 * _t], axis=-1)
_MINE_STD = 0.1

# --- physics ----------------------------------------------------------------
_ACCEL = 0.0025
_MAX_SPEED = 0.02
_ROTATION = float(np.float32(np.deg2rad(15.0)))
_START_ANGLE = float(np.float32(np.deg2rad(45.0)))
_CAPACITY = 1.5
_FUEL_IDLE = -0.005
_FUEL_ACC = -0.025
_FUEL_MINE = -0.05


class MinecartState(NamedTuple):
    pos: torch.Tensor  # (N, 2)
    speed: torch.Tensor  # (N,)
    angle: torch.Tensor  # (N,) radians
    cargo: torch.Tensor  # (N, 2)
    departed: torch.Tensor  # (N,) bool: left home at least once
    t: torch.Tensor  # (N,) int32


class Minecart(MOEnv):
    reward_dim = 3
    name = "minecart-v0"

    def __init__(self, deterministic: bool = False, max_episode_steps: int = 1000):
        self.deterministic = deterministic
        if deterministic:
            self.name = "minecart-deterministic-v0"
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(
            low=(0.0, 0.0, 0.0, -1.0, -1.0, 0.0, 0.0),
            high=(1.0, 1.0, 1.0, 1.0, 1.0, float(_CAPACITY), float(_CAPACITY)),
        )
        self.action_space = Discrete(6)
        self._consts: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def _mines(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(mine positions (5, 2), ore means (5, 2)) on ``device``, cached."""
        if device not in self._consts:
            self._consts[device] = (
                torch.as_tensor(_MINE_POS, device=device),
                torch.as_tensor(_MINE_MEANS, device=device),
            )
        return self._consts[device]

    def _obs(self, s: MinecartState) -> torch.Tensor:
        return torch.cat(
            [
                s.pos,
                (s.speed / _MAX_SPEED)[:, None],
                torch.sin(s.angle)[:, None],
                torch.cos(s.angle)[:, None],
                s.cargo,
            ],
            dim=-1,
        )

    def reset(self, n: int, gen: torch.Generator):
        dev = gen.device
        s = MinecartState(
            pos=torch.as_tensor(_HOME, device=dev).expand(n, 2).clone(),
            speed=torch.zeros((n,), device=dev),
            angle=torch.full((n,), _START_ANGLE, device=dev),
            cargo=torch.zeros((n, 2), device=dev),
            departed=torch.zeros((n,), dtype=torch.bool, device=dev),
            t=torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        return s, self._obs(s)

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor | None:
        """(n, 2) standard normals for the ore amounts; None when deterministic."""
        if self.deterministic:
            return None
        return torch.randn((n, 2), generator=gen, device=gen.device)

    def step(self, state: MinecartState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        mine_pos, mine_means = self._mines(state.pos.device)
        mine_act = action == 0
        left = action == 1
        right = action == 2
        acc = action == 3
        brake = action == 4

        angle = state.angle + torch.where(left, _ROTATION, 0.0) - torch.where(right, _ROTATION, 0.0)
        speed = state.speed + torch.where(acc, _ACCEL, 0.0)
        speed = torch.where(brake, speed * 0.5, speed)
        speed = torch.clamp(speed, 0.0, _MAX_SPEED)
        heading = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
        pos = torch.clamp(state.pos + speed[:, None] * heading, 0.0, 1.0)

        # mining: only effective within a mine's radius and below capacity
        d2 = torch.sum((mine_pos[None, :, :] - pos[:, None, :]) ** 2, dim=-1)  # (N, 5)
        in_mine = d2 <= _MINE_RADIUS**2
        nearest = torch.argmin(d2, dim=-1)
        can_mine = mine_act & torch.any(in_mine, dim=-1)
        mean = mine_means[nearest]
        if self.deterministic:
            mined = mean
        else:
            mined = torch.clamp(mean + _MINE_STD * noise, min=0.0)
        room = _CAPACITY - torch.sum(state.cargo, dim=-1)
        mined = mined * torch.clamp(room / torch.clamp(torch.sum(mined, dim=-1), min=1e-8), max=1.0)[:, None]
        cargo = state.cargo + torch.where(can_mine[:, None], mined, 0.0)

        at_home = torch.sum(pos**2, dim=-1) <= _HOME_RADIUS**2  # home is the origin
        departed = state.departed | ~at_home
        sell = at_home & departed & (torch.sum(cargo, dim=-1) > 0)

        fuel = _FUEL_IDLE + torch.where(acc, _FUEL_ACC, 0.0) + torch.where(mine_act, _FUEL_MINE, 0.0)
        reward = torch.cat([torch.where(sell[:, None], cargo, 0.0), fuel[:, None]], dim=-1)

        cargo = torch.where(sell[:, None], 0.0, cargo)
        t = state.t + 1
        new_state = MinecartState(pos, speed, angle, cargo, departed, t)
        return StepOut(new_state, self._obs(new_state), reward, sell, t >= self.max_episode_steps)

    # ------------------------------------------------------------------ front

    def _scripted_rollout_returns(self, gamma: float) -> np.ndarray:
        """True discounted returns of the scripted mine-and-return policy
        family, SIMULATED under this env's exact dynamics (deterministic ore
        means) — the construction MO-Gymnasium's ``pareto_front(gamma)`` uses.

        Policy parameters: target mine i, number of mine actions k, and the
        acceleration budget n_acc.  Controller: rotate to face the mine,
        accelerate n_acc times then coast, brake on entering the mine radius,
        mine k times, rotate 180 degrees, accelerate n_acc times and coast
        home; the sale fires in the env itself.  All 60 policies step as one
        batch on the host for ``max_episode_steps`` steps.
        """
        det_env = Minecart(deterministic=True, max_episode_steps=self.max_episode_steps)
        gen = torch.Generator()
        mine_pos, _ = det_env._mines(torch.device("cpu"))

        mine_ids, ks, naccs = np.meshgrid(
            np.arange(_N_MINES), np.array([1, 2, 3]), np.array([1, 2, 4, 8]), indexing="ij"
        )
        p = mine_ids.size
        # rotation steps from the start angle (45 deg) to the mine angle, in
        # +/-15 deg increments (mine angles are exact multiples)
        rot = torch.as_tensor(np.rint((_MINE_ANGLES - np.deg2rad(45.0)) / np.deg2rad(15.0)).astype(np.int64))[
            torch.as_tensor(mine_ids.ravel())
        ]
        n_acc = torch.as_tensor(naccs.ravel(), dtype=torch.int64)
        rot_out = rot.abs()
        acc_out = n_acc.clone()
        brake = torch.full((p,), 10, dtype=torch.int64)
        mine = torch.as_tensor(ks.ravel(), dtype=torch.int64)
        rot_back = torch.full((p,), 12, dtype=torch.int64)
        acc_back = n_acc.clone()

        env_s, _ = det_env.reset(p, gen)
        ret = torch.zeros((p, 3))
        gpow = torch.ones((p,))
        done = torch.zeros((p,), dtype=torch.bool)
        for _ in range(self.max_episode_steps):
            d2 = torch.sum((mine_pos[None, :, :] - env_s.pos[:, None, :]) ** 2, dim=-1)
            in_mine = torch.any(d2 <= _MINE_RADIUS**2, dim=-1)
            outbound = mine > 0
            # priority cascade: rotate out -> travel out -> brake -> mine ->
            # rotate back -> accelerate back -> coast
            a = torch.full((p,), 5, dtype=torch.int64)
            a = torch.where((acc_back > 0) & ~outbound & (rot_back == 0), 3, a)
            a = torch.where((rot_back > 0) & ~outbound, 1, a)
            a = torch.where(outbound & in_mine & (brake == 0), 0, a)
            a = torch.where(outbound & in_mine & (brake > 0), 4, a)
            a = torch.where(outbound & ~in_mine & (acc_out > 0) & (rot_out == 0), 3, a)
            a = torch.where(rot_out > 0, torch.where(rot > 0, 1, 2), a)

            out = det_env.step(env_s, a)
            rot_out = rot_out - (rot_out > 0).long()
            acc_out = acc_out - ((a == 3) & outbound).long()
            brake = brake - (a == 4).long()
            mine = mine - (a == 0).long()
            rot_back = rot_back - ((a == 1) & ~outbound).long()
            acc_back = acc_back - ((a == 3) & ~outbound).long()
            ret = ret + torch.where(done, 0.0, gpow)[:, None] * out.reward
            done = done | out.terminated | out.truncated
            gpow = gpow * gamma
            env_s = out.state
        # keep only policies that actually completed a sale
        return ret.numpy().astype(np.float64)[done.numpy()]

    def pareto_front(self, gamma: float) -> np.ndarray:
        """Known discounted front: the simulated scripted policy family plus
        the idle policy (never leave home: zero ore, idle fuel to the horizon)."""
        from ..core.pareto import filter_pareto_dominated

        pts = list(self._scripted_rollout_returns(gamma))
        if gamma < 1.0:
            idle_fuel = _FUEL_IDLE * (1.0 - gamma**self.max_episode_steps) / (1.0 - gamma)
        else:
            idle_fuel = _FUEL_IDLE * self.max_episode_steps
        pts.append(np.array([0.0, 0.0, idle_fuel]))
        return filter_pareto_dominated(np.asarray(pts, dtype=np.float64), keep_duplicates=False)
