"""mo-highway-jx — batched torch multi-objective highway driving.

PyTorch port of ``morl_baselines_tpu/envs/highway.py``, the device-resident
re-design of MO-Gymnasium's ``mo-highway-v0`` (highway-env's HighwayEnv
with a vector reward):

- 4 lanes; the ego car takes the 5 DiscreteMetaActions (LANE_LEFT, IDLE,
  LANE_RIGHT, FASTER, SLOWER) with target speeds {20, 25, 30} m/s;
- ``n_other`` IDM-style cars ahead keep a time gap to their same-lane
  leader and never change lanes;
- observation: Kinematics of 5 vehicles x (presence, x, y, vx, vy), the ego
  row absolute and the 4 nearest cars (by |dx|) relative to it, normalized
  by highway-env's feature ranges;
- reward [high_speed, right_lane, -collision]; a crash terminates, 40
  decisions (4 substeps of 0.25 s each) truncate.

``reset`` draws the ego lane, the other cars' lanes, their spacing jitter
and their speeds; ``initial_state`` takes those draws, so a test can hand
the JAX env's to the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import Box, Discrete, MOEnv, StepOut

_N_LANES = 4
_LANE_W = 4.0
_DT = 0.25
_SUBSTEPS = 4  # 1 Hz decisions
_DURATION = 40  # decisions per episode
_CAR_LEN = 5.0
_V_RANGE = 20.0
_XY_RANGE = 100.0
# IDM-ish spacing of the scripted traffic
_TIME_GAP = 1.5
_MIN_GAP = 10.0
_ACCEL = 3.0


class HighwayState(NamedTuple):
    ego_x: torch.Tensor  # (N,) f32 longitudinal position
    ego_lane: torch.Tensor  # (N,) i32
    ego_v: torch.Tensor  # (N,) f32
    ego_speed_idx: torch.Tensor  # (N,) i32 index into the target speeds {20, 25, 30}
    other_x: torch.Tensor  # (N, V) f32
    other_lane: torch.Tensor  # (N, V) i32
    other_v: torch.Tensor  # (N, V) f32
    crashed: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) i32 decision counter


class MOHighway(MOEnv):
    """3-objective highway: (high_speed, right_lane, collision)."""

    reward_dim = 3
    name = "mo-highway-jx-v0"

    def __init__(self, n_other: int = 10, max_episode_steps: int = _DURATION):
        self.n_other = n_other
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(-1.0,) * 25, high=(1.0,) * 25)
        self.action_space = Discrete(5)

    def _obs(self, s: HighwayState) -> torch.Tensor:
        n = s.ego_x.shape[0]
        dx = s.other_x - s.ego_x[:, None]
        dy = (s.other_lane - s.ego_lane[:, None]).to(torch.float32) * _LANE_W
        dvx = s.other_v - s.ego_v[:, None]
        # the 4 nearest cars by |dx| (highway-env sorts by distance)
        order = torch.argsort(torch.abs(dx), dim=1, stable=True)[:, :4]
        near = lambda x: torch.gather(x, 1, order)  # noqa: E731
        ones, zeros = torch.ones((n, 4), device=dx.device), torch.zeros((n, 4), device=dx.device)
        rows = torch.stack(
            [
                ones,
                torch.clamp(near(dx) / _XY_RANGE, -1.0, 1.0),
                torch.clamp(near(dy) / _XY_RANGE, -1.0, 1.0),
                torch.clamp(near(dvx) / _V_RANGE, -1.0, 1.0),
                zeros,
            ],
            dim=-1,
        )  # (N, 4, 5)
        ego_row = torch.stack(
            [
                ones[:, 0],
                torch.clamp(s.ego_x / (10.0 * _XY_RANGE), -1.0, 1.0),
                torch.clamp(s.ego_lane.to(torch.float32) * _LANE_W / _XY_RANGE, -1.0, 1.0),
                torch.clamp(s.ego_v / 30.0, -1.0, 1.0),
                zeros[:, 0],
            ],
            dim=-1,
        )
        return torch.cat([ego_row[:, None], rows], dim=1).reshape(n, -1)

    def initial_state(self, lane: torch.Tensor, other_lane: torch.Tensor, jitter: torch.Tensor, other_v: torch.Tensor):
        """(state, obs) from the reset draws: the ego lane (n,), the other cars'
        lanes (n, V), their spacing jitter in [-8, 8] (n, V) and speeds (n, V)."""
        n, dev = lane.shape[0], lane.device
        spacing = 30.0 + 25.0 * torch.arange(self.n_other, device=dev, dtype=torch.int32)
        state = HighwayState(
            ego_x=torch.zeros((n,), device=dev),
            ego_lane=lane.to(torch.int32),
            ego_v=torch.full((n,), 25.0, device=dev),
            ego_speed_idx=torch.ones((n,), dtype=torch.int32, device=dev),
            other_x=spacing + jitter,
            other_lane=other_lane.to(torch.int32),
            other_v=other_v,
            crashed=torch.zeros((n,), dtype=torch.bool, device=dev),
            t=torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        return state, self._obs(state)

    def reset(self, n: int, gen: torch.Generator):
        dev, v = gen.device, self.n_other
        lane = torch.randint(0, _N_LANES, (n,), generator=gen, device=dev)
        other_lane = torch.randint(0, _N_LANES, (n, v), generator=gen, device=dev)
        jitter = torch.rand((n, v), generator=gen, device=dev) * 16.0 - 8.0
        other_v = 20.0 + torch.rand((n, v), generator=gen, device=dev) * 4.0
        return self.initial_state(lane, other_lane, jitter, other_v)

    def step(self, state: HighwayState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        s = state
        action = action.reshape(-1)
        # meta-action: lane and target-speed changes at decision time
        lane = torch.clamp(s.ego_lane + (action == 2).to(torch.int32) - (action == 0).to(torch.int32), 0, _N_LANES - 1)
        sp_idx = torch.clamp(s.ego_speed_idx + (action == 3).to(torch.int32) - (action == 4).to(torch.int32), 0, 2)
        target_v = 20.0 + 5.0 * sp_idx.to(torch.float32)  # the FASTER/SLOWER targets {20, 25, 30} m/s

        ego_x, ego_v = s.ego_x, s.ego_v
        other_x, other_v = s.other_x, s.other_v
        crashed = s.crashed
        same_lane_pair = s.other_lane[:, None, :] == s.other_lane[:, :, None]  # (N, V, V): [i, j] = lane_j == lane_i
        ego_lane_cars = s.other_lane == lane[:, None]
        for _ in range(_SUBSTEPS):
            # the ego car tracks its target speed
            ego_v = ego_v + torch.clamp(target_v - ego_v, -_ACCEL * _DT, _ACCEL * _DT)
            ego_x = ego_x + ego_v * _DT
            # scripted traffic: gap control to the same-lane leader
            dx_all = other_x[:, None, :] - other_x[:, :, None]  # [i, j] = x_j - x_i
            lead_gap = torch.where(same_lane_pair & (dx_all > 0), dx_all, torch.inf).amin(dim=2)
            desired = _MIN_GAP + _TIME_GAP * other_v
            decel = torch.where(lead_gap < desired, -_ACCEL, 0.5)
            other_v = torch.clamp(other_v + decel * _DT, 15.0, 25.0)
            other_x = other_x + other_v * _DT
            # collision: same lane as the ego car and bumper overlap
            hit = ego_lane_cars & (torch.abs(other_x - ego_x[:, None]) < _CAR_LEN)
            crashed = crashed | hit.any(dim=1)

        t = s.t + 1
        new = HighwayState(ego_x, lane, ego_v, sp_idx, other_x, s.other_lane, other_v, crashed, t)
        reward = torch.stack(
            [
                torch.clamp((ego_v - 20.0) / 10.0, 0.0, 1.0),
                lane.to(torch.float32) / (_N_LANES - 1),
                -crashed.to(torch.float32),
            ],
            dim=-1,
        )
        return StepOut(new, self._obs(new), reward, crashed, t >= self.max_episode_steps)
