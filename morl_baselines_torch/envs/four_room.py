"""Four-Room — batched torch 3-objective gridworld.

PyTorch port of ``morl_baselines_tpu/envs/four_room.py``, the companion of
MO-Gymnasium's ``four-room-v0``: a 13x13 grid split into four rooms by walls
with one doorway per side; items of three shapes are scattered through the
rooms and picking one up yields +1 on that shape's objective; reaching the
goal cell terminates the episode.  The observation is the agent position
plus the remaining-item bitmap, so the state is enumerable (``state_index``)
for the tabular agents.  The item layout is the JAX package's fixed one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut

_N = 13
# walls: row 6 and col 6, with doorways at (6,3), (6,9), (3,6), (9,6)
_WALLS = np.zeros((_N, _N), dtype=bool)
_WALLS[6, :] = True
_WALLS[:, 6] = True
for _r, _c in [(6, 3), (6, 9), (3, 6), (9, 6)]:
    _WALLS[_r, _c] = False
# items: (row, col, shape 0..2), three per shape, spread over the rooms
_ITEMS = np.array(
    [(2, 2, 0), (10, 10, 0), (2, 10, 0), (10, 2, 1), (4, 4, 1), (8, 8, 1), (4, 8, 2), (8, 4, 2), (11, 5, 2)],
    dtype=np.int64,
)
_START = (12, 0)
_GOAL = (0, 12)
_NUM_ITEMS = len(_ITEMS)
# 0=up 1=down 2=left 3=right
_DROW = np.array([-1, 1, 0, 0], dtype=np.int32)
_DCOL = np.array([0, 0, -1, 1], dtype=np.int32)


class FourRoomState(NamedTuple):
    row: torch.Tensor  # (N,) int32
    col: torch.Tensor  # (N,) int32
    items: torch.Tensor  # (N, 9) bool, True = still present
    t: torch.Tensor  # (N,) int32


class FourRoom(MOEnv):
    """3 objectives: one per item shape; +1 on pickup, the episode ends at the goal."""

    reward_dim = 3
    name = "four-room-v0"
    num_states = _N * _N * (2**_NUM_ITEMS)

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(
            low=tuple([0.0, 0.0] + [0.0] * _NUM_ITEMS),
            high=tuple([float(_N - 1)] * 2 + [1.0] * _NUM_ITEMS),
        )
        self.action_space = Discrete(4)
        self._consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def _tables(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(walls, item rows, item cols, item shape one-hot (9, 3), drow, dcol, bit values) on ``device``, cached."""
        if device not in self._consts:
            shape_onehot = np.eye(3, dtype=np.float32)[_ITEMS[:, 2]]
            arrays = (_WALLS, _ITEMS[:, 0], _ITEMS[:, 1], shape_onehot, _DROW, _DCOL, 2 ** np.arange(_NUM_ITEMS))
            self._consts[device] = tuple(torch.as_tensor(a, device=device) for a in arrays)
        return self._consts[device]

    def _obs(self, s: FourRoomState) -> torch.Tensor:
        return torch.cat([torch.stack([s.row, s.col], dim=-1).to(torch.float32), s.items.to(torch.float32)], dim=-1)

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        """((row * 13 + col) * 512 + item bitmap) of each obs (..., 11), int64."""
        bits = self._tables(obs.device)[6]
        cells = obs[..., :2].long()
        mask = torch.sum(obs[..., 2:].long() * bits, dim=-1)
        return (cells[..., 0] * _N + cells[..., 1]) * (2**_NUM_ITEMS) + mask

    def reset(self, n: int, gen: torch.Generator):
        dev = gen.device
        s = FourRoomState(
            torch.full((n,), _START[0], dtype=torch.int32, device=dev),
            torch.full((n,), _START[1], dtype=torch.int32, device=dev),
            torch.ones((n, _NUM_ITEMS), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        return s, self._obs(s)

    def step(self, state: FourRoomState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        walls, item_row, item_col, item_shape, drow, dcol, _ = self._tables(state.row.device)
        action = action.long().reshape(-1)
        row = torch.clamp(state.row + drow[action], 0, _N - 1)
        col = torch.clamp(state.col + dcol[action], 0, _N - 1)
        hit_wall = walls[row.long(), col.long()]
        row = torch.where(hit_wall, state.row, row)
        col = torch.where(hit_wall, state.col, col)
        here = (item_row == row[:, None]) & (item_col == col[:, None]) & state.items  # (N, 9)
        reward = here.to(torch.float32) @ item_shape
        items = state.items & ~here
        t = state.t + 1
        terminated = (row == _GOAL[0]) & (col == _GOAL[1])
        new = FourRoomState(row, col, items, t)
        return StepOut(new, self._obs(new), reward, terminated, t >= self.max_episode_steps)
