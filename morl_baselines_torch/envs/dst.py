"""Deep Sea Treasure — batched torch MO env (2 objectives: treasure, time).

PyTorch port of ``morl_baselines_tpu/envs/dst.py``, the counterpart of
MO-Gymnasium's ``deep-sea-treasure-v0``: the canonical 11x10 submarine grid
(Vamplew et al., 2011).  The agent starts at the surface top-left and moves
up/down/left/right; the sea floor deepens to the right and each column's
floor cell holds a treasure of increasing value.  Rewards are
(treasure, -1 time penalty); the episode terminates on treasure pickup.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut

# Column -> row of the treasure (sea floor) and treasure values.
_DEPTHS = np.array([1, 2, 3, 4, 4, 4, 7, 7, 9, 10], dtype=np.int32)
_CONVEX_VALUES = np.array([0.7, 8.2, 11.5, 14.0, 15.1, 16.1, 19.6, 20.3, 22.4, 23.7], dtype=np.float32)
_CONCAVE_VALUES = np.array([1.0, 2.0, 3.0, 5.0, 8.0, 16.0, 24.0, 50.0, 74.0, 124.0], dtype=np.float32)
# 0=up 1=down 2=left 3=right
_DROW = np.array([-1, 1, 0, 0], dtype=np.int32)
_DCOL = np.array([0, 0, -1, 1], dtype=np.int32)

_N_ROWS = 11
_N_COLS = 10


class DSTState(NamedTuple):
    row: torch.Tensor  # (N,) int32
    col: torch.Tensor  # (N,) int32
    t: torch.Tensor  # (N,) int32 step counter


class DeepSeaTreasure(MOEnv):
    """2-objective grid world.  ``dst_map``: "convex" (default) or "concave"."""

    reward_dim = 2
    name = "deep-sea-treasure-v0"

    def __init__(self, dst_map: str = "convex", max_episode_steps: int = 500):
        if dst_map == "convex":
            values = _CONVEX_VALUES
        elif dst_map == "concave":
            values = _CONCAVE_VALUES
            self.name = "deep-sea-treasure-concave-v0"
        else:
            raise ValueError(dst_map)
        self._values_np = values
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=(0.0, 0.0), high=(float(_N_ROWS - 1), float(_N_COLS - 1)))
        self.action_space = Discrete(4)
        self._consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def _tables(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(depths, values, drow, dcol) on ``device``, cached."""
        if device not in self._consts:
            self._consts[device] = tuple(
                torch.as_tensor(a, device=device) for a in (_DEPTHS, self._values_np, _DROW, _DCOL)
            )
        return self._consts[device]

    def _obs(self, state: DSTState) -> torch.Tensor:
        return torch.stack([state.row, state.col], dim=-1).to(torch.float32)

    def reset(self, n: int, gen: torch.Generator):
        z = torch.zeros((n,), dtype=torch.int32, device=gen.device)
        state = DSTState(z, z.clone(), z.clone())
        return state, self._obs(state)

    def step(self, state: DSTState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        depths, values, drow, dcol = self._tables(state.row.device)
        action = action.long()
        row = torch.clamp(state.row + drow[action], 0, _N_ROWS - 1)
        col = torch.clamp(state.col + dcol[action], 0, _N_COLS - 1)
        # ground below each column's treasure: blocked -> stay in place
        blocked = row > depths[col.long()]
        row = torch.where(blocked, state.row, row)
        col = torch.where(blocked, state.col, col)
        on_treasure = row == depths[col.long()]
        treasure = torch.where(on_treasure, values[col.long()], 0.0)
        reward = torch.stack([treasure, torch.full_like(treasure, -1.0)], dim=-1)
        t = state.t + 1
        return StepOut(DSTState(row, col, t), self._obs(DSTState(row, col, t)), reward, on_treasure, t >= self.max_episode_steps)

    num_states = _N_ROWS * _N_COLS

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        """row * 10 + col of each obs (..., 2), as int64."""
        cells = obs.long()
        return cells[..., 0] * _N_COLS + cells[..., 1]

    def pareto_front(self, gamma: float) -> np.ndarray:
        """Discounted front: one point per treasure, reached by the shortest path.

        Shortest path to column c's treasure is c rights + depth[c] downs.
        Treasure lands on the final step (discount gamma^(t-1)); time penalty
        accrues -1 every step.
        """
        from ..core.pareto import filter_pareto_dominated

        pts = []
        for c in range(_N_COLS):
            t = int(_DEPTHS[c]) + c
            disc_treasure = float(self._values_np[c]) * gamma ** (t - 1)
            disc_time = -sum(gamma**k for k in range(t))
            pts.append([disc_treasure, disc_time])
        return filter_pareto_dominated(np.asarray(pts, dtype=np.float64))

    def render_frame(self, state: DSTState, cell: int = 24) -> np.ndarray:
        """(H, W, 3) uint8 image of the grid and the submarine of a one-env
        ``state`` (host numpy, visualization only)."""
        row, col = int(state.row.reshape(())), int(state.col.reshape(()))
        img = np.zeros((_N_ROWS * cell, _N_COLS * cell, 3), dtype=np.uint8)
        for r in range(_N_ROWS):
            for c in range(_N_COLS):
                if r > _DEPTHS[c]:
                    color = (60, 50, 40)  # seabed
                elif r == _DEPTHS[c]:
                    color = (230, 200, 60)  # treasure
                else:
                    color = (30, 90, 180)  # sea
                img[r * cell : (r + 1) * cell, c * cell : (c + 1) * cell] = color
        img[row * cell + 4 : (row + 1) * cell - 4, col * cell + 4 : (col + 1) * cell - 4] = (220, 50, 50)
        return img
