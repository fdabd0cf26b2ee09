"""Pixel-observation Deep Sea Treasure — device-rendered RGB frames.

PyTorch port of ``morl_baselines_tpu/envs/pixel.py``.  The reference
exercises its CNN path on mo-supermario through the wrap_mario stack
(launch_experiment.py:158-180); this env plays that role on the device: its
observation is an (88, 80, 3) uint8 frame of the DST grid, a static
background with the agent's cell drawn over it, so the mario wrapper stack
(wrappers.py) and the NatureCNN trunk run on it end to end.  Dynamics,
rewards and the known Pareto front are DeepSeaTreasure's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span
from .base import ArrayBox, MOEnv, StepOut
from .dst import _DEPTHS, _N_COLS, _N_ROWS, DeepSeaTreasure, DSTState

_CELL = 8  # pixels per grid cell: 11x10 grid -> 88x80 frame
_SEA, _SEABED, _TREASURE, _AGENT = (30, 90, 180), (60, 50, 40), (230, 200, 60), (220, 50, 50)


def _background() -> np.ndarray:
    """The static (88, 80, 3) uint8 frame: sea, seabed and treasure cells."""
    bg = np.zeros((_N_ROWS, _N_COLS, 3), dtype=np.uint8)
    for r in range(_N_ROWS):
        for c in range(_N_COLS):
            bg[r, c] = _SEABED if r > _DEPTHS[c] else _TREASURE if r == _DEPTHS[c] else _SEA
    return np.kron(bg, np.ones((_CELL, _CELL, 1), dtype=np.uint8))


class PixelDST(MOEnv):
    reward_dim = 2
    name = "deep-sea-treasure-pixel-v0"

    def __init__(self, dst_map: str = "convex", max_episode_steps: int = 500):
        self._inner = DeepSeaTreasure(dst_map=dst_map, max_episode_steps=max_episode_steps)
        self.max_episode_steps = max_episode_steps
        self.action_space = self._inner.action_space
        self.observation_space = ArrayBox(0, 255, (_N_ROWS * _CELL, _N_COLS * _CELL, 3))
        self._bg_np = _background()
        self._consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def _tables(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(background, agent colour, row of each pixel row, col of each pixel column) on ``device``, cached."""
        if device not in self._consts:
            self._consts[device] = (
                torch.as_tensor(self._bg_np, device=device),
                torch.as_tensor(_AGENT, dtype=torch.uint8, device=device),
                torch.arange(_N_ROWS * _CELL, dtype=torch.int32, device=device) // _CELL,
                torch.arange(_N_COLS * _CELL, dtype=torch.int32, device=device) // _CELL,
            )
        return self._consts[device]

    def _render(self, state: DSTState) -> torch.Tensor:
        """(n, 88, 80, 3) uint8 frames, in an ``env.frames`` span."""
        with span("env.frames"):
            bg, agent, rows, cols = self._tables(state.row.device)
            mask = (rows[None, :, None] == state.row[:, None, None]) & (cols[None, None, :] == state.col[:, None, None])
            return torch.where(mask[..., None], agent, bg)

    def reset(self, n: int, gen: torch.Generator):
        state, _ = self._inner.reset(n, gen)
        return state, self._render(state)

    def step(self, state: DSTState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        out = self._inner.step(state, action, noise)
        return out._replace(obs=self._render(out.state))

    def pareto_front(self, gamma: float) -> np.ndarray:
        return self._inner.pareto_front(gamma)
