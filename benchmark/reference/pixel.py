"""The pixel Deep Sea Treasure under the mario wrapper stack, in plain PyTorch.

Written from the published descriptions, and imports nothing of the program
under test:

- Deep Sea Treasure (Vamplew et al., 2011; MO-Gymnasium's
  ``deep-sea-treasure-v0``, convex map): an 11 x 10 grid, the submarine starts
  at the top-left cell and moves up, down, left or right; a move into the sea
  floor leaves it where it was; the floor cell of each column holds a
  treasure, whose pickup ends the episode; the reward is (treasure, -1); an
  episode is cut after 500 moves.
- Its frame: 8 x 8 pixels a cell, 88 x 80 x 3 uint8; sea, sea floor and
  treasure cells in fixed colours, the submarine's cell in its own colour.
- The mario wrapper stack of morl-baselines' ``launch_experiment.py``:
  MaxAndSkip(4) (the action repeated 4 times, the rewards summed, the
  elementwise max of the last two sub-steps' frames; an env whose episode
  ended holds its state and frame through the sub-steps left), a resize to
  84 x 84, grayscale, FrameStack(4) (a reset fills the stack with the reset
  frame), TimeLimit(1000), and the stack flattened to float32.
- The resize is bilinear with antialiasing where it shrinks: output pixel i
  of an axis of n_in -> n_out pixels (scale s = n_in / n_out) weighs input
  pixel j by max(0, 1 - |j + 0.5 - (i + 0.5) s| / max(s, 1)), normalized over
  j; computed in float64, rounded to the nearest integer, clipped to 0..255.
- Grayscale is round(0.2989 R + 0.5870 G + 0.1140 B), in float32.

``PixelStack`` steps ``n`` envs at once with same-step autoreset: an env
whose episode ended returns its reset observation, and the observation the
episode ended on separately."""

from __future__ import annotations

from typing import NamedTuple

import torch

DEPTHS = (1, 2, 3, 4, 4, 4, 7, 7, 9, 10)  # the sea floor's row in each column
VALUES = (0.7, 8.2, 11.5, 14.0, 15.1, 16.1, 19.6, 20.3, 22.4, 23.7)  # its treasure
ROWS, COLS, CELL = 11, 10, 8
SEA, FLOOR, TREASURE, SUBMARINE = (30, 90, 180), (60, 50, 40), (230, 200, 60), (220, 50, 50)
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))  # up, down, left, right
SKIP, STACK, SIZE = 4, 4, (84, 84)
DST_HORIZON, TIME_LIMIT = 500, 1000


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float64 weights of the antialiased bilinear resize of one axis."""
    scale = n_in / n_out
    centre = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * scale
    taps = torch.arange(n_in, dtype=torch.float64, device=device) + 0.5
    w = torch.clamp(1.0 - (taps[None] - centre[:, None]).abs() / max(scale, 1.0), min=0.0)
    return w / w.sum(dim=1, keepdim=True)


class Subs(NamedTuple):
    row: torch.Tensor  # (n,) int64
    col: torch.Tensor
    moves: torch.Tensor  # moves of the episode
    steps: torch.Tensor  # wrapper steps of the episode
    stack: torch.Tensor  # (n, 4, 84, 84) uint8, the oldest frame first


class PixelStack:
    obs_dim, num_actions, reward_dim = STACK * SIZE[0] * SIZE[1], 4, 2

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        self.depths = torch.tensor(DEPTHS, device=device)
        self.values = torch.tensor(VALUES, dtype=torch.float32, device=device)
        self.moves = torch.tensor(MOVES, device=device)
        rr = torch.arange(ROWS, device=device)[:, None]
        floor = rr > self.depths[None]
        treasure = rr == self.depths[None]
        colour = lambda c: torch.tensor(c, dtype=torch.uint8, device=device)  # noqa: E731
        cells = torch.where(floor[..., None], colour(FLOOR), torch.where(treasure[..., None], colour(TREASURE), colour(SEA)))
        self.background = cells.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)  # (88, 80, 3)
        self.submarine = colour(SUBMARINE)
        self.wh = resize_weights(ROWS * CELL, SIZE[0], device)
        self.ww = resize_weights(COLS * CELL, SIZE[1], device)

    def render(self, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        """(n, 88, 80, 3) uint8 frames of the submarines at (row, col)."""
        pr = torch.arange(ROWS * CELL, device=self.device) // CELL
        pc = torch.arange(COLS * CELL, device=self.device) // CELL
        here = (pr[None, :, None] == row[:, None, None]) & (pc[None, None, :] == col[:, None, None])
        return torch.where(here[..., None], self.submarine, self.background)

    def process(self, rgb: torch.Tensor) -> torch.Tensor:
        """(n, 88, 80, 3) uint8 -> (n, 84, 84) uint8: the resize, then grayscale."""
        x = torch.einsum("ih,nhwc,jw->nijc", self.wh, rgb.double(), self.ww)
        x = torch.clamp(torch.round(x), 0, 255).to(torch.uint8).to(torch.float32)
        grey = x[..., 0] * 0.2989 + x[..., 1] * 0.5870 + x[..., 2] * 0.1140
        return torch.clamp(torch.round(grey), 0, 255).to(torch.uint8)

    def start(self) -> Subs:
        z = torch.zeros((self.n,), dtype=torch.int64, device=self.device)
        frame = self.process(self.render(z, z))
        return Subs(z, z.clone(), z.clone(), z.clone(), frame[:, None].repeat(1, STACK, 1, 1))

    @staticmethod
    def observe(s: Subs) -> torch.Tensor:
        return s.stack.reshape(s.stack.shape[0], -1).to(torch.float32)

    def _move(self, row, col, a):
        """One move of the grid: (row, col, whether it found a treasure, the reward)."""
        r = torch.clamp(row + self.moves[a, 0], 0, ROWS - 1)
        c = torch.clamp(col + self.moves[a, 1], 0, COLS - 1)
        blocked = r > self.depths[c]
        r, c = torch.where(blocked, row, r), torch.where(blocked, col, c)
        found = r == self.depths[c]
        treasure = torch.where(found, self.values[c], 0.0)
        return r, c, found, torch.stack([treasure, torch.full_like(treasure, -1.0)], dim=-1)

    def step(self, s: Subs, a: torch.Tensor, gen: torch.Generator):
        """One wrapper step of every env: (next state after autoreset, next obs,
        reward, terminated, truncated, the obs before the reset).  The grid is
        deterministic: ``gen`` is not drawn from."""
        row, col, moves = s.row, s.col, s.moves
        reward = torch.zeros((self.n, 2), device=self.device)
        term = torch.zeros((self.n,), dtype=torch.bool, device=self.device)
        trunc = torch.zeros_like(term)
        last = []
        for i in range(SKIP):
            ran = ~(term | trunc)
            r, c, found, rew = self._move(row, col, a)
            row, col = torch.where(ran, r, row), torch.where(ran, c, col)
            moves = moves + ran.long()
            reward = reward + torch.where(ran[:, None], rew, 0.0)
            term = term | (ran & found)
            trunc = trunc | (ran & (moves >= DST_HORIZON))
            if i >= SKIP - 2:
                last.append(self.render(row, col))
        frame = self.process(torch.maximum(*last))
        steps = s.steps + 1
        trunc = trunc | (steps >= TIME_LIMIT)
        stack = torch.cat([s.stack[:, 1:], frame[:, None]], dim=1)
        ended = Subs(row, col, moves, steps, stack)
        done = term | trunc
        fresh = self.start()
        nxt = Subs(*(torch.where(done.reshape(-1, *[1] * (x.dim() - 1)), f, x) for f, x in zip(fresh, ended)))
        return nxt, self.observe(nxt), reward, term, trunc, self.observe(ended)
