"""Batched MO environment API on torch tensors.

PyTorch port of ``morl_baselines_tpu/envs/base.py``.  Every env steps all N
of its copies in one call:

    reset(n, gen)               -> (state, obs (n, obs_dim))
    sample_noise(n, gen)        -> the step's noise tensor, or None
    step(state, action, noise)  -> StepOut(state, obs, reward (n, d), terminated (n,), truncated (n,))

The state is a NamedTuple of (n, ...) tensors.  Randomness is explicit: the
generator's device is the envs' device, and ``step`` takes its noise as a
tensor so that a test can hand the same numbers to the JAX env.  Autoreset is
a wrapper (vector.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def shape(self):
        return ()

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, self.n, (n,), generator=gen, device=gen.device)


@dataclass(frozen=True)
class Box:
    low: Tuple[float, ...]
    high: Tuple[float, ...]

    @property
    def shape(self):
        return (len(self.low),)

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        lo = torch.as_tensor(self.low, dtype=torch.float32, device=gen.device)
        hi = torch.as_tensor(self.high, dtype=torch.float32, device=gen.device)
        return lo + torch.rand((n, *lo.shape), generator=gen, device=gen.device) * (hi - lo)


@dataclass(frozen=True)
class ArrayBox:
    """n-D box with scalar bounds (image observations, stacked frames)."""

    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.uint8

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n uniform draws in [low, high), cast to ``dtype`` (truncation, as the JAX ``astype``)."""
        u = torch.rand((n, *self.shape), generator=gen, device=gen.device)
        return (self.low + u * (self.high - self.low)).to(self.dtype)


class StepOut(NamedTuple):
    state: Any
    obs: torch.Tensor  # (n, obs_dim), or (n, *frame) for image obs
    reward: torch.Tensor  # (n, reward_dim) vector reward — the MO extension
    terminated: torch.Tensor  # (n,) bool
    truncated: torch.Tensor  # (n,) bool


def tree_where(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` over two env states of the same structure
    (NamedTuples of (n, ...) tensors, nested for wrapped envs); ``cond`` is
    (n,) and broadcasts over each leaf's trailing axes."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)
    return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))


class MOEnv:
    """Base class; subclasses define the fields below and batched reset/step."""

    observation_space: Any
    action_space: Any
    reward_dim: int
    max_episode_steps: int | None = None
    name: str = "moenv"

    @property
    def obs_dim(self) -> int:
        return int(np.prod(self.observation_space.shape)) if self.observation_space.shape else 1

    @property
    def num_actions(self) -> int:
        assert isinstance(self.action_space, Discrete)
        return self.action_space.n

    @property
    def action_dim(self) -> int:
        if isinstance(self.action_space, Discrete):
            return 1
        return int(np.prod(self.action_space.shape))

    def reset(self, n: int, gen: torch.Generator):
        raise NotImplementedError

    # the axis of ``sample_noise``'s tensor that runs over the n envs
    noise_env_dim: int = 0

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor | None:
        """The noise one ``step`` of n envs consumes; None for deterministic envs."""
        return None

    def step(self, state, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        raise NotImplementedError

    # Tabular support: envs with enumerable states expose an integer index so
    # the tabular agents (MOQL, MPMOQL, PQL) keep dense (S, A, ...) tables.
    num_states: int | None = None

    def state_index(self, obs: torch.Tensor) -> torch.Tensor:
        """Integer state index (int64) of each row of a batch of obs (..., obs_dim)."""
        raise NotImplementedError(f"{self.name} has no discrete state indexing")

    def pareto_front(self, gamma: float) -> np.ndarray | None:
        """Known discounted Pareto front, when the env has one (host numpy)."""
        return None
