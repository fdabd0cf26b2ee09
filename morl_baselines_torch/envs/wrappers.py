"""Observation wrappers — batched torch counterparts of the reference's
env-specific wrapper stacks (experiments/benchmark/launch_experiment.py:147-181):

  highway: FlattenObservation
  mario:   MOMaxAndSkipObservation(4) -> ResizeObservation(84,84)
           -> GrayscaleObservation -> FrameStackObservation(4) -> TimeLimit(1000)

PyTorch port of ``morl_baselines_tpu/envs/wrappers.py``.  A wrapper's state
is an extra NamedTuple layer around the inner env's (frame rings, step
counters), and every image op works on (n, ...) batches on the device, so
the whole stack steps N envs in one call.  A wrapper's ``sample_noise`` is
its inner env's (MaxAndSkip: one draw per sub-step, stacked).  The image work
(the max of the last two frames, the resize, the grayscale, the stack shift)
runs in ``env.frames`` spans, as the pixel env's renders do.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .base import ArrayBox, Box, MOEnv, StepOut, tree_where


class _Wrapper(MOEnv):
    """Delegating base: forwards spaces and metadata; subclasses override obs/step."""

    def __init__(self, env: MOEnv):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.reward_dim = env.reward_dim
        self.max_episode_steps = env.max_episode_steps
        self.name = env.name
        self.num_states = env.num_states
        self.noise_env_dim = env.noise_env_dim

    def sample_noise(self, n: int, gen: torch.Generator):
        return self.env.sample_noise(n, gen)

    def state_index(self, obs):
        return self.env.state_index(obs)

    def pareto_front(self, gamma: float):
        return self.env.pareto_front(gamma)


# ---------------------------------------------------------------------------
# Stateless observation transforms
# ---------------------------------------------------------------------------


class _ObsMapWrapper(_Wrapper):
    """Applies a batched function to every observation (reset and step)."""

    def _map(self, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reset(self, n: int, gen: torch.Generator):
        state, obs = self.env.reset(n, gen)
        return state, self._map(obs)

    def step(self, state, action, noise=None) -> StepOut:
        out = self.env.step(state, action, noise)
        return out._replace(obs=self._map(out.obs))


class FlattenObservation(_ObsMapWrapper):
    """gymnasium.wrappers.FlattenObservation: (n, ...) -> (n, D) float32."""

    def __init__(self, env: MOEnv):
        super().__init__(env)
        sp = env.observation_space
        n = int(np.prod(sp.shape))
        if isinstance(sp, ArrayBox):
            self.observation_space = Box(low=(float(sp.low),) * n, high=(float(sp.high),) * n)
        else:
            lo = np.broadcast_to(np.asarray(sp.low, dtype=np.float64).ravel(), (n,))
            hi = np.broadcast_to(np.asarray(sp.high, dtype=np.float64).ravel(), (n,))
            self.observation_space = Box(low=tuple(lo), high=tuple(hi))

    def _map(self, obs):
        return obs.reshape(obs.shape[0], -1).to(torch.float32)


class GrayscaleObservation(_ObsMapWrapper):
    """(n, H, W, 3) uint8 -> (n, H, W) uint8 by ITU-R 601 luma (gymnasium semantics)."""

    _LUMA = (0.2989, 0.5870, 0.1140)

    def __init__(self, env: MOEnv):
        super().__init__(env)
        h, w = env.observation_space.shape[:2]
        self.observation_space = ArrayBox(0, 255, (h, w))

    def _map(self, obs):
        with span("env.frames"):
            r, g, b = obs.to(torch.float32).unbind(-1)
            y = r * self._LUMA[0] + g * self._LUMA[1] + b * self._LUMA[2]
            return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


class ResizeObservation(_ObsMapWrapper):
    """Bilinear resize of (n, H, W[, C]) image obs to ``shape``, uint8 out.

    ``jax.image.resize(..., "bilinear")`` antialiases where it shrinks (here
    the height, 88 -> 84), so this is ``interpolate(antialias=True)``; the
    result is rounded and clipped as the JAX wrapper does."""

    def __init__(self, env: MOEnv, shape: Tuple[int, int] = (84, 84)):
        super().__init__(env)
        self._hw = tuple(shape)
        rest = env.observation_space.shape[2:]
        self.observation_space = ArrayBox(0, 255, self._hw + tuple(rest))

    def _map(self, obs):
        with span("env.frames"):
            x = obs.to(torch.float32)
            x = x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)  # (n, C, H, W)
            y = F.interpolate(x, size=self._hw, mode="bilinear", align_corners=False, antialias=True)
            y = y[:, 0] if obs.dim() == 3 else y.permute(0, 2, 3, 1)
            return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Stateful wrappers
# ---------------------------------------------------------------------------


class FrameStackState(NamedTuple):
    inner: Any
    frames: torch.Tensor  # (n, k, *frame_shape)


class FrameStackObservation(_Wrapper):
    """Stack the last k observations on a new axis after the env axis
    (gymnasium FrameStackObservation; a reset pads with the reset frame)."""

    def __init__(self, env: MOEnv, num_stack: int = 4):
        super().__init__(env)
        self.num_stack = num_stack
        sp = env.observation_space
        lo = sp.low if np.isscalar(sp.low) else float(np.min(sp.low))
        hi = sp.high if np.isscalar(sp.high) else float(np.max(sp.high))
        self.observation_space = ArrayBox(lo, hi, (num_stack, *sp.shape))

    def reset(self, n: int, gen: torch.Generator):
        inner, obs = self.env.reset(n, gen)
        with span("env.frames"):
            frames = obs[:, None].expand(n, self.num_stack, *obs.shape[1:]).clone()
        return FrameStackState(inner, frames), frames

    def step(self, state: FrameStackState, action, noise=None) -> StepOut:
        out = self.env.step(state.inner, action, noise)
        with span("env.frames"):
            frames = torch.cat([state.frames[:, 1:], out.obs[:, None]], dim=1)
        return StepOut(FrameStackState(out.state, frames), frames, out.reward, out.terminated, out.truncated)


class MOMaxAndSkipObservation(_Wrapper):
    """Repeat the action ``skip`` times, sum the vector rewards, return the
    elementwise max of the last two frames (mo_gymnasium.wrappers
    MOMaxAndSkipObservation).  An env's sub-steps after its episode ended
    leave its state, obs and reward as they were (the gym wrapper breaks out
    of its loop)."""

    def __init__(self, env: MOEnv, skip: int = 4):
        super().__init__(env)
        self.skip = skip
        self.noise_env_dim = env.noise_env_dim + 1  # the sub-step draws are stacked in front

    def reset(self, n: int, gen: torch.Generator):
        return self.env.reset(n, gen)

    def sample_noise(self, n: int, gen: torch.Generator):
        """The inner env's noise of each sub-step, stacked (skip, n, ...); None for a deterministic env."""
        draws = [self.env.sample_noise(n, gen) for _ in range(self.skip)]
        return None if draws[0] is None else torch.stack(draws)

    def step(self, state, action, noise=None) -> StepOut:
        terminated = truncated = reward = prev_obs = cur_obs = None
        for i in range(self.skip):
            out = self.env.step(state, action, None if noise is None else noise[i])
            if cur_obs is None:
                state, reward, cur_obs = out.state, out.reward, out.obs
                terminated, truncated = out.terminated, out.truncated
                continue
            alive = ~(terminated | truncated)
            state = tree_where(alive, out.state, state)
            reward = reward + torch.where(alive[:, None], out.reward, 0.0)
            with span("env.frames"):
                prev_obs, cur_obs = cur_obs, tree_where(alive, out.obs, cur_obs)
            terminated, truncated = terminated | out.terminated, truncated | out.truncated
        with span("env.frames"):
            obs = cur_obs if prev_obs is None else torch.maximum(prev_obs, cur_obs)
        return StepOut(state, obs, reward, terminated, truncated)


class TimeLimitState(NamedTuple):
    inner: Any
    t: torch.Tensor  # (n,) int32


class TimeLimit(_Wrapper):
    """Truncate after ``max_episode_steps`` wrapper-level steps (gymnasium
    TimeLimit; the mario stack caps at 1000)."""

    def __init__(self, env: MOEnv, max_episode_steps: int):
        super().__init__(env)
        self.max_episode_steps = max_episode_steps

    def reset(self, n: int, gen: torch.Generator):
        inner, obs = self.env.reset(n, gen)
        return TimeLimitState(inner, torch.zeros((n,), dtype=torch.int32, device=gen.device)), obs

    def step(self, state: TimeLimitState, action, noise=None) -> StepOut:
        out = self.env.step(state.inner, action, noise)
        t = state.t + 1
        truncated = out.truncated | (t >= self.max_episode_steps)
        return StepOut(TimeLimitState(out.state, t), out.obs, out.reward, out.terminated, truncated)


def wrap_pixel_stack(env: MOEnv) -> MOEnv:
    """The reference's mario CNN stack (launch_experiment.py:158-180):
    MaxAndSkip(4) -> Resize(84, 84) -> Grayscale -> FrameStack(4) ->
    TimeLimit(1000) -> Flatten.

    The flatten keeps the agent interface 1-D (buffers and batches stay
    (N, D)); the CNN trunk reshapes back to (k, H, W) (``EnvelopeQNet``'s
    ``image_shape``)."""
    env = MOMaxAndSkipObservation(env, skip=4)
    env = ResizeObservation(env, (84, 84))
    env = GrayscaleObservation(env)
    env = FrameStackObservation(env, 4)
    env = TimeLimit(env, 1000)
    return FlattenObservation(env)
