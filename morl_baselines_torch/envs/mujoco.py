"""MO-MuJoCo environments: host-stepped gymnasium physics behind the batched API.

PyTorch port of ``morl_baselines_tpu/envs/mujoco.py``, the counterpart of
MO-Gymnasium's MuJoCo suite (mo-hopper, mo-halfcheetah, mo-reacher) used by
the reference's continuous-control benchmarks.  The physics runs on the host
in a pool of gymnasium envs; the env state on the device is (slot, t): each
env's index into the pool and its step count.

A vector step moves the actions to the host once (``.cpu().numpy()``), steps
the pool in a ``ThreadPoolExecutor``, resets the finished envs on the host in
the same call (same-step autoreset, as ``VectorMOEnv`` does for the device
envs) and returns obs, rewards and flags as tensors on the state's device.
``VectorMOEnv`` calls ``vector_reset``/``vector_step`` for such envs.  The
reset seeds come from the caller's generator.  The vector of rewards is
computed from the info dict the way MO-Gymnasium decomposes them:

- mo-hopper-v5: (forward velocity, jump height 10*(z - z_init), -energy)
- mo-halfcheetah-v5: (forward velocity, -energy)
- mo-reacher-v5: closeness to 4 fixed targets, 9 discrete torques

The host functions (``_host_*``) are the JAX package's, numpy for numpy.
This path trades throughput for parity; the planar ``-jx-`` envs are the
device path.  gymnasium and mujoco are imported when an env is made.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut


class MuJoCoState(NamedTuple):
    slot: torch.Tensor  # (n,) int32 index into the host pool
    t: torch.Tensor  # (n,) int32 steps into the episode


class _HostPool:
    """Round-robin pool of gymnasium env instances, host side."""

    def __init__(self, make_fn: Callable, max_envs: int = 4096):
        self.make_fn = make_fn
        self.max_envs = max_envs
        self.envs: list = []
        self.counter = 0
        self.lock = threading.Lock()

    def alloc(self) -> int:
        with self.lock:
            if len(self.envs) < self.max_envs:
                self.envs.append(self.make_fn())
                return len(self.envs) - 1
            slot = self.counter % self.max_envs
            self.counter += 1
            return slot

    def env(self, slot: int):
        return self.envs[int(slot)]


class MOMuJoCoEnv(MOEnv):
    """Host-stepped MuJoCo env with vector rewards behind the batched API."""

    def __init__(
        self,
        gym_id: str,
        reward_dim: int,
        mo_reward_fn: Callable[[np.ndarray, np.ndarray, float, dict], np.ndarray],
        name: str,
        max_episode_steps: int = 1000,
    ):
        import gymnasium

        # max_episode_steps=-1 disables the inner TimeLimit (in gymnasium 1.2.2
        # None means the spec's default, which would let Reacher's 50-step limit
        # fire before this adapter's own truncation)
        probe = gymnasium.make(gym_id, max_episode_steps=-1)
        self._gym_id = gym_id
        self._obs_dim = int(np.prod(probe.observation_space.shape))
        self._act_dim = int(np.prod(probe.action_space.shape))
        self.observation_space = Box(
            low=tuple(np.full(self._obs_dim, -np.inf)), high=tuple(np.full(self._obs_dim, np.inf))
        )
        self.action_space = Box(low=tuple(-np.ones(self._act_dim)), high=tuple(np.ones(self._act_dim)))
        self.reward_dim = reward_dim
        self.name = name
        self.max_episode_steps = max_episode_steps
        self._mo_reward_fn = mo_reward_fn
        self._act_scale = (probe.action_space.high - probe.action_space.low) / 2.0
        self._act_bias = (probe.action_space.high + probe.action_space.low) / 2.0
        probe.close()
        self._pool = _HostPool(lambda: gymnasium.make(gym_id, max_episode_steps=-1))
        self._executor_cached: ThreadPoolExecutor | None = None

    # ---- host functions ------------------------------------------------------

    def _host_reset_slot(self, slot, seed) -> np.ndarray:
        """Reset an already-allocated pool slot; returns the reset obs."""
        obs, _info = self._pool.env(int(slot)).reset(seed=int(np.asarray(seed)) % (2**31 - 1))
        return np.asarray(obs, dtype=np.float32)

    def _host_reset(self, seed):
        slot = self._pool.alloc()
        return np.int32(slot), self._host_reset_slot(slot, seed)

    def _host_step(self, slot, action):
        env = self._pool.env(int(slot))
        a = np.asarray(action, dtype=np.float64) * self._act_scale + self._act_bias
        obs, _r, term, trunc, info = env.step(a)
        mo_r = self._mo_reward_fn(np.asarray(obs), a, float(_r), info)
        return (
            np.asarray(obs, dtype=np.float32),
            np.asarray(mo_r, dtype=np.float32),
            np.bool_(term),
            np.bool_(trunc),
        )

    @property
    def _executor(self) -> ThreadPoolExecutor:
        if self._executor_cached is None:
            self._executor_cached = ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2))
        return self._executor_cached

    def _host_vector_reset(self, seeds):
        seeds = np.asarray(seeds)
        out = list(self._executor.map(lambda i: self._host_reset(seeds[i]), range(len(seeds))))
        slots = np.asarray([r[0] for r in out], dtype=np.int32)
        obs = np.stack([r[1] for r in out]).astype(np.float32)
        return slots, obs

    def _host_vector_step(self, slots, t, actions, seeds):
        """One step of every env with same-step autoreset on the host:
        (slots, new_t, obs, reward, term, trunc, final_obs)."""
        slots, t, actions, seeds = map(np.asarray, (slots, t, actions, seeds))
        n = len(slots)
        obs = np.empty((n, self._obs_dim), dtype=np.float32)
        final_obs = np.empty((n, self._obs_dim), dtype=np.float32)
        reward = np.empty((n, self.reward_dim), dtype=np.float32)
        term = np.empty((n,), dtype=np.bool_)
        trunc = np.empty((n,), dtype=np.bool_)
        new_t = np.empty((n,), dtype=np.int32)

        def one(i):
            o, r, te, tr = self._host_step(slots[i], actions[i])
            tr = bool(tr) or (int(t[i]) + 1 >= self.max_episode_steps)
            final_obs[i] = o
            reward[i] = r
            term[i] = te
            trunc[i] = tr
            if te or tr:
                obs[i] = self._host_reset_slot(slots[i], seeds[i])
                new_t[i] = 0
            else:
                obs[i] = o
                new_t[i] = int(t[i]) + 1

        list(self._executor.map(one, range(n)))
        return slots, new_t, obs, reward, term, trunc, final_obs

    def _host_batch_step(self, slots, actions):
        """One step of every env without autoreset, one after another as the
        JAX package's per-env callbacks run (the evaluation rollouts step a
        few envs, where the thread pool's hand-offs cost more than the
        physics): (obs, reward, term, trunc)."""
        out = [self._host_step(slot, a) for slot, a in zip(slots, actions)]
        return tuple(np.stack([r[k] for r in out]) for k in range(4))

    def close(self) -> None:
        """Stop the step threads and close the pool's gymnasium envs."""
        if self._executor_cached is not None:
            self._executor_cached.shutdown()
            self._executor_cached = None
        for env in self._pool.envs:
            env.close()
        self._pool.envs.clear()

    # ---- the device side -----------------------------------------------------

    def _host_actions(self, actions: torch.Tensor, n: int) -> np.ndarray:
        return actions.detach().to("cpu", torch.float32).reshape(n, self._act_dim).numpy()

    @staticmethod
    def _seeds(n: int, gen: torch.Generator) -> np.ndarray:
        return torch.randint(0, 2**31 - 1, (n,), generator=gen, device=gen.device).cpu().numpy()

    def reset(self, n: int, gen: torch.Generator):
        slots, obs = self._host_vector_reset(self._seeds(n, gen))
        dev = gen.device
        state = MuJoCoState(torch.as_tensor(slots, device=dev), torch.zeros((n,), dtype=torch.int32, device=dev))
        return state, torch.as_tensor(obs, device=dev)

    def step(self, state: MuJoCoState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        n, dev = state.slot.shape[0], state.slot.device
        obs, reward, term, trunc = self._host_batch_step(state.slot.cpu().numpy(), self._host_actions(action, n))
        t = state.t + 1
        trunc = torch.as_tensor(trunc, device=dev) | (t >= self.max_episode_steps)
        return StepOut(
            MuJoCoState(state.slot, t), torch.as_tensor(obs, device=dev), torch.as_tensor(reward, device=dev),
            torch.as_tensor(term, device=dev), trunc,
        )

    def vector_reset(self, gen: torch.Generator, num_envs: int):
        """``VectorMOEnv``'s reset: one host call for the batch (``reset`` already is one)."""
        return self.reset(num_envs, gen)

    def vector_step(self, state: MuJoCoState, actions: torch.Tensor, gen: torch.Generator):
        """``VectorMOEnv``'s step: one host call for the batch, the finished
        envs reset on the host from seeds drawn from ``gen``."""
        from .vector import VecStepOut

        n, dev = state.slot.shape[0], state.slot.device
        seeds = self._seeds(n, gen)
        slots, new_t, obs, reward, term, trunc, final_obs = self._host_vector_step(
            state.slot.cpu().numpy(), state.t.cpu().numpy(), self._host_actions(actions, n), seeds
        )
        to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        return VecStepOut(MuJoCoState(to(slots), to(new_t)), to(obs), to(reward), to(term), to(trunc), to(final_obs))


def _hopper_mo_reward(obs, action, scalar_r, info):
    """(velocity, jump height, energy): MO-Gymnasium's mo-hopper decomposition."""
    vx = info.get("x_velocity", 0.0)
    z = obs[0]  # hopper obs[0] is the torso height
    height = 10.0 * (z - 1.25)  # 1.25 = initial torso height
    energy = -2e-4 * float(np.sum(np.square(action)))
    return np.array([vx, height, energy], dtype=np.float32)


def _halfcheetah_mo_reward(obs, action, scalar_r, info):
    """(velocity, energy): MO-Gymnasium's mo-halfcheetah decomposition."""
    vx = info.get("x_velocity", 0.0)
    energy = -0.1 * float(np.sum(np.square(action)))
    return np.array([vx, energy], dtype=np.float32)


class MOReacher(MOMuJoCoEnv):
    """MO Reacher: 4 objectives = closeness to 4 fixed targets, 9 discrete torques.

    Counterpart of MO-Gymnasium's ``mo-reacher-v5`` (the 4-target reacher of
    the Envelope paper): targets sit at radius 0.14 at angles 0/90/180/270,
    reward_i = 1 - 4*||fingertip - target_i||, actions are the 9 torque
    combinations {-1, 0, 1}^2, observation is
    [cos θ1, cos θ2, sin θ1, sin θ2, qvel1, qvel2].
    """

    _TORQUES = np.array(
        [[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1], [1, 1], [1, -1], [-1, 1], [-1, -1]],
        dtype=np.float64,
    )
    _TARGETS = 0.14 * np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.float64)

    def __init__(self, max_episode_steps: int = 100):
        super().__init__("Reacher-v5", 4, lambda *a: None, "mo-reacher-v5", max_episode_steps)
        self._obs_dim = 6
        self.observation_space = Box(low=tuple(np.full(6, -np.inf)), high=tuple(np.full(6, np.inf)))
        self.action_space = Discrete(9)

    def _reacher_obs(self, env) -> np.ndarray:
        qpos = env.unwrapped.data.qpos
        qvel = env.unwrapped.data.qvel
        return np.array(
            [np.cos(qpos[0]), np.cos(qpos[1]), np.sin(qpos[0]), np.sin(qpos[1]), qvel[0], qvel[1]],
            dtype=np.float32,
        )

    def _host_reset_slot(self, slot, seed) -> np.ndarray:
        env = self._pool.env(int(slot))
        env.reset(seed=int(np.asarray(seed)) % (2**31 - 1))
        return self._reacher_obs(env)

    def _host_step(self, slot, action):
        env = self._pool.env(int(slot))
        torque = self._TORQUES[int(np.asarray(action))]
        env.step(torque)
        tip = env.unwrapped.get_body_com("fingertip")[:2]
        dists = np.linalg.norm(self._TARGETS - tip[None, :], axis=1)
        mo_r = (1.0 - 4.0 * dists).astype(np.float32)
        return self._reacher_obs(env), mo_r, np.bool_(False), np.bool_(False)

    def _host_actions(self, actions: torch.Tensor, n: int) -> np.ndarray:
        return actions.detach().to("cpu", torch.int64).reshape(n).numpy()


def make_mo_reacher(max_episode_steps: int = 100) -> MOReacher:
    return MOReacher(max_episode_steps)


def make_mo_hopper(max_episode_steps: int = 1000) -> MOMuJoCoEnv:
    return MOMuJoCoEnv("Hopper-v5", 3, _hopper_mo_reward, "mo-hopper-v5", max_episode_steps)


def make_mo_halfcheetah(max_episode_steps: int = 1000) -> MOMuJoCoEnv:
    return MOMuJoCoEnv("HalfCheetah-v5", 2, _halfcheetah_mo_reward, "mo-halfcheetah-v5", max_episode_steps)
