"""Vectorized autoresetting MO envs + episode statistics.

PyTorch port of ``morl_baselines_tpu/envs/vector.py`` (the counterpart of
MO-Gymnasium's ``MOSyncVectorEnv`` / ``MORecordEpisodeStatistics``).  The N
env states are (N, ...) tensors on one device and step in one batched call;
autoreset is a ``torch.where`` select.

Autoreset semantics: *same-step* — when an episode ends, the returned obs is
already the reset obs, and the pre-reset final obs is returned separately so
TD targets can bootstrap correctly (``final_obs`` + ``terminated``).

An env that steps on the host (the MuJoCo adapter) provides
``vector_reset``/``vector_step``, which reset and step the whole batch in one
host call with the autoreset done there; ``VectorMOEnv`` calls them instead.

Sharded over ranks (``parallel.RowShard``), a rank holds its slice of the
``num_envs`` env states; ``reset`` and ``step`` draw the reset and the step
noise of all ``num_envs`` envs and keep the local rows, so each env sees the
draws it sees in one process.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..parallel.mesh import local
from ..utils.profiling import span
from .base import MOEnv, tree_where


class VecStepOut(NamedTuple):
    state: Any  # env-state NamedTuple of (N, ...) tensors (nested for wrapped envs)
    obs: torch.Tensor  # (N, obs_dim), or (N, *frame) for image obs — post-autoreset obs
    reward: torch.Tensor  # (N, d)
    terminated: torch.Tensor  # (N,)
    truncated: torch.Tensor  # (N,)
    final_obs: torch.Tensor  # pre-reset obs of this step, obs's shape


class VectorMOEnv:
    """N copies of a batched MOEnv with same-step autoreset."""

    def __init__(self, env: MOEnv, num_envs: int):
        self.env = env
        self.num_envs = num_envs
        self.reward_dim = env.reward_dim

    def reset(self, gen: torch.Generator, shard=None):
        if hasattr(self.env, "vector_reset"):
            _host_unsharded(self.env, shard)
            return self.env.vector_reset(gen, self.num_envs)
        return local(shard, self.env.reset(self.num_envs, gen))

    def step(self, state, actions: torch.Tensor, gen: torch.Generator, shard=None) -> VecStepOut:
        with span("env.step"):
            if hasattr(self.env, "vector_step"):
                _host_unsharded(self.env, shard)
                return self.env.vector_step(state, actions, gen)
            n = self.num_envs
            noise = local(shard, self.env.sample_noise(n, gen), self.env.noise_env_dim)
            out = self.env.step(state, actions, noise)
            done = out.terminated | out.truncated
            reset_state, reset_obs = local(shard, self.env.reset(n, gen))
            # select reset state/obs where done (same-step autoreset)
            new_state = tree_where(done, reset_state, out.state)
            obs = tree_where(done, reset_obs, out.obs)
            return VecStepOut(new_state, obs, out.reward, out.terminated, out.truncated, out.obs)


def _host_unsharded(env: MOEnv, shard) -> None:
    if shard is not None:
        raise NotImplementedError(
            f"{env.name} steps on the host; sharding its vector env over ranks is not ported "
            "(ROADMAP Queue 3: host MuJoCo under a shard)"
        )


class EpisodeStats(NamedTuple):
    """Per-env episode accumulators; reported rows are only meaningful at done."""

    ret: torch.Tensor  # (N, d) undiscounted vector return
    disc_ret: torch.Tensor  # (N, d) discounted vector return
    length: torch.Tensor  # (N,)
    gamma_pow: torch.Tensor  # (N,)

    @staticmethod
    def create(num_envs: int, reward_dim: int, device) -> "EpisodeStats":
        return EpisodeStats(
            ret=torch.zeros((num_envs, reward_dim), device=device),
            disc_ret=torch.zeros((num_envs, reward_dim), device=device),
            length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            gamma_pow=torch.ones((num_envs,), device=device),
        )

    def update(self, reward: torch.Tensor, done: torch.Tensor, gamma: float):
        """Returns (next_stats, finished: EpisodeStats of rows that just ended).

        ``finished`` holds the completed-episode statistics (the reference's
        info["episode"] r/dr/l); rows where ``done`` is False are zeros.
        """
        ret = self.ret + reward
        disc = self.disc_ret + self.gamma_pow[:, None] * reward
        length = self.length + 1
        d = done[:, None]
        finished = EpisodeStats(
            ret=torch.where(d, ret, 0.0),
            disc_ret=torch.where(d, disc, 0.0),
            length=torch.where(done, length, 0),
            gamma_pow=torch.zeros_like(self.gamma_pow),
        )
        nxt = EpisodeStats(
            ret=torch.where(d, 0.0, ret),
            disc_ret=torch.where(d, 0.0, disc),
            length=torch.where(done, 0, length),
            gamma_pow=torch.where(done, 1.0, self.gamma_pow * gamma),
        )
        return nxt, finished


# ---------------------------------------------------------------------------
# Reward normalization / clipping (functional MONormalizeReward / MOClipReward)
# ---------------------------------------------------------------------------


class RewardNormState(NamedTuple):
    """Per-objective running stats of discounted return (gymnasium semantics).

    Leading axes (a population's member axis) come before the env axis:
    mean and var (..., d), count (...), returns (..., N, d).
    """

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor
    returns: torch.Tensor

    @staticmethod
    def create(num_envs: int, reward_dim: int, device, lead: tuple = ()) -> "RewardNormState":
        return RewardNormState(
            mean=torch.zeros((*lead, reward_dim), device=device),
            var=torch.ones((*lead, reward_dim), device=device),
            count=torch.full(lead, 1e-4, device=device),
            returns=torch.zeros((*lead, num_envs, reward_dim), device=device),
        )


def normalize_reward(
    state: RewardNormState,
    reward: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    eps: float = 1e-8,
    clip: float | None = None,
):
    """Normalize vector rewards (..., N, d) by the std of their discounted returns.

    Per-objective version of gymnasium's NormalizeReward, as MO-Gymnasium's
    MONormalizeReward does for one chosen index (reference mo_ppo.py:133-136
    applies it per objective).  The return accumulator is reset by this
    step's own ``done`` (..., N).  The statistics are over the env axis, the
    population variance (ddof 0).  Optionally clip (MOClipReward).
    """
    returns = state.returns * gamma * (1.0 - done.to(torch.float32))[..., None] + reward
    batch_mean = returns.mean(dim=-2)
    batch_var = returns.var(dim=-2, correction=0)
    batch_count = returns.shape[-2]
    count = state.count[..., None]
    delta = batch_mean - state.mean
    tot = count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m2 = state.var * count + batch_var * batch_count + delta**2 * count * batch_count / tot
    new_var = m2 / tot
    normed = reward / torch.sqrt(new_var + eps)[..., None, :]
    if clip is not None:
        normed = torch.clamp(normed, -clip, clip)
    return RewardNormState(new_mean, new_var, state.count + batch_count, returns), normed
