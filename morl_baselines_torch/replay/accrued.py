"""Accrued-reward replay buffer for ESR algorithms (EUPG).

PyTorch port of ``morl_baselines_tpu/replay/accrued.py`` (reference
common/accrued_reward_buffer.py:7-117): each transition also stores the
reward *accrued so far in the episode* (the ESR conditioning variable) and
the in-episode timestep.  The storage is the uniform ring buffer's, written
in place; ``reset`` zeroes the pointer and the size, so the tensors are
reused (EUPG is on-policy and clears its buffer each episode, reference
eupg.py:360-363).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .buffer import ReplayBuffer


class AccruedTransition(NamedTuple):
    obs: torch.Tensor
    accrued_reward: torch.Tensor  # (d,) reward accrued before this step
    action: torch.Tensor
    reward: torch.Tensor  # (d,)
    next_obs: torch.Tensor
    terminated: torch.Tensor
    timestep: torch.Tensor  # int32 in-episode t


class AccruedRewardReplayBuffer(ReplayBuffer):
    """``add_batch``, ``gather`` and ``sample`` (uniform, from a
    ``torch.Generator``) are the ring buffer's, over ``AccruedTransition`` rows."""

    @staticmethod
    def create(
        capacity: int,
        obs_dim: int,
        reward_dim: int,
        action_shape: tuple = (),
        action_dtype=torch.int64,
        device="cuda",
    ) -> "AccruedRewardReplayBuffer":
        z = lambda *shape, dtype=torch.float32: torch.zeros((capacity, *shape), dtype=dtype, device=device)  # noqa: E731
        return AccruedRewardReplayBuffer(
            AccruedTransition(
                obs=z(obs_dim),
                accrued_reward=z(reward_dim),
                action=z(*action_shape, dtype=action_dtype),
                reward=z(reward_dim),
                next_obs=z(obs_dim),
                terminated=z(),
                timestep=z(dtype=torch.int32),
            )
        )

    def get_all(self) -> tuple[AccruedTransition, torch.Tensor]:
        """All rows and their validity mask (fixed shape; reference get_all_data :95-110)."""
        valid = torch.arange(self.capacity, device=self.data.obs.device) < self.size
        return self.data, valid

    def reset(self) -> "AccruedRewardReplayBuffer":
        """On-policy cleanup between episodes (reference cleanup :112-117)."""
        self.ptr, self.size = 0, 0
        return self
