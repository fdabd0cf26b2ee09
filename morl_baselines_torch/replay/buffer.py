"""Device-resident uniform replay buffer.

PyTorch port of ``morl_baselines_tpu/replay/buffer.py`` (reference
morl_baselines/common/buffer.py:50-135).  The storage is preallocated tensors
on one device, written **in place** (``index_copy_``) instead of returning a
new pytree; the write pointer and the fill size are host integers, so adding
and sampling never wait on the device.

Supports batched adds (N transitions per env-step from the vectorized env)
via scatter at ring positions, and CER ("use latest transition in every
sampled batch", reference buffer.py:103-106) as an option on ``sample``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import span


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor  # (d,) vector reward
    next_obs: torch.Tensor
    terminated: torch.Tensor  # float 0/1


def _storage(capacity, obs_dim, action_shape, reward_dim, action_dtype, obs_dtype, device, lead: tuple = ()) -> Transition:
    return Transition(
        obs=torch.zeros((*lead, capacity, obs_dim), dtype=obs_dtype, device=device),
        action=torch.zeros((*lead, capacity, *action_shape), dtype=action_dtype, device=device),
        reward=torch.zeros((*lead, capacity, reward_dim), dtype=torch.float32, device=device),
        next_obs=torch.zeros((*lead, capacity, obs_dim), dtype=obs_dtype, device=device),
        terminated=torch.zeros((*lead, capacity), dtype=torch.float32, device=device),
    )


class ReplayBuffer:
    def __init__(self, data: Transition):
        self.data = data  # tensors of shape (capacity, ...)
        self.ptr = 0  # next write position
        self.size = 0  # number of valid rows

    @property
    def capacity(self) -> int:
        return self.data.obs.shape[0]

    @staticmethod
    def create(
        capacity: int,
        obs_dim: int,
        action_shape: tuple = (),
        reward_dim: int = 2,
        action_dtype=torch.int64,
        obs_dtype=torch.float32,
        device="cuda",
    ) -> "ReplayBuffer":
        return ReplayBuffer(_storage(capacity, obs_dim, action_shape, reward_dim, action_dtype, obs_dtype, device))

    def _ring_idx(self, n: int) -> torch.Tensor:
        return (self.ptr + torch.arange(n, device=self.data.obs.device)) % self.capacity

    def add_batch(self, batch: Transition) -> "ReplayBuffer":
        """Insert N transitions at the ring pointer (N = leading dim), in place."""
        with span("replay.add"):
            return self._store(batch)

    def _store(self, batch: Transition) -> "ReplayBuffer":
        """``add_batch``'s ring scatter, outside its span (a subclass's span holds it)."""
        n = batch.obs.shape[0]
        idx = self._ring_idx(n)
        for buf, new in zip(self.data, batch):
            buf.index_copy_(0, idx, new.to(buf.dtype))
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        return self

    def gather(self, idx: torch.Tensor) -> Transition:
        """The rows at ``idx``, as the storage's own row type."""
        return type(self.data)(*(x[idx] for x in self.data))

    def add(self, tr: Transition) -> "ReplayBuffer":
        """Insert one transition (fields without the leading batch dim), in place."""
        return self.add_batch(type(tr)(*(torch.as_tensor(x, device=self.data.obs.device)[None] for x in tr)))

    def get_all_data(self, max_samples: int | None = None) -> Transition:
        """The valid rows as host numpy arrays (reference buffer.py:126-135);
        above ``max_samples`` rows, a subset drawn without replacement by
        ``np.random.default_rng(0)``, as the JAX package draws it."""
        rows = type(self.data)(*(x[: self.size].cpu().numpy() for x in self.data))
        if max_samples is not None and self.size > max_samples:
            sel = np.random.default_rng(0).choice(self.size, max_samples, replace=False)
            rows = type(rows)(*(x[sel] for x in rows))
        return rows

    def sample(self, gen: torch.Generator, batch_size: int, use_cer: bool = False) -> Transition:
        """Uniform sample of batch_size transitions (with replacement).

        use_cer: overwrite index 0 with the most recent transition
        (reference buffer.py:103-106).
        """
        with span("replay.sample"):
            idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=gen, device=gen.device)
            if use_cer:
                idx[0] = (self.ptr - 1) % self.capacity
            return self.gather(idx)

    def sample_obs(self, gen: torch.Generator, batch_size: int) -> torch.Tensor:
        """Sample observations only (reference buffer.py:118-124, used by Dyna)."""
        idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=gen, device=gen.device)
        return self.data.obs[idx]


class MemberReplayBuffer:
    """One ring buffer per population member, stacked on a leading axis:
    storage (P, capacity, ...).  Every member adds its N rows of a step at
    once (one shared pointer, as the JAX package's vmapped buffers keep equal
    pointers), and each member samples its own indices."""

    def __init__(self, data: Transition):
        self.data = data  # tensors of shape (members, capacity, ...)
        self.ptr = 0
        self.size = 0

    @property
    def members(self) -> int:
        return self.data.obs.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.obs.shape[1]

    @staticmethod
    def create(
        members: int,
        capacity: int,
        obs_dim: int,
        action_shape: tuple = (),
        reward_dim: int = 2,
        action_dtype=torch.int64,
        obs_dtype=torch.float32,
        device="cuda",
    ) -> "MemberReplayBuffer":
        return MemberReplayBuffer(_storage(capacity, obs_dim, action_shape, reward_dim, action_dtype, obs_dtype, device, (members,)))

    def add_batch(self, batch: Transition) -> "MemberReplayBuffer":
        """Insert (P, N, ...) transitions at the ring pointer, in place."""
        with span("replay.add"):
            return self._store(batch)

    def _store(self, batch: Transition) -> "MemberReplayBuffer":
        """``add_batch``'s ring scatter, outside its span (a subclass's span holds it)."""
        n = batch.obs.shape[1]
        idx = (self.ptr + torch.arange(n, device=self.data.obs.device)) % self.capacity
        for buf, new in zip(self.data, batch):
            buf.index_copy_(1, idx, new.to(buf.dtype))
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        return self

    def sample(self, gen: torch.Generator, batch_size: int, shard=None) -> Transition:
        """batch_size uniform rows (with replacement) from each member's ring:
        (P, batch_size, ...).  The members sharded over ranks (``shard``), the
        indices are drawn for all members and each rank keeps its own."""
        with span("replay.sample"):
            n = self.members if shard is None else self.members * shard.world
            idx = torch.randint(0, max(self.size, 1), (n, batch_size), generator=gen, device=gen.device)
            idx = idx if shard is None else shard.local(idx)
            rows = torch.arange(self.members, device=idx.device)[:, None]
            return Transition(*(x[rows, idx] for x in self.data))
