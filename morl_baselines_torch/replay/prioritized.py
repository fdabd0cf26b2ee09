"""Device-resident prioritized replay — cumsum + searchsorted sampling.

PyTorch port of ``morl_baselines_tpu/replay/prioritized.py``, the re-design of
the reference's SumTree PER (reference
morl_baselines/common/prioritized_buffer.py:12-226): one ``cumsum`` and one
``searchsorted`` over the priority vector per sample, priority updates as
plain scatters.  Storage and priorities are written in place; the running
max priority stays a device scalar, so nothing waits on the device.

``MemberPrioritizedReplayBuffer`` stacks one such buffer per member on a
leading axis (the JAX package's ``PrioritizedReplayBuffer`` under
``jax.vmap``): priorities (P, capacity), a cumsum along the ring axis and
one batched ``searchsorted`` for every member's draws.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .buffer import MemberReplayBuffer, ReplayBuffer, Transition, _storage


def proportional_indices(priorities: torch.Tensor, u: torch.Tensor):
    """Rows drawn in proportion to ``priorities`` (C,) at uniforms ``u`` in
    [0, 1): the inverse CDF of the cumulative priorities.  Returns (idx, probs)."""
    cdf = torch.cumsum(priorities, dim=0)
    total = torch.clamp(cdf[-1], min=1e-12)
    idx = torch.clamp(torch.searchsorted(cdf, u * total, right=True), 0, priorities.shape[0] - 1)
    return idx, priorities[idx] / total


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, data: Transition):
        super().__init__(data)
        dev = data.obs.device
        self.priorities = torch.zeros((self.capacity,), dtype=torch.float32, device=dev)  # 0 for empty rows
        self.max_priority = torch.ones((), dtype=torch.float32, device=dev)  # for new inserts (reference :150)

    @staticmethod
    def create(
        capacity: int,
        obs_dim: int,
        action_shape: tuple = (),
        reward_dim: int = 2,
        action_dtype=torch.int64,
        obs_dtype=torch.float32,
        device="cuda",
    ) -> "PrioritizedReplayBuffer":
        return PrioritizedReplayBuffer(
            _storage(capacity, obs_dim, action_shape, reward_dim, action_dtype, obs_dtype, device)
        )

    def add_batch(self, batch: Transition, priority: torch.Tensor | None = None) -> "PrioritizedReplayBuffer":
        """Insert N transitions with priority (default: current max, reference :147-156)."""
        with span("replay.add"):
            n = batch.obs.shape[0]
            idx = self._ring_idx(n)
            p = self.max_priority if priority is None else priority
            self.priorities.index_copy_(0, idx, torch.broadcast_to(p, (n,)).to(torch.float32))
            return self._store(batch)

    def sample(self, gen: torch.Generator, batch_size: int):
        """Proportional sampling: returns (batch, idx, probs)."""
        with span("replay.sample"):
            return self.sample_at(torch.rand((batch_size,), generator=gen, device=gen.device))

    def sample_at(self, u: torch.Tensor):
        """Proportional sampling at given uniforms ``u`` in [0, 1).

        Inverse CDF on the cumulative priorities, as SumTree.sample's
        proportional scheme (reference :30-54).  Returns (batch, idx, probs).
        """
        idx, probs = proportional_indices(self.priorities, u)
        return self.gather(idx), idx, probs

    def update_priorities(self, idx: torch.Tensor, priorities: torch.Tensor) -> "PrioritizedReplayBuffer":
        """Scatter new priorities, tracking the running max (reference :197-205)."""
        with span("replay.update_priorities"):
            p = torch.clamp(priorities, min=1e-12)
            self.priorities[idx] = p
            self.max_priority = torch.maximum(self.max_priority, p.max())
        return self

    def reset_priorities(self, value: float = 1.0) -> "PrioritizedReplayBuffer":
        """Uniform priority ``value`` on the valid rows, 0 on the rest, and the
        running max set to ``value`` (GPI-PD continuous on a new task weight,
        reference gpi_pd.py:619-660)."""
        self.priorities = torch.where(
            torch.arange(self.capacity, device=self.priorities.device) < self.size, value, 0.0
        ).to(torch.float32)
        self.max_priority = torch.full((), value, dtype=torch.float32, device=self.priorities.device)
        return self


class MemberPrioritizedReplayBuffer(MemberReplayBuffer):
    """``PrioritizedReplayBuffer`` once per member, on a leading axis:
    storage (P, capacity, ...), priorities (P, capacity) and a running max
    priority per member (P,).  Members share the ring pointer, as the
    vmapped buffers keep equal pointers."""

    def __init__(self, data: Transition):
        super().__init__(data)
        dev = data.obs.device
        self.priorities = torch.zeros((self.members, self.capacity), dtype=torch.float32, device=dev)
        self.max_priority = torch.ones((self.members,), dtype=torch.float32, device=dev)

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
    ) -> "MemberPrioritizedReplayBuffer":
        data = MemberReplayBuffer.create(
            members, capacity, obs_dim, action_shape, reward_dim, action_dtype, obs_dtype, device
        ).data
        return MemberPrioritizedReplayBuffer(data)

    def add_batch(self, batch: Transition) -> "MemberPrioritizedReplayBuffer":
        """Insert (P, N, ...) transitions at each member's current max priority."""
        with span("replay.add"):
            n = batch.obs.shape[1]
            idx = (self.ptr + torch.arange(n, device=self.priorities.device)) % self.capacity
            self.priorities.index_copy_(1, idx, self.max_priority[:, None].expand(-1, n).contiguous())
            return self._store(batch)

    def sample(self, gen: torch.Generator, batch_size: int):
        """Proportional sampling per member: returns (batch (P, B, ...), idx (P, B), probs (P, B))."""
        with span("replay.sample"):
            return self.sample_at(torch.rand((self.members, batch_size), generator=gen, device=gen.device))

    def sample_at(self, u: torch.Tensor):
        """Each member's rows at its uniforms ``u`` (P, B) in [0, 1), by the
        inverse CDF of its cumulative priorities."""
        cdf = torch.cumsum(self.priorities, dim=1)
        total = torch.clamp(cdf[:, -1:], min=1e-12)
        idx = torch.clamp(torch.searchsorted(cdf, u * total, right=True), 0, self.capacity - 1)
        rows = torch.arange(self.members, device=idx.device)[:, None]
        return Transition(*(x[rows, idx] for x in self.data)), idx, self.priorities.gather(1, idx) / total

    def update_priorities(self, idx: torch.Tensor, priorities: torch.Tensor) -> "MemberPrioritizedReplayBuffer":
        """Scatter each member's new priorities (P, B), tracking its running max."""
        with span("replay.update_priorities"):
            p = torch.clamp(priorities, min=1e-12)
            self.priorities.scatter_(1, idx, p)
            self.max_priority = torch.maximum(self.max_priority, p.max(dim=1).values)
        return self
