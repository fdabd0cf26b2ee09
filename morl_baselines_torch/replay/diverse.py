"""DiverseMemory: multi-priority replay with a crowding-retained secondary store.

PyTorch port of ``morl_baselines_tpu/replay/diverse.py`` (reference
common/diverse_buffer.py:11-605, DynMORL's DiverseMemory).  No algorithm of
either package consumes it; it is provided for inventory completeness.

- One data ring shared by T priority vectors (the reference's several
  SumTrees, :11-198); sampling from a tree is the inverse CDF of
  ``prioritized.py``.
- A fixed-capacity secondary store: when the ring is full, the first row a
  batch overwrites replaces the store's least diverse row (by NSGA-II
  crowding distance over the trace values) unless it is itself the least
  diverse (reference move_to_sec/crowd_dist, :490-605).  The promotion is a
  ``torch.where``, so adding never waits on the device.

Every tensor is written in place; the pointer and the size are host integers.
"""

from __future__ import annotations

import torch

from .buffer import ReplayBuffer, Transition, _storage
from .episodic import crowding_distance
from .prioritized import proportional_indices


class DiverseMemory(ReplayBuffer):
    def __init__(self, data: Transition, sec_data: Transition, num_trees: int):
        super().__init__(data)
        dev = data.obs.device
        reward_dim = data.reward.shape[1]
        self.priorities = torch.zeros((num_trees, self.capacity), device=dev)
        self.trace_value = torch.zeros((self.capacity, reward_dim), device=dev)  # per-row trace signature
        self.sec_data = sec_data
        self.sec_value = torch.zeros((sec_data.obs.shape[0], reward_dim), device=dev)
        self.sec_valid = torch.zeros((sec_data.obs.shape[0],), dtype=torch.bool, device=dev)
        self.max_priority = torch.ones((), device=dev)

    @staticmethod
    def create(
        capacity: int,
        sec_capacity: int,
        obs_dim: int,
        reward_dim: int,
        num_trees: int = 2,
        action_shape: tuple = (),
        action_dtype=torch.int64,
        device="cuda",
    ) -> "DiverseMemory":
        mk = lambda cap: _storage(cap, obs_dim, action_shape, reward_dim, action_dtype, torch.float32, device)  # noqa: E731
        return DiverseMemory(mk(capacity), mk(sec_capacity), num_trees)

    def add_batch(self, batch: Transition, trace_value: torch.Tensor) -> "DiverseMemory":
        """Insert N transitions with their trace values, in place; the first
        row they overwrite may move to the secondary store."""
        n = batch.obs.shape[0]
        idx = self._ring_idx(n)
        if self.size >= self.capacity:
            evict_val = self.trace_value[idx[0]]
            sec_vals = torch.where(self.sec_valid[:, None], self.sec_value, -torch.inf)
            all_vals = torch.cat([sec_vals, evict_val[None]], dim=0)
            all_valid = torch.cat([self.sec_valid, torch.ones((1,), dtype=torch.bool, device=idx.device)])
            crowd = crowding_distance(all_vals, all_valid)
            worst = torch.argmin(torch.where(all_valid, crowd, torch.inf))
            # promote unless the evicted row is itself the least diverse
            promote = worst != all_vals.shape[0] - 1
            slot = torch.clamp(worst, max=self.sec_valid.shape[0] - 1).reshape(1)
            for sec, rows in zip(self.sec_data, self.data):
                sec[slot] = torch.where(promote, rows[idx[:1]], sec[slot])
            self.sec_value[slot] = torch.where(promote, evict_val[None], self.sec_value[slot])
            self.sec_valid[slot] = self.sec_valid[slot] | promote
        self.priorities[:, idx] = self.max_priority
        self.trace_value.index_copy_(0, idx, trace_value.to(torch.float32))
        return super().add_batch(batch)

    def sample(self, gen: torch.Generator, batch_size: int, tree: int = 0):
        """Proportional sample from priority tree ``tree`` (reference :243-293);
        returns (batch, idx, probs)."""
        return self.sample_at(torch.rand((batch_size,), generator=gen, device=gen.device), tree)

    def sample_at(self, u: torch.Tensor, tree: int = 0):
        """``sample`` at given uniforms ``u`` in [0, 1)."""
        idx, probs = proportional_indices(self.priorities[tree], u)
        return self.gather(idx), idx, probs

    def update_priorities(self, idx: torch.Tensor, priorities: torch.Tensor, tree: int = 0) -> "DiverseMemory":
        p = torch.clamp(priorities, min=1e-12)
        self.priorities[tree, idx] = p
        self.max_priority = torch.maximum(self.max_priority, p.max())
        return self

    def sample_secondary(self, gen: torch.Generator, batch_size: int):
        """Uniform sample over the retained diverse rows; returns (batch, idx).
        Reads the valid count on the host."""
        n_valid = max(int(self.sec_valid.sum()), 1)
        order = torch.argsort((~self.sec_valid).to(torch.uint8), stable=True)  # valid rows first
        idx = order[torch.randint(0, n_valid, (batch_size,), generator=gen, device=gen.device)]
        return Transition(*(x[idx] for x in self.sec_data)), idx
