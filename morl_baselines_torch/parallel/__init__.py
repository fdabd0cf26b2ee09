"""Sharding over ``torch.distributed``: the port of ``morl_baselines_tpu/parallel``."""

from .mesh import (
    RowShard,
    assert_replicas_synced,
    batch_sharded,
    launch,
    make_mesh,
    replicated,
    shard_agent_state,
)

__all__ = [
    "RowShard",
    "assert_replicas_synced",
    "batch_sharded",
    "launch",
    "make_mesh",
    "replicated",
    "shard_agent_state",
]
