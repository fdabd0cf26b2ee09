"""Agent base: config contract, logging — the host-side shell.

PyTorch port of ``morl_baselines_tpu/agents/base.py`` (reference MOAgent /
MOPolicy contracts, common/morl_algorithm.py:23-337): config export, the
metric logger and the result accessors.  Checkpointing comes in a later
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..envs.base import MOEnv
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger


class MOAgentBase:
    """Shared shell for all algorithms; ``device`` defaults to CUDA and never
    falls back to the CPU."""

    def __init__(
        self,
        env: MOEnv,
        config: Any,
        log: bool = False,
        experiment_name: str | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.env = env
        self.config = config
        self.reward_dim = env.reward_dim
        self.obs_dim = env.obs_dim
        self.logger = MetricLogger(experiment=experiment_name or type(self).__name__, enabled=log)

    @property
    def ccs(self) -> list:
        """Convex coverage set value vectors found so far (outer-loop agents)."""
        ls = getattr(self, "_linear_support", None)
        return list(ls.ccs) if ls is not None else []

    @property
    def last_eval(self):
        """(return, discounted_return) of the most recent evaluation, if any."""
        return getattr(self, "_last_eval", None)

    def get_config(self) -> dict:
        """Flat config dict (reference morl_algorithm.py:275-281)."""
        cfg = dataclasses.asdict(self.config) if dataclasses.is_dataclass(self.config) else dict(self.config)
        cfg["env_id"] = self.env.name
        cfg["algo"] = type(self).__name__
        return cfg
