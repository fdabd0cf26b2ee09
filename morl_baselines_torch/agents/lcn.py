"""LCN — Lorenz Conditioned Networks (the fair variant of PCN).

PyTorch port of ``morl_baselines_tpu/agents/lcn.py`` (reference
multi_policy/lcn/lcn.py:26-529, Michailidis et al.): PCN where dominance is
(lambda-)Lorenz dominance — returns are compared through the cumulative sum
of their ascending-sorted objectives (``core.pareto.lorenz_vector``).  Only
the buffer's ranking and the command selection change: commands come from
the rows whose Lorenz vectors are non-dominated, not the raw returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.pareto import lorenz_vector, non_dominated_mask
from .pcn import PCN, PCNConfig


@dataclass(frozen=True)
class LCNConfig(PCNConfig):
    lorenz_lambda: float = 1.0  # 1 = pure Lorenz dominance; < 1 interpolates


class LCN(PCN):
    def __init__(self, env, config: LCNConfig = LCNConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self._buffer_rank_lambda = config.lorenz_lambda

    def _command_mask(self, vals: np.ndarray) -> np.ndarray:
        return non_dominated_mask(lorenz_vector(torch.as_tensor(vals), self.cfg.lorenz_lambda)).numpy()
