"""Pareto archives: host archive of (individual, evaluation) + device front.

PyTorch port of ``morl_baselines_tpu/core/archive.py`` (reference
``ParetoArchive``, morl_baselines/common/pareto.py:149-175).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.pareto_kernel import non_dominated_mask_auto
from ..utils.device import resolve_device
from .pareto import non_dominated_mask


class DeviceParetoFront(NamedTuple):
    """Fixed-capacity Pareto front living on a device.

    values: (N, d) float32; valid: (N,) bool.
    """

    values: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def create(capacity: int, num_objectives: int, device="cuda") -> "DeviceParetoFront":
        device = resolve_device(device)
        return DeviceParetoFront(
            values=torch.zeros((capacity, num_objectives), dtype=torch.float32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def add(self, candidates: torch.Tensor, cand_valid: torch.Tensor | None = None) -> "DeviceParetoFront":
        """Insert a batch of candidate points and re-prune; returns a new front.

        Keeps at most ``capacity`` non-dominated points, non-dominated first
        and then by the sum of objectives (a static top-k).  Ties in that score
        may come out in another order than ``lax.top_k`` gives them.
        """
        dev = self.values.device
        cand = torch.as_tensor(candidates, dtype=torch.float32, device=dev)
        if cand.dim() == 1:
            cand = cand[None, :]
        m = cand.shape[0]
        if cand_valid is None:
            cand_valid = torch.ones((m,), dtype=torch.bool, device=dev)
        all_vals = torch.cat([self.values, cand], dim=0)
        all_valid = torch.cat([self.valid, cand_valid.to(dev)], dim=0)
        nd = non_dominated_mask_auto(all_vals, all_valid, keep_duplicates=False)
        score = nd.to(torch.float32) * 1e6 + torch.where(nd, all_vals.sum(dim=-1), 0.0)
        _, top = torch.topk(score, self.values.shape[0])
        return DeviceParetoFront(values=all_vals[top], valid=nd[top])


class ParetoArchive:
    """Host archive of (individual, evaluation) pairs, re-pruned on insert.

    Mirrors reference pareto.py:149-175 (``ParetoArchive.add``): the archive
    always holds exactly the non-dominated evaluations seen so far, with their
    individuals (policy snapshots, parameter dicts, ...).
    """

    def __init__(self):
        self.individuals: list[Any] = []
        self.evaluations: list[np.ndarray] = []

    def add(self, individual: Any, evaluation: np.ndarray) -> None:
        self.individuals.append(individual)
        self.evaluations.append(np.asarray(evaluation, dtype=np.float64))
        vals = torch.as_tensor(np.stack(self.evaluations), dtype=torch.float32)
        # keep_duplicates=False keeps one copy of equal evaluations, like the
        # reference's list-compaction
        mask = non_dominated_mask(vals, keep_duplicates=False).tolist()
        self.individuals = [ind for ind, keep in zip(self.individuals, mask) if keep]
        self.evaluations = [ev for ev, keep in zip(self.evaluations, mask) if keep]

    @property
    def front(self) -> np.ndarray:
        if not self.evaluations:
            return np.zeros((0, 0))
        return np.stack(self.evaluations)

    def __len__(self) -> int:
        return len(self.individuals)
