"""Agent base: config contract, checkpointing, logging — the host-side shell.

PyTorch port of ``morl_baselines_tpu/agents/base.py`` (reference MOAgent /
MOPolicy contracts, common/morl_algorithm.py:23-337): config export, the
metric logger, the result accessors, and a checkpoint of an algorithm's
whole state in one ``torch.save`` file.

A checkpoint walks the state through dataclasses, NamedTuples, tuples,
lists, dicts and the attributes of plain objects (the replay buffers), and
stores tensors, modules and optimizers (``state_dict``), generators
(``get_state``), numpy arrays (as tensors of their dtype) and Python scalars,
every tensor on the CPU: ``torch.load(..., weights_only=True)`` reads it.
Envs, vector envs and a sharded state's ``RowShard`` are configuration, not
state: the template's are kept.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from ..envs.base import MOEnv
from ..envs.vector import VectorMOEnv
from ..models.networks import MemberAdam
from ..parallel.mesh import RowShard
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger

_OPTIMIZERS = (torch.optim.Optimizer, MemberAdam)
_SCALARS = (bool, int, float, str, type(None))
_STATIC = (MOEnv, VectorMOEnv, RowShard)


def _cpu(x: Any) -> Any:
    """A ``state_dict``'s tensors moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def state_tree(x: Any) -> Any:
    """``x`` as the tree a checkpoint stores: CPU tensors, scalars, lists and
    dicts.  Two states that continue alike give equal trees."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (nn.Module, *_OPTIMIZERS)):
        return _cpu(x.state_dict())
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, _STATIC):
        return None
    if isinstance(x, _SCALARS):
        return x
    if dataclasses.is_dataclass(x):
        return {f.name: state_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [state_tree(v) for v in x]
    if isinstance(x, dict):
        return {k: state_tree(v) for k, v in x.items()}
    if hasattr(x, "__dict__"):
        return {k: state_tree(v) for k, v in vars(x).items()}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _unpack(t: Any, s: Any) -> Any:
    """The template ``t`` with the saved values ``s``, on ``t``'s devices and dtypes."""
    if isinstance(t, torch.Tensor):
        if t.requires_grad:  # a leaf an optimizer holds: restore it in place
            with torch.no_grad():
                t.copy_(s)
            return t
        return s.to(device=t.device, dtype=t.dtype)
    if isinstance(t, torch.optim.Optimizer):
        # as saved: ``load_state_dict`` makes a capturable group's step counts float32,
        # so each state tensor gets its saved dtype back; a capturable group steps only
        # CUDA parameters, so on the CPU it loads as the default Adam
        t.load_state_dict(s)
        for group, saved in zip(t.param_groups, s["param_groups"]):
            for p, i in zip(group["params"], saved["params"]):
                for k, v in s["state"].get(i, {}).items():
                    if isinstance(v, torch.Tensor):
                        t.state[p][k] = t.state[p][k].to(v.dtype)
            if group.get("capturable") and not group["params"][0].is_cuda:
                group["capturable"] = False
        return t
    if isinstance(t, (nn.Module, *_OPTIMIZERS)):
        t.load_state_dict(s)
        return t
    if isinstance(t, torch.Generator):
        t.set_state(s)
        return t
    if isinstance(t, np.ndarray):
        return s.numpy().astype(t.dtype)
    if isinstance(t, np.generic):
        return type(t)(s)
    if isinstance(t, _SCALARS):
        return s
    if isinstance(t, _STATIC):
        return t
    if isinstance(t, (tuple, list)):
        if len(t) != len(s):
            raise ValueError(f"the template's {type(t).__name__} has {len(t)} entries, the checkpoint {len(s)}")
        vals = [_unpack(a, b) for a, b in zip(t, s)]
        return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
    if isinstance(t, dict):
        return {k: _unpack(v, s[k]) for k, v in t.items()}
    if dataclasses.is_dataclass(t) or hasattr(t, "__dict__"):
        names = [f.name for f in dataclasses.fields(t)] if dataclasses.is_dataclass(t) else list(vars(t))
        new = copy.copy(t)  # frozen dataclasses too: rebuilt, not mutated
        for name in names:
            object.__setattr__(new, name, _unpack(getattr(t, name), s[name]))
        return new
    raise TypeError(f"cannot restore a {type(t).__name__}")


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

    # -- checkpointing ------------------------------------------------------

    def save(self, state: Any, path: str | Path) -> None:
        """Write the algorithm's whole state to ``path`` (parent directories
        created), uniform across algorithms as the JAX package's orbax
        checkpoint is (it replaces the reference's per-algorithm ``th.save``
        dicts, e.g. envelope.py:230-261).  ``state`` may be any tree of
        states, e.g. a (state, buffer) pair."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(state_tree(state), path)

    def load(self, template: Any, path: str | Path) -> Any:
        """Restore a checkpoint into ``template``, a fresh state of the same
        agent (e.g. ``init_state()``), and return it: every tensor on the
        template's device and dtype, modules, optimizers and generators
        restored in place."""
        return _unpack(template, torch.load(Path(path), map_location="cpu", weights_only=True))
