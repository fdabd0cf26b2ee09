"""Env registry — name -> constructor, mirroring MO-Gymnasium ids.

PyTorch port of ``morl_baselines_tpu/envs/registry.py`` for the ids the port
has so far; any other id raises ``KeyError``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import MOEnv
from .dst import DeepSeaTreasure
from .minecart import Minecart

ENV_REGISTRY: Dict[str, Callable[..., MOEnv]] = {
    "deep-sea-treasure-v0": lambda **kw: DeepSeaTreasure(dst_map="convex", **kw),
    "minecart-v0": lambda **kw: Minecart(deterministic=False, **kw),
    "minecart-deterministic-v0": lambda **kw: Minecart(deterministic=True, **kw),
}


def make(env_id: str, **kwargs) -> MOEnv:
    if env_id not in ENV_REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; known: {sorted(ENV_REGISTRY)}")
    env = ENV_REGISTRY[env_id](**kwargs)
    env.name = env_id
    return env
