"""Env registry — name -> constructor, mirroring MO-Gymnasium ids.

PyTorch port of ``morl_baselines_tpu/envs/registry.py`` for the ids the port
has so far; any other id raises ``KeyError``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import MOEnv
from .dst import DeepSeaTreasure
from .fishwood import Fishwood
from .fruit_tree import FruitTree
from .minecart import Minecart
from .mountaincar import MOMountainCar, MOMountainCarContinuous
from .planar import MOHalfCheetahJX, MOHopperJX
from .water_reservoir import WaterReservoir

ENV_REGISTRY: Dict[str, Callable[..., MOEnv]] = {
    "deep-sea-treasure-v0": lambda **kw: DeepSeaTreasure(dst_map="convex", **kw),
    "deep-sea-treasure-concave-v0": lambda **kw: DeepSeaTreasure(dst_map="concave", **kw),
    "fishwood-v0": Fishwood,
    "fruit-tree-v0": FruitTree,
    "minecart-v0": lambda **kw: Minecart(deterministic=False, **kw),
    "minecart-deterministic-v0": lambda **kw: Minecart(deterministic=True, **kw),
    "water-reservoir-v0": WaterReservoir,
    "mo-mountaincar-v0": MOMountainCar,
    "mo-mountaincarcontinuous-v0": MOMountainCarContinuous,
    # the planar MuJoCo-class locomotion envs; their constants live on ``device`` (default CUDA)
    "mo-hopper-jx-v5": MOHopperJX,
    "mo-halfcheetah-jx-v5": MOHalfCheetahJX,
}


def make(env_id: str, **kwargs) -> MOEnv:
    if env_id not in ENV_REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; known: {sorted(ENV_REGISTRY)}")
    env = ENV_REGISTRY[env_id](**kwargs)
    env.name = env_id
    return env
