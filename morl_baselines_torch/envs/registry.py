"""Env registry — name -> constructor, mirroring MO-Gymnasium ids.

PyTorch port of ``morl_baselines_tpu/envs/registry.py``: every id of the
JAX registry.  The host-stepped MuJoCo ids (``mo-hopper-v5``,
``mo-halfcheetah-v5``, their v4 aliases and ``mo-reacher-v4/v5``) import
gymnasium and mujoco only when such an env is made.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import MOEnv
from .breakable_bottles import BreakableBottles
from .dst import DeepSeaTreasure
from .fishwood import Fishwood
from .four_room import FourRoom
from .fruit_tree import FruitTree
from .highway import MOHighway
from .lunar_lander import MOLunarLander, MOLunarLanderContinuous
from .minecart import Minecart
from .mountaincar import MOMountainCar, MOMountainCarContinuous
from .pixel import PixelDST
from .planar import MOHalfCheetahJX, MOHopperJX
from .resource_gathering import ResourceGathering
from .water_reservoir import WaterReservoir
from .wrappers import wrap_pixel_stack


def _mujoco_env(maker: str):
    def build(**kw):
        from . import mujoco

        return {"hopper": mujoco.make_mo_hopper, "halfcheetah": mujoco.make_mo_halfcheetah,
                "reacher": mujoco.make_mo_reacher}[maker](**kw)

    return build


ENV_REGISTRY: Dict[str, Callable[..., MOEnv]] = {
    "deep-sea-treasure-v0": lambda **kw: DeepSeaTreasure(dst_map="convex", **kw),
    "deep-sea-treasure-concave-v0": lambda **kw: DeepSeaTreasure(dst_map="concave", **kw),
    "fishwood-v0": Fishwood,
    "fruit-tree-v0": FruitTree,
    "resource-gathering-v0": ResourceGathering,
    "four-room-v0": FourRoom,
    "breakable-bottles-v0": BreakableBottles,
    "water-reservoir-v0": WaterReservoir,
    "mo-mountaincar-v0": MOMountainCar,
    "mo-mountaincarcontinuous-v0": MOMountainCarContinuous,
    "mo-lunar-lander-v3": MOLunarLander,
    "mo-lunar-lander-continuous-v3": MOLunarLanderContinuous,
    "minecart-v0": lambda **kw: Minecart(deterministic=False, **kw),
    "minecart-deterministic-v0": lambda **kw: Minecart(deterministic=True, **kw),
    # host-stepped MuJoCo (gymnasium's physics in a host pool)
    "mo-hopper-v5": _mujoco_env("hopper"),
    "mo-halfcheetah-v5": _mujoco_env("halfcheetah"),
    # v4 aliases (the reference's examples use both generations)
    "mo-hopper-v4": _mujoco_env("hopper"),
    "mo-halfcheetah-v4": _mujoco_env("halfcheetah"),
    "mo-reacher-v4": _mujoco_env("reacher"),
    "mo-reacher-v5": _mujoco_env("reacher"),
    # pixel-observation DST, alone and under the reference's mario CNN wrapper stack
    "deep-sea-treasure-pixel-v0": PixelDST,
    "deep-sea-treasure-pixel-stack-v0": lambda **kw: wrap_pixel_stack(PixelDST(**kw)),
    # the planar MuJoCo-class locomotion envs; their constants live on ``device`` (default CUDA)
    "mo-hopper-jx-v5": MOHopperJX,
    "mo-halfcheetah-jx-v5": MOHalfCheetahJX,
    # highway driving (the mo-highway-v0 re-design)
    "mo-highway-jx-v0": MOHighway,
    "mo-highway-fast-jx-v0": lambda **kw: MOHighway(n_other=6, **kw),
}

# Envs whose exact discounted Pareto front is known (reference common/experiments.py:45-52).
ENVS_WITH_KNOWN_PARETO_FRONT = [
    "deep-sea-treasure-concave-v0",
    "deep-sea-treasure-v0",
    "minecart-v0",
    "minecart-deterministic-v0",
    "resource-gathering-v0",
    "fruit-tree-v0",
]


def make(env_id: str, **kwargs) -> MOEnv:
    if env_id not in ENV_REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; known: {sorted(ENV_REGISTRY)}")
    env = ENV_REGISTRY[env_id](**kwargs)
    # the requested id is the env's identity
    env.name = env_id
    return env
