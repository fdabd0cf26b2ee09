"""Batched torch multi-objective environments (MO-Gymnasium parity)."""

from .base import ArrayBox, Box, Discrete, MOEnv, StepOut, tree_where
from .breakable_bottles import BreakableBottles
from .dst import DeepSeaTreasure
from .fishwood import Fishwood, fishwood_utility
from .four_room import FourRoom
from .fruit_tree import FruitTree
from .highway import MOHighway
from .lunar_lander import MOLunarLander, MOLunarLanderContinuous, lander_heuristic
from .minecart import Minecart
from .mountaincar import MOMountainCar, MOMountainCarContinuous
from .pixel import PixelDST
from .planar import MOHalfCheetahJX, MOHopperJX, PlanarState
from .registry import ENV_REGISTRY, ENVS_WITH_KNOWN_PARETO_FRONT, make
from .resource_gathering import ResourceGathering
from .vector import EpisodeStats, RewardNormState, VecStepOut, VectorMOEnv, normalize_reward
from .water_reservoir import WaterReservoir
from .wrappers import (
    FlattenObservation,
    FrameStackObservation,
    GrayscaleObservation,
    MOMaxAndSkipObservation,
    ResizeObservation,
    TimeLimit,
    wrap_pixel_stack,
)

__all__ = [
    "ArrayBox",
    "Box",
    "BreakableBottles",
    "DeepSeaTreasure",
    "Discrete",
    "ENVS_WITH_KNOWN_PARETO_FRONT",
    "ENV_REGISTRY",
    "EpisodeStats",
    "Fishwood",
    "FlattenObservation",
    "FourRoom",
    "FrameStackObservation",
    "FruitTree",
    "GrayscaleObservation",
    "MOEnv",
    "MOHalfCheetahJX",
    "MOHighway",
    "MOHopperJX",
    "MOLunarLander",
    "MOLunarLanderContinuous",
    "MOMaxAndSkipObservation",
    "MOMountainCar",
    "MOMountainCarContinuous",
    "Minecart",
    "PixelDST",
    "PlanarState",
    "ResizeObservation",
    "ResourceGathering",
    "RewardNormState",
    "StepOut",
    "TimeLimit",
    "VecStepOut",
    "VectorMOEnv",
    "WaterReservoir",
    "fishwood_utility",
    "lander_heuristic",
    "make",
    "normalize_reward",
    "tree_where",
]
