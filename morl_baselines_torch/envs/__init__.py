"""Batched torch multi-objective environments (MO-Gymnasium parity)."""

from .base import Box, Discrete, MOEnv, StepOut
from .dst import DeepSeaTreasure
from .fishwood import Fishwood, fishwood_utility
from .fruit_tree import FruitTree
from .minecart import Minecart
from .mountaincar import MOMountainCar, MOMountainCarContinuous
from .planar import MOHalfCheetahJX, MOHopperJX, PlanarState
from .registry import ENV_REGISTRY, make
from .vector import EpisodeStats, RewardNormState, VecStepOut, VectorMOEnv, normalize_reward
from .water_reservoir import WaterReservoir

__all__ = [
    "Box",
    "DeepSeaTreasure",
    "Discrete",
    "ENV_REGISTRY",
    "EpisodeStats",
    "Fishwood",
    "FruitTree",
    "MOEnv",
    "MOHalfCheetahJX",
    "MOHopperJX",
    "MOMountainCar",
    "MOMountainCarContinuous",
    "Minecart",
    "PlanarState",
    "RewardNormState",
    "StepOut",
    "VecStepOut",
    "VectorMOEnv",
    "WaterReservoir",
    "fishwood_utility",
    "make",
    "normalize_reward",
]
