"""Batched torch multi-objective environments (MO-Gymnasium parity)."""

from .base import Box, Discrete, MOEnv, StepOut
from .dst import DeepSeaTreasure
from .minecart import Minecart
from .registry import ENV_REGISTRY, make
from .vector import EpisodeStats, VecStepOut, VectorMOEnv

__all__ = [
    "Box",
    "DeepSeaTreasure",
    "Discrete",
    "ENV_REGISTRY",
    "EpisodeStats",
    "MOEnv",
    "Minecart",
    "StepOut",
    "VecStepOut",
    "VectorMOEnv",
    "make",
]
