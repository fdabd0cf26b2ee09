"""Torch model components: trunks, conditioned Q-nets, critic ensembles and the dynamics ensemble."""

from .dynamics import EnsembleConfig, EnsembleState, GaussianMLP, ModelEnv, ProbabilisticEnsemble, get_termination_fn
from .networks import (
    MLP,
    EnsembleDense,
    EnvelopeQNet,
    LayerNorm,
    TrainState,
    WeightConditionedQNet,
    huber,
    load_flax_params,
    polyak_update,
    to_flax_params,
)

__all__ = [
    "EnsembleConfig",
    "EnsembleDense",
    "EnsembleState",
    "EnvelopeQNet",
    "GaussianMLP",
    "LayerNorm",
    "MLP",
    "ModelEnv",
    "ProbabilisticEnsemble",
    "TrainState",
    "WeightConditionedQNet",
    "get_termination_fn",
    "huber",
    "load_flax_params",
    "polyak_update",
    "to_flax_params",
]
