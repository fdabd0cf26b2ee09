"""Torch model components: trunks, conditioned Q-nets, critic ensembles, continuous actors and critics, and the dynamics ensemble."""

from .continuous import ContinuousQNet, DeterministicActor, StabilizedActor, StabilizedQNet
from .dynamics import EnsembleConfig, EnsembleState, GaussianMLP, ModelEnv, ProbabilisticEnsemble, get_termination_fn
from .networks import (
    MLP,
    BatchRenorm,
    EnsembleDense,
    EnvelopeQNet,
    LayerNorm,
    TrainState,
    WeightConditionedQNet,
    WeightNormDense,
    huber,
    load_flax_params,
    load_flax_variables,
    polyak_update,
    to_flax_params,
    to_flax_variables,
)

__all__ = [
    "BatchRenorm",
    "ContinuousQNet",
    "DeterministicActor",
    "EnsembleConfig",
    "EnsembleDense",
    "EnsembleState",
    "EnvelopeQNet",
    "GaussianMLP",
    "LayerNorm",
    "MLP",
    "ModelEnv",
    "ProbabilisticEnsemble",
    "StabilizedActor",
    "StabilizedQNet",
    "TrainState",
    "WeightConditionedQNet",
    "WeightNormDense",
    "get_termination_fn",
    "huber",
    "load_flax_params",
    "load_flax_variables",
    "polyak_update",
    "to_flax_params",
    "to_flax_variables",
]
