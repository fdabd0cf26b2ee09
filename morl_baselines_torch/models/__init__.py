"""Torch model components: trunks and conditioned Q-nets."""

from .networks import MLP, EnvelopeQNet, TrainState, load_flax_params, polyak_update

__all__ = ["EnvelopeQNet", "MLP", "TrainState", "load_flax_params", "polyak_update"]
