"""Core MORL math: Pareto ops, weights, scalarization, indicators, archives."""

from .pareto import filter_pareto_dominated, get_non_dominated_inds, non_dominated_mask
from .indicators import (
    cardinality,
    expected_utility,
    hypervolume,
    hypervolume_2d,
    hypervolume_3d,
    hypervolume_mc,
    hypervolume_small_exact,
    igd,
    maximum_utility_loss,
    sparsity,
)
from .archive import DeviceParetoFront, ParetoArchive
from .scalarization import tchebicheff, update_utopian, weighted_sum
from .weights import equally_spaced_weights, extrema_weights, random_weights

__all__ = [
    "DeviceParetoFront",
    "ParetoArchive",
    "cardinality",
    "equally_spaced_weights",
    "expected_utility",
    "extrema_weights",
    "filter_pareto_dominated",
    "get_non_dominated_inds",
    "hypervolume",
    "hypervolume_2d",
    "hypervolume_3d",
    "hypervolume_mc",
    "hypervolume_small_exact",
    "igd",
    "maximum_utility_loss",
    "non_dominated_mask",
    "random_weights",
    "sparsity",
    "tchebicheff",
    "update_utopian",
    "weighted_sum",
]
