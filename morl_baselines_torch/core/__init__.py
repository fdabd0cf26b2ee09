"""Core MORL math: Pareto ops, weights, scalarization, indicators, archives."""

from .pareto import (
    batched_pareto_dominates,
    filter_convex_dominated,
    filter_pareto_dominated,
    get_non_dominated_inds,
    lorenz_dominates,
    lorenz_vector,
    non_dominated_count,
    non_dominated_mask,
    pareto_dominates,
    strict_pareto_dominates,
)
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
    "batched_pareto_dominates",
    "cardinality",
    "equally_spaced_weights",
    "expected_utility",
    "extrema_weights",
    "filter_convex_dominated",
    "filter_pareto_dominated",
    "get_non_dominated_inds",
    "hypervolume",
    "hypervolume_2d",
    "hypervolume_3d",
    "hypervolume_mc",
    "hypervolume_small_exact",
    "igd",
    "lorenz_dominates",
    "lorenz_vector",
    "maximum_utility_loss",
    "non_dominated_count",
    "non_dominated_mask",
    "pareto_dominates",
    "random_weights",
    "sparsity",
    "strict_pareto_dominates",
    "tchebicheff",
    "update_utopian",
    "weighted_sum",
]
