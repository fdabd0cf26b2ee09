from .device import resolve_device
from .logging import MetricLogger
from .schedules import linearly_decaying_value, nearest_neighbors, unique_tol

__all__ = ["MetricLogger", "linearly_decaying_value", "nearest_neighbors", "resolve_device", "unique_tol"]
