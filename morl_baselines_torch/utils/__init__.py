from .device import resolve_device
from .logging import MetricLogger, reset_wandb_env
from .profiling import PhaseTimer, span, trace
from .render import make_gif, rollout_frames
from .schedules import linearly_decaying_value, nearest_neighbors, unique_tol

__all__ = [
    "MetricLogger",
    "PhaseTimer",
    "linearly_decaying_value",
    "make_gif",
    "nearest_neighbors",
    "reset_wandb_env",
    "resolve_device",
    "rollout_frames",
    "span",
    "trace",
    "unique_tol",
]
