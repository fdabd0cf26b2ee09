"""Device-resident replay buffers, updated in place."""

from .buffer import ReplayBuffer, Transition
from .prioritized import PrioritizedReplayBuffer

__all__ = ["PrioritizedReplayBuffer", "ReplayBuffer", "Transition"]
