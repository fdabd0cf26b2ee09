"""Device-resident replay buffers, updated in place."""

from .buffer import MemberReplayBuffer, ReplayBuffer, Transition
from .prioritized import PrioritizedReplayBuffer

__all__ = ["MemberReplayBuffer", "PrioritizedReplayBuffer", "ReplayBuffer", "Transition"]
