"""Device-resident replay buffers, updated in place."""

from .buffer import MemberReplayBuffer, ReplayBuffer, Transition
from .episodic import EpisodeBatch, EpisodicBuffer, crowding_distance
from .prioritized import PrioritizedReplayBuffer

__all__ = [
    "EpisodeBatch",
    "EpisodicBuffer",
    "MemberReplayBuffer",
    "PrioritizedReplayBuffer",
    "ReplayBuffer",
    "Transition",
    "crowding_distance",
]
