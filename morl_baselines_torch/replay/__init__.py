"""Device-resident replay buffers, updated in place."""

from .accrued import AccruedRewardReplayBuffer, AccruedTransition
from .buffer import MemberReplayBuffer, ReplayBuffer, Transition
from .diverse import DiverseMemory
from .episodic import EpisodeBatch, EpisodicBuffer, crowding_distance
from .prioritized import MemberPrioritizedReplayBuffer, PrioritizedReplayBuffer

__all__ = [
    "AccruedRewardReplayBuffer",
    "AccruedTransition",
    "DiverseMemory",
    "EpisodeBatch",
    "EpisodicBuffer",
    "MemberPrioritizedReplayBuffer",
    "MemberReplayBuffer",
    "PrioritizedReplayBuffer",
    "ReplayBuffer",
    "Transition",
    "crowding_distance",
]
