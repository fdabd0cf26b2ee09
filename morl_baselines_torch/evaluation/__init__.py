from .evaluation import (
    device_front_metrics,
    evaluate_front,
    log_episode_info,
    multi_policy_metrics,
    policy_evaluation,
    rollout_episode,
    seed_everything,
)

__all__ = [
    "device_front_metrics",
    "evaluate_front",
    "log_episode_info",
    "multi_policy_metrics",
    "policy_evaluation",
    "rollout_episode",
    "seed_everything",
]
