from .evaluation import (
    device_front_metrics,
    evaluate_front,
    multi_policy_metrics,
    policy_evaluation,
    rollout_episode,
)

__all__ = [
    "device_front_metrics",
    "evaluate_front",
    "multi_policy_metrics",
    "policy_evaluation",
    "rollout_episode",
]
