"""Pareto Q-Learning on deep-sea-treasure (counterpart of reference examples/pql_dst.py).

Learns the set of non-dominated Q-vectors per (state, action), then tracks
the max-treasure point of the start state's Pareto coverage set.
"""

import numpy as np
import torch

from morl_baselines_torch.agents import PQL, PQLConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("deep-sea-treasure-v0")
    agent = PQL(
        env,
        ref_point=np.array([0.0, -50.0]),
        config=PQLConfig(gamma=1.0, initial_epsilon=1.0, final_epsilon=0.2, epsilon_decay_steps=80_000),
        log=True,
        device=device,
    )
    state = agent.train(
        total_timesteps=100_000,
        ref_point=np.array([0.0, -50.0]),
        known_pareto_front=env.pareto_front(1.0),
        eval_freq=10_000,
    )
    start = int(env.state_index(torch.zeros(2)))
    front = agent.get_local_pcs(state, start)
    print("front:", front)
    target = front[np.argmax(front[:, 0])]
    tracked = agent.track_policy(state, target)
    print("tracked return:", tracked, "target:", target)
    return agent


if __name__ == "__main__":
    main()
