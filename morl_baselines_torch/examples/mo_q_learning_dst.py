"""MO Q-Learning on deep-sea-treasure (counterpart of reference examples/mo_q_learning_dst.py).

Tabular Q-learning under a fixed linear scalarization, 16 envs in one batch.
"""

import numpy as np

from morl_baselines_torch.agents import MOQLearning, MOQLearningConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("deep-sea-treasure-v0")
    agent = MOQLearning(
        env,
        weights=np.array([0.4, 0.6]),
        config=MOQLearningConfig(
            gamma=0.9,
            initial_epsilon=0.9,
            final_epsilon=0.1,
            epsilon_decay_steps=100_000,
            num_envs=16,
        ),
        log=True,
        device=device,
    )
    agent.train(total_timesteps=400_000, eval_freq=40_000)
    ret, disc = agent.last_eval
    print("vec return:", ret, "discounted:", disc)
    return agent


if __name__ == "__main__":
    main()
