"""Multi-policy MO Q-Learning with OLS on deep-sea-treasure.

Counterpart of reference examples/mp_mo_q_learning_dst.py: optimistic
linear support picks each MO Q-Learning run's weight, Q-tables transferred.
"""

import numpy as np

from morl_baselines_torch.agents import MOQLearningConfig, MPMOQLConfig, MPMOQLearning
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("deep-sea-treasure-v0")
    agent = MPMOQLearning(
        env,
        MPMOQLConfig(
            num_timesteps_per_iteration=40_000,
            weight_selection_algo="ols",
            transfer_q_table=True,
            moql=MOQLearningConfig(
                gamma=0.9,
                initial_epsilon=0.9,
                final_epsilon=0.1,
                epsilon_decay_steps=30_000,
                num_envs=16,
            ),
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=400_000,
        ref_point=np.array([0.0, -50.0]),
        known_pareto_front=env.pareto_front(0.9),
    )
    print("CCS:", agent.ccs)
    return agent


if __name__ == "__main__":
    main()
