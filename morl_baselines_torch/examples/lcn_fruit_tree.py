"""LCN on fruit-tree (counterpart of reference examples/lcn_fruit_tree.py).

PCN with Lorenz-conditioned commands (``lorenz_lambda`` 1.0) on the
6-objective fruit tree.
"""

import numpy as np

from morl_baselines_torch.agents import LCN, LCNConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("fruit-tree-v0")
    agent = LCN(
        env,
        LCNConfig(
            gamma=1.0,
            scaling_factor=(0.1,) * 6 + (0.1,),
            max_episode_len=8,
            max_buffer_episodes=128,
            num_envs=16,
            lorenz_lambda=1.0,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=100_000,
        ref_point=np.zeros(6),
        num_er_episodes=64,
    )
    return agent


if __name__ == "__main__":
    main()
