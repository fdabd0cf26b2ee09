"""PCN on deterministic minecart (counterpart of reference examples/pcn_minecart.py)."""

import numpy as np

from morl_baselines_torch.agents import PCN, PCNConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("minecart-deterministic-v0")
    agent = PCN(
        env,
        PCNConfig(
            gamma=1.0,
            scaling_factor=(1.0, 1.0, 0.1, 0.1),
            max_episode_len=400,
            max_buffer_episodes=128,
            num_envs=8,
            num_model_updates=50,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=400_000,
        ref_point=np.array([0.0, 0.0, -200.0]),
        num_er_episodes=32,
    )
    return agent


if __name__ == "__main__":
    main()
