"""MORL/D with discrete MOSAC members on the lunar lander.

Counterpart of reference examples/morld_lunar_lander.py: 6 members with PSA
weight adaptation on the 4-objective ``mo-lunar-lander-v3``.
"""

import numpy as np

from morl_baselines_torch.agents import MORLD, MORLDConfig, MOSACConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-lunar-lander-v3")
    agent = MORLD(
        env,
        MORLDConfig(
            pop_size=6,
            exchange_every=5000,
            neighborhood_size=1,
            shared_buffer=True,
            update_passes=10,
            weight_adaptation_method="PSA",
            sac=MOSACConfig(
                num_envs=8,
                buffer_size=200_000,
                batch_size=128,
                learning_starts=1000,
                hidden=(256, 256, 256, 256),
            ),
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=200_000,
        ref_point=np.array([-101.0, -1001.0, -101.0, -101.0]),
    )
    return agent


if __name__ == "__main__":
    main()
