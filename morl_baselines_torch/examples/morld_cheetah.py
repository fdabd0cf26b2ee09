"""MORL/D population (continuous MOSAC members) on mo-halfcheetah.

Counterpart of reference examples/morld_cheetah.py, on the host-stepped MuJoCo
env (gymnasium and mujoco must be installed); use
MORLDConfig(vectorized=True) to train every member as one member-axis state.
"""

import numpy as np

from morl_baselines_torch.agents import MORLD, MORLDConfig, MOSACConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-halfcheetah-v5")
    agent = MORLD(
        env,
        MORLDConfig(
            pop_size=6,
            exchange_every=10_000,
            shared_buffer=True,
            update_passes=10,
            sac=MOSACConfig(num_envs=4, buffer_size=400_000, learning_starts=2000),
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=300_000,
        ref_point=np.array([-100.0, -100.0]),
    )
    return agent


if __name__ == "__main__":
    main()
