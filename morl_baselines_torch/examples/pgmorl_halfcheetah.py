"""PGMORL on mo-halfcheetah (counterpart of reference examples/pgmorl_halfcheetah.py).

Runs on the host-stepped MuJoCo halfcheetah (gymnasium and mujoco must be
installed); ``mo-halfcheetah-jx-v5`` is the device-resident equivalent.
"""

import numpy as np

from morl_baselines_torch.agents import PGMORL, PGMORLConfig
from morl_baselines_torch.agents.moppo import MOPPOConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-halfcheetah-v5")
    agent = PGMORL(
        env,
        origin=np.array([0.0, -5.0]),
        config=PGMORLConfig(
            pop_size=6,
            warmup_iterations=10,
            evolutionary_iterations=4,
            ppo=MOPPOConfig(num_envs=8, steps_per_iteration=4096),
        ),
        log=True,
        device=device,
    )
    agent.train(total_timesteps=2_000_000, ref_point=np.array([0.0, -5.0]))
    return agent


if __name__ == "__main__":
    main()
