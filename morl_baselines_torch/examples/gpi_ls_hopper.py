"""Continuous GPI-LS on mo-hopper (counterpart of reference examples/gpi_ls_hopper.py).

Runs on the host-stepped MuJoCo hopper (gymnasium and mujoco must be
installed); ``mo-hopper-jx-v5`` is the device-resident equivalent.
"""

import numpy as np

from morl_baselines_torch.agents import GPILSContinuous, GPILSContinuousConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-hopper-v5")
    agent = GPILSContinuous(
        env,
        GPILSContinuousConfig(num_envs=8, buffer_size=400_000, learning_starts=2000),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=200_000,
        ref_point=np.array([-100.0, -100.0, -100.0]),
        timesteps_per_iter=20_000,
        weight_selection_algo="gpi-ls",
    )
    print("CCS:", agent.ccs)
    return agent


if __name__ == "__main__":
    main()
