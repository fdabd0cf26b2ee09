"""Continuous GPI-PD (Dyna + PER) on the planar hopper.

Counterpart of reference examples/gpi_pd_hopper.py on the device-resident
``mo-hopper-jx-v5`` with 500-step episodes.
"""

import numpy as np

from morl_baselines_torch.agents import GPIPDContinuous, GPIPDContinuousConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-hopper-jx-v5", max_episode_steps=500, device=device)
    agent = GPIPDContinuous(
        env,
        GPIPDContinuousConfig(
            num_envs=8,
            buffer_size=400_000,
            learning_starts=2000,
            gradient_updates=8,
            per=True,
            dyna=True,
            dynamics_rollout_starts=1000,
            dynamics_rollout_len=5,
            dynamics_train_freq=250,
            dyna_buffer_size=200_000,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=150_000,
        ref_point=np.array([-100.0, -100.0, -100.0]),
        timesteps_per_iter=15_000,
        weight_selection_algo="gpi-ls",
        eval_max_steps=500,
    )
    print("CCS:", agent.ccs)
    return agent


if __name__ == "__main__":
    main()
