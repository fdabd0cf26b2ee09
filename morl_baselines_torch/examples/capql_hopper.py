"""CAPQL on the planar hopper (counterpart of reference examples/capql_hopper.py).

The BASELINE config's continuous actor-critic on the device-resident
``mo-hopper-jx-v5`` with 500-step episodes.
"""

import numpy as np

from morl_baselines_torch.agents import CAPQL, CAPQLConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-hopper-jx-v5", max_episode_steps=500, device=device)
    agent = CAPQL(
        env,
        CAPQLConfig(
            num_envs=32,
            buffer_size=200_000,
            batch_size=256,
            learning_starts=1_000,
            gradient_updates=8,
            gamma=0.99,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=150_000,
        ref_point=np.array([-100.0, -100.0, -100.0]),
        eval_freq=10_000,
        num_eval_weights_for_front=32,
        eval_max_steps=500,
    )
    return agent


if __name__ == "__main__":
    main()
