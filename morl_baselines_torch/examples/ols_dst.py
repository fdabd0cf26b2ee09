"""GPI-LS with OLS weight selection on deep-sea-treasure (counterpart of reference examples/ols_dst.py)."""

import numpy as np

from morl_baselines_torch.agents import GPILS, GPILSConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("deep-sea-treasure-v0")
    agent = GPILS(
        env,
        GPILSConfig(num_envs=64, buffer_size=100_000, epsilon_decay_steps=30_000),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=150_000,
        ref_point=np.array([0.0, -50.0]),
        known_pareto_front=env.pareto_front(0.98),
        timesteps_per_iter=15_000,
        weight_selection_algo="ols",
    )
    print("CCS:", agent.ccs)
    return agent


if __name__ == "__main__":
    main()
