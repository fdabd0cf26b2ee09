"""GPI-PD on minecart (counterpart of reference examples/gpi_pd_minecart.py).

PER with envelope-target priorities and GPI-prioritized weight selection;
``gradient_updates`` is per vector step (20 per env step at 16 envs).
"""

import numpy as np

from morl_baselines_torch.agents import GPIPD, GPIPDConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("minecart-v0")
    agent = GPIPD(
        env,
        GPIPDConfig(
            num_envs=16,
            buffer_size=200_000,
            gradient_updates=320,  # 20 per env-step at 16 envs (reference g=20)
            full_updates_after=5_000,
            epsilon_decay_steps=3_000,  # per-env-step clock
            target_net_update_freq=12,
            learning_starts=256,
            per=True,
            gpi_pd=True,
            dyna=False,
            dynamics_rollout_starts=25_000,
            dynamics_uncertainty_threshold=1.5,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=150_000,
        ref_point=np.array([0.0, 0.0, -200.0]),
        known_pareto_front=env.pareto_front(0.98),
        timesteps_per_iter=10_000,
        weight_selection_algo="gpi-ls",
    )
    print("CCS:", agent.ccs)
    return agent


if __name__ == "__main__":
    main()
