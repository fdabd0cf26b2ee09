"""Envelope Q-Learning on minecart (counterpart of reference examples/envelope_minecart.py).

The BASELINE benchmark config: weight-conditioned DQN with the envelope
max-over-weights TD target, hundreds of device-resident minecart envs.
"""

import numpy as np

from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("minecart-v0")
    agent = Envelope(
        env,
        EnvelopeConfig(
            num_envs=512,
            buffer_size=200_000,
            batch_size=128,
            num_sample_w=4,
            gamma=0.98,
            learning_starts=2048,
            epsilon_decay_steps=100_000,
            homotopy_decay_steps=100_000,
            per=True,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=400_000,
        ref_point=np.array([0.0, 0.0, -200.0]),
        known_pareto_front=env.pareto_front(0.98),
        eval_freq=50_000,
    )
    return agent


if __name__ == "__main__":
    main()
