"""Envelope with the NatureCNN trunk on pixel deep-sea-treasure.

Counterpart of the reference's image-observation path
(launch_experiment.py:158-180): the mario wrapper stack (grayscale, resize
to 84x84, 4 stacked frames) over the pixel DST, and Envelope's Q-net with a
NatureCNN trunk before the weight-conditioned head.
"""

import numpy as np

from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("deep-sea-treasure-pixel-stack-v0")
    agent = Envelope(
        env,
        EnvelopeConfig(
            num_envs=64,
            buffer_size=50_000,
            batch_size=64,
            hidden=(256, 256),
            image_shape=(4, 84, 84),
            num_sample_w=4,
            learning_starts=1000,
            epsilon_decay_steps=20_000,
            gamma=0.98,
        ),
        log=True,
        device=device,
    )
    agent.train(
        total_timesteps=200_000,
        ref_point=np.array([0.0, -50.0]),
        eval_freq=10_000,
        num_eval_weights_for_front=32,
    )
    print("final:", agent._last_metrics)
    return agent


if __name__ == "__main__":
    main()
