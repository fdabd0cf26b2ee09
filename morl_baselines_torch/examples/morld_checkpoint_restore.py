"""MORL/D with checkpoint save and restore (counterpart of the reference's
examples/morld_lunar_lander_restore.py pattern).

Each member's whole state is written with the agent's ``save`` (one
``torch.save`` file) under the temporary directory and restored with
``load`` into a template state.
"""

import tempfile
from pathlib import Path

import numpy as np

from morl_baselines_torch.agents import MORLD, MORLDConfig
from morl_baselines_torch.agents.mosac import MOSACConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("mo-mountaincarcontinuous-v0")
    agent = MORLD(
        env,
        MORLDConfig(pop_size=4, exchange_every=20_000, sac=MOSACConfig(num_envs=32)),
        log=True,
        device=device,
    )
    states = agent.train(total_timesteps=400_000, ref_point=np.array([-1100.0, -110.0]))
    ckpt = Path(tempfile.gettempdir()) / "morld_ckpt"
    for i, st in enumerate(states):
        agent.save(st, ckpt / f"member_{i}")
    restored = agent.load(states[0], ckpt / "member_0")
    print("restored global_step:", int(restored.global_step))
    return agent


if __name__ == "__main__":
    main()
