"""EUPG on fishwood (counterpart of reference examples/eupg_fishwood.py).

Expected-utility policy gradient under the non-linear ESR utility
min(fish, wood // 2).
"""

from morl_baselines_torch.agents import EUPG, EUPGConfig
from morl_baselines_torch.envs import fishwood_utility, make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("fishwood-v0")
    agent = EUPG(
        env,
        scalarization=fishwood_utility,  # min(fish, wood // 2)
        config=EUPGConfig(num_envs=64, chunk_len=200, learning_rate=1e-3, gamma=0.99),
        log=True,
        device=device,
    )
    agent.train(total_timesteps=2_000_000, eval_freq=100_000)
    return agent


if __name__ == "__main__":
    main()
