"""IPRO on deep-sea-treasure (counterpart of reference examples/ipro_dst.py).

Outer loop: Pareto-oracle calls, each an NL-MOPPO run on an achievement
scalarizing function toward a referent, until the front's coverage is
within ``tolerance``.
"""

from morl_baselines_torch.agents.ipro import IPRO, IPROConfig
from morl_baselines_torch.agents.nlmoppo import NLMOPPOConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.examples import parse_device


def main(argv=None):
    device = parse_device(argv, __doc__)
    env = make("deep-sea-treasure-v0")
    ipro = IPRO(
        env,
        IPROConfig(
            tolerance=0.05,
            max_iterations=24,
            iter_total_timesteps=150_000,
            offset=1.0,
            ppo=NLMOPPOConfig(
                num_envs=64,
                num_steps=128,
                update_epochs=4,
                num_minibatches=4,
                gamma=0.995,
                ent_coef=0.05,
                ent_coef_start=0.15,
            ),
        ),
        log=True,
        device=device,
    )
    pf = ipro.train()
    print("pareto front:", pf)
    print("coverage:", ipro.coverage, "replay_triggered:", ipro.replay_triggered)
    return ipro


if __name__ == "__main__":
    main()
