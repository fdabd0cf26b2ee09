"""Share of PCN's warm-up episodes on minecart-deterministic that return home.

Runs ``train``'s warm-up alone (``total_timesteps=0``, 32 episodes under
random commands) of the ``pcn_minecart`` protocol config for each seed, in
the JAX package or in the PyTorch port, each with its own random stream, and
counts the episodes that end before the 400-step limit (the cart came home)
and those that sold ore.  Prints one JSON line: the counts, the share of early
episodes with its 95% normal-approximation interval, and per seed
(seed, early, sold, warm-up steps).

    python tools/pcn_warmup_rate.py jax --seeds 64
    python tools/pcn_warmup_rate.py torch --seeds 64 [--device cuda|cpu]

Each package is imported only when asked for; the JAX side runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

CONFIG = dict(gamma=1.0, scaling_factor=(1.0, 1.0, 0.1, 0.1), max_episode_len=400, max_buffer_episodes=128,
              num_envs=8, num_model_updates=50, batch_size=256, learning_rate=1e-3)
EPISODES = 32


def _agent(package: str, seed: int, device: str):
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from morl_baselines_tpu.agents import PCN, PCNConfig
        from morl_baselines_tpu.envs import make

        return PCN(make("minecart-deterministic-v0"), PCNConfig(seed=seed, **CONFIG))
    from morl_baselines_torch.agents import PCN, PCNConfig
    from morl_baselines_torch.envs import make

    return PCN(make("minecart-deterministic-v0"), PCNConfig(seed=seed, **CONFIG), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "torch"])
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="the port's device (torch only)")
    args = ap.parse_args(argv)
    t0 = time.time()
    per_seed = []
    for seed in range(args.seeds):
        state = _agent(args.package, seed, args.device).train(total_timesteps=0, num_er_episodes=EPISODES)
        buf = state.buffer
        size = int(buf.size)
        length = np.asarray(buf.data.length[:size].tolist())
        ret = np.asarray(buf.data.vec_return[:size].tolist())
        assert size == EPISODES, size
        per_seed.append((seed, int((length < CONFIG["max_episode_len"]).sum()), int((ret[:, :2].sum(axis=1) > 0).sum()),
                         int(state.global_step)))
    n = EPISODES * len(per_seed)
    early = sum(s[1] for s in per_seed)
    p = early / n
    print(json.dumps(dict(
        package=args.package, device="cpu" if args.package == "jax" else args.device, seeds=len(per_seed),
        episodes=n, early=early, sold=sum(s[2] for s in per_seed), share=p, ci95=1.96 * float(np.sqrt(p * (1 - p) / n)),
        seeds_with_early=sum(1 for s in per_seed if s[1] > 0), wall=time.time() - t0, per_seed=per_seed,
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
