"""A/B of the bf16 GPI action forward at the ``gpils_minecart`` bench point.

    python -m morl_baselines_torch.cli.bench_gpils_ab [--small] [--device cuda|cpu]

Counterpart of the JAX package's ``scripts/bench_gpils_ab.py``.  The
(N x M)-row conditioned forward is GPI-LS's hot op; bf16 GEMMs run at twice
the float32 tensor-core rate where the op is compute-bound.  Prints
``{"bf16_act", "sps"}`` for ``False``, then ``True``: env-steps/s of
``GPILS.train_segment`` at 4096 envs, 50 iterations (``--small``: 32 envs, 4
iterations), the median of 3 calls after a warm-up, each on a state built
afresh from the same seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..agents import GPILS, GPILSConfig
from ..core.weights import equally_spaced_weights
from ..utils.device import resolve_device
from .bench import _time, announce
from .experiments import make_env


def run(bf16_act: bool, device: torch.device, num_envs: int = 4096, iters: int = 50) -> float:
    env = make_env("minecart-v0", device)
    cfg = GPILSConfig(
        num_envs=num_envs,
        buffer_size=max(4 * num_envs, 16384),
        batch_size=128,
        learning_starts=num_envs,
        gradient_updates=10,
        max_support=16,
        bf16_act=bf16_act,
    )
    agent = GPILS(env, cfg, device=device)

    def fresh():
        return agent.set_weight_support(agent.init_state(0), equally_spaced_weights(3, 16))

    dt = _time(lambda s: agent.train_segment(s, iters, True), fresh, device)
    return iters * num_envs / dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="32 envs, 4 iterations")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    announce(device, "bench_gpils_ab")
    size = dict(num_envs=32, iters=4) if args.small else {}
    for bf16 in (False, True):
        sps = run(bf16, device, **size)
        print(json.dumps({"bf16_act": bf16, "sps": round(sps, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
