"""GPI-LS minecart tuning sweep: six configurations at the 2.5M-step budget.

Counterpart of the JAX package's ``scripts/gpils_minecart_tune.py``: the
same variants A-F, the same base config, env, reference point and ``train``
arguments.  Each variant logs its evaluation curve to
``gpils_minecart_tune_<variant>_seed<seed>.jsonl`` and appends one record
(``variant, seed, wall, total, ccs, metrics, buffer_size, sale_rows`` and
the ``device`` it ran on) to ``gpils_minecart_tune.jsonl``, both under
``--out`` (default ``results/torch/``).

    python -m morl_baselines_torch.cli.gpils_minecart_tune [variant ...] [--seed N] [--total N]
        [--timesteps-per-iter N] [--device cuda|cpu] [--out DIR]

The device is CUDA unless ``--device cpu`` is given.  ``--timesteps-per-iter``
(default 10,000, the JAX script's) sets the steps of one outer iteration, so
that a short check still runs a few outer iterations.  A variant that raises
is recorded under ``exception``, its traceback goes to stderr, and the rest
run; the process exits non-zero at the end if any raised.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..agents import GPILS, GPILSConfig
from ..envs import make
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger

RESULTS = Path(__file__).resolve().parents[2] / "results" / "torch"

# Two failure modes found and fixed by earlier sweep rounds:
# 1. epsilon decays on the per-env step clock (global_step//num_envs): the
#    decay budget must fit within total/num_envs per-env steps (a 100k decay
#    at 64 envs/2.5M steps left the agent ~70% random all run: HV 0).
# 2. the replay buffer must be >= total steps, as the reference's minecart
#    config is (buffer 2e5 >= 1.5e5 steps, examples/gpi_pd_minecart.py:28):
#    minecart sales are rare early-exploration events; a ring buffer smaller
#    than the run overwrites them (measured: 3 sale rows in a 100k ring).
VARIANTS = {
    # reference-shaped operating point: match Envelope's updates-per-env-step
    "A": dict(num_envs=64, gradient_updates=8, batch_size=512, final_epsilon=0.2,
              epsilon_decay_steps=15_000, target_net_update_freq=200, max_support=16,
              buffer_size=2_500_000),
    # faster target refresh + PER (prioritizes the rare sale transitions)
    "B": dict(num_envs=64, gradient_updates=8, batch_size=512, final_epsilon=0.2,
              epsilon_decay_steps=15_000, target_net_update_freq=100, max_support=16,
              per=True, buffer_size=2_500_000),
    # lower floor, soft target updates
    "C": dict(num_envs=64, gradient_updates=8, batch_size=512, final_epsilon=0.05,
              epsilon_decay_steps=10_000, tau=0.005, max_support=32,
              buffer_size=2_500_000),
    # more envs, shorter decay, more updates
    "D": dict(num_envs=128, gradient_updates=16, batch_size=512, final_epsilon=0.1,
              epsilon_decay_steps=8_000, target_net_update_freq=200, max_support=16,
              buffer_size=2_500_000),
    # E: update-count matched to the reference operating point (reference
    # examples/gpi_pd_minecart.py trains 150k serial steps x g~10 updates/step
    # = ~1.5M gradient updates at batch 128, per=False for GPI-LS): at 64 envs
    # x 2.5M steps, 32 updates/iteration gives 1.25M updates.  Uniform buffer,
    # target sync every ~320 gradient steps (reference 200).
    "E": dict(num_envs=64, gradient_updates=32, batch_size=128, final_epsilon=0.05,
              epsilon_decay_steps=15_000, target_net_update_freq=10, max_support=16,
              per=False, buffer_size=2_500_000),
    # F: reference-shaped budget: 150k TOTAL steps at 4 envs (37.5k serial
    # steps/env, epsilon decays over the same 1/3-of-run fraction as the
    # reference's 50k/150k), 16 updates/iteration = 4 per env-step.
    "F": dict(num_envs=4, gradient_updates=16, batch_size=128, final_epsilon=0.05,
              epsilon_decay_steps=12_000, target_net_update_freq=50, max_support=16,
              per=False, buffer_size=200_000),
}
TOTALS = {"F": 150_000}
DEFAULT_TOTAL = 2_500_000
ENV_ID = "minecart-v0"
REF_POINT = (0.0, 0.0, -200.0)
FRONT_GAMMA = 0.98
TRAIN = dict(timesteps_per_iter=10_000, num_eval_weights_for_front=32, eval_max_steps=400)


def config(name: str, seed: int = 0) -> GPILSConfig:
    """Variant ``name``'s agent config at ``seed``."""
    return GPILSConfig(gamma=0.98, learning_starts=2048, seed=seed, **VARIANTS[name])


def buffer_diagnostic(state) -> dict:
    """Separate exploration failure from propagation failure: how many stored
    transitions actually sold ore (reward in the first two objectives)?"""
    buf = state.buffer
    rew = buf.data.reward[: buf.size].cpu().numpy()
    return dict(buffer_size=int(buf.size), sale_rows=int((rew[:, :2].sum(axis=1) > 0).sum()))


def run(
    name: str,
    seed: int = 0,
    total: int | None = None,
    device="cuda",
    out: Path = RESULTS,
    timesteps_per_iter: int = TRAIN["timesteps_per_iter"],
) -> dict:
    """Train variant ``name`` for ``total`` steps (its own total by default),
    its curve logged under ``out``; returns the variant's record."""
    device = resolve_device(device)
    total = total or TOTALS.get(name, DEFAULT_TOTAL)
    env = make(ENV_ID)
    agent = GPILS(env, config(name, seed), log=True, device=device)
    jsonl = out / f"gpils_minecart_tune_{name}_seed{seed}.jsonl"
    jsonl.unlink(missing_ok=True)  # a rerun replaces the curve; the records append
    agent.logger = MetricLogger(experiment=f"gpils_minecart_tune_{name}_s{seed}", jsonl_path=jsonl, stdout_every=5)
    t0 = time.time()
    try:
        state = agent.train(
            total_timesteps=total,
            ref_point=np.array(REF_POINT),
            known_pareto_front=env.pareto_front(FRONT_GAMMA),
            **dict(TRAIN, timesteps_per_iter=timesteps_per_iter),
        )
    finally:
        agent.logger.close()
    wall = time.time() - t0
    rec = dict(
        variant=name,
        seed=seed,
        wall=round(wall, 1),
        total=total,
        ccs=[list(map(float, v)) for v in agent.ccs],
        metrics={k: float(v) for k, v in agent._last_metrics.items()},
        **buffer_diagnostic(state),
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"variants to run (default: all of {', '.join(VARIANTS)})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--total", type=int, default=None, help="steps a variant (default: its own total, else 2.5M)")
    ap.add_argument("--timesteps-per-iter", type=int, default=TRAIN["timesteps_per_iter"],
                    help="steps of one outer iteration (default 10,000)")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    ap.add_argument("--out", default=None, help="records directory (default results/torch)")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    device = resolve_device(args.device)
    out = Path(args.out) if args.out else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    failed = 0
    # one write a record on an O_APPEND descriptor: runs in other processes may append beside it
    records = os.open(out / "gpils_minecart_tune.jsonl", os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        for name in args.variants or list(VARIANTS):
            try:
                rec = run(name, args.seed, args.total, device, out, args.timesteps_per_iter)
            except Exception as e:  # recorded, and the next variant runs
                traceback.print_exc()
                rec = dict(variant=name, exception=repr(e))
                failed += 1
            os.write(records, (json.dumps(rec) + "\n").encode())
    finally:
        os.close(records)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
