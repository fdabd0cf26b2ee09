"""Breakdown of the population bench points: what bounds PGMORL and MORL/D.

    python -m morl_baselines_torch.cli.profile_population [--sweep] [--trace=DIR] [--small] [--device cuda|cpu]

Counterpart of the JAX package's ``scripts/profile_population.py``.  At the
``pgmorl_halfcheetah`` and ``morld_halfcheetah`` bench points:

  1. phase split: a PGMORL iteration against the same with one rollout step
     (``steps_per_iteration = num_envs``; the 10 epochs x 32 minibatches
     stay), so that the difference is the rollout; a MORL/D round with its
     cooperation passes against the same with none, so that the difference
     is the cooperation;
  2. ``--sweep``: PGMORL at 64/256/1024/4096 envs (8192 steps an iteration)
     and MORL/D at 256/1024/4096.  A program of long chains of small launches
     shows steps/s rising about linearly with envs a step; a bandwidth- or
     FLOP-bound one stays flat;
  3. ``--trace=DIR``: the default measurements under ``utils.profiling.trace``
     (``DIR/trace.json``).

One JSON line a measurement on stdout, under the JAX script's keys.  Every
call starts from a state built afresh from the same seeds; seconds are
medians of 3 calls after a warm-up.  ``--small``: the phase split with PGMORL
at 32 envs and 256 steps, MORL/D at 4 envs and 2 iterations.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..agents import MORLD, PGMORL, MOPPOConfig, MORLDConfig, MOSACConfig, PGMORLConfig
from ..utils.device import resolve_device
from ..utils.profiling import trace
from .bench import _time, announce
from .experiments import make_env


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _pgmorl_iteration_s(device: torch.device, cfg: PGMORLConfig) -> float:
    """Median seconds of one vectorized PGMORL iteration (rollout, GAE, the minibatch epochs)."""
    env = make_env("mo-halfcheetah-jx-v5", device)
    agent = PGMORL(env, origin=np.zeros(env.reward_dim), config=cfg, device=device)
    proto, ws = agent.agents[0], agent._weights()
    return _time(lambda st: proto.train_iteration(st, ws), lambda: proto.init_state(list(range(cfg.pop_size))), device)


def profile_pgmorl(device: torch.device, num_envs: int = 64, spi: int = 8192, pop: int = 6) -> None:
    cfg = PGMORLConfig(pop_size=pop, ppo=MOPPOConfig(num_envs=num_envs, steps_per_iteration=spi), vectorized=True)
    # full iteration (rollout + GAE + 10x32 minibatch updates)
    dt_full = _pgmorl_iteration_s(device, cfg)
    T = spi // num_envs
    # one rollout step that still runs the full 10 epochs x 32 minibatches:
    # dt_upd isolates the sequential update chain, dt_full - dt_upd ~ rollout
    cfg1 = dataclasses.replace(cfg, ppo=dataclasses.replace(cfg.ppo, steps_per_iteration=num_envs))
    dt_upd = _pgmorl_iteration_s(device, cfg1)
    emit(
        workload="pgmorl", num_envs=num_envs, steps_per_iteration=spi, pop=pop,
        iteration_s=round(dt_full, 4), update_chain_s=round(dt_upd, 4),
        rollout_s=round(dt_full - dt_upd, 4),
        env_steps_per_sec=round(pop * spi / dt_full, 1),
        rollout_steps=T, sequential_updates=cfg.ppo.update_epochs * cfg.ppo.num_minibatches,
    )


def profile_morld(device: torch.device, num_envs: int = 256, seg_iters: int = 32, pop: int = 6) -> None:
    env = make_env("mo-halfcheetah-jx-v5", device)
    cfg = MORLDConfig(
        pop_size=pop, vectorized=True,
        sac=MOSACConfig(num_envs=num_envs, learning_starts=num_envs, buffer_size=16384),
    )
    algo = MORLD(env, cfg, device=device)
    agent = algo.population[0]
    weights = torch.as_tensor(np.stack(algo.weights), dtype=torch.float32, device=device)
    fresh = lambda: (agent.init_state(list(range(pop))), agent.make_buffer(pop))  # noqa: E731

    dt_full = _time(lambda sb: algo._pop_step(sb[0], sb[1], weights, seg_iters, cfg.update_passes), fresh, device)
    dt_nocoop = _time(lambda sb: algo._pop_step(sb[0], sb[1], weights, seg_iters, 0), fresh, device)
    emit(
        workload="morld", num_envs=num_envs, seg_iters=seg_iters, pop=pop,
        segment_s=round(dt_full, 4), coop_updates_s=round(dt_full - dt_nocoop, 4),
        train_segment_s=round(dt_nocoop, 4),
        env_steps_per_sec=round(pop * seg_iters * num_envs / dt_full, 1),
    )


def sweep_envs(device: torch.device) -> None:
    for n in (64, 256, 1024, 4096):
        profile_pgmorl(device, num_envs=n, spi=8192)
    for n in (256, 1024, 4096):
        profile_morld(device, num_envs=n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="the env-count sweep")
    ap.add_argument("--trace", default=None, metavar="DIR", help="profile the default measurements into DIR")
    ap.add_argument("--small", action="store_true", help="small sizes for the phase split (the sweep keeps its env counts)")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    announce(device, "profile_population")
    pgmorl = dict(num_envs=32, spi=256) if args.small else {}
    morld = dict(num_envs=4, seg_iters=2) if args.small else {}
    if args.trace:
        with trace(args.trace):
            profile_pgmorl(device, **pgmorl)
            profile_morld(device, **morld)
    elif args.sweep:
        sweep_envs(device)
    else:
        profile_pgmorl(device, **pgmorl)
        profile_morld(device, **morld)
    return 0


if __name__ == "__main__":
    sys.exit(main())
