"""Breakdown of the GPI-LS and Envelope minecart bench points into their parts.

    python -m morl_baselines_torch.cli.profile_gpils [--small] [--device cuda|cpu]

Counterpart of the JAX package's ``scripts/profile_gpils.py``.  Splits the
``gpils_minecart`` bench point (4096 envs, a 16-weight support, 10 DroQ
updates of batch 128 an iteration, the bf16 act path) into its parts and
times each alone:

  - act:    the (N x M)-row GPI action forward over the support, and the same over a support of 1
  - env:    the vectorized minecart step
  - update: a chain of 10 DroQ updates, each with its own replay sample and support-weight draw

beside the whole ``train_segment``; then the ``envelope_minecart`` headline
point (32768 envs, 16 updates of batch 128 an iteration): its segment and
its act (the conditioned forward and scalarized argmax over N rows).  The
two points differ in both the act cost a row (an M=16 GPI max against a
plain argmax) and the updates per env step (1/410 against 1/2048).  One
JSON line a measurement on stdout, under the JAX script's keys; seconds are
medians of 3 calls after a warm-up, the clock read after the card's queue
drained.  ``--small``: 32 and 64 envs, 4 iterations.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..agents import GPILS, Envelope, EnvelopeConfig, GPILSConfig
from ..core.weights import equally_spaced_weights
from ..utils.device import resolve_device
from .bench import _time, announce
from .experiments import make_env


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def profile_gpils(device: torch.device, num_envs: int = 4096, iters: int = 50) -> None:
    env = make_env("minecart-v0", device)
    cfg = GPILSConfig(
        num_envs=num_envs, buffer_size=max(4 * num_envs, 16384), batch_size=128,
        learning_starts=num_envs, gradient_updates=10, max_support=16, bf16_act=True,
    )
    agent = GPILS(env, cfg, device=device)

    def fresh():
        # the support installed, the buffer warmed by 4 iterations
        state = agent.set_weight_support(agent.init_state(0), equally_spaced_weights(3, 16))
        return agent.train_segment(state, 4, True)

    # full segment
    seg = _time(lambda s: agent.train_segment(s, iters, True), fresh, device)
    emit(metric="gpils_segment_s_per_iter", value=seg / iters, envs=num_envs,
         steps_per_sec=num_envs * iters / seg)

    state = fresh()
    net, support = state.ts.net, state.valid_support
    # act: the (N x M)-row GPI forward
    t_act = _time(lambda _: agent._gpi_actions(net, state.obs, state.task_w, support), lambda: None, device)
    emit(metric="gpils_gpi_act_s_per_iter", value=t_act, rows=num_envs * 16)

    # a support of 1 for reference: the same net, no GPI max
    t_act1 = _time(lambda _: agent._gpi_actions(net, state.obs, state.task_w, support[:1]), lambda: None, device)
    emit(metric="gpils_act_support1_s_per_iter", value=t_act1, rows=num_envs)

    # env: the vectorized step alone
    zeros = torch.zeros((num_envs,), dtype=torch.long, device=device)
    t_env = _time(lambda _: agent.venv.step(state.env_state, zeros, state.gen), lambda: None, device)
    emit(metric="gpils_env_step_s_per_iter", value=t_env)

    # the update chain: 10 DroQ updates of batch 128
    def updates(_):
        for _ in range(cfg.gradient_updates):
            batch = state.buffer.sample(state.gen, cfg.batch_size)
            widx = torch.randint(0, state.support_size, (cfg.batch_size,), generator=state.gen, device=device)
            agent._update(state.ts, batch, state.support[widx], state.gen)

    emit(metric="gpils_update_chain_s_per_iter", value=_time(updates, lambda: None, device),
         updates=cfg.gradient_updates, batch=cfg.batch_size)


def profile_envelope(device: torch.device, num_envs: int = 32768, iters: int = 100) -> None:
    env = make_env("minecart-v0", device)
    cfg = EnvelopeConfig(
        num_envs=num_envs, buffer_size=max(4 * num_envs, 65536), batch_size=128,
        learning_starts=num_envs, gradient_updates=16, train_freq=1, num_sample_w=4,
    )
    agent = Envelope(env, cfg, device=device)

    def fresh():
        return agent.train_segment(agent.init_state(0), 4)

    seg = _time(lambda s: agent.train_segment(s, iters), fresh, device)
    emit(metric="envelope_segment_s_per_iter", value=seg / iters, envs=num_envs,
         steps_per_sec=num_envs * iters / seg)

    # act: the conditioned forward + scalarized argmax over N rows
    state = fresh()
    t_act = _time(lambda _: agent._greedy_actions(state.ts.net, state.obs, state.weights), lambda: None, device)
    emit(metric="envelope_act_s_per_iter", value=t_act, rows=num_envs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="32 and 64 envs, 4 iterations")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    announce(device, "profile_gpils")
    small = args.small
    emit(note="gpils breakdown", point="bench gpils_minecart (4096 envs, M=16, 10 upd/iter)")
    profile_gpils(device, num_envs=32 if small else 4096, iters=4 if small else 50)
    emit(note="envelope breakdown", point="bench envelope_minecart (32768 envs, 16 upd/iter)")
    profile_envelope(device, num_envs=64 if small else 32768, iters=4 if small else 100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
