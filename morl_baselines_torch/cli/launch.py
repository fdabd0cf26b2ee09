"""Benchmark launcher CLI.

PyTorch port of ``morl_baselines_tpu/cli/launch.py`` (reference
experiments/benchmark/launch_experiment.py:28-217): build an algorithm from
the registry and an env from the env registry, wire the known Pareto front
when there is one, and train.  ``--device`` (default ``cuda``) goes to the
agent and to the envs that hold constants on a device; without CUDA the
launcher raises unless given ``--device cpu``.

Usage:
    python -m morl_baselines_torch.cli.launch --algo envelope \
        --env-id deep-sea-treasure-v0 --ref-point 0 -50 \
        --num-timesteps 100000 --init-hyperparams num_envs:128
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect

import numpy as np

from ..envs.registry import ENVS_WITH_KNOWN_PARETO_FRONT
from ..utils.device import resolve_device
from .experiments import ALGOS, StoreDict, make_env


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", type=str, required=True, choices=list(ALGOS.keys()))
    parser.add_argument("--env-id", type=str, required=True)
    parser.add_argument("--num-timesteps", type=int, default=100_000)
    parser.add_argument("--gamma", type=float, default=None, help="override env discount for the known front")
    parser.add_argument("--ref-point", type=float, nargs="+", required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--log", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="torch device; cpu only when asked for")
    parser.add_argument(
        "--init-hyperparams",
        type=str,
        nargs="+",
        action=StoreDict,
        default={},
        help="constructor config overrides, e.g. num_envs:128 batch_size:256",
    )
    parser.add_argument(
        "--train-hyperparams",
        type=str,
        nargs="+",
        action=StoreDict,
        default={},
        help="train() kwargs overrides, e.g. timesteps_per_iter:5000",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(args.env_id, device)
    # env-specific wrapper stacks, mirroring the reference CLI
    # (launch_experiment.py:155-180): highway-class envs flatten their
    # kinematics obs; pixel envs get the mario CNN stack (wrap_pixel_stack is
    # already applied by the registry's -stack id) and the matching CNN trunk.
    if "highway" in args.env_id:
        from ..envs.wrappers import FlattenObservation

        env = FlattenObservation(env)
    if "pixel-stack" in args.env_id:
        args.init_hyperparams.setdefault("image_shape", (4, 84, 84))
    algo_cls = ALGOS[args.algo]
    ref_point = np.asarray(args.ref_point, dtype=np.float64)

    # construct the config dataclass with overrides when the agent takes one
    sig = inspect.signature(algo_cls.__init__)
    kwargs = {}
    if "config" in sig.parameters and args.init_hyperparams:
        kwargs["config"] = dataclasses.replace(sig.parameters["config"].default, **args.init_hyperparams)
    if "ref_point" in sig.parameters:
        kwargs["ref_point"] = ref_point
    if "origin" in sig.parameters:
        kwargs["origin"] = ref_point
    if "weights" in sig.parameters:
        kwargs["weights"] = np.ones(env.reward_dim) / env.reward_dim
    if "device" in sig.parameters:
        kwargs["device"] = device

    agent = algo_cls(env, log=args.log, **kwargs)

    train_kwargs = dict(args.train_hyperparams)
    known_front = None
    if args.env_id in ENVS_WITH_KNOWN_PARETO_FRONT:
        gamma = args.gamma if args.gamma is not None else getattr(agent.config, "gamma", 0.99)
        known_front = env.pareto_front(gamma)
    tsig = inspect.signature(agent.train)
    if "ref_point" in tsig.parameters:
        train_kwargs.setdefault("ref_point", ref_point)
    if "known_pareto_front" in tsig.parameters and known_front is not None:
        train_kwargs.setdefault("known_pareto_front", known_front)
    agent.train(args.num_timesteps, **train_kwargs)
    if hasattr(agent, "_last_metrics"):
        print("final:", agent._last_metrics)
    return agent


if __name__ == "__main__":
    main()
