"""Hyperparameter search harness: random search, successive halving and TPE.

PyTorch port of ``morl_baselines_tpu/cli/sweep.py`` (reference
experiments/hyperparameter_search/launch_sweep.py:34-188, which runs wandb
bayes sweeps maximizing ``avg_hypervolume`` over N seeds).  The objective is
the same: the mean over seeds of each run's last ``eval/hypervolume``
(0.0 for an agent that logs none).  An Envelope trial, on flat or pixel
observations, trains its seeds as one seed-stacked state
(``run_trial_vmapped``: one stream of launches for all seeds, where the JAX
package vmaps over seeds); every other trial, and any trial under
``--no-vmap-seeds``, trains its seeds one after another.  The dispatch is
by that rule, never by catching a failure: a stacked trial that fails
raises (the JAX package falls back to sequential seeds on any exception,
which makes its CAPQL trials sequential).

Scheduling: plain random search (default), successive halving
(``--halving``: sample N configs, train all at budget/eta^(rungs-1),
promote the top 1/eta per rung), or TPE (``--tpe``: tree-structured Parzen
estimator suggestions, the model family of wandb's bayes sweeps).  The
suggestions are pure numpy and equal the JAX package's for the same
``np.random.Generator``.

Search-space spec (JSON): {"param": {"values": [...]}} or
{"param": {"min": lo, "max": hi, "log": true, "int": true}} ("int" rounds to
int, the reference's int_uniform).  Dotted param names descend into nested
configs ("ppo.learning_rate").  Spaces mirroring the reference's wandb YAMLs
live in configs/sweeps/*.json (use --space-file).  ``--device`` (default
``cuda``) is handed to every agent; without CUDA the sweep raises unless
given ``--device cpu``.

Usage:
    python -m morl_baselines_torch.cli.sweep --algo envelope \
        --env-id deep-sea-treasure-v0 --ref-point 0 -50 \
        --space '{"learning_rate": {"min": 1e-4, "max": 1e-2, "log": true},
                  "batch_size": {"values": [64, 128]}}' \
        --num-trials 10 --num-seeds 3 --num-timesteps 20000 --halving
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import time

import numpy as np
import torch

from ..agents.envelope import Envelope
from ..core.indicators import hypervolume
from ..core.pareto import get_non_dominated_inds
from ..core.weights import equally_spaced_weights
from ..utils.device import resolve_device
from .experiments import ALGOS, make_env


def sample_config(space: dict, rng: np.random.Generator) -> dict:
    out = {}
    for k, spec in space.items():
        if "values" in spec:
            v = spec["values"][rng.integers(0, len(spec["values"]))]
        elif spec.get("log"):
            v = float(np.exp(rng.uniform(np.log(spec["min"]), np.log(spec["max"]))))
        else:
            v = float(rng.uniform(spec["min"], spec["max"]))
        if spec.get("int") and not isinstance(v, bool):
            v = int(round(v))  # reference int_uniform distributions
        out[k] = v
    return out


def _to_unit(v, spec):
    """Map a sampled value into the TPE modeling space ([0,1] for numeric)."""
    if "values" in spec:
        return spec["values"].index(v)
    lo, hi = spec["min"], spec["max"]
    if spec.get("log"):
        return (np.log(v) - np.log(lo)) / (np.log(hi) - np.log(lo))
    return (v - lo) / (hi - lo)


def _from_unit(u, spec):
    if "values" in spec:
        return spec["values"][int(u)]
    lo, hi = spec["min"], spec["max"]
    if spec.get("log"):
        v = float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
    else:
        v = float(lo + u * (hi - lo))
    return int(round(v)) if spec.get("int") else v


def tpe_suggest(space: dict, history: list, rng: np.random.Generator,
                gamma: float = 0.25, n_candidates: int = 24, n_init: int = 4) -> dict:
    """Tree-structured Parzen Estimator suggestion (independent per-param),
    approximating the reference's wandb bayes sweeps
    (launch_sweep.py:34-188) without a wandb server.

    Split past trials into good (top gamma fraction by score) and bad; model
    each set with a Parzen mixture per parameter (Gaussian kernels on the
    unit-mapped value; smoothed histogram for categoricals); return the
    candidate maximizing the density ratio l_good/g_bad.
    """
    if len(history) < n_init:
        return sample_config(space, rng)
    hist = sorted(history, key=lambda t: -t[1])
    n_good = max(1, int(np.ceil(gamma * len(hist))))
    good, bad = hist[:n_good], hist[n_good:] or hist[-1:]
    out = {}
    for k, spec in space.items():
        gv = np.array([_to_unit(t[0][k], spec) for t in good], dtype=np.float64)
        bv = np.array([_to_unit(t[0][k], spec) for t in bad], dtype=np.float64)
        if "values" in spec:
            m = len(spec["values"])
            lg = np.bincount(gv.astype(int), minlength=m) + 1.0
            lb = np.bincount(bv.astype(int), minlength=m) + 1.0
            ratio = (lg / lg.sum()) / (lb / lb.sum())
            # sample from the good distribution, break ties by the ratio
            cand = rng.choice(m, size=min(n_candidates, 4 * m), p=lg / lg.sum())
            out[k] = _from_unit(cand[np.argmax(ratio[cand])], spec)
        else:
            bw_g = max(1.0 / max(len(gv), 1), gv.std() + 1e-3)
            bw_b = max(1.0 / max(len(bv), 1), bv.std() + 1e-3)
            cand = np.clip(gv[rng.integers(0, len(gv), n_candidates)]
                           + rng.normal(0, bw_g, n_candidates), 0.0, 1.0)

            def parzen(x, centers, bw):
                z = (x[:, None] - centers[None, :]) / bw
                return np.exp(-0.5 * z * z).mean(axis=1) / bw

            score = np.log(parzen(cand, gv, bw_g) + 1e-12) - np.log(parzen(cand, bv, bw_b) + 1e-12)
            out[k] = _from_unit(float(cand[np.argmax(score)]), spec)
    return out


def _apply_overrides(cfg, overrides: dict):
    """dataclasses.replace with dotted keys descending into nested configs
    (e.g. "ppo.learning_rate" for PGMORLConfig.ppo)."""
    flat = {k: v for k, v in overrides.items() if "." not in k}
    nested: dict = {}
    for k, v in overrides.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        flat[head] = _apply_overrides(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **flat)


def _build_agent(algo: str, env_id: str, ref_point, overrides: dict, seed: int, device="cuda"):
    env = make_env(env_id, device)
    algo_cls = ALGOS[algo]
    sig = inspect.signature(algo_cls.__init__)
    kwargs = {}
    if "config" in sig.parameters:
        default_cfg = sig.parameters["config"].default
        kwargs["config"] = _apply_overrides(default_cfg, dict(overrides, seed=seed))
    if "ref_point" in sig.parameters:
        kwargs["ref_point"] = np.asarray(ref_point)
    if "origin" in sig.parameters:
        kwargs["origin"] = np.asarray(ref_point)
    if "weights" in sig.parameters:
        kwargs["weights"] = np.ones(env.reward_dim) / env.reward_dim
    if "device" in sig.parameters:
        kwargs["device"] = device
    return algo_cls(env, **kwargs), env


def run_trial_vmapped(algo: str, env_id: str, ref_point, overrides: dict, num_seeds: int, num_timesteps: int,
                      device="cuda"):
    """All seeds of an Envelope trial trained as one seed-stacked state.

    Seeds ``range(num_seeds)``: stacked member s starts where the sequential
    trial's seed s starts.  ``num_timesteps // num_envs`` iterations, then
    the S fronts (32 equally spaced weights, one episode each, up to the
    env's episode length or 500 steps) evaluated as one batch, each filtered
    to its non-dominated points and scored by the host ``hypervolume``.
    Returns (mean_hv, per-seed hvs) like ``run_trial``.
    """
    agent, env = _build_agent(algo, env_id, ref_point, overrides, 0, device)
    cfg = agent.cfg
    state = agent.init_state_seeds(range(num_seeds))
    state = agent.train_segment(state, max(1, num_timesteps // cfg.num_envs))
    eval_weights = torch.as_tensor(equally_spaced_weights(env.reward_dim, 32), dtype=torch.float32, device=agent.device)
    fronts = agent._eval_front(state.ts.net, eval_weights, 1, env.max_episode_steps or 500).cpu().numpy()
    scores = [float(hypervolume(front[get_non_dominated_inds(front)], np.asarray(ref_point))) for front in fronts]
    return float(np.mean(scores)), scores


def stacks_seeds(algo: str) -> bool:
    """Whether a trial trains its seeds stacked: Envelope, on flat or pixel
    observations (its NatureCNN trunk takes the seed axis too)."""
    return issubclass(ALGOS[algo], Envelope)


def run_trial(algo: str, env_id: str, ref_point, overrides: dict, num_seeds: int, num_timesteps: int,
              train_kwargs=None, device="cuda", vmap_seeds: bool = True):
    """Mean final hypervolume over seeds (the sweep objective, reference :100-141).
    ``vmap_seeds`` stacks the seeds where ``stacks_seeds`` allows it."""
    if vmap_seeds and stacks_seeds(algo):
        return run_trial_vmapped(algo, env_id, ref_point, overrides, num_seeds, num_timesteps, device=device)
    scores = []
    for seed in range(num_seeds):
        agent, env = _build_agent(algo, env_id, ref_point, overrides, seed, device)
        tkw = dict(train_kwargs or {})
        tsig = inspect.signature(agent.train)
        if "ref_point" in tsig.parameters:
            tkw.setdefault("ref_point", np.asarray(ref_point))
        agent.train(num_timesteps, **tkw)
        hv = agent._last_metrics.get("eval/hypervolume", 0.0) if hasattr(agent, "_last_metrics") else 0.0
        scores.append(hv)
    return float(np.mean(scores)), scores


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", required=True, choices=list(ALGOS))
    parser.add_argument("--env-id", required=True)
    parser.add_argument("--ref-point", type=float, nargs="+", required=True)
    parser.add_argument("--space", type=str, default=None, help="JSON search space (inline)")
    parser.add_argument("--space-file", type=str, default=None,
                        help="path to a JSON search-space file (see configs/sweeps/)")
    parser.add_argument("--num-trials", type=int, default=10)
    parser.add_argument("--num-seeds", type=int, default=3)
    parser.add_argument("--num-timesteps", type=int, default=50_000)
    parser.add_argument("--out", type=str, default="sweep_results.jsonl")
    parser.add_argument("--sweep-seed", type=int, default=0)
    parser.add_argument("--no-vmap-seeds", action="store_true", help="force sequential per-seed training")
    parser.add_argument("--halving", action="store_true", help="successive-halving schedule")
    parser.add_argument("--eta", type=int, default=2, help="halving promotion factor")
    parser.add_argument("--rungs", type=int, default=3, help="halving rungs")
    parser.add_argument("--tpe", action="store_true", help="TPE (bayes-like) suggestions instead of random")
    parser.add_argument("--device", type=str, default="cuda", help="torch device; cpu only when asked for")
    args = parser.parse_args(argv)

    if args.space is None and args.space_file is None:
        parser.error("one of --space / --space-file is required")
    device = resolve_device(args.device)
    if args.space_file is not None:
        with open(args.space_file) as f:
            space = json.load(f)
    else:
        space = json.loads(args.space)
    space = {k: v for k, v in space.items() if not k.startswith("_")}  # drop _comment etc.
    rng = np.random.default_rng(args.sweep_seed)
    best = (-np.inf, None)

    def evaluate(trial_id, overrides, budget, f):
        t0 = time.time()
        score, scores = run_trial(
            args.algo, args.env_id, args.ref_point, overrides, args.num_seeds, budget, device=device,
            vmap_seeds=not args.no_vmap_seeds,
        )
        rec = {
            "trial": trial_id,
            "overrides": overrides,
            "num_timesteps": budget,
            "avg_hypervolume": score,
            "seed_hypervolumes": scores,
            "wall_s": time.time() - t0,
        }
        f.write(json.dumps(rec) + "\n")
        f.flush()
        print(json.dumps(rec))
        return score

    with open(args.out, "a") as f:
        if args.halving:
            # successive halving: all configs at budget/eta^(rungs-1); promote
            # the top 1/eta per rung (the budget role of the reference's bayes sweep)
            pool = [(f"t{i}", sample_config(space, rng)) for i in range(args.num_trials)]
            for rung in range(args.rungs):
                budget = max(1, args.num_timesteps // (args.eta ** (args.rungs - 1 - rung)))
                scored = [(evaluate(f"{tid}-r{rung}", ov, budget, f), tid, ov) for tid, ov in pool]
                scored.sort(key=lambda x: -x[0])
                if scored and scored[0][0] > best[0]:
                    best = (scored[0][0], scored[0][2])
                keep = max(1, len(scored) // args.eta)
                pool = [(tid, ov) for _, tid, ov in scored[:keep]]
        else:
            history: list = []
            for trial in range(args.num_trials):
                overrides = tpe_suggest(space, history, rng) if args.tpe else sample_config(space, rng)
                score = evaluate(trial, overrides, args.num_timesteps, f)
                history.append((overrides, score))
                if score > best[0]:
                    best = (score, overrides)
    print("best:", best)
    return best


if __name__ == "__main__":
    main()
