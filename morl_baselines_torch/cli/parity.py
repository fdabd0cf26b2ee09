"""Protocol runner: the BASELINE configs at the reference budgets, over seeds.

Counterpart of the JAX package's ``scripts/parity.py``: the same 22 configs
under the same names, with the same envs, agent configs, ``train``
arguments and summary fields.  Each (config, seed) logs the reference-named
evaluation curves (``eval/hypervolume``, ``eval/eum``, ``eval/igd``,
``eval/mul``, the scalarized returns) to ``parity_<config>_seed<k>.jsonl``
and appends one summary record to ``parity_summary.jsonl``.

    python -m morl_baselines_torch.cli.parity [config ...] [--seeds=0,1,2] [--smoke] [--device cuda|cpu] [--out DIR]
    python -m morl_baselines_torch.cli.parity --table results/torch results/r4 results/r5

``--smoke`` shrinks the budgets the JAX runner shrinks under
``PARITY_SMOKE=1`` (an API check, no learning) and writes to a temporary
directory; without it the records go to ``results/torch/``.  The device is
CUDA unless ``--device cpu`` is given.  A (config, seed) that raises is
recorded under ``exception``, its traceback goes to stderr, and the runner
goes on; it exits non-zero at the end if any raised.  ``--table`` prints,
for the records of the port and of the JAX runner, the statistics that set
one beside the other.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..agents import (
    CAPQL,
    EUPG,
    GPILS,
    GPIPD,
    IPRO,
    MORLD,
    MOSAC,
    PCN,
    PGMORL,
    PQL,
    CAPQLConfig,
    Envelope,
    EnvelopeConfig,
    EUPGConfig,
    GPILSConfig,
    GPILSContinuous,
    GPILSContinuousConfig,
    GPIPDConfig,
    GPIPDContinuous,
    GPIPDContinuousConfig,
    IPROConfig,
    MOPPOConfig,
    MOQLearning,
    MOQLearningConfig,
    MORLDConfig,
    MOSACConfig,
    MPMOQLConfig,
    MPMOQLearning,
    NLMOPPOConfig,
    PCNConfig,
    PGMORLConfig,
    PQLConfig,
)
from ..core.pareto import filter_pareto_dominated
from ..envs import fishwood_utility
from ..models.dynamics import EnsembleConfig
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger
from .experiments import make_env

RESULTS = Path(__file__).resolve().parents[2] / "results" / "torch"
MINECART_REF = np.array([0.0, 0.0, -200.0])
HOPPER_REF = np.array([-100.0, -100.0, -100.0])


@dataclass
class Spec:
    """One config at one seed: the env, the agent's class, config and
    keyword arguments, and what its run is given (``train``: the keyword
    arguments of ``agent.train``, or of ``drive`` where the config runs its
    own loop).  ``front_gamma`` is the discount of the env's known front
    passed as ``known_pareto_front``; ``summary`` turns the finished run into
    the config's summary fields."""

    env_id: str
    agent: type
    config: Any
    summary: Callable[["Run"], dict]
    train: dict = field(default_factory=dict)
    agent_kwargs: dict = field(default_factory=dict)
    env_kwargs: dict = field(default_factory=dict)
    front_gamma: float | None = None
    drive: Callable[["Run"], Any] | None = None


@dataclass
class Run:
    name: str
    seed: int
    spec: Spec
    env: Any
    agent: Any
    jsonl: Path
    logger: MetricLogger
    result: Any = None


# ---------------------------------------------------------------- summaries


def _metrics(run: Run) -> dict:
    return dict(metrics={k: float(v) for k, v in run.agent._last_metrics.items()})


def _ccs_metrics(run: Run) -> dict:
    return dict(ccs=[list(map(float, v)) for v in run.agent.ccs], **_metrics(run))


def _ccs_metrics_trajectory(run: Run) -> dict:
    return dict(**_ccs_metrics(run), **_hv_trajectory(run.jsonl))


def _archive_front(run: Run) -> dict:
    return dict(front=[list(map(float, v)) for v in run.agent.archive.evaluations], **_metrics(run))


def _last_front(run: Run) -> dict:
    return dict(front=[list(map(float, p)) for p in np.asarray(run.agent._last_front)], **_metrics(run))


def _last_eval(run: Run) -> list:
    return [list(map(float, np.asarray(x))) for x in run.agent.last_eval]


def _hv_trajectory(path: Path) -> dict:
    """Best-so-far HV across the run's eval snapshots (the reference's CCS
    persists best-per-weight evaluations across iterations; recomputed
    fronts are point-in-time snapshots, so the max is the comparable datum),
    and the median of the last three evaluations: single-eval finals are a
    lottery on stochastic-eval envs, the median of the last three is the
    robust end-of-run statistic."""
    try:
        hvs = [
            (r["global_step"], r["eval/hypervolume"])
            for r in map(json.loads, open(path))
            if "eval/hypervolume" in r
        ]
    except FileNotFoundError:
        return {}
    if not hvs:
        return {}
    step_max, hv_max = max(hvs, key=lambda t: t[1])
    last3 = sorted(v for _, v in hvs[-3:])
    return dict(hv_final=hvs[-1][1], hv_final3_median=last3[len(last3) // 2], hv_max=hv_max, hv_max_step=step_max)


def _moql_summary(run: Run) -> dict:
    """The gap to the best Tchebicheff utility any policy on the known front
    achieves, under the utopian the agent's scalarizer converges to
    (elementwise max step reward + tau 0.5)."""
    env, w = run.env, run.spec.agent_kwargs["weights"]
    front = np.asarray(env.pareto_front(0.9))
    utopian = np.max(np.asarray(env.pareto_front(1.0)), axis=0) + 0.5
    tcheb = lambda p: -float(np.max(w * np.abs(utopian - p)))  # noqa: E731
    optimal = max(tcheb(p) for p in front)
    achieved = tcheb(np.asarray(run.agent.last_eval[1]))
    return dict(last_eval=_last_eval(run), optimal_tchebicheff=optimal, achieved_tchebicheff=achieved,
                gap_to_optimal=optimal - achieved)


def _eupg_summary(run: Run) -> dict:
    disc = torch.as_tensor(run.agent.last_eval[1])
    return dict(last_eval=_last_eval(run), esr_utility=float(fishwood_utility(disc)))


def _ipro_summary(run: Run) -> dict:
    known = filter_pareto_dominated(np.asarray(run.env.pareto_front(0.99)))
    pf = np.asarray(run.result).reshape(-1, 2)
    # distance of each found point to its nearest known-front point
    d2known = [float(np.min(np.linalg.norm(known - p[None], axis=1))) for p in pf]
    out = dict(pf=[list(map(float, p)) for p in pf])
    if run.name == "ipro_dst_fine":
        out["pf_unique"] = len({tuple(round(float(x), 3) for x in p) for p in pf})
    ipro = run.agent
    return dict(out, coverage=float(ipro.coverage), error=float(ipro.error),
                replay_triggered=int(ipro.replay_triggered), dist_to_known_front=d2known)


def _pql_summary(run: Run) -> dict:
    """The start state's PCS, and the reference test bar: track its
    max-treasure point and obtain it."""
    agent, state = run.agent, run.result
    start = int(run.env.state_index(torch.zeros(2)))
    front = np.asarray(agent.get_local_pcs(state, start))
    tracked = []
    if len(front):
        target = front[int(np.argmax(front[:, 0]))]
        got = agent.track_policy(state, target)
        tracked = dict(target=list(map(float, target)), obtained=list(map(float, np.asarray(got))))
    return dict(front=[list(map(float, p)) for p in front], tracking=tracked, **_metrics(run))


def _mosac_drive(run: Run):
    """Segments of ``seg_steps`` env-steps, each followed by ``rep``
    evaluation episodes at the agent's fixed weight; draws from one
    generator seeded with the run's seed."""
    agent, t = run.agent, run.spec.train
    w = run.spec.agent_kwargs["weights"]
    gen = torch.Generator(agent.device).manual_seed(run.seed)
    state, buffer = agent.init_state(), agent.make_buffer()
    done, disc = 0, np.zeros(len(w))
    while done < t["total"]:
        iters = max(1, min(t["seg_steps"], t["total"] - done) // agent.cfg.num_envs)
        state = agent.train_segment(state, buffer, iters)
        done += iters * agent.cfg.num_envs
        ret, disc = (x[0].cpu().numpy() for x in agent.policy_eval(state, gen, t["rep"], max_steps=t["max_steps"]))
        run.logger.log(
            {
                "eval/vec_return": [float(x) for x in ret],
                "eval/discounted_vec_return": [float(x) for x in disc],
                "eval/scalarized_discounted_return": float(disc @ w),
            },
            done,
        )
    return disc


def _mosac_summary(run: Run) -> dict:
    disc = run.result
    return dict(final_disc_return=[float(x) for x in disc], scalarized=float(disc @ run.spec.agent_kwargs["weights"]))


def _capql_summary(run: Run) -> dict:
    # the front beside the JAX record's metrics, so the card can score it again
    return dict(front=[list(map(float, p)) for p in np.asarray(run.agent._last_front)], **_metrics(run))


# ---------------------------------------------------------------- configs


def _moql_dst(seed: int, smoke: bool) -> Spec:
    """Reference examples/mo_q_learning_DST.py: concave map,
    tchebicheff(tau=4), w=(0.3, 0.7), gamma 0.9, constant epsilon 0.1, 100k steps."""
    return Spec(
        "deep-sea-treasure-concave-v0", MOQLearning,
        MOQLearningConfig(gamma=0.9, initial_epsilon=0.1, final_epsilon=0.1, scalarization="tchebicheff",
                          num_envs=16, seed=seed),
        _moql_summary,
        train=dict(total_timesteps=100_000, eval_freq=5_000),
        agent_kwargs=dict(weights=np.array([0.3, 0.7])),
    )


def _eupg_fishwood(seed: int, smoke: bool, learning_rate: float = 1e-3, eval_freq: int = 100_000) -> Spec:
    """Reference examples/eupg_fishwood.py: 4M steps, ESR utility min(fish, wood // 2)."""
    return Spec(
        "fishwood-v0", EUPG,
        EUPGConfig(num_envs=64, chunk_len=200, learning_rate=learning_rate, gamma=0.99, seed=seed),
        _eupg_summary,
        train=dict(total_timesteps=4_000_000, eval_freq=eval_freq),
        agent_kwargs=dict(scalarization=fishwood_utility),
    )


def _eupg_fishwood_lr5e4(seed: int, smoke: bool) -> Spec:
    """The same protocol at half the learning rate."""
    return _eupg_fishwood(seed, smoke, learning_rate=5e-4, eval_freq=200_000)


def _envelope_minecart(seed: int, smoke: bool) -> Spec:
    """Envelope/minecart at 64 envs x 8 updates x batch 512, 2.5M env-steps.
    The buffer holds every step (rare early ore sales are never evicted);
    epsilon decays over half the run on the per-env step clock."""
    return Spec(
        "minecart-v0", Envelope,
        EnvelopeConfig(num_envs=64, buffer_size=2_500_000, batch_size=512, num_sample_w=4, gamma=0.98,
                       learning_starts=2048, gradient_updates=8, epsilon_decay_steps=20_000,
                       homotopy_decay_steps=15_000, per=True, seed=seed),
        _metrics,
        train=dict(total_timesteps=2_500_000, ref_point=MINECART_REF, eval_freq=125_000,
                   num_eval_weights_for_front=32, eval_max_steps=400),
        front_gamma=0.98,
    )


def _gpils_dst(seed: int, smoke: bool) -> Spec:
    """GPI-LS on DST, 200k steps (200k / 128 envs = 1.5k per-env steps)."""
    return Spec(
        "deep-sea-treasure-v0", GPILS,
        GPILSConfig(num_envs=128, buffer_size=100_000, gradient_updates=10, epsilon_decay_steps=1_200,
                    gamma=0.98, seed=seed),
        _ccs_metrics,
        train=dict(total_timesteps=200_000, ref_point=np.array([0.0, -50.0]), timesteps_per_iter=10_000,
                   num_eval_weights_for_front=32),
        front_gamma=0.98,
    )


def _gpils_minecart(seed: int, smoke: bool) -> Spec:
    """GPI-LS on minecart at 2.5M steps, the tuning sweep's config; the buffer
    holds every step (sales are rare exploration events)."""
    return Spec(
        "minecart-v0", GPILS,
        GPILSConfig(gamma=0.98, learning_starts=2048, seed=seed, num_envs=64, gradient_updates=8, batch_size=512,
                    final_epsilon=0.2, epsilon_decay_steps=15_000, target_net_update_freq=100, max_support=16,
                    per=True, buffer_size=2_500_000),
        _ccs_metrics,
        train=dict(total_timesteps=2_500_000, ref_point=MINECART_REF, timesteps_per_iter=10_000,
                   num_eval_weights_for_front=32, eval_max_steps=400),
        front_gamma=0.98,
    )


def _gpipd_minecart_train(smoke: bool) -> dict:
    # minecart mining is stochastic: 5 evaluation episodes a weight, as the reference
    return dict(total_timesteps=1_500 if smoke else 150_000, ref_point=MINECART_REF,
                timesteps_per_iter=500 if smoke else 10_000, num_eval_weights_for_front=32,
                num_eval_episodes_for_front=5, eval_max_steps=40 if smoke else 400)


def _gpipd_minecart(seed: int, smoke: bool, **overrides) -> Spec:
    """GPI-PD with the reference defaults (Dyna on) and the whole-buffer
    fit to convergence, at the reference example's ratios (150k = 15 x
    10k steps, 20 updates an env-step: 320 an iteration of 16 envs)."""
    cfg = GPIPDConfig(
        num_envs=16, gradient_updates=4 if smoke else 320, full_updates_after=5_000,
        batch_size=128, buffer_size=4_096 if smoke else 200_000,
        final_epsilon=0.05, epsilon_decay_steps=3_000,
        target_net_update_freq=12, max_support=16, gamma=0.98,
        learning_starts=256, seed=seed,
        per=True, gpi_pd=True, dyna=True,
        dynamics_train_freq=16, dynamics_rollout_freq=16,
        dynamics_rollout_len=1, dynamics_rollout_starts=256 if smoke else 25_000,
        dynamics_uncertainty_threshold=1.5,
        dynamics_fit_to_convergence=True,
        dyna_buffer_size=2_048 if smoke else 100_000,
        dyna_batch_share=0.5,
        # 50 epochs, not the reference's 200: the holdout keeps improving on
        # near-deterministic minecart, so the patience stop rarely fires
        ensemble=EnsembleConfig(num_members=5, num_elites=2, hidden=(256, 256, 256), max_epochs=8 if smoke else 50),
    )
    return Spec("minecart-v0", GPIPD, dataclasses.replace(cfg, **overrides), _ccs_metrics_trajectory,
                train=_gpipd_minecart_train(smoke), front_gamma=0.98)


def _gpipd_minecart_rw(seed: int, smoke: bool) -> Spec:
    """Dyna on, with sale rows weighted 100x in the dynamics NLL."""
    return _gpipd_minecart(seed, smoke, dynamics_fit_positive_weight=99.0)


def _gpipd_minecart_base(seed: int, smoke: bool, **overrides) -> Spec:
    """The GPI-PD minecart ablations: the fixed-budget dynamics fit."""
    cfg = GPIPDConfig(
        num_envs=16, gradient_updates=4 if smoke else 320, full_updates_after=5_000,
        batch_size=128, buffer_size=4_096 if smoke else 200_000,
        final_epsilon=0.05, epsilon_decay_steps=3_000,
        target_net_update_freq=12, max_support=16, gamma=0.98,
        learning_starts=256, seed=seed,
        per=True, gpi_pd=True, dyna=True,
        dynamics_train_freq=16, dynamics_rollout_freq=16,
        dynamics_rollout_len=1, dynamics_rollout_starts=256 if smoke else 25_000,
        dynamics_uncertainty_threshold=1.5,
        dynamics_fit_to_convergence=False,
        dynamics_fit_samples=256 if smoke else 16_384,
        dyna_buffer_size=2_048 if smoke else 100_000,
        dyna_batch_share=0.5,
    )
    return Spec("minecart-v0", GPIPD, dataclasses.replace(cfg, **overrides), _ccs_metrics_trajectory,
                train=_gpipd_minecart_train(smoke), front_gamma=0.98)


def _gpipd_minecart_nodyna(seed: int, smoke: bool) -> Spec:
    """GPI-PD without imagined data: envelope-target priorities only."""
    return _gpipd_minecart_base(seed, smoke, dyna=False)


def _gpipd_minecart_strongmodel(seed: int, smoke: bool) -> Spec:
    """Dyna with a much stronger fixed-budget model fit."""
    return _gpipd_minecart_base(
        seed, smoke,
        dynamics_fit_samples=512 if smoke else 65_536,
        ensemble=EnsembleConfig(num_members=5, num_elites=2, epochs=4 if smoke else 25),
    )


def _gpipd_hopper(seed: int, smoke: bool) -> Spec:
    """Continuous GPI-PD at the reference example's shape (150k = 10 x 15k,
    buffer 4e5, batch 128, len-5 imagined rollouts, uncertainty 2.0, real
    ratio 0.1, min priority 0.1); 3 evaluation episodes a weight."""
    return Spec(
        "mo-hopper-jx-v5", GPIPDContinuous,
        GPIPDContinuousConfig(
            num_envs=32, gradient_updates=4 if smoke else 32, batch_size=128,
            buffer_size=8_192 if smoke else 400_000,
            learning_starts=1_000, gamma=0.99, seed=seed,
            per=True, dyna=True, min_priority=0.1,
            dynamics_train_freq=8, dynamics_rollout_freq=8,
            dynamics_rollout_len=5, dynamics_rollout_starts=256 if smoke else 8_192,
            dynamics_uncertainty_threshold=2.0,
            dynamics_fit_to_convergence=not smoke,
            dynamics_fit_samples=256 if smoke else 8_192,
            dyna_buffer_size=2_048 if smoke else 200_000,
            dyna_batch_share=0.9,
            ensemble=EnsembleConfig(num_members=5, num_elites=2, max_epochs=8 if smoke else 50),
        ),
        _ccs_metrics_trajectory,
        train=dict(total_timesteps=1_500 if smoke else 150_000, ref_point=HOPPER_REF,
                   timesteps_per_iter=500 if smoke else 15_000, num_eval_weights_for_front=32,
                   num_eval_episodes_for_front=3, eval_max_steps=50 if smoke else 500),
        env_kwargs=dict(max_episode_steps=500),
    )


def _gpils_cont_hopper(seed: int, smoke: bool, long: bool = False) -> Spec:
    """Continuous GPI-LS on the planar hopper at the reference example's
    budget shape (10 x 15k steps, batch 128, 500-step episodes); 32 envs x 32
    updates keeps one update an env-step.  ``long``: the 500k-step control."""
    return Spec(
        "mo-hopper-jx-v5", GPILSContinuous,
        GPILSContinuousConfig(num_envs=32, gradient_updates=32, batch_size=128,
                              buffer_size=500_000 if long else 400_000, learning_starts=1_000, gamma=0.99, seed=seed),
        _ccs_metrics,
        train=dict(total_timesteps=(5_000 if smoke else 500_000) if long else (1_500 if smoke else 150_000),
                   ref_point=HOPPER_REF, timesteps_per_iter=500 if smoke else 15_000,
                   num_eval_weights_for_front=32, eval_max_steps=50 if smoke else 500),
        env_kwargs=dict(max_episode_steps=500),
    )


def _gpils_cont_hopper_500k(seed: int, smoke: bool) -> Spec:
    return _gpils_cont_hopper(seed, smoke, long=True)


def _ipro_dst(seed: int, smoke: bool, fine: bool = False) -> Spec:
    """IPRO with the NL-MOPPO oracle on DST (150k steps an oracle call, each
    call ramping entropy 0.15 -> 0.05 over its first half, annealing lr and
    returning its best evaluated iterate).  ``fine``: tolerance 0.02 and up
    to 40 iterations."""
    return Spec(
        "deep-sea-treasure-v0", IPRO,
        IPROConfig(
            tolerance=0.02 if fine else 0.05,
            max_iterations=3 if smoke else (40 if fine else 24),
            iter_total_timesteps=1_024 if smoke else 150_000,
            offset=1.0, seed=seed,
            ppo=NLMOPPOConfig(num_envs=64, num_steps=128, update_epochs=4, num_minibatches=4, gamma=0.995,
                              ent_coef=0.05, ent_coef_start=0.15, seed=seed),
        ),
        _ipro_summary,
    )


def _ipro_dst_fine(seed: int, smoke: bool) -> Spec:
    return _ipro_dst(seed, smoke, fine=True)


def _pgmorl_halfcheetah(seed: int, smoke: bool) -> Spec:
    """PGMORL on the planar halfcheetah, vectorized, at the reference
    example's shape (pop 6, warm-up 80, evolution 20, origin (0, -5), 5M
    steps) with 64 envs x 8192 steps an iteration."""
    return Spec(
        "mo-halfcheetah-jx-v5", PGMORL,
        PGMORLConfig(
            pop_size=6, warmup_iterations=2 if smoke else 80, evolutionary_iterations=20,
            ppo=MOPPOConfig(num_envs=4 if smoke else 64, steps_per_iteration=256 if smoke else 8192,
                            gamma=0.995, seed=seed),
            vectorized=True, seed=seed,
        ),
        _archive_front,
        train=dict(total_timesteps=3_000 if smoke else 5_000_000, ref_point=np.array([-100.0, -100.0]),
                   eval_max_steps=50 if smoke else 500),
        agent_kwargs=dict(origin=np.array([0.0, -5.0])),
    )


def _morld_halfcheetah(seed: int, smoke: bool) -> Spec:
    """MORL/D on the planar halfcheetah, vectorized, at the reference
    example's shape (pop 6, exchange every 5e4, shared buffer, 10 update
    passes, PSA, 3M steps)."""
    return Spec(
        "mo-halfcheetah-jx-v5", MORLD,
        MORLDConfig(
            pop_size=6, exchange_every=512 if smoke else 50_000, shared_buffer=True,
            update_passes=2 if smoke else 10,
            weight_adaptation_method="PSA", vectorized=True, seed=seed,
            sac=MOSACConfig(num_envs=4 if smoke else 32, learning_starts=64 if smoke else 2_000,
                            buffer_size=4_096 if smoke else 400_000, seed=seed),
        ),
        _archive_front,
        train=dict(total_timesteps=2_000 if smoke else 3_000_000, ref_point=np.array([-100.0, -100.0]),
                   eval_max_steps=50 if smoke else 500),
    )


def _pql_dst(seed: int, smoke: bool) -> Spec:
    """Reference examples/pql_dst.py: the concave map, gamma 0.99, epsilon
    1 -> 0.2 over 50k, ref point (0, -25), hypervolume action scoring."""
    ref = np.array([0.0, -25.0])
    return Spec(
        "deep-sea-treasure-concave-v0", PQL,
        PQLConfig(gamma=0.99, initial_epsilon=1.0, final_epsilon=0.2, epsilon_decay_steps=50_000,
                  action_eval="hypervolume", seed=seed),
        _pql_summary,
        train=dict(total_timesteps=1_000 if smoke else 100_000, ref_point=ref, eval_freq=200 if smoke else 5_000),
        agent_kwargs=dict(ref_point=ref),
        front_gamma=0.99,
    )


def _mpmoql_dst(seed: int, smoke: bool) -> Spec:
    """Reference examples/mp_mo_q_learning_DST.py's shape: one tabular MOQL
    an OLS weight on the convex map, Q-tables transferred."""
    return Spec(
        "deep-sea-treasure-v0", MPMOQLearning,
        MPMOQLConfig(
            num_timesteps_per_iteration=500 if smoke else 40_000,
            weight_selection_algo="ols", transfer_q_table=True,
            moql=MOQLearningConfig(gamma=0.9, initial_epsilon=0.9, final_epsilon=0.1, epsilon_decay_steps=30_000,
                                   num_envs=16, seed=seed),
        ),
        _ccs_metrics,
        train=dict(total_timesteps=2_000 if smoke else 400_000, ref_point=np.array([0.0, -50.0])),
        front_gamma=0.9,
    )


def _pcn_minecart(seed: int, smoke: bool) -> Spec:
    """Reference examples/pcn_minecart.py: deterministic minecart, gamma 1,
    scaling (1, 1, 0.1, 0.1), batch 256, 1e7 steps (8 episodes a batch)."""
    return Spec(
        "minecart-deterministic-v0", PCN,
        PCNConfig(gamma=1.0, scaling_factor=(1.0, 1.0, 0.1, 0.1), max_episode_len=400, max_buffer_episodes=128,
                  num_envs=8, num_model_updates=50, batch_size=256, learning_rate=1e-3, seed=seed),
        _last_front,
        train=dict(total_timesteps=8_000 if smoke else 10_000_000, ref_point=MINECART_REF,
                   num_er_episodes=8 if smoke else 32, eval_freq=None if smoke else 100_000),
        front_gamma=1.0,
    )


def _capql_hopper(seed: int, smoke: bool) -> Spec:
    """CAPQL on the planar hopper with the reference capql.py defaults
    (2 critics, 22.5 degree angle weights, batch 256, tau 0.005)."""
    return Spec(
        "mo-hopper-jx-v5", CAPQL,
        CAPQLConfig(num_envs=32, buffer_size=200_000, batch_size=256, learning_starts=1_000, gradient_updates=8,
                    gamma=0.99, seed=seed),
        _capql_summary,
        train=dict(total_timesteps=1_500 if smoke else 150_000, ref_point=HOPPER_REF,
                   eval_freq=500 if smoke else 10_000, num_eval_weights_for_front=32,
                   eval_max_steps=50 if smoke else 500),
        env_kwargs=dict(max_episode_steps=500),
    )


def _mosac_hopper(seed: int, smoke: bool) -> Spec:
    """Continuous MOSAC on the planar hopper at the fixed weight 1/3: the
    discounted scalarized return must rise."""
    return Spec(
        "mo-hopper-jx-v5", MOSAC,
        MOSACConfig(num_envs=32, buffer_size=200_000, batch_size=256, learning_starts=1_000, gamma=0.99, seed=seed),
        _mosac_summary,
        train=dict(total=1_500 if smoke else 150_000, seg_steps=500 if smoke else 10_000, rep=5,
                   max_steps=50 if smoke else 500),
        agent_kwargs=dict(weights=np.ones(3) / 3.0),
        env_kwargs=dict(max_episode_steps=500),
        drive=_mosac_drive,
    )


SPECS: dict[str, Callable[[int, bool], Spec]] = dict(
    moql_dst=_moql_dst,
    eupg_fishwood=_eupg_fishwood,
    eupg_fishwood_lr5e4=_eupg_fishwood_lr5e4,
    envelope_minecart=_envelope_minecart,
    gpils_dst=_gpils_dst,
    gpils_minecart=_gpils_minecart,
    gpipd_minecart=_gpipd_minecart,
    gpipd_minecart_rw=_gpipd_minecart_rw,
    gpipd_minecart_nodyna=_gpipd_minecart_nodyna,
    gpipd_minecart_strongmodel=_gpipd_minecart_strongmodel,
    gpipd_hopper=_gpipd_hopper,
    ipro_dst=_ipro_dst,
    ipro_dst_fine=_ipro_dst_fine,
    gpils_cont_hopper=_gpils_cont_hopper,
    gpils_cont_hopper_500k=_gpils_cont_hopper_500k,
    pgmorl_halfcheetah=_pgmorl_halfcheetah,
    morld_halfcheetah=_morld_halfcheetah,
    pql_dst=_pql_dst,
    mpmoql_dst=_mpmoql_dst,
    pcn_minecart=_pcn_minecart,
    capql_hopper=_capql_hopper,
    mosac_hopper=_mosac_hopper,
)


def spec(name: str, seed: int, smoke: bool = False) -> Spec:
    """The config ``name`` at ``seed``; ``smoke`` shrinks what the JAX runner shrinks."""
    return SPECS[name](seed, smoke)


# ---------------------------------------------------------------- running


def run_spec(name: str, seed: int, sp: Spec, device: torch.device, out: Path) -> dict:
    """Build the env and the agent of ``sp``, run it with a JSONL logger
    into ``out``, and return the config's summary fields."""
    env = make_env(sp.env_id, device, **sp.env_kwargs)
    agent = sp.agent(env, config=sp.config, log=True, device=device, **sp.agent_kwargs)
    jsonl = out / f"parity_{name}_seed{seed}.jsonl"
    jsonl.unlink(missing_ok=True)  # a rerun replaces the curve; the summary appends
    logger = MetricLogger(experiment=f"{name}_s{seed}", jsonl_path=jsonl, stdout_every=5)
    agent.logger = logger
    run = Run(name, seed, sp, env, agent, jsonl, logger)
    try:
        if sp.drive is not None:
            run.result = sp.drive(run)
        else:
            kwargs = dict(sp.train)
            if sp.front_gamma is not None:
                kwargs["known_pareto_front"] = env.pareto_front(sp.front_gamma)
            run.result = agent.train(**kwargs)
        return sp.summary(run)
    finally:
        logger.close()


def _last_step(path: Path) -> int | None:
    steps = [json.loads(line).get("global_step") for line in open(path)] if path.exists() else []
    return steps[-1] if steps else None


def table(dirs) -> list[dict]:
    """Per (records directory, config, seed): the statistics the comparison
    with the JAX records reads — the curve's ``_hv_trajectory``, the final
    front's HV and EUM, the ESR utility, IPRO's coverage and distinct
    points, MOSAC's scalarized return, MO-Q-Learning's discounted return —
    from a ``parity_summary.jsonl`` (its last record a (config, seed)) and
    the curves beside it.  Reads the JAX runner's directories unchanged."""
    rows = []
    for d in map(Path, dirs):
        last = {(r["config"], r["seed"]): r for r in map(json.loads, open(d / "parity_summary.jsonl"))}
        for (name, seed), r in sorted(last.items()):
            row = dict(dir=str(d), config=name, seed=seed, wall=r.get("wall"), **_hv_trajectory(
                d / f"parity_{name}_seed{seed}.jsonl"))
            if "metrics" in r:
                row.update(final_hv=r["metrics"].get("eval/hypervolume"), final_eum=r["metrics"].get("eval/eum"))
            if "last_eval" in r:
                disc = r["last_eval"][1]
                row["disc_return"] = disc
                if name.startswith("eupg"):
                    row["esr_utility"] = float(fishwood_utility(torch.tensor(disc)))
            if "pf" in r:
                row.update(coverage=r["coverage"], pf_distinct=len({tuple(round(x, 3) for x in p) for p in r["pf"]}))
            for k in ("gap_to_optimal", "scalarized", "exception"):
                if k in r:
                    row[k] = r[k]
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", help=f"configs to run (default: all of {', '.join(SPECS)})")
    ap.add_argument("--seeds", default="0,1,2", help="comma-separated seeds (default 0,1,2)")
    ap.add_argument("--smoke", action="store_true", help="the JAX runner's PARITY_SMOKE budgets (an API check)")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    ap.add_argument("--out", default=None, help="records directory (default results/torch, a temporary one under --smoke)")
    ap.add_argument("--table", nargs="+", metavar="DIR", help="print each record's comparison statistics and exit")
    args = ap.parse_args(argv)
    if args.table:
        for row in table(args.table):
            print(json.dumps(row))
        return 0
    unknown = [c for c in args.configs if c not in SPECS]
    if unknown:
        ap.error(f"unknown configs {unknown}; known: {list(SPECS)}")
    device = resolve_device(args.device)
    names = args.configs or list(SPECS)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out) if args.out else (Path(tempfile.gettempdir()) / "parity_smoke" if args.smoke else RESULTS)
    out.mkdir(parents=True, exist_ok=True)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    failed = 0
    # one write a record on an O_APPEND descriptor: runs in other processes may append beside it
    summary = os.open(out / "parity_summary.jsonl", os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        for name in names:
            for seed in seeds:
                t0 = time.time()
                rec = dict(config=name, seed=seed)
                try:
                    rec.update(run_spec(name, seed, spec(name, seed, args.smoke), device, out))
                except Exception as e:  # recorded, and the next (config, seed) runs
                    traceback.print_exc()
                    rec["exception"] = repr(e)
                    failed += 1
                rec.update(wall=round(time.time() - t0, 1), device=card,
                           global_step=_last_step(out / f"parity_{name}_seed{seed}.jsonl"))
                os.write(summary, (json.dumps(rec) + "\n").encode())
                print("DONE", name, seed, "exception" if "exception" in rec else "ok", rec["wall"], flush=True)
    finally:
        os.close(summary)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
