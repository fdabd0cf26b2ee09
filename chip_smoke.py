"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``morl_baselines_torch/csrc`` with nvcc
(sm_90a) and prints ptxas's registers and spills.  Holds the kernel bitwise
against its plain PyTorch version on random, ``front``, ``archive_add`` and
``inf`` inputs that reach both launch configurations (one block for small N,
column chunks spread over the card above) and both compare paths (arithmetic
on finite tiles, predicates on the rest), and times both at the main path's size and
at archive scale (N=131072), with the profiler's device time beside the event
time.  Drives ``DeviceParetoFront.add`` at archive scale (65536 + 65536 points)
and checks the kept set against the plain path.  Then drives the main path —
Envelope Q-learning on minecart at the accelerator config of
``bench.py::bench_envelope_minecart`` (32768 envs, (256,)*4 Q-net) — through
``train_segment`` and ``Envelope.train`` and scores the evaluated front on the
card, which runs the kernel.  Then the GPI paths on minecart: GPI-LS at the
accelerator config of ``bench.py::bench_gpils_minecart`` (4096 envs, a
16-weight support, bf16 GEMMs in the action forward, 2 critics of (256,)*4)
through ``train_segment`` and ``GPILS.train``, and GPI-PD through
``GPIPD.train`` (PER with envelope-target priorities, Dyna with the default
5-member dynamics ensemble fit to convergence); each front is scored on the
card.  Then the continuous-control slice: ``[planar]`` steps the planar
hopper and halfcheetah at 2048 envs (ms and kernel launches per control
step, finite states, passive hoppers settling on the foot); GPI-LS
continuous at the accelerator config of ``bench.py::bench_gpils_cont_hopper``
(2048 envs, 2 BatchRenorm/WeightNorm critics of (256, 256), an 8-weight
support) through ``train_segment`` and ``GPILSContinuous.train``, and
GPI-PD continuous through ``GPIPDContinuous.train`` (PER, Dyna with the
default 5-member ensemble fit to convergence, 512 rollout starts of 5
steps), on ``mo-hopper-jx-v5`` with 500-step episodes; each front is
scored on the card.  Then the populations on ``mo-halfcheetah-jx-v5``:
``[pgmorl_iter]`` times the vectorized PGMORL iteration at the accelerator
config of ``bench.py::bench_pgmorl_halfcheetah`` (6 MOPPO workers of 64
envs, 8192 steps, 10 epochs of 32 minibatches) and ``[pgmorl_train]`` runs
``PGMORL.train`` through one task-weight selection; ``[morld_step]`` times
the vectorized MORL/D round of ``bench.py::bench_morld_halfcheetah`` (6
MOSAC members of 256 envs, 32 iterations, 5 cooperation passes) and
``[morld_train]`` runs ``MORLD.train`` for 2 rounds with PSA; both archive
fronts are scored on the card.  Then the tabular family and ESR at their
examples' widths: ``[moql]`` trains MO-Q-Learning on deep-sea-treasure
(``examples/mo_q_learning_dst.py``: 16 envs) and evaluates it greedily,
``[mpmoql]`` runs 3 OLS iterations of MPMOQL
(``examples/mp_mo_q_learning_dst.py``) and scores the CCS on the card,
``[pql]`` trains Pareto Q-learning (``examples/pql_dst.py``), scores the
local PCS at the start state on the card and tracks its max-treasure
point, and ``[eupg]`` trains EUPG on fishwood (``examples/eupg_fishwood.py``:
64 envs, chunks of 200 steps) and evaluates its ESR utility.  Then the
remaining multi-policy algorithms at their examples' widths: ``[capql]``
times CAPQL's ``train_segment`` on ``mo-hopper-jx-v5`` after learning starts
(``examples/capql_hopper.py``: 32 envs, 2 critics of (256, 256), 8 updates
an iteration) and runs ``CAPQL.train`` with two evaluations of 32 weights;
``[pcn]`` runs ``PCN.train`` on deterministic minecart
(``examples/pcn_minecart.py``: 8 envs, 400-step episodes, 50 model updates
a round), each round split into update, commands, collect and add, and
re-executes 8 commands greedily; ``[lcn]`` runs ``LCN.train`` on fruit-tree
(``examples/lcn_fruit_tree.py``: 16 envs, Lorenz lambda 1) and times the
host's 6-D hypervolume; ``[ipro]`` runs ``IPRO.train`` on deep-sea-treasure
(``examples/ipro_dst.py``: the NL-MOPPO oracle of 64 envs x 128 steps), each
oracle call and each NL-MOPPO iteration's rollout, update and evaluation
timed.  Each of the four scores its front on the card (3-D, 3-D, 6-D and
2-D); the kernel's inputs include d = 6 rows for LCN's fronts.  Then the
discrete and pixel paths and their envs: ``[envs]`` steps the landers,
four-room, resource-gathering, breakable-bottles, both highways and the
pixel DST at 4096 envs (the pixel stack at 256) with random actions, ms
and launches a step, observations and
rewards in their bounds, and lands 256 landers with the PD heuristic (at
least 90% must land); ``[morld_lunar_step]`` times the vectorized MORL/D
round of ``examples/morld_lunar_lander.py`` (6 MOSACDiscrete members of 8
envs, (256,)*4, batch 128, 10 cooperation passes; 128 iterations a round)
and ``[morld_lunar_train]`` runs ``MORLD.train`` for 2 rounds with PSA;
``[envelope_pixel]`` times Envelope's ``train_segment`` with the NatureCNN
trunk on the pixel DST under the mario wrapper stack
(``examples/envelope_pixel_dst.py``: 64 envs, a 50k float32 frame buffer,
batch 64, 4 sampled weights), logs the peak device memory and runs
``Envelope.train`` with one evaluation; ``[pql_four_room]`` runs PQL with
hypervolume action scoring at d = 3 on four-room.  Each of the three scores
its front on the card (4-D, 2-D, 3-D); the kernel's inputs include d = 4
rows for the lander's archive.
Then the harness: ``[native]`` builds the host library
(``native/morl_native.cpp`` with g++ into ``build/``), holds its WFG
hypervolume against the port's Python WFG at d = 2..6 and on LCN's buffer of
exact copies (rel 1e-12), its batch against single calls and its host mask on
4096 float32 points at d = 3 and 6 against the CUDA kernel (bitwise), and
times both HV routes; the ``launch`` path times Envelope's ``train_segment``
with the bf16 Q-net at the main path's config, then runs
``cli.launch.main`` as a user does, Envelope on minecart at that config in
bf16 (20 iterations, one evaluation of 32 weights) and GPI-LS on
deep-sea-treasure (its known front gives ``eval/igd`` and ``eval/mul``),
each front scored on the card; the ``checkpoint`` path saves and restores
Envelope at the main path's config, the vectorized MORL/D population of
``[morld_step]`` and PCN with its episodic buffer, checks every tensor,
optimizer moment and generator state bitwise, trains on, and scores the
original and the restored Envelope's fronts (bitwise equal) on the card; the
``sweep`` path runs ``cli.sweep.main`` with successive halving over
``configs/sweeps/envelope.json`` on deep-sea-treasure (4 trials x 2 seeds,
2 rungs, the seeds one after another: ``--no-vmap-seeds``), each trial's
front scored on the card, and checks the JSONL.  Then slice 10: ``[mujoco]``
(after ``[envs]``) steps the host-stepped ``mo-hopper-v5`` and
``mo-halfcheetah-v5`` at 64 envs and ``mo-reacher-v5`` at 16 for 100 vector
steps from CUDA action tensors where gymnasium and mujoco are installed
(otherwise it says so and is skipped); the ``sweep_seeds`` path runs
``[train_segment_seeds]``, Envelope with a seed axis at the main path's
config (4 seeds x 32768 envs in one stacked state: ms, launches and device
busy an iteration beside the one-seed iteration, the peak memory, every
seed's buffer its own, the 4 fronts evaluated as one batch and each scored
on the card), then ``cli.sweep.main`` with the stacked trial (4 trials x 4
seeds, 2 rungs, every seed's front scored on the card), then one fixed
trial stacked against ``--no-vmap-seeds`` in turns (wall times, launches
an iteration).  Then slice 11: the ``mesh`` path initialises a world-size-1
NCCL process group (one card; a ``file://`` rendezvous in a temporary
directory, destroyed after the phase) and runs Envelope at the main path's
config sharded through ``parallel.make_mesh`` and ``shard_agent_state``
beside the unsharded run of the same seed (Q-nets, targets and buffers
bitwise equal; ms and launches an iteration, the all-gather's bytes, ms and
launches), then ``MORLD.train`` at ``[morld_train]``'s config with
``mesh=`` over ``pop`` beside the unsharded run (bitwise equal), its front
scored on the card; the ``envelope_pixel_seeds`` path trains 4 seeds of
``[envelope_pixel]``'s config through the stacked NatureCNN trunk (the
buffers' 42 GiB reckoned first; ms, launches and device busy an iteration
beside the one-seed pixel iteration, the peak memory, member s's Q-values
against its one-seed net, the trunk's per-member convolutions beside one
grouped convolution a layer, the 4 x 32 evaluation episodes as one batch, each front
scored on the card), then one pixel trial that the sweep's dispatch sends
down the stacked path.  Then slice 12: the ``parity`` path runs the protocol
runner ``cli.parity.main`` as a user does, on ``pql_dst`` and
``capql_hopper`` at the JAX runner's smoke budgets, seed 0, into a temporary
directory; it fails on an ``exception`` record or a missing reference
metric, logs each wall time and scores each front of the summary on the card.
After it, the ``gpils_tune`` path runs the GPI-LS minecart tuning sweep
``cli.gpils_minecart_tune.main`` as a user does, its six variants at full
width and two outer iterations of 1280 steps, into a temporary directory; it
fails on an ``exception`` record, a missing reference metric or more sale rows
than buffer rows, and scores each variant's CCS on the card.
Then slice 13: the ``bench`` path runs the port's throughput bench
``cli.bench.main([])`` as a user does: its six lines in ``bench.py``'s order
with finite positive values, the Pareto line's kernel bitwise equal to the
(N, N) torch mask at N=8192 before both are timed (``python3 chip_smoke.py
--bench-profile`` runs this path alone and profiles one more call of each
timed function on a fresh state: launches, device busy share); the
``bench_probes`` path runs the four breakdowns
(``profile_gpils``, ``profile_population``, ``bench_gpils_ab``,
``probe_planar``) at their small sizes and checks their lines.
MO-Q-Learning, EUPG and the breakdowns score no front, in the JAX
package either, so their paths launch no kernel.  Every path is driven with the kernel's launch count
set to 0 just before it and read just after.  Every phase raises on a mismatch; the
script exits non-zero without a result when CUDA is absent.  The
second-to-last line is a JSON record of the kernels, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from morl_baselines_torch.agents import (
    CAPQL,
    EUPG,
    GPILS,
    GPIPD,
    IPRO,
    LCN,
    MORLD,
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
    LCNConfig,
    MOPPO,
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
from morl_baselines_torch.agents.base import state_tree
from morl_baselines_torch.agents.ipro import make_linear_u
from morl_baselines_torch.cli import (
    bench,
    bench_gpils_ab,
    experiments,
    gpils_minecart_tune,
    launch,
    parity,
    probe_planar,
    profile_gpils,
    profile_population,
    sweep,
)
from morl_baselines_torch.core.indicators import _hv_wfg
from morl_baselines_torch.core import DeviceParetoFront, equally_spaced_weights, filter_pareto_dominated
from morl_baselines_torch.envs import VectorMOEnv, fishwood_utility, lander_heuristic, make
from morl_baselines_torch.parallel import assert_replicas_synced, make_mesh, shard_agent_state
from morl_baselines_torch.replay import Transition
from morl_baselines_torch.evaluation import device_front_metrics, multi_policy_metrics, rollout_episode
from morl_baselines_torch.evaluation import evaluation as evaluation_module
from morl_baselines_torch.ops import _build
from morl_baselines_torch.ops.pareto_kernel import nd_launch_plan, non_dominated_mask_cuda, non_dominated_mask_plain
from morl_baselines_torch.utils import native

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

NUM_ENVS = 32768
CONFIG = EnvelopeConfig(
    num_envs=NUM_ENVS,
    buffer_size=max(4 * NUM_ENVS, 65536),
    batch_size=128,
    learning_starts=NUM_ENVS,
    gradient_updates=16,
    train_freq=1,
    num_sample_w=4,
)
REF_POINT = np.array([0.0, 0.0, -200.0])

# bench.py::bench_gpils_minecart on an accelerator; (256,)*4, 2 critics, LayerNorm and dropout by default
GPILS_ENVS = 4096
GPILS_CONFIG = GPILSConfig(
    num_envs=GPILS_ENVS,
    buffer_size=max(4 * GPILS_ENVS, 16384),
    batch_size=128,
    learning_starts=GPILS_ENVS,
    gradient_updates=10,
    max_support=16,
    bf16_act=True,
)
# the same Q-nets with PER, envelope-target priorities and Dyna (default ensemble: 5 members of (200,)*4);
# at 4 iterations per outer iteration the second one recomputes the priorities, fits and rolls out
GPIPD_CONFIG = GPIPDConfig(**{**dataclasses.asdict(GPILS_CONFIG), "per": True, "gpi_pd": True, "dyna": True})
GPI_STEPS_PER_ITER = 4 * GPILS_ENVS

# bench.py::bench_gpils_cont_hopper on an accelerator (bench.py:115-123): 2048 envs, buffer 16384,
# learning_starts 2048, batch 128, 1 update per iteration; 2 critics of (256, 256) with BatchRenorm,
# WeightNorm, leaky-relu and dropout 0.01 by default
CONT_ENVS = 2048
GPILS_CONT_CONFIG = GPILSContinuousConfig(
    num_envs=CONT_ENVS, buffer_size=max(4 * CONT_ENVS, 16384), learning_starts=CONT_ENVS, gradient_updates=1
)
# the same nets with PER and Dyna: the default ensemble (5 members of (200,)*4) fit to convergence,
# 512 rollout starts of 5 steps (examples/gpi_pd_hopper.py); the second outer iteration fits and rolls out
GPIPD_CONT_CONFIG = GPIPDContinuousConfig(
    **{**dataclasses.asdict(GPILS_CONT_CONFIG), "per": True, "dyna": True,
       "dynamics_rollout_starts": 512, "dynamics_rollout_len": 5}
)
CONT_STEPS_PER_ITER = 4 * CONT_ENVS
HOPPER_REF_POINT = np.array([-100.0, -100.0, -100.0])  # examples/gpi_pd_hopper.py
HOPPER_EPISODE_STEPS = 500  # examples/gpi_pd_hopper.py; the evaluations run up to this many steps

# bench.py::bench_pgmorl_halfcheetah on an accelerator (bench.py:138-146): 6 PPO workers of 64 envs, 8192
# steps per iteration (128 rollout steps), 10 epochs of 32 minibatches, tanh MLPs of (64, 64)
POP = 6
PGMORL_CONFIG = PGMORLConfig(
    pop_size=POP, warmup_iterations=1, evolutionary_iterations=1, vectorized=True,
    ppo=MOPPOConfig(num_envs=64, steps_per_iteration=8192),
)
PGMORL_ORIGIN = np.array([0.0, -5.0])  # examples/pgmorl_halfcheetah.py
# bench.py::bench_morld_halfcheetah on an accelerator (bench.py:162-177): 6 MOSAC members of 256 envs,
# learning_starts 256, buffer 16384, batch 256, (256, 256), 32 iterations a round, 5 cooperation passes
MORLD_ENVS, MORLD_SEG_ITERS = 256, 32
MORLD_CONFIG = MORLDConfig(
    pop_size=POP, vectorized=True, exchange_every=MORLD_SEG_ITERS * MORLD_ENVS, weight_adaptation_method="PSA",
    sac=MOSACConfig(num_envs=MORLD_ENVS, learning_starts=MORLD_ENVS, buffer_size=16384),
)
# the repo's halfcheetah protocol (scripts/parity.py::pgmorl_halfcheetah, morld_halfcheetah; examples/morld_cheetah.py)
CHEETAH_REF_POINT = np.array([-100.0, -100.0])
POP_EVAL_STEPS = 100  # the population evaluations' episodes, cut from the env's 1000 steps

# examples/mo_q_learning_dst.py: 16 envs, w (0.4, 0.6), gamma 0.9, epsilon 0.9 -> 0.1 over 100k steps
MOQL_WEIGHTS = np.array([0.4, 0.6])
MOQL_CONFIG = MOQLearningConfig(gamma=0.9, initial_epsilon=0.9, final_epsilon=0.1, epsilon_decay_steps=100_000, num_envs=16)
MOQL_STEPS = 100_000  # the example trains 400k
# examples/mp_mo_q_learning_dst.py: OLS, Q-table transfer, 40k steps per iteration of 16 envs
MPMOQL_CONFIG = MPMOQLConfig(
    num_timesteps_per_iteration=40_000, weight_selection_algo="ols", transfer_q_table=True,
    moql=MOQLearningConfig(gamma=0.9, initial_epsilon=0.9, final_epsilon=0.1, epsilon_decay_steps=30_000, num_envs=16),
)
MPMOQL_ITERS = 3  # the example runs 10
DST_REF_POINT = np.array([0.0, -50.0])  # examples/mp_mo_q_learning_dst.py, examples/pql_dst.py
# examples/pql_dst.py: sets of K = 16, gamma 1, epsilon 1 -> 0.2 over 80k steps, one env
PQL_CONFIG = PQLConfig(gamma=1.0, initial_epsilon=1.0, final_epsilon=0.2, epsilon_decay_steps=80_000)
PQL_STEPS = 2_000  # the example runs 100k
# examples/eupg_fishwood.py: 64 envs, chunks of 200 steps, lr 1e-3, gamma 0.99, (64, 64); seed 1: at seed 0
# the card's random stream collapses to the river-only policy (utility 0), as the JAX package does at 3 of
# 12 seeds on the CPU
EUPG_CONFIG = EUPGConfig(num_envs=64, chunk_len=200, learning_rate=1e-3, gamma=0.99, seed=1)
EUPG_CHUNKS = 31  # 396,800 steps, RESULTS.md's 400k row (the example runs 2M)
EUPG_RESULTS_UTILITY = 21.0  # RESULTS.md:34, the JAX package at 400k steps: a quality record, not a target

# examples/capql_hopper.py: 32 envs, buffer 200k, batch 256, learning_starts 1000, 8 gradient updates, gamma 0.99;
# 2 critics of (256, 256) and the cone angle 0.418 by default; 500-step episodes, ref (-100, -100, -100)
CAPQL_CONFIG = CAPQLConfig(num_envs=32, buffer_size=200_000, batch_size=256, learning_starts=1_000, gradient_updates=8,
                           gamma=0.99)
CAPQL_STEPS, CAPQL_EVAL_FREQ = 8_000, 4_000  # the example trains 150k, evaluating every 10k
CAPQL_SEG_ITERS = 20  # timed iterations of train_segment after learning_starts
# examples/pcn_minecart.py: gamma 1, scaling (1, 1, 0.1, 0.1), 400-step episodes, 128 buffer episodes, 8 envs,
# 50 model updates a round; batch 256 and hidden 64 by default; 32 warm-up episodes, ref (0, 0, -200)
PCN_CONFIG = PCNConfig(gamma=1.0, scaling_factor=(1.0, 1.0, 0.1, 0.1), max_episode_len=400, max_buffer_episodes=128,
                       num_envs=8, num_model_updates=50)
PCN_STEPS, PCN_EVAL_FREQ, PCN_ER_EPISODES = 20_000, 10_000, 32  # the example trains 400k
# examples/lcn_fruit_tree.py: 16 envs, 8-step episodes, 128 buffer episodes, scaling 0.1 x 7, Lorenz lambda 1;
# 64 warm-up episodes, ref zeros(6).  One evaluation at the first round (step 480: 384 warm-up steps, then 96 a
# round) and one near the end (step 9,504; an eval_freq of 10,000 would fall after the last round, at 10,080):
# each runs the host's Python WFG hypervolume in 6-D, seconds at 64 points
LCN_CONFIG = LCNConfig(gamma=1.0, scaling_factor=(0.1,) * 7, max_episode_len=8, max_buffer_episodes=128, num_envs=16,
                       lorenz_lambda=1.0)
LCN_STEPS, LCN_EVAL_FREQ = 10_000, 9_000  # the example trains 100k
LCN_ER_EPISODES = 64
# examples/ipro_dst.py: NL-MOPPO of 64 envs x 128 steps, 4 epochs of 4 minibatches, gamma 0.995, ent_coef 0.05
# ramped from 0.15, (64, 64) by default; tolerance 0.05, offset 1.  Cut to 10 NL-MOPPO iterations an oracle
# call (the example 150k steps, 18) and 2 outer iterations (24).  At 2 iterations a call the card's random
# stream left both extrema on one point; at 10, eight seeds on the CPU all found two
IPRO_CONFIG = IPROConfig(
    tolerance=0.05, offset=1.0, max_iterations=2, iter_total_timesteps=81_920,
    ppo=NLMOPPOConfig(num_envs=64, num_steps=128, update_epochs=4, num_minibatches=4, gamma=0.995, ent_coef=0.05,
                      ent_coef_start=0.15),
)


# the envs of the discrete and pixel paths, stepped with random actions: (envs, whether observations stay inside the
# observation box, reward bounds per objective). The bounds are the env modules' documented rewards; the lander's shaped
# reward is a potential difference, left unbounded, and its observation box is the upstream's nominal range, which it leaves
NEW_ENVS = {
    "mo-lunar-lander-v3": (4096, False, (-100.0, -math.inf, -0.3, -0.03), (100.0, math.inf, 0.0, 0.0)),
    "mo-lunar-lander-continuous-v3": (4096, False, (-100.0, -math.inf, -0.3, -0.03), (100.0, math.inf, 0.0, 0.0)),
    "four-room-v0": (4096, True, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "resource-gathering-v0": (4096, True, (-1.0, 0.0, 0.0), (0.0, 1.0, 1.0)),
    "breakable-bottles-v0": (4096, True, (-1.0, 0.0, -1.0), (-1.0, 25.0, 0.0)),
    "mo-highway-jx-v0": (4096, True, (0.0, 0.0, -1.0), (1.0, 1.0, 0.0)),
    "mo-highway-fast-jx-v0": (4096, True, (0.0, 0.0, -1.0), (1.0, 1.0, 0.0)),
    "deep-sea-treasure-pixel-v0": (4096, True, (0.0, -1.0), (23.7, -1.0)),
    "deep-sea-treasure-pixel-stack-v0": (256, True, (0.0, -4.0), (23.7, -1.0)),  # 4 sub-steps a step
}
ENV_STEPS = 100
LANDERS = 256  # the heuristic's landing check (tests/test_envs.py::test_lunar_lander_heuristic_lands: >= 90% land)

# examples/morld_lunar_lander.py: pop 6, 8 envs, shared buffer of 200k, batch 128, learning_starts 1000, (256,)*4,
# 10 cooperation passes, PSA; ref (-101, -1001, -101, -101).  A round cut to 128 iterations (exchange_every 1024 of
# 5000): learning starts in the first round's 125th iteration, so every timed round updates
MORLD_LUNAR_CONFIG = MORLDConfig(
    pop_size=POP, vectorized=True, exchange_every=128 * 8, neighborhood_size=1, update_passes=10,
    weight_adaptation_method="PSA",
    sac=MOSACConfig(num_envs=8, buffer_size=200_000, batch_size=128, learning_starts=1000, hidden=(256, 256, 256, 256)),
)
LUNAR_REF_POINT = np.array([-101.0, -1001.0, -101.0, -101.0])
# examples/envelope_pixel_dst.py: 64 envs, buffer 50k, batch 64, (256, 256), NatureCNN on (4, 84, 84), 4 sampled
# weights, learning_starts 1000, epsilon over 20k steps, gamma 0.98; ref (0, -50).  Cut to 40 iterations of 200k steps
PIXEL_CONFIG = EnvelopeConfig(num_envs=64, buffer_size=50_000, batch_size=64, hidden=(256, 256), image_shape=(4, 84, 84),
                              num_sample_w=4, learning_starts=1000, epsilon_decay_steps=20_000, gamma=0.98)
PIXEL_SEG_ITERS = 20  # timed iterations of train_segment after learning_starts
PIXEL_TRAIN_STEPS = 40 * 64
# tests/test_agents_multi.py::test_pql_3obj_hypervolume_scoring: four-room, K = 4, gamma 0.95, epsilon over 400
# steps, hypervolume action scoring at d = 3, 800 steps, ref (-1, -1, -1)
PQL4_CONFIG = PQLConfig(gamma=0.95, set_capacity=4, epsilon_decay_steps=400, action_eval="hypervolume")
PQL4_STEPS = 800
FOUR_ROOM_REF_POINT = np.array([-1.0, -1.0, -1.0])

# the harness: the launcher drives the main path's config with the bf16 Q-net; learning starts after the
# first of its iterations, and one evaluation of 32 weights (1000 steps) ends the run
BF16_CONFIG = dataclasses.replace(CONFIG, bf16=True)
LAUNCH_ITERS = 20
GPILS_LAUNCH_STEPS = 2_000  # two GPI-LS iterations on deep-sea-treasure at GPILSConfig's defaults
CKPT_ITERS = 3  # Envelope iterations before the checkpoint and after the restore
CKPT_EVAL_STEPS = 200  # the restored and the original Envelope's evaluation, cut from 1000 steps
SWEEP_STEPS = 4_000  # the last rung's budget on deep-sea-treasure (the first rung's is half)
SWEEP_SPACE = Path(__file__).resolve().parent / "configs" / "sweeps" / "envelope.json"

# slice 10: Envelope with a seed axis at the main path's config, the stacked sweep, the host MuJoCo envs
SEEDS = 4  # 4 x 32768 = 131,072 envs in one stacked state
SEEDS_ITERS = 20  # timed stacked iterations after 2 warm-up ones (the one-seed [train_segment] times 20 as well)
# slice 11: the mesh path (a world-size-1 NCCL group: one card) and the stacked pixel trunk
MESH_ITERS = 20  # timed iterations of each Envelope run after 2 warm-up ones, sharded and unsharded
MESH_BATCHED = {"env_state", "obs", "weights", "stats"}
PIXEL_SEEDS = 4  # seeds of PIXEL_CONFIG stacked: 4 x 64 envs, 4 x 50,000 frames of (4, 84, 84) float32 twice
PIXEL_SEEDS_ITERS = 20  # timed stacked iterations after learning_starts (the one-seed [envelope_pixel] times 20)
PIXEL_SEEDS_QTOL = dict(rtol=1e-4, atol=1e-5)  # member s's Q-values against its one-seed net (float32, TF32 off)
PIXEL_TRIAL_STEPS = 40 * 64  # the sweep's stacked pixel trial: 40 iterations of the 4 seeds
MUJOCO_ENVS = {"mo-hopper-v5": 64, "mo-halfcheetah-v5": 64, "mo-reacher-v5": 16}
MUJOCO_STEPS = 100
MUJOCO_EPISODE_STEPS = 40  # episodes cut so that every env resets on the host twice in the window


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, runs: int = 15, reps: int = 20) -> float:
    """Time on the card of one call, from CUDA events: the median over ``runs``
    of (``reps`` calls back to back) / ``reps``, so that one late launch of a
    short call does not set the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def sphere(rng, n: int, d: int) -> np.ndarray:
    """n float32 points on the positive orthant of the unit sphere: mutually
    non-dominated, bar rare ties from rounding."""
    p = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def nd_inputs(seed: int, n: int, d: int, family: str = "random"):
    """Points and valid mask on the card for one input family:

    - ``random``: normal points with planted groups of exact duplicates and a
      random valid mask; almost every row has a dominator early on.
    - ``front``: ``sphere`` points, all valid; no row has a dominator, so every
      row scans every column.
    - ``archive_add``: what ``DeviceParetoFront.create(n // 2, d).add(n // 2
      candidates)`` hands the mask when the archive is full: rows below n // 2
      are a ``front``; of the candidates, half are new sphere points and half
      sphere points scaled by a factor in [0.9, 0.999), dominated only by near
      neighbours; about 1% of the candidates are exact copies of archive rows.
    - ``inf``: points on a coarse grid (ties and signed zeros), the rows of the
      second half with +-inf coordinates, three valid rows all -inf, planted
      duplicates there: the tiles of the first half take the arithmetic path,
      the rest the exact predicate path.
    """
    rng = np.random.default_rng(seed)
    if family == "random":
        pts = rng.normal(size=(n, d)).astype(np.float32)
        k = max(1, n // 10)
        pts[rng.integers(0, n, size=k)] = pts[rng.integers(0, n, size=k)]
        valid = rng.uniform(size=n) > 0.2
    elif family == "front":
        pts, valid = sphere(rng, n, d), np.ones(n, dtype=bool)
    elif family == "archive_add":
        half, m = n // 2, n - n // 2
        front, cand = sphere(rng, half, d), sphere(rng, m, d)
        cand[m // 2 :] *= rng.uniform(0.9, 0.999, size=(m - m // 2, 1)).astype(np.float32)
        k = max(1, n // 100)
        cand[rng.integers(0, m, size=k)] = front[rng.integers(0, half, size=k)]
        pts, valid = np.concatenate([front, cand]), np.ones(n, dtype=bool)
    elif family == "inf":
        pts = (np.round(2 * rng.normal(size=(n, d))) / 2).astype(np.float32)
        tail = pts[n // 2 :]
        tail[rng.uniform(size=tail.shape) < 0.1] = -np.inf
        tail[rng.uniform(size=tail.shape) < 0.05] = np.inf
        tail[:3] = -np.inf
        k = max(1, n // 20)
        pts[rng.integers(n // 2, n, size=k)] = pts[rng.integers(0, n, size=k)]
        valid = rng.uniform(size=n) > 0.2
        valid[n // 2 : n // 2 + 3] = True
    else:
        raise ValueError(f"unknown input family {family!r}")
    return torch.as_tensor(pts, device="cuda"), torch.as_tensor(valid, device="cuda")


def nd_bound_ms(points: torch.Tensor, valid: torch.Tensor, keep_duplicates: bool, block_rows: int = 1024):
    """(least time, what sets it, pairs compared) for the mask on these inputs: the larger of
    bytes/HBM rate and ops/f32 rate.  Ops count (3d + 2) per pair actually needed: each valid
    row against the columns up to its first dominator (all N if none)."""
    n, d = points.shape
    pairs = 0
    col_idx = torch.arange(n, device=points.device)
    for start in range(0, n, block_rows):
        rows = points[start : start + block_rows, None, :]
        ge = torch.all(points[None] >= rows, dim=-1)
        gt = torch.any(points[None] > rows, dim=-1)
        hit = gt if keep_duplicates else gt | (col_idx[None, :] < col_idx[start : start + block_rows, None])
        hit = ge & hit & valid[None, :]
        first = torch.where(hit.any(-1), hit.to(torch.uint8).argmax(-1) + 1, n)
        first = torch.where(valid[start : start + block_rows], first, 0)
        pairs += int(first.sum())
    t_bytes = (n * (4 * d + 1) + n) / PEAK_BYTES  # points and valid read once, mask written once
    t_ops = pairs * (3 * d + 2) / PEAK_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[env] {smi}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {sorted(built) or 'nothing to build'} in {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR}")
    for _, out in built.values():  # ptxas: registers, shared memory and spills of each kernel
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


# (family, N, d): every one is held bitwise against the plain version in both dedup modes
ND_INPUTS = [
    ("random", 32, 3), ("random", 37, 3), ("random", 96, 3), ("random", 1000, 3), ("random", 8192, 3),
    ("random", 131072, 3), ("random", 1000, 2), ("random", 1000, 4), ("random", 1000, 8),
    ("front", 131072, 3), ("archive_add", 131072, 3),
    # each launch configuration: the largest single-block N, the smallest chunked N, R = 2 rows a lane
    # (d > 8), a small archive add, and d = 1 (every front point is the same point: all duplicates)
    ("random", 256, 3), ("random", 257, 3), ("front", 4096, 16), ("archive_add", 8192, 3), ("front", 3000, 1),
    # +-inf on valid rows, one block and chunked: the exact predicate path, both dedup modes
    ("inf", 200, 3), ("inf", 3000, 3),
    # d = 6, LCN's fruit-tree fronts: one block (the buffer's 128 episodes) and chunked
    ("front", 128, 6), ("random", 128, 6), ("front", 8192, 6), ("random", 8192, 6),
    # d = 4, the lander's MORL/D archive: one block and chunked
    ("front", 96, 4), ("random", 96, 4), ("front", 8192, 4), ("random", 8192, 4),
]  # fmt: skip
# timed: the main path's archive add (N=96), archive-scale inputs, and d = 6 at LCN's buffer size and above
ND_TIMED = {("random", 96, 3), ("random", 8192, 3), ("random", 131072, 3), ("front", 131072, 3), ("archive_add", 131072, 3),
            ("front", 128, 6), ("front", 8192, 6), ("random", 8192, 6), ("front", 96, 4), ("front", 8192, 4)}


def device_ms(fn, name: str = "nd_mask", calls: int = 20) -> float | None:
    """The kernel's own time per call, read from a short torch.profiler window:
    the device time of every kernel whose name holds ``name``, over ``calls``.
    None when the trace holds no device time (then it is not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(
        _device_us(e)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and name in e.key
    )
    return us / 1e3 / calls if us else None


def plan_name(n: int, d: int) -> str:
    p = nd_launch_plan(n, d, torch.cuda.get_device_properties(0).multi_processor_count)
    if p.n_chunks == 1:
        return f"single block, {p.warps_per_block} warps"
    return f"{p.row_tiles} row tiles x {p.n_chunks} chunks of {p.chunk_tiles} column tiles, {p.blocks} blocks"


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def phase_kernel_vs_plain(smi: str) -> list[dict]:
    """Bitwise comparison on every input and both dedup modes; timings on the
    inputs the archive and the main path give the kernel."""
    rows = []
    configs = {nd_launch_plan(n, d, 1).n_chunks > 1 for _, n, d in ND_INPUTS}
    if configs != {False, True}:
        raise AssertionError("the inputs must reach both the single-block and the chunked launch")
    for seed, (family, n, d) in enumerate(ND_INPUTS):
        pts, valid = nd_inputs(seed, n, d, family)
        for keep in (True, False):
            got = non_dominated_mask_cuda(pts, valid, keep)
            want = non_dominated_mask_plain(pts, valid, keep)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain on {family} N={n} d={d} keep_duplicates={keep}")
            line = f"[kernel] {family} N={n} d={d} keep_duplicates={keep} ({plan_name(n, d)}): bitwise equal ({int(got.sum())} non-dominated)"
            if (family, n, d) in ND_TIMED:
                row = timed_row(family, pts, valid, keep)
                rows.append(row)
                line += (
                    f"; kernel {row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.6f} ms ({100 * row['bound_ms'] / row['ms']:.2f}% of it), "
                    f"full scan {row['full_scan_ms_f32']:.4f} ms ({100 * row['full_scan_ms_f32'] / row['ms']:.2f}%)"
                    f" [{smi}]"
                )
            log(line)
    return rows


def timed_row(family: str, pts, valid, keep: bool) -> dict:
    n, d = pts.shape
    bound_ms, bound_by, pairs = nd_bound_ms(pts, valid, keep)
    full_ops = n * n * (3 * d + 2)  # every row against every column, no early exit
    kernel = lambda: non_dominated_mask_cuda(pts, valid, keep)  # noqa: E731
    return dict(
        family=family,
        n=n,
        d=d,
        keep_duplicates=keep,
        ms=time_ms(kernel),
        device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: non_dominated_mask_plain(pts, valid, keep), warmup=1, runs=5, reps=20 if n <= 8192 else 1),
        bound_ms=bound_ms,
        bound_by=bound_by,
        pairs_needed=pairs,
        full_scan_ms_f32=1e3 * full_ops / PEAK_F32_OPS,
    )


def phase_train_segment(smi: str, cfg: EnvelopeConfig = CONFIG, tag: str = "train_segment") -> dict:
    """Envelope's one-seed ``train_segment`` at the main path's config: 2
    warm-up iterations, 20 timed, then 3 profiled; returns {ms, launches, busy_ms}
    an iteration (launches and busy None when the trace holds no device time)."""
    env = make("minecart-v0")
    agent = Envelope(env, cfg)
    state = agent.init_state()
    state = agent.train_segment(state, 2)  # warm: first learn steps, allocator, cuBLAS handles
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    state = agent.train_segment(state, iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = 22 * NUM_ENVS
    if state.global_step != steps or state.iter_count != 22:
        raise AssertionError(f"global_step {state.global_step} != {steps}")
    if state.buffer.size != min(steps, cfg.buffer_size):
        raise AssertionError(f"buffer size {state.buffer.size}")
    if not _params_finite(state.ts.net):
        raise AssertionError("non-finite Q-net params")
    if not math.isfinite(float(state.loss)):
        raise AssertionError(f"non-finite loss {float(state.loss)}")
    log(
        f"[{tag}] minecart num_envs={NUM_ENVS} hidden={cfg.hidden} gradient_updates=16 bf16={cfg.bf16}: "
        f"{iters} iters in {dt:.3f} s = {iters * NUM_ENVS / dt:.0f} env-steps/s, "
        f"{1e3 * dt / iters:.2f} ms/iter, loss {float(state.loss):.4g} [{smi}]"
    )
    prof = profile_window(lambda: agent.train_segment(state, 3), f"{tag} 3 iters")
    if prof:
        log(f"[{tag}] {prof['launches'] / 3:.0f} launches an iteration, device busy {prof['busy_ms'] / 3:.2f} ms an iteration")
    return dict(ms=1e3 * dt / iters, launches=prof and prof["launches"] / 3, busy_ms=prof and prof["busy_ms"] / 3,
                busy_share=prof and prof["busy_ms"] / prof["wall_ms"])


def profile_window(fn, what: str, cpu: bool = True, top: int = 8) -> dict | None:
    """Device busy share and the costliest kernels over one call of ``fn``;
    returns {busy_ms, wall_ms, launches}, or None when the trace holds no device time.
    ``cpu=False`` traces the device alone, for a window of hundreds of
    thousands of launches where the host's operator events would cost more
    than the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels only: a record_function range (Adam's step) also shows on the device timeline
    events = [
        e
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us = sum(_device_us(e) for e in events)
    if busy_us == 0:
        log("[profile] no device time in the trace: busy share not measured")
        return None
    n_launch = sum(e.count for e in events)
    log(f"[profile] {what}: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch} kernel launches")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(f"[profile]   {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return dict(busy_ms=busy_us / 1e3, wall_ms=wall_us / 1e3, launches=n_launch)


def _device_us(event) -> float:
    # the attribute was renamed from self_cuda_time_total in newer torch
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def phase_train_and_score() -> None:
    env = make("minecart-v0")
    agent = Envelope(env, CONFIG)
    total = 4 * NUM_ENVS
    t0 = time.perf_counter()
    state = agent.train(
        total_timesteps=total,
        ref_point=REF_POINT,
        known_pareto_front=env.pareto_front(0.98),
        eval_freq=total,
        num_eval_weights_for_front=32,
    )
    torch.cuda.synchronize()
    host = agent._last_metrics
    log(f"[train] Envelope.train {state.global_step} steps + 1 evaluation (32 weights x 1000 steps) "
        f"in {time.perf_counter() - t0:.2f} s: " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()))
    score_on_card(agent._last_front, host, REF_POINT)


def score_on_card(front_np: np.ndarray, host: dict, ref_point: np.ndarray) -> int:
    """Score an (n, d) front on the card with ``device_front_metrics`` (at the
    env's ``ref_point``, against 32 equally spaced weights) and
    ``DeviceParetoFront.add``, hold the device cardinality, EUM and archive
    against the host's, and return the kernel's launches."""
    n, d = front_np.shape
    if n == 0 or d != len(ref_point) or not np.isfinite(front_np).all():
        raise AssertionError(f"bad front {front_np.shape}")

    before = non_dominated_mask_cuda.launches
    front = torch.as_tensor(front_np, dtype=torch.float32, device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    weights = torch.as_tensor(equally_spaced_weights(d, 32), dtype=torch.float32, device="cuda")
    dev = device_front_metrics(front, valid, torch.as_tensor(ref_point, dtype=torch.float32, device="cuda"), weights)
    archive = DeviceParetoFront.create(max(64, 2 * n), d).add(front)
    torch.cuda.synchronize()
    launched = non_dominated_mask_cuda.launches - before
    if launched < 2:
        raise AssertionError(f"scoring launched the kernel {launched} times, expected >= 2")
    card, eum = float(dev["eval/cardinality"]), float(dev["eval/eum"])
    if card != host["eval/cardinality"]:
        raise AssertionError(f"device cardinality {card} != host {host['eval/cardinality']}")
    if not math.isclose(eum, host["eval/eum"], rel_tol=1e-5, abs_tol=1e-7):
        raise AssertionError(f"device eum {eum} != host {host['eval/eum']}")
    if d == 2 and not math.isclose(float(dev["eval/hypervolume"]), host["eval/hypervolume"], rel_tol=1e-5, abs_tol=1e-6):
        raise AssertionError(f"device hypervolume {float(dev['eval/hypervolume'])} != host {host['eval/hypervolume']}")
    distinct = filter_pareto_dominated(front_np.astype(np.float64), keep_duplicates=False)
    got = archive.values[archive.valid].cpu().numpy()
    if len(got) != len(distinct) or not np.array_equal(np.unique(got, axis=0), np.unique(distinct.astype(np.float32), axis=0)):
        raise AssertionError(f"device archive {got} != host front {distinct}")
    log(f"[score] {n} x {d} front: device eval/cardinality={card:g} eval/eum={eum:.6g} (host {host['eval/eum']:.6g}); "
        f"archive holds {len(got)} points; kernel launched {launched} times")
    return launched


def _params_finite(net: torch.nn.Module) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in net.parameters())


def phase_gpils_segment(smi: str) -> None:
    """GPI-LS ``train_segment`` at bench.py's accelerator config: 2 warm-up
    iterations, then 50 timed; then the action forward alone (4096 envs x
    16 support rows through 2 critics) in bf16 and float32."""
    agent = GPILS(make("minecart-v0"), GPILS_CONFIG)
    state = agent.init_state()
    agent.set_weight_support(state, equally_spaced_weights(3, 16))
    agent.train_segment(state, 2)
    torch.cuda.synchronize()
    iters = 50
    t0 = time.perf_counter()
    agent.train_segment(state, iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = (iters + 2) * GPILS_ENVS
    if state.global_step != steps or state.iter_count != iters + 2 or state.support_size != 16:
        raise AssertionError(f"global_step {state.global_step} != {steps}, or support {state.support_size} != 16")
    if state.buffer.size != min(steps, GPILS_CONFIG.buffer_size):
        raise AssertionError(f"buffer size {state.buffer.size}")
    if not _params_finite(state.ts.net) or not math.isfinite(float(state.loss)):
        raise AssertionError(f"non-finite params or loss {float(state.loss)}")
    log(
        f"[gpils_segment] minecart num_envs={GPILS_ENVS} hidden={GPILS_CONFIG.hidden} n_critics=2 support=16 "
        f"bf16_act gradient_updates=10: {iters} iters in {dt:.3f} s = {iters * GPILS_ENVS / dt:.0f} env-steps/s, "
        f"{1e3 * dt / iters:.2f} ms/iter, loss {float(state.loss):.4g} [{smi}]"
    )
    profile_window(lambda: agent.train_segment(state, 3), "gpils 3 iters")

    net, support = state.ts.net, state.valid_support
    act = lambda: agent._gpi_actions(net, state.obs, state.task_w, support)  # noqa: E731
    bf16_ms = time_ms(act)
    profile_window(act, "gpils act forward bf16, 65536 rows")
    agent.act_dtype = None
    f32_ms = time_ms(act)
    agent.act_dtype = torch.bfloat16
    log(f"[gpils_act] GPI action forward over {GPILS_ENVS} x 16 rows, 2 critics: bf16 {bf16_ms:.4f} ms, "
        f"float32 {f32_ms:.4f} ms [{smi}]")


class PhaseTimer:
    """Wraps methods of an object to time each call on the card (synchronised)."""

    def __init__(self):
        self.calls: dict[str, list] = {}

    def wrap(self, obj, name: str, keep=lambda out: None) -> None:
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.setdefault(name, []).append((time.perf_counter() - t0, keep(out)))
            return out

        setattr(obj, name, timed)


def phase_gpils_train(smi: str) -> int:
    """``GPILS.train``: 2 outer iterations, the front of 32 weights scored on the card."""
    env = make("minecart-v0")
    agent = GPILS(env, GPILS_CONFIG)
    t0 = time.perf_counter()
    state = agent.train(
        total_timesteps=2 * GPI_STEPS_PER_ITER,
        ref_point=REF_POINT,
        known_pareto_front=env.pareto_front(0.98),
        num_eval_weights_for_front=32,
        timesteps_per_iter=GPI_STEPS_PER_ITER,
    )
    torch.cuda.synchronize()
    host = agent._last_metrics
    if not agent.ccs or state.global_step != 2 * GPI_STEPS_PER_ITER:
        raise AssertionError(f"CCS {agent.ccs}, global_step {state.global_step}")
    log(f"[gpils_train] GPILS.train {state.global_step} steps, 2 outer iterations, CCS of {len(agent.ccs)}, "
        f"in {time.perf_counter() - t0:.2f} s: " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(agent._last_front, host, REF_POINT)


def phase_gpipd_train(smi: str) -> int:
    """``GPIPD.train``: 2 outer iterations; the second recomputes the
    priorities, fits the dynamics to convergence and rolls out once."""
    env = make("minecart-v0")
    agent = GPIPD(env, GPIPD_CONFIG)
    timer = PhaseTimer()
    for name in ("fit_dynamics", "rollout_dynamics", "recompute_priorities"):
        timer.wrap(agent, name)
    timer.wrap(agent.dynamics, "fit_converged", keep=lambda out: (float(out[1]), out[2]))
    t0 = time.perf_counter()
    state = agent.train(
        total_timesteps=2 * GPI_STEPS_PER_ITER,
        ref_point=REF_POINT,
        known_pareto_front=env.pareto_front(0.98),
        num_eval_weights_for_front=32,
        timesteps_per_iter=GPI_STEPS_PER_ITER,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("fit_dynamics", "rollout_dynamics", "recompute_priorities", "fit_converged"):
        if not timer.calls.get(name):
            raise AssertionError(f"GPIPD.train never ran {name}")
    base, host = state.base, agent._last_metrics
    buf, dyna = base.buffer, state.dyna_buffer
    prios = buf.priorities[: buf.size]
    if dyna.size == 0 or not bool(torch.isfinite(prios).all()) or not bool((prios > 0).all()):
        raise AssertionError(f"imagined rows {dyna.size}, priorities finite and > 0: {bool(torch.isfinite(prios).all())}, {bool((prios > 0).all())}")
    if not _params_finite(base.ts.net) or not _params_finite(state.ens.net):
        raise AssertionError("non-finite Q-net or dynamics params")
    fits = ", ".join(f"{1e3 * dt:.1f} ms ({epochs} epochs, holdout MSE {mse:.4g})" for dt, (mse, epochs) in timer.calls["fit_converged"])
    each = "; ".join(f"{name} " + ", ".join(f"{1e3 * dt:.1f} ms" for dt, _ in timer.calls[name])
                     for name in ("recompute_priorities", "fit_dynamics", "rollout_dynamics"))
    log(f"[gpipd_train] GPIPD.train {base.global_step} steps, 2 outer iterations in {wall:.2f} s; {each}; "
        f"fit_converged {fits}; imagined buffer {dyna.size} rows; real buffer {buf.size} rows, priorities in "
        f"[{float(prios.min()):.4g}, {float(prios.max()):.4g}]; " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(agent._last_front, host, REF_POINT)


def phase_planar(smi: str) -> dict:
    """Both planar envs at the continuous agents' ``CONT_ENVS`` envs: ms per control step by CUDA
    events and kernel launches per step from a profile window; the states
    stay finite under 50 steps of random actions, and passive hoppers settle
    on the foot near z = 1.205 (tests/test_planar.py), fewer than 1% of them
    tipping past the healthy angle."""
    out = {}
    for env_id in ("mo-hopper-jx-v5", "mo-halfcheetah-jx-v5"):
        env = make(env_id)
        gen = torch.Generator(env.device).manual_seed(0)
        state, _ = env.reset(CONT_ENVS, gen)
        for _ in range(50):
            state = env.step(state, env.action_space.sample(gen, CONT_ENVS)).state
        if not (bool(torch.isfinite(state.q).all()) and bool(torch.isfinite(state.qd).all())):
            raise AssertionError(f"{env_id}: non-finite states after 50 random steps")
        a = env.action_space.sample(gen, CONT_ENVS)
        ms = time_ms(lambda: env.step(state, a), warmup=2, runs=5, reps=5)
        prof = profile_window(lambda: env.step(state, a), f"{env_id} one control step, {CONT_ENVS} envs")
        launches = prof["launches"] if prof else None
        log(f"[planar] {env_id} {CONT_ENVS} envs, {env.n_sub} substeps per control step: {ms:.3f} ms per step "
            f"({1e3 * CONT_ENVS / ms:.0f} env-steps/s), {launches} kernel launches per step [{smi}]")
        out[env_id] = dict(ms=ms, launches=launches, substeps=env.n_sub)
    env = make("mo-hopper-jx-v5")
    state, _ = env.reset(CONT_ENVS, torch.Generator(env.device).manual_seed(1))
    zero = torch.zeros(CONT_ENVS, 3, device=env.device)
    terminated = torch.zeros(CONT_ENVS, dtype=torch.bool, device=env.device)
    for _ in range(80):
        o = env.step(state, zero)
        state, terminated = o.state, terminated | o.terminated
    dz = float((state.q[:, 1] - 1.205).abs().max())
    n_term = int(terminated.sum())
    # a few of 2048 tip slowly past |angle| 0.2 by step 80, in the JAX package too (6 of 2048 on the CPU)
    if n_term > CONT_ENVS // 100 or dz > 0.05:
        raise AssertionError(f"passive hoppers: {n_term} terminated, max |z - 1.205| = {dz:.4f}")
    log(f"[planar] {CONT_ENVS} passive hoppers after 80 steps: {n_term} tipped past |angle| 0.2, "
        f"max |z - 1.205| = {dz:.4f}")
    return out


def phase_gpils_cont_segment(smi: str) -> None:
    """Continuous GPI-LS ``train_segment`` on the hopper at bench.py's
    accelerator config: 2 warm-up iterations, then 50 timed, then a profile window."""
    agent = GPILSContinuous(make("mo-hopper-jx-v5"), GPILS_CONT_CONFIG)
    state = agent.init_state()
    agent.set_weight_support(state, equally_spaced_weights(3, 8))
    agent.train_segment(state, 2)
    torch.cuda.synchronize()
    iters = 50
    t0 = time.perf_counter()
    agent.train_segment(state, iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = (iters + 2) * CONT_ENVS
    if state.global_step != steps or state.iter_count != iters + 2 or state.support_size != 8:
        raise AssertionError(f"global_step {state.global_step} != {steps}, or support {state.support_size} != 8")
    if state.buffer.size != min(steps, GPILS_CONT_CONFIG.buffer_size):
        raise AssertionError(f"buffer size {state.buffer.size}")
    if not _params_finite(state.actor.net) or not _params_finite(state.critic.net) or not math.isfinite(float(state.loss)):
        raise AssertionError(f"non-finite params or loss {float(state.loss)}")
    log(
        f"[gpils_cont_segment] mo-hopper num_envs={CONT_ENVS} hidden={GPILS_CONT_CONFIG.hidden} n_critics=2 "
        f"BatchRenorm support=8 gradient_updates=1: {iters} iters in {dt:.3f} s = {iters * CONT_ENVS / dt:.0f} "
        f"env-steps/s, {1e3 * dt / iters:.2f} ms/iter, critic loss {float(state.loss):.4g} [{smi}]"
    )
    profile_window(lambda: agent.train_segment(state, 3), "gpils_cont 3 iters")


def phase_gpils_cont_train(smi: str) -> int:
    """``GPILSContinuous.train`` on the hopper: 2 outer iterations, the front of 32 weights scored on the card."""
    env = make("mo-hopper-jx-v5", max_episode_steps=HOPPER_EPISODE_STEPS)
    agent = GPILSContinuous(env, GPILS_CONT_CONFIG)
    timer = PhaseTimer()
    timer.wrap(agent, "eval_weights_values", keep=lambda out: out.shape[0])
    t0 = time.perf_counter()
    state = agent.train(
        total_timesteps=2 * CONT_STEPS_PER_ITER,
        ref_point=HOPPER_REF_POINT,
        num_eval_weights_for_front=32,
        timesteps_per_iter=CONT_STEPS_PER_ITER,
    )
    torch.cuda.synchronize()
    host = agent._last_metrics
    if not agent.ccs or state.global_step != 2 * CONT_STEPS_PER_ITER:
        raise AssertionError(f"CCS {agent.ccs}, global_step {state.global_step}")
    evals = ", ".join(f"{k} weights {1e3 * dt:.0f} ms" for dt, k in timer.calls["eval_weights_values"])
    log(f"[gpils_cont_train] GPILSContinuous.train {state.global_step} steps, 2 outer iterations, CCS of "
        f"{len(agent.ccs)}, in {time.perf_counter() - t0:.2f} s; evaluations: {evals}; " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(agent._last_front, host, HOPPER_REF_POINT)


def phase_gpipd_cont_train(smi: str) -> int:
    """``GPIPDContinuous.train`` on the hopper: 2 outer iterations; the second
    resets the priorities, fits the dynamics to convergence and rolls out."""
    env = make("mo-hopper-jx-v5", max_episode_steps=HOPPER_EPISODE_STEPS)
    agent = GPIPDContinuous(env, GPIPD_CONT_CONFIG)
    sizes = []  # the real buffer's size at each priority reset
    on_new_task = agent._on_new_task
    agent._on_new_task = lambda st, w: (sizes.append(st.base.buffer.size), on_new_task(st, w))[1]
    timer = PhaseTimer()
    for name in ("_on_new_task", "fit_dynamics", "rollout_dynamics", "eval_weights_values"):
        timer.wrap(agent, name)
    timer.wrap(agent.dynamics, "fit_converged", keep=lambda out: (float(out[1]), out[2]))
    t0 = time.perf_counter()
    state = agent.train(
        total_timesteps=2 * CONT_STEPS_PER_ITER,
        ref_point=HOPPER_REF_POINT,
        num_eval_weights_for_front=32,
        timesteps_per_iter=CONT_STEPS_PER_ITER,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("fit_dynamics", "rollout_dynamics", "fit_converged"):
        if not timer.calls.get(name):
            raise AssertionError(f"GPIPDContinuous.train never ran {name}")
    if sizes != [0, CONT_STEPS_PER_ITER]:
        raise AssertionError(f"priority resets at buffer sizes {sizes}, expected [0, {CONT_STEPS_PER_ITER}]")
    base, host = state.base, agent._last_metrics
    buf, dyna = base.buffer, state.dyna_buffer
    prios = buf.priorities[: buf.size]
    if dyna.size == 0 or not bool(torch.isfinite(prios).all()) or not bool((prios > 0).all()):
        raise AssertionError(f"imagined rows {dyna.size}, priorities finite and > 0: "
                             f"{bool(torch.isfinite(prios).all())}, {bool((prios > 0).all())}")
    if not all(_params_finite(n) for n in (base.actor.net, base.critic.net, state.ens.net)):
        raise AssertionError("non-finite actor, critic or dynamics params")
    fits = ", ".join(f"{1e3 * dt:.1f} ms ({epochs} epochs, holdout MSE {mse:.4g})" for dt, (mse, epochs) in timer.calls["fit_converged"])
    each = "; ".join(f"{name} " + ", ".join(f"{1e3 * dt:.1f} ms" for dt, _ in timer.calls[name])
                     for name in ("_on_new_task", "fit_dynamics", "rollout_dynamics", "eval_weights_values"))
    log(f"[gpipd_cont_train] GPIPDContinuous.train {base.global_step} steps, 2 outer iterations in {wall:.2f} s; {each}; "
        f"fit_converged {fits}; imagined buffer {dyna.size} rows; real buffer {buf.size} rows, priorities in "
        f"[{float(prios.min()):.4g}, {float(prios.max()):.4g}]; " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(agent._last_front, host, HOPPER_REF_POINT)


def phase_pgmorl_iter(smi: str) -> None:
    """The vectorized PGMORL iteration at bench.py's accelerator config (the
    counterpart of ``_train_all_vec``): every worker's rollout, GAE and 320
    minibatch steps in one pass over the member axis.  One warm-up
    iteration, 2 timed, then a profiled window of rollout and minibatch
    steps, scaled to the iteration."""
    agent = PGMORL(make("mo-halfcheetah-jx-v5"), origin=PGMORL_ORIGIN, config=PGMORL_CONFIG)
    proto, spi = agent.agents[0], PGMORL_CONFIG.ppo.steps_per_iteration
    state = proto.init_state(list(range(POP)))
    ws = agent._weights()
    proto.train_iteration(state, ws)
    torch.cuda.synchronize()
    iters = 2
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = proto.train_iteration(state, ws)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if state.global_step != (iters + 1) * spi or not _params_finite(state.net) or not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"global_step {state.global_step}, or non-finite params or loss {loss.tolist()}")
    ppo = PGMORL_CONFIG.ppo
    log(f"[pgmorl_iter] mo-halfcheetah pop={POP} num_envs={ppo.num_envs} steps_per_iteration={spi} "
        f"epochs={ppo.update_epochs} minibatches={ppo.num_minibatches} hidden={ppo.hidden}: {1e3 * dt / iters:.1f} ms/iteration, "
        f"{iters * POP * spi / dt:.0f} env-steps/s, losses {[round(x, 4) for x in loss.tolist()]} [{smi}]")
    # the profile reads a window of the same loop, scaled to the iteration: prof_steps rollout steps
    # (with their GAE) by an agent that differs from proto in steps_per_iteration alone, then
    # prof_mb minibatch steps of the iteration's minibatch size on that rollout
    prof_steps, prof_mb = 8, 16
    short = MOPPO(proto.env, proto.w.cpu().numpy(), dataclasses.replace(ppo, steps_per_iteration=prof_steps * ppo.num_envs),
                  device=proto.device)
    batch = []
    roll = profile_window(lambda: batch.append(short.rollout(state, ws)), f"pgmorl {prof_steps} rollout steps")
    mb, rows = spi // ppo.num_minibatches, prof_steps * ppo.num_envs
    idx = torch.argsort(torch.rand((POP, rows), device=state.gen.device), dim=1)[:, :mb]
    upd = profile_window(lambda: [proto.minibatch_step(state, batch[0], idx) for _ in range(prof_mb)],
                         f"pgmorl {prof_mb} minibatch steps")
    if roll and upd:
        k_roll, k_mb = spi // ppo.num_envs / prof_steps, ppo.update_epochs * ppo.num_minibatches / prof_mb
        busy_ms = k_roll * roll["busy_ms"] + k_mb * upd["busy_ms"]
        launches = round(k_roll * roll["launches"] + k_mb * upd["launches"])
        log(f"[pgmorl_iter] scaled to the iteration (rollout x{k_roll:g}, minibatch steps x{k_mb:g}): device busy "
            f"{busy_ms:.2f} ms = {100 * busy_ms * iters / (1e3 * dt):.1f}% of the timed iteration; {launches} launches an iteration")


def phase_pgmorl_train(smi: str) -> int:
    """``PGMORL.train`` vectorized: the first evaluation, a warm-up iteration,
    an evaluation, one task-weight selection, an evolutionary iteration and an
    evaluation (18 episodes of ``POP_EVAL_STEPS`` steps each); the archive front scored on the card."""
    agent = PGMORL(make("mo-halfcheetah-jx-v5"), origin=PGMORL_ORIGIN, config=PGMORL_CONFIG)
    timer = PhaseTimer()
    for name in ("_eval_all_vec", "_task_weight_selection"):
        timer.wrap(agent, name)
    t0 = time.perf_counter()
    state = agent.train(total_timesteps=2 * POP * PGMORL_CONFIG.ppo.steps_per_iteration, ref_point=CHEETAH_REF_POINT,
                        eval_max_steps=POP_EVAL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(timer.calls.get("_task_weight_selection", [])) != 1 or len(timer.calls["_eval_all_vec"]) != 3:
        raise AssertionError(f"phases run: { {k: len(v) for k, v in timer.calls.items()} }")
    if not len(agent.archive) or not _params_finite(state.net):
        raise AssertionError(f"archive of {len(agent.archive)}, or non-finite params")
    host = agent._last_metrics
    each = "; ".join(f"{name} " + ", ".join(f"{1e3 * dt:.0f} ms" for dt, _ in timer.calls[name]) for name in timer.calls)
    log(f"[pgmorl_train] PGMORL.train {agent.global_step} steps in {wall:.2f} s; {each}; archive of {len(agent.archive)}, "
        f"weights {[[round(x, 3) for x in a.w.tolist()] for a in agent.agents]}; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(agent._last_front, host, CHEETAH_REF_POINT)


def phase_morld_step(smi: str, env_id: str = "mo-halfcheetah-jx-v5", cfg: MORLDConfig = MORLD_CONFIG,
                     tag: str = "morld_step") -> None:
    """The vectorized MORL/D round (``_pop_step``): ``exchange_every //
    num_envs`` act-step-store-update iterations of all 6 members, then the
    neighbour-batch cooperation passes; at bench.py's accelerator config on
    the halfcheetah (MOSAC members), at the example's on the lander
    (MOSACDiscrete members).  One warm-up round, 2 timed, one profiled."""
    algo = MORLD(make(env_id), cfg)
    agent = algo.population[0]
    envs, seg_iters = cfg.sac.num_envs, cfg.exchange_every // cfg.sac.num_envs
    state, buffer = agent.init_state(list(range(POP))), agent.make_buffer(POP)
    weights = torch.as_tensor(np.stack(algo.weights), device=agent.device)
    step = lambda: algo._pop_step(state, buffer, weights, seg_iters, cfg.update_passes)  # noqa: E731
    step()
    torch.cuda.synchronize()
    rounds = 2
    t0 = time.perf_counter()
    for _ in range(rounds):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = (rounds + 1) * seg_iters
    if state.iter_count != n or buffer.size != min(n * envs, buffer.capacity):
        raise AssertionError(f"iter_count {state.iter_count}, buffer size {buffer.size}")
    if not all(_params_finite(net) for net in (state.actor, state.critic.net, state.critic.target_net)):
        raise AssertionError("non-finite actor or critic params")
    log(f"[{tag}] {env_id} {type(agent).__name__} pop={POP} num_envs={envs} hidden={cfg.sac.hidden} "
        f"batch={cfg.sac.batch_size} seg_iters={seg_iters} update_passes={cfg.update_passes}: "
        f"{1e3 * dt / rounds:.1f} ms/round, {1e3 * dt / rounds / seg_iters:.2f} ms/iteration, "
        f"{rounds * POP * seg_iters * envs / dt:.0f} env-steps/s, "
        f"alpha {[round(x, 4) for x in state.log_alpha.detach().exp().tolist()]} [{smi}]")
    prof = profile_window(step, f"{tag} 1 round", cpu=False)
    if prof:
        log(f"[{tag}] device busy {prof['busy_ms']:.2f} ms = {100 * prof['busy_ms'] * rounds / (1e3 * dt):.1f}% "
            f"of the timed round; {prof['launches']} launches a round, {prof['launches'] / seg_iters:.0f} an iteration")


def phase_morld_train(smi: str, env_id: str = "mo-halfcheetah-jx-v5", cfg: MORLDConfig = MORLD_CONFIG,
                      ref_point: np.ndarray = CHEETAH_REF_POINT, tag: str = "morld_train") -> int:
    """``MORLD.train`` vectorized: 2 rounds with the neighbour transfer after
    the first, PSA, each round's 18 evaluation episodes of ``POP_EVAL_STEPS``
    steps; the archive front scored on the card."""
    algo = MORLD(make(env_id), cfg)
    timer = PhaseTimer()
    timer.wrap(algo, "_pop_step")
    timer.wrap(algo.population[0], "policy_eval")
    total = 2 * POP * cfg.exchange_every
    t0 = time.perf_counter()
    state = algo.train(total_timesteps=total, ref_point=ref_point, eval_max_steps=POP_EVAL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(timer.calls["_pop_step"]) != 2 or not len(algo.archive) or not _params_finite(state.actor):
        raise AssertionError(f"rounds {len(timer.calls['_pop_step'])}, archive of {len(algo.archive)}, or non-finite params")
    host = algo._last_metrics
    each = "; ".join(f"{name} " + ", ".join(f"{1e3 * dt:.0f} ms" for dt, _ in timer.calls[name]) for name in timer.calls)
    log(f"[{tag}] MORLD.train {total} steps in {wall:.2f} s; {each}; archive of {len(algo.archive)}, "
        f"weights {[[round(float(x), 3) for x in w] for w in algo.weights]}; front {algo._last_front.round(3).tolist()}; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(algo._last_front, host, ref_point)


def phase_moql(smi: str) -> None:
    """``MOQLearning.train`` on deep-sea-treasure at the example's config, one
    segment and one greedy evaluation; then a profiled window of 50 iterations."""
    agent = MOQLearning(make("deep-sea-treasure-v0"), MOQL_WEIGHTS, MOQL_CONFIG)
    timer = PhaseTimer()
    timer.wrap(agent, "train_segment")
    timer.wrap(agent, "_policy_eval")
    t0 = time.perf_counter()
    state = agent.train(total_timesteps=MOQL_STEPS, eval_freq=MOQL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = MOQL_STEPS // MOQL_CONFIG.num_envs
    (seg, _), = timer.calls["train_segment"]
    (ev, _), = timer.calls["_policy_eval"]
    ret, disc = agent.last_eval
    if state.global_step != MOQL_STEPS or not bool(torch.isfinite(state.q_table).all()):
        raise AssertionError(f"global_step {state.global_step}, or a non-finite Q-table")
    if not (np.isfinite(ret).all() and ret[0] > 0):
        raise AssertionError(f"greedy evaluation returned {ret}: no treasure reached")
    log(f"[moql] deep-sea-treasure num_envs={MOQL_CONFIG.num_envs} w={MOQL_WEIGHTS.tolist()}: MOQLearning.train "
        f"{state.global_step} steps in {wall:.2f} s; train_segment {1e3 * seg / iters:.3f} ms/iteration, "
        f"{MOQL_STEPS / seg:.0f} env-steps/s; greedy evaluation {1e3 * ev:.0f} ms: return {ret.tolist()}, "
        f"discounted {disc.tolist()} [{smi}]")
    prof = profile_window(lambda: agent.train_segment(state, 50), "moql 50 iterations")
    if prof:
        log(f"[moql] {prof['launches'] / 50:.1f} launches an iteration, device busy {prof['busy_ms'] / 50:.4f} ms of "
            f"{1e3 * seg / iters:.3f} ms ({100 * prof['busy_ms'] / 50 / (1e3 * seg / iters):.1f}%)")


def phase_mpmoql(smi: str) -> int:
    """``MPMOQLearning.train``: 3 OLS iterations of the example's config, the
    CCS scored on the card at the example's ref point."""
    env = make("deep-sea-treasure-v0")
    agent = MPMOQLearning(env, MPMOQL_CONFIG)
    ends = []  # the end of each OLS iteration: its evaluation is its last step
    eval_weight = agent._eval_weight
    agent._eval_weight = lambda *a, **kw: (eval_weight(*a, **kw), ends.append(time.perf_counter()))[0]
    t0 = time.perf_counter()
    agent.train(total_timesteps=MPMOQL_ITERS * MPMOQL_CONFIG.num_timesteps_per_iteration, ref_point=DST_REF_POINT,
                known_pareto_front=env.pareto_front(MPMOQL_CONFIG.moql.gamma))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(ends) != MPMOQL_ITERS or not agent.ccs:
        raise AssertionError(f"{len(ends)} OLS iterations, CCS {agent.ccs}")
    if not all(bool(torch.isfinite(st.q_table).all()) for st in agent.states):
        raise AssertionError("a non-finite Q-table")
    each = np.diff([t0, *ends])
    host = agent._last_metrics
    log(f"[mpmoql] deep-sea-treasure OLS {MPMOQL_ITERS} iterations of {MPMOQL_CONFIG.num_timesteps_per_iteration} steps, "
        f"num_envs={MPMOQL_CONFIG.moql.num_envs}: {wall:.2f} s, per iteration {[round(float(x), 3) for x in each]} s; weights "
        f"{[[round(float(x), 4) for x in w] for w in agent.policy_weights]}; CCS {[[round(float(x), 4) for x in v] for v in agent.ccs]}; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(np.stack(agent.ccs), host, DST_REF_POINT)


def phase_pql(smi: str, env_id: str = "deep-sea-treasure-v0", cfg: PQLConfig = PQL_CONFIG, steps: int = PQL_STEPS,
              ref_point: np.ndarray = DST_REF_POINT, tag: str = "pql") -> int:
    """``PQL.train`` for ``steps`` steps; then a profiled window of 20 steps,
    the local PCS at the start state scored on the card, and
    ``track_policy`` of its point with the largest first objective."""
    env = make(env_id)
    agent = PQL(env, ref_point, cfg)
    timer = PhaseTimer()
    timer.wrap(agent, "train_segment")
    t0 = time.perf_counter()
    state = agent.train(total_timesteps=steps, ref_point=ref_point, known_pareto_front=env.pareto_front(cfg.gamma),
                        eval_freq=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (seg, _), = timer.calls["train_segment"]
    front, host = agent._last_front, agent._last_metrics
    d = len(ref_point)
    if state.global_step != steps or front.shape[-1] != d or not len(front) or not bool(torch.isfinite(state.q_sets).all()):
        raise AssertionError(f"global_step {state.global_step}, local PCS {front}, or non-finite Q-sets")
    log(f"[{tag}] {env_id} K={cfg.set_capacity} action_eval={cfg.action_eval}: PQL.train {steps} steps in {wall:.2f} s; "
        f"train_segment {1e3 * seg / steps:.3f} ms/step; {int(state.q_valid.sum())} set members; local PCS at the "
        f"start state {front.tolist()}; " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    prof = profile_window(lambda: agent.train_segment(state, 20), f"{tag} 20 steps")
    if prof:
        log(f"[{tag}] {prof['launches'] / 20:.1f} launches a step, device busy {prof['busy_ms'] / 20:.4f} ms of "
            f"{1e3 * seg / steps:.3f} ms ({100 * prof['busy_ms'] / 20 / (1e3 * seg / steps):.1f}%)")
    launched = score_on_card(front, host, ref_point)
    target = front[np.argmax(front[:, 0])]
    t0 = time.perf_counter()
    tracked = agent.track_policy(state, target)
    if tracked.shape != (d,) or not np.isfinite(tracked).all():
        raise AssertionError(f"track_policy returned {tracked}")
    log(f"[{tag}] track_policy of {target.tolist()}: return {tracked.tolist()} in {1e3 * (time.perf_counter() - t0):.0f} ms")
    return launched


def phase_eupg(smi: str) -> None:
    """``EUPG.train`` on fishwood at the example's config for ``EUPG_CHUNKS``
    chunks and one ESR evaluation; then a profiled chunk."""
    agent = EUPG(make("fishwood-v0"), fishwood_utility, config=EUPG_CONFIG)
    per_chunk = EUPG_CONFIG.num_envs * EUPG_CONFIG.chunk_len
    timer = PhaseTimer()
    timer.wrap(agent, "train_segment", keep=float)
    timer.wrap(agent, "_eval_esr")
    t0 = time.perf_counter()
    state = agent.train(total_timesteps=EUPG_CHUNKS * per_chunk, eval_freq=EUPG_CHUNKS * per_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chunks = [dt for dt, _ in timer.calls["train_segment"]]
    losses = [loss for _, loss in timer.calls["train_segment"]]
    (ev, _), = timer.calls["_eval_esr"]
    ret, disc = agent.last_eval
    if state.global_step != EUPG_CHUNKS * per_chunk or len(chunks) != EUPG_CHUNKS or not _params_finite(state.net):
        raise AssertionError(f"global_step {state.global_step}, {len(chunks)} chunks, or non-finite params")
    if not (np.isfinite(ret).all() and np.isfinite(disc).all() and (ret >= 0).all() and math.isfinite(losses[-1])):
        raise AssertionError(f"ESR evaluation returned {ret}, {disc}; last loss {losses[-1]}")
    ms = 1e3 * statistics.median(chunks[1:])
    utility = float(fishwood_utility(torch.as_tensor(ret)))
    log(f"[eupg] fishwood num_envs={EUPG_CONFIG.num_envs} chunk_len={EUPG_CONFIG.chunk_len} hidden={EUPG_CONFIG.hidden}: "
        f"EUPG.train {state.global_step} steps in {wall:.2f} s; {ms:.1f} ms a chunk (median of {EUPG_CHUNKS - 1} after "
        f"the first, {1e3 * chunks[0]:.1f}), {per_chunk / (ms / 1e3):.0f} env-steps/s; ESR evaluation {1e3 * ev:.0f} ms: "
        f"return {ret.tolist()}, utility min(fish, wood // 2) = {utility:g} (RESULTS.md: {EUPG_RESULTS_UTILITY:g} at 400k "
        f"steps, the JAX package); last loss {losses[-1]:.4g} [{smi}]")
    prof = profile_window(lambda: agent.train_segment(state), "eupg 1 chunk")
    if prof:
        log(f"[eupg] {prof['launches']} launches a chunk, device busy {100 * prof['busy_ms'] / ms:.1f}% of the chunk")


def phase_capql(smi: str) -> int:
    """CAPQL on the hopper at the example's config: ``train_segment`` past
    ``learning_starts``, then ``CAPQL_SEG_ITERS`` timed iterations and a
    profiled window; then ``CAPQL.train`` from scratch with two evaluations
    of 32 weights, its front scored on the card."""
    env = make("mo-hopper-jx-v5", max_episode_steps=HOPPER_EPISODE_STEPS)
    cfg, N = CAPQL_CONFIG, CAPQL_CONFIG.num_envs
    agent = CAPQL(env, cfg)
    state = agent.init_state()
    agent.train_segment(state, cfg.learning_starts // N + 2)  # the first updates warm the allocator and cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.train_segment(state, CAPQL_SEG_ITERS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / CAPQL_SEG_ITERS
    log(f"[capql] mo-hopper num_envs={N} hidden={cfg.hidden} batch={cfg.batch_size} gradient_updates={cfg.gradient_updates}: "
        f"train_segment {ms:.2f} ms/iteration, {N / (ms / 1e3):.0f} env-steps/s [{smi}]")
    prof = profile_window(lambda: agent.train_segment(state, 3), "capql 3 iterations")
    if prof:
        log(f"[capql] {prof['launches'] / 3:.0f} launches an iteration, device busy {prof['busy_ms'] / 3:.2f} ms of "
            f"{ms:.2f} ms ({100 * prof['busy_ms'] / 3 / ms:.1f}%)")

    agent = CAPQL(env, cfg)
    timer = PhaseTimer()
    timer.wrap(agent, "train_segment")
    timer.wrap(agent, "_eval_front")
    t0 = time.perf_counter()
    state = agent.train(total_timesteps=CAPQL_STEPS, ref_point=HOPPER_REF_POINT, eval_freq=CAPQL_EVAL_FREQ,
                        num_eval_weights_for_front=32, eval_max_steps=HOPPER_EPISODE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nets = (state.actor, state.critic.net, state.critic.target_net)
    if state.global_step != CAPQL_STEPS or state.buffer.size != state.global_step or not all(map(_params_finite, nets)):
        raise AssertionError(f"global_step {state.global_step}, buffer size {state.buffer.size}, or non-finite params")
    l1 = state.behavior_w.abs().sum(dim=1)
    if not bool(torch.allclose(l1, torch.ones_like(l1), atol=1e-5)):
        raise AssertionError(f"behaviour weights with L1 norms {l1.tolist()}")
    host = agent._last_metrics
    each = "; ".join(f"{name} " + ", ".join(f"{1e3 * dt:.0f} ms" for dt, _ in timer.calls[name]) for name in timer.calls)
    log(f"[capql] CAPQL.train {state.global_step} steps in {wall:.2f} s; {each}; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return score_on_card(agent._last_front, host, HOPPER_REF_POINT)


def _round_split(timer: "PhaseTimer", names: tuple, state, wall: float, rounds: int, what: str) -> str:
    """ms a round of a PCN-style train loop, split into its timed phases (the medians)."""
    med = {n: 1e3 * statistics.median(dt for dt, _ in timer.calls[n]) for n in names}
    split = ", ".join(f"{n} {v:.1f} ms (x{len(timer.calls[n])})" for n, v in med.items())
    return f"[{what}] {rounds} rounds, {state.global_step} steps in {wall:.2f} s; a round {sum(med.values()):.1f} ms: {split}"


PCN_PHASES = ("update_model", "choose_commands", "collect_episodes", "add_episodes")


def _profile_round(agent, state, what: str, smi: str) -> None:
    before = state.global_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.train_round(state)
    torch.cuda.synchronize()
    ms, steps = 1e3 * (time.perf_counter() - t0), state.global_step - before
    log(f"[{what}] one round {ms:.1f} ms, {steps} env steps, {steps / (ms / 1e3):.0f} env-steps/s [{smi}]")
    # the device alone: a PCN round is tens of thousands of launches, whose host events would cost more than the round
    prof = profile_window(lambda: agent.train_round(state), f"{what} 1 round", cpu=False)
    if prof:
        log(f"[{what}] {prof['launches']} launches a round, device busy {100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of the round")


def phase_pcn(smi: str) -> int:
    """``PCN.train`` on deterministic minecart at the example's config, each
    round split into update, commands, collect and add; the buffer's returns
    (distinct rows) scored on the card; one greedy ``eval_commands`` of 8
    commands.  At this depth no episode brings ore home, so the front is one
    point: the phase shows that the path runs, not that it learns."""
    agent = PCN(make("minecart-deterministic-v0"), PCN_CONFIG)
    state = agent.init_state()
    timer = PhaseTimer()
    for name in PCN_PHASES[:3]:
        timer.wrap(agent, name)
    timer.wrap(state.buffer, "add_episodes")
    t0 = time.perf_counter()
    agent.train(total_timesteps=PCN_STEPS, ref_point=REF_POINT, num_er_episodes=PCN_ER_EPISODES, eval_freq=PCN_EVAL_FREQ,
                state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = len(timer.calls["update_model"])
    episodes = PCN_ER_EPISODES + rounds * PCN_CONFIG.num_envs
    if state.global_step < PCN_STEPS or state.buffer.size != min(episodes, PCN_CONFIG.max_buffer_episodes) or not _params_finite(state.model):
        raise AssertionError(f"global_step {state.global_step}, buffer of {state.buffer.size} after {episodes} episodes, "
                             "or non-finite params")
    host = agent._last_metrics
    log(_round_split(timer, PCN_PHASES, state, wall, rounds, "pcn") + "; " + ", ".join(f"{k}={v:.6g}" for k, v in host.items())
        + f" [{smi}]")
    cmds = agent.choose_commands(state.buffer, 8, seed=0)
    t0 = time.perf_counter()
    returns = agent.eval_commands(state.model, cmds, torch.Generator(agent.device).manual_seed(0)).cpu().numpy()
    if returns.shape != (8, 3) or not np.isfinite(returns).all():
        raise AssertionError(f"eval_commands returned {returns}")
    log(f"[pcn] eval_commands of 8 commands in {1e3 * (time.perf_counter() - t0):.0f} ms: commands "
        f"{np.round(cmds.cpu().numpy(), 3).tolist()}, returns {np.round(returns, 3).tolist()}")
    _profile_round(agent, state, "pcn", smi)
    if len(np.unique(agent._last_front, axis=0)) < 2:
        raise AssertionError(f"the buffer's returns are one point: {agent._last_front[:1].tolist()}")
    return score_on_card(agent._last_front, host, REF_POINT)


def phase_lcn(smi: str) -> int:
    """``LCN.train`` on fruit-tree at the example's config, each round split as
    PCN's, the host's 6-D hypervolume timed; the buffer's 6-D front scored on
    the card (cardinality and EUM held against the host's)."""
    agent = LCN(make("fruit-tree-v0"), LCN_CONFIG)
    state = agent.init_state()
    timer = PhaseTimer()
    for name in PCN_PHASES[:3]:
        timer.wrap(agent, name)
    timer.wrap(state.buffer, "add_episodes")
    host_hv = evaluation_module.hypervolume
    timer.wrap(evaluation_module, "hypervolume", keep=float)
    try:
        t0 = time.perf_counter()
        agent.train(total_timesteps=LCN_STEPS, ref_point=np.zeros(6), num_er_episodes=LCN_ER_EPISODES,
                    eval_freq=LCN_EVAL_FREQ, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        evaluation_module.hypervolume = host_hv
    rounds = len(timer.calls["update_model"])
    if state.global_step < LCN_STEPS or len(timer.calls["hypervolume"]) != 2 or not _params_finite(state.model):
        raise AssertionError(f"global_step {state.global_step}, {len(timer.calls['hypervolume'])} evaluations, or non-finite params")
    hv = ", ".join(f"{hv:.6g} in {1e3 * dt:.0f} ms" for dt, hv in timer.calls["hypervolume"])
    front = agent._last_front
    log(_round_split(timer, PCN_PHASES, state, wall, rounds, "lcn") + f"; host 6-D hypervolume of the {len(front)}-episode "
        f"front: {hv}; " + ", ".join(f"{k}={v:.6g}" for k, v in agent._last_metrics.items()) + f" [{smi}]")
    _profile_round(agent, state, "lcn", smi)
    return score_on_card(front, agent._last_metrics, np.zeros(6))


def phase_ipro(smi: str) -> int:
    """``IPRO.train`` on deep-sea-treasure at the example's config, cut to 10
    NL-MOPPO iterations an oracle call and 2 outer iterations: each oracle
    call's time, an NL-MOPPO iteration split into rollout, update and
    evaluation; the init phase's two extrema must differ; the front scored on
    the card (the 2-D HV held against the host's)."""
    ipro = IPRO(make("deep-sea-treasure-v0"), IPRO_CONFIG)
    timer = PhaseTimer()
    for name in ("train", "rollout", "update", "policy_evaluate"):
        timer.wrap(ipro.agent, name)
    t0 = time.perf_counter()
    pf = ipro.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    extrema, front = np.unique(np.stack(ipro._init_pf), axis=0), np.stack(pf)
    if len(extrema) < 2 or len(np.unique(front, axis=0)) < 2:
        raise AssertionError(f"the oracle collapsed: init-phase extrema {extrema.tolist()}, front {front.tolist()}")
    if not 0.0 <= ipro.coverage <= 1.0 or not _params_finite(ipro._state.net):
        raise AssertionError(f"coverage {ipro.coverage}, or non-finite params")
    ppo = IPRO_CONFIG.ppo
    med = {n: 1e3 * statistics.median(dt for dt, _ in timer.calls[n]) for n in ("rollout", "update", "policy_evaluate")}
    calls = ", ".join(f"{dt:.2f} s" for dt, _ in timer.calls["train"])
    host = multi_policy_metrics(front, DST_REF_POINT, equally_spaced_weights(2, 32))
    log(f"[ipro] deep-sea-treasure NL-MOPPO num_envs={ppo.num_envs} num_steps={ppo.num_steps} epochs={ppo.update_epochs} "
        f"minibatches={ppo.num_minibatches}: IPRO.train in {wall:.2f} s, {len(timer.calls['train'])} oracle calls ({calls}); "
        f"an NL-MOPPO iteration: rollout {med['rollout']:.1f} ms ({ppo.num_envs * ppo.num_steps / (med['rollout'] / 1e3):.0f} "
        f"env-steps/s), update {med['update']:.1f} ms, evaluation {med['policy_evaluate']:.1f} ms "
        f"(x{len(timer.calls['policy_evaluate'])}); extrema {np.round(extrema, 4).tolist()}, front {np.round(front, 4).tolist()}, coverage {ipro.coverage:.4f}, "
        f"replays {ipro.replay_triggered}; " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    u = make_linear_u([0.5, 0.5], ipro.device)
    prof = profile_window(lambda: ipro.agent.train_iteration(ipro._state, u), "ipro 1 NL-MOPPO iteration")
    if prof:
        log(f"[ipro] {prof['launches']} launches an NL-MOPPO iteration, device busy {100 * prof['busy_ms'] / prof['wall_ms']:.1f}%")
    return score_on_card(front, host, DST_REF_POINT)


def phase_envs(smi: str) -> dict:
    """The envs of the discrete and pixel paths, stepped with random actions through the
    vector env (autoreset included) for ``ENV_STEPS`` steps: ms and kernel
    launches a step, finite observations (inside the observation box where
    ``NEW_ENVS`` says so), rewards in their documented bounds.  Then the PD heuristic on ``LANDERS`` landers:
    at least 90% land (+100 on objective 0)."""
    out = {}
    for env_id, (n, in_box, lo, hi) in NEW_ENVS.items():
        env = make(env_id)
        venv = VectorMOEnv(env, n)
        gen = torch.Generator("cuda").manual_seed(0)
        state, _ = venv.reset(gen)
        rewards, obs_ok = [], True
        space = env.observation_space
        box = None if not in_box else (
            torch.as_tensor(np.broadcast_to(np.asarray(space.low), space.shape).astype(np.float32).reshape(-1), device="cuda"),
            torch.as_tensor(np.broadcast_to(np.asarray(space.high), space.shape).astype(np.float32).reshape(-1), device="cuda"),
        )

        def steps(k, keep=False):
            nonlocal state, obs_ok
            for _ in range(k):
                o = venv.step(state, env.action_space.sample(gen, n), gen)
                state = o.state
                if keep:
                    x = o.obs.reshape(n, -1).to(torch.float32)
                    ok = torch.isfinite(x).all()
                    if box is not None:
                        ok = ok & (x >= box[0]).all() & (x <= box[1]).all()
                    obs_ok = obs_ok & ok
                    rewards.append(o.reward)

        steps(2)  # warm: caches of constants, the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(ENV_STEPS, keep=True)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ENV_STEPS
        rew = torch.stack(rewards)
        lo_t, hi_t = (torch.as_tensor(b, dtype=torch.float32, device="cuda") for b in (lo, hi))
        if not bool(obs_ok) or not bool(torch.isfinite(rew[..., torch.isfinite(lo_t)]).all()):
            raise AssertionError(f"{env_id}: observations outside their box or non-finite rewards")
        if not bool(((rew >= lo_t - 1e-5) & (rew <= hi_t + 1e-5)).all()):
            raise AssertionError(f"{env_id}: rewards outside {lo}..{hi}: {rew.amin((0, 1)).tolist()} .. {rew.amax((0, 1)).tolist()}")
        prof = profile_window(lambda: steps(5), f"{env_id} 5 steps", top=0)
        launches = prof["launches"] / 5 if prof else None
        out[env_id] = dict(envs=n, ms=ms, launches=launches)
        log(f"[envs] {env_id} x {n}: {ms:.3f} ms a step ({ENV_STEPS * n / (ms * ENV_STEPS / 1e3):.0f} env-steps/s), "
            f"{launches if launches is None else f'{launches:.0f}'} launches a step; rewards "
            f"{[round(float(x), 4) for x in rew.amin((0, 1))]} .. {[round(float(x), 4) for x in rew.amax((0, 1))]} [{smi}]")

    env = make("mo-lunar-lander-v3")
    w = torch.zeros((LANDERS, 4), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret, _, length = rollout_episode(env, lambda obs, w_, g: lander_heuristic(obs), w,
                                     torch.Generator("cuda").manual_seed(3), 1.0, 1000)
    torch.cuda.synchronize()
    landed = float((ret[:, 0] == 100.0).float().mean())
    crashed = float((ret[:, 0] == -100.0).float().mean())
    log(f"[envs] lander heuristic on {LANDERS} landers: {100 * landed:.1f}% landed, {100 * crashed:.1f}% crashed, "
        f"episodes of {int(length.min())}..{int(length.max())} steps, main fuel {float(ret[:, 2].mean()):.3f}, "
        f"{time.perf_counter() - t0:.2f} s")
    if landed < 0.9 or not bool((ret[:, 2] < 0).all()):
        raise AssertionError(f"the heuristic landed {landed:.3f} of the landers (>= 0.9 needed), or one burned no fuel")
    out["lander_heuristic"] = dict(landers=LANDERS, landed=landed, crashed=crashed)
    return out


def phase_envelope_pixel(smi: str) -> int:
    """Envelope with the NatureCNN trunk on the pixel DST under the mario
    wrapper stack, at the example's widths: ``train_segment`` past
    ``learning_starts``, then ``PIXEL_SEG_ITERS`` timed iterations and a
    profiled window, the peak device memory (the float32 frame buffer); then
    ``Envelope.train`` from scratch with one evaluation of 32 weights, its
    front scored on the card."""
    env = make("deep-sea-treasure-pixel-stack-v0")
    cfg, N = PIXEL_CONFIG, PIXEL_CONFIG.num_envs
    torch.cuda.reset_peak_memory_stats()
    agent = Envelope(env, cfg)
    state = agent.init_state()
    agent.train_segment(state, cfg.learning_starts // N + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.train_segment(state, PIXEL_SEG_ITERS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PIXEL_SEG_ITERS
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not _params_finite(state.ts.net) or not math.isfinite(float(state.loss)):
        raise AssertionError(f"non-finite Q-net params or loss {float(state.loss)}")
    log(f"[envelope_pixel] deep-sea-treasure-pixel-stack num_envs={N} image={cfg.image_shape} hidden={cfg.hidden} "
        f"batch={cfg.batch_size} num_sample_w={cfg.num_sample_w} buffer={cfg.buffer_size}: train_segment {ms:.2f} "
        f"ms/iteration, {N / (ms / 1e3):.0f} env-steps/s, loss {float(state.loss):.4g}; peak device memory {peak:.2f} GiB "
        f"[{smi}]")
    prof = profile_window(lambda: agent.train_segment(state, 3), "envelope_pixel 3 iterations")
    if prof:
        log(f"[envelope_pixel] {prof['launches'] / 3:.0f} launches an iteration, device busy {prof['busy_ms'] / 3:.2f} ms "
            f"an iteration, {100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of the profiled window")
    one_seed = dict(ms=ms, launches=prof and prof["launches"] / 3, busy_ms=prof and prof["busy_ms"] / 3,
                    busy_share=prof and prof["busy_ms"] / prof["wall_ms"], peak_gib=peak)
    del agent, state
    torch.cuda.empty_cache()

    agent = Envelope(env, cfg)
    timer = PhaseTimer()
    timer.wrap(agent, "train_segment")
    timer.wrap(agent, "_eval_front")
    t0 = time.perf_counter()
    state = agent.train(total_timesteps=PIXEL_TRAIN_STEPS, ref_point=DST_REF_POINT,
                        known_pareto_front=env.pareto_front(cfg.gamma), eval_freq=PIXEL_TRAIN_STEPS,
                        num_eval_weights_for_front=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if state.global_step != PIXEL_TRAIN_STEPS or not _params_finite(state.ts.net):
        raise AssertionError(f"global_step {state.global_step}, or non-finite params")
    host = agent._last_metrics
    each = "; ".join(f"{name} " + ", ".join(f"{1e3 * dt:.0f} ms" for dt, _ in timer.calls[name]) for name in timer.calls)
    log(f"[envelope_pixel] Envelope.train {state.global_step} steps in {wall:.2f} s; {each}; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    score_on_card(agent._last_front, host, DST_REF_POINT)
    return one_seed


def native_front(rng, n: int, d: int) -> np.ndarray:
    """A float64 front for the host hypervolume: ``sphere`` points and scaled
    (dominated) copies of a third of them."""
    pts = sphere(rng, n, d).astype(np.float64)
    return np.concatenate([pts, pts[: n // 3] * rng.uniform(0.2, 0.95, size=(n // 3, 1))])


def lcn_buffer(rng) -> np.ndarray:
    """LCN's 128-episode buffer on fruit-tree: a few distinct 6-D returns, each repeated many times."""
    leaves = sphere(rng, 6, 6).astype(np.float64) * 10.0
    return leaves[rng.integers(0, len(leaves), size=128)]


def host_ms(fn, runs: int = 5) -> float:
    """Median host time of one call of ``fn``, in ms."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_native(smi: str) -> dict:
    """The host library (``utils/native.py``): built from ``native/morl_native.cpp``
    into ``build/``; its WFG held against the port's Python WFG at d = 2..6 and
    on LCN's buffer of exact copies (rel 1e-12), its batch against single
    calls, its host mask against the CUDA kernel on float32 points (bitwise);
    both HV routes timed on a 2-D front of PGMORL's task selection and on
    LCN's 6-D buffer."""
    lib, secs = native.build()
    log(f"[native] {' '.join(native.compile_command(lib))}: {secs:.2f} s -> {lib}")
    rng = np.random.default_rng(9)
    for d, n in ((2, 300), (3, 90), (4, 36), (5, 21), (6, 15)):
        pts, ref = native_front(rng, n, d), np.full(d, -0.1)
        got, want = native.hv_exact(pts, ref), _hv_wfg(pts, ref)
        if not math.isclose(got, want, rel_tol=1e-12):
            raise AssertionError(f"native HV {got!r} != Python WFG {want!r} at d={d}")
    lcn = lcn_buffer(rng)
    got, want, distinct = native.hv_exact(lcn, np.zeros(6)), _hv_wfg(lcn, np.zeros(6)), _hv_wfg(np.unique(lcn, axis=0), np.zeros(6))
    if not (math.isclose(got, want, rel_tol=1e-12) and math.isclose(got, distinct, rel_tol=1e-12)):
        raise AssertionError(f"native HV {got!r} on LCN's copies != Python {want!r} / distinct rows {distinct!r}")
    fronts = np.stack([native_front(rng, 24, 3)[:24] for _ in range(6)])
    batch = native.hv_exact_batch(fronts, np.zeros(3))
    if not np.array_equal(batch, [native.hv_exact(f, np.zeros(3)) for f in fronts]):
        raise AssertionError(f"native HV batch {batch} != single calls")
    for d in (3, 6):
        pts = np.concatenate([sphere(rng, 2048, d), sphere(rng, 1024, d) * np.float32(0.9)])
        pts = np.concatenate([pts, pts[rng.integers(0, len(pts), size=1024)]])  # 4096 rows, exact copies among them
        host = native.pareto_mask(pts.astype(np.float64))
        dev = non_dominated_mask_cuda(torch.as_tensor(pts, device="cuda"), keep_duplicates=True).cpu().numpy()
        if not np.array_equal(host, dev):
            raise AssertionError(f"host mask != CUDA kernel at d={d}: {int((host != dev).sum())} rows differ")
        log(f"[native] pareto_mask on 4096 x {d} float32 points: {int(host.sum())} kept, bitwise equal to the CUDA kernel")
    pg = native_front(rng, 12, 2)[:16]
    out = {}
    for name, pts, ref in (("pgmorl_2d_16", pg, np.full(2, -0.1)), ("lcn_6d_128", lcn, np.zeros(6))):
        out[name] = {"native_ms": host_ms(lambda: native.hv_exact(pts, ref)), "python_ms": host_ms(lambda: _hv_wfg(pts, ref))}
    log(f"[native] HV at d = 2..6 and on LCN's copies equal to the Python WFG (rel 1e-12), the batch bitwise; ms a call: "
        f"{json.dumps(out)} [{smi}]")
    return out


class ScoredEnvelope(Envelope):
    """Envelope whose every ``train`` also scores its last front on the card,
    so a CLI's runs launch the mask kernel.  ``train`` keeps Envelope's
    signature, which the CLIs read to pass ``ref_point``."""

    @functools.wraps(Envelope.train)
    def train(self, *args, **kwargs):
        state = super().train(*args, **kwargs)
        if kwargs.get("ref_point") is not None:
            score_on_card(self._last_front, self._last_metrics, np.asarray(kwargs["ref_point"]))
        return state


def phase_launch(smi: str) -> int:
    """``cli.launch.main`` as a user runs it: Envelope on minecart at
    ``bench.py``'s widths with the bf16 Q-net for ``LAUNCH_ITERS`` iterations and
    one evaluation of 32 weights, the front scored on the card; then GPI-LS on
    deep-sea-treasure, whose known front gives ``eval/igd`` and ``eval/mul``."""
    hyper = [f"{k}:{v!r}" for k, v in dataclasses.asdict(BF16_CONFIG).items() if v != getattr(EnvelopeConfig(), k)]
    total = LAUNCH_ITERS * NUM_ENVS
    t0 = time.perf_counter()
    agent = launch.main(["--algo", "envelope", "--env-id", "minecart-v0", "--ref-point", *map(str, REF_POINT),
                         "--num-timesteps", str(total), "--init-hyperparams", *hyper,
                         "--train-hyperparams", f"eval_freq:{total}", "num_eval_weights_for_front:32", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not agent.cfg.bf16 or agent.cfg.num_envs != NUM_ENVS:
        raise AssertionError(f"the launcher built {agent.cfg}")
    host = agent._last_metrics
    log(f"[launch] envelope minecart-v0 {' '.join(hyper)}: {total} steps + 1 evaluation in {wall:.2f} s; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    launched = score_on_card(agent._last_front, host, REF_POINT)
    t0 = time.perf_counter()
    agent = launch.main(["--algo", "gpi_ls_discrete", "--env-id", "deep-sea-treasure-v0", "--ref-point", *map(str, DST_REF_POINT),
                         "--num-timesteps", str(GPILS_LAUNCH_STEPS), "--train-hyperparams",
                         f"timesteps_per_iter:{GPILS_LAUNCH_STEPS // 2}", "num_eval_weights_for_front:32", "--device", "cuda"])
    torch.cuda.synchronize()
    host = agent._last_metrics
    if not {"eval/igd", "eval/mul"} <= set(host) or not all(math.isfinite(v) for v in host.values()):
        raise AssertionError(f"GPI-LS through the launcher logged {host}")
    log(f"[launch] gpi_ls_discrete deep-sea-treasure-v0 {GPILS_LAUNCH_STEPS} steps in {time.perf_counter() - t0:.2f} s; "
        + ", ".join(f"{k}={v:.6g}" for k, v in host.items()) + f" [{smi}]")
    return launched + score_on_card(agent._last_front, host, DST_REF_POINT)


def trees_equal(a, b) -> bool:
    """Bitwise equality of two ``state_tree``s."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


def round_trip(agent, state, tag: str, path) -> tuple:
    """Save ``state``, load it into a fresh template and check every tensor,
    parameter, optimizer moment and generator state bitwise; returns (restored, record)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.save(state, path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    template = fresh_template(agent, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = agent.load(template, path)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    if not trees_equal(state_tree(state), state_tree(restored)):
        raise AssertionError(f"[{tag}] the restored state differs from the saved one")
    rec = {"bytes": path.stat().st_size, "save_ms": save_ms, "load_ms": load_ms}
    log(f"[checkpoint] {tag}: {rec['bytes'] / 2**20:.2f} MiB, save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
        f"every tensor, parameter, optimizer moment and generator state bitwise equal")
    return restored, rec


def fresh_template(agent, state):
    """A new state of the same agent, from another seed, in ``state``'s layout."""
    if isinstance(state, tuple):  # a MOSAC population state and its member buffers
        return agent.init_state([100 + p for p in range(state[0].members)]), agent.make_buffer(state[0].members)
    return agent.init_state(seed=100)


def phase_checkpoint(smi: str) -> int:
    """Checkpoints on the card: Envelope at the main path's config (its
    131,072-row buffer included), the vectorized MORL/D population of
    ``[morld_step]`` and PCN with its episodic buffer.  Each trains a little,
    is saved and loaded into a fresh template (bitwise), and trains on.  The
    original and restored Envelope evaluate 32 weights with one generator
    seed; both fronts are scored on the card and must be bitwise equal."""
    import tempfile

    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        agent = Envelope(make("minecart-v0"), CONFIG)
        state = agent.train_segment(agent.init_state(), CKPT_ITERS)
        restored, records["envelope"] = round_trip(agent, state, "envelope", Path(tmp) / "envelope" / "state.pt")
        weights = torch.as_tensor(equally_spaced_weights(3, 32), dtype=torch.float32, device="cuda")
        fronts = [agent._eval_front(s.ts.net, weights, 1, CKPT_EVAL_STEPS, torch.Generator("cuda").manual_seed(7)).cpu().numpy()
                  for s in (state, restored)]
        if not np.array_equal(*fronts):
            raise AssertionError("the restored Envelope's front differs from the original's")
        launched = 0
        for front in fronts:
            launched += score_on_card(front, multi_policy_metrics(front, REF_POINT, equally_spaced_weights(3, 32)), REF_POINT)
        agent.train_segment(restored, CKPT_ITERS)
        if restored.global_step != 2 * CKPT_ITERS * NUM_ENVS:
            raise AssertionError(f"restored Envelope global_step {restored.global_step}")

        algo = MORLD(make("mo-halfcheetah-jx-v5"), MORLD_CONFIG)
        member, seg_iters = algo.population[0], MORLD_CONFIG.exchange_every // MORLD_CONFIG.sac.num_envs
        weights = torch.as_tensor(np.stack(algo.weights), device="cuda")
        pop = (member.init_state(list(range(POP))), member.make_buffer(POP))
        algo._pop_step(*pop, weights, seg_iters, MORLD_CONFIG.update_passes)
        (rstate, rbuffer), records["morld"] = round_trip(member, pop, "morld", Path(tmp) / "morld.pt")
        algo._pop_step(rstate, rbuffer, weights, seg_iters, MORLD_CONFIG.update_passes)
        n = 2 * seg_iters * MORLD_CONFIG.sac.num_envs
        if rstate.global_step != n or rstate.iter_count != 2 * seg_iters or rbuffer.size != min(n, rbuffer.capacity):
            raise AssertionError(f"restored MORL/D global_step {rstate.global_step}, buffer {rbuffer.size}")

        pcn = PCN(make("minecart-deterministic-v0"), PCN_CONFIG)
        pstate = pcn.train(total_timesteps=2 * PCN_CONFIG.num_envs * PCN_CONFIG.max_episode_len, num_er_episodes=PCN_CONFIG.num_envs)
        restored, records["pcn"] = round_trip(pcn, pstate, "pcn", Path(tmp) / "pcn.pt")
        steps = pstate.global_step
        pcn.train_round(restored)
        if restored.global_step <= steps or restored.buffer.size < pstate.buffer.size:
            raise AssertionError(f"restored PCN global_step {restored.global_step}, buffer {restored.buffer.size}")
    log(f"[checkpoint] {json.dumps(records)} [{smi}]")
    return launched


def phase_sweep(smi: str) -> int:
    """``cli.sweep.main`` with successive halving over ``configs/sweeps/envelope.json``
    on deep-sea-treasure at the default widths: 4 trials x 2 seeds, 2 rungs,
    the seeds trained one after another (``--no-vmap-seeds``); every trial's front scored on the card; the JSONL holds one line per
    (trial, rung) whose ``avg_hypervolume`` is the mean of its seeds'."""
    import tempfile

    before = experiments.ALGOS["envelope"]
    experiments.ALGOS["envelope"] = ScoredEnvelope
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "sweep.jsonl"
            t0 = time.perf_counter()
            sweep.main(["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", *map(str, DST_REF_POINT),
                        "--space-file", str(SWEEP_SPACE), "--halving", "--num-trials", "4", "--num-seeds", "2",
                        "--rungs", "2", "--num-timesteps", str(SWEEP_STEPS), "--out", str(out), "--device", "cuda",
                        "--no-vmap-seeds"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            recs = [json.loads(line) for line in out.read_text().splitlines()]
    finally:
        experiments.ALGOS["envelope"] = before
    trials = [r["trial"] for r in recs]
    if len(recs) != 6 or sorted(t for t in trials if t.endswith("-r0")) != [f"t{i}-r0" for i in range(4)]:
        raise AssertionError(f"the sweep wrote {trials}")
    for r in recs:
        hvs = r["seed_hypervolumes"]
        if len(hvs) != 2 or not all(math.isfinite(h) for h in hvs) or r["avg_hypervolume"] != float(np.mean(hvs)):
            raise AssertionError(f"bad sweep record {r}")
    log(f"[sweep] 4 trials x 2 seeds, 2 rungs of {SWEEP_STEPS // 2} and {SWEEP_STEPS} steps in {wall:.2f} s: "
        + "; ".join(f"{r['trial']} {r['avg_hypervolume']:.4g} ({r['wall_s']:.1f} s)" for r in recs) + f" [{smi}]")
    return len(recs)


def phase_train_segment_seeds(smi: str, one_seed: dict) -> int:
    """Envelope with a seed axis at the main path's config: ``SEEDS`` seeds of
    ``NUM_ENVS`` envs in one stacked state, 2 warm-up iterations, ``SEEDS_ITERS``
    timed and 3 profiled (launches and device busy an iteration), the peak
    device memory, and the ratio to ``[train_segment]``'s one-seed iteration
    of this run.  Checks finite params and losses, and that every seed's
    buffer holds rows of its own; then evaluates the ``SEEDS`` fronts of 32
    weights as one batch and scores each on the card."""
    env = make("minecart-v0")
    torch.cuda.reset_peak_memory_stats()
    agent = Envelope(env, CONFIG)
    state = agent.init_state_seeds(range(SEEDS))
    state = agent.train_segment(state, 2)  # warm: first learn steps of the stacked shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = agent.train_segment(state, SEEDS_ITERS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SEEDS_ITERS
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = (2 + SEEDS_ITERS) * NUM_ENVS
    if state.global_step != steps or state.buffer.size != min(steps, CONFIG.buffer_size):
        raise AssertionError(f"global_step {state.global_step}, buffer size {state.buffer.size}")
    if not _params_finite(state.ts.net) or not bool(torch.isfinite(state.loss).all()):
        raise AssertionError(f"non-finite Q-net params or losses {state.loss.tolist()}")
    rows = state.buffer.data.obs[:, : state.buffer.size]
    same = [(a, b) for a in range(SEEDS) for b in range(a + 1, SEEDS) if torch.equal(rows[a], rows[b])]
    if same:
        raise AssertionError(f"seeds {same} hold the same buffer rows")
    ratio = ms / one_seed["ms"]
    log(f"[train_segment_seeds] minecart {SEEDS} seeds x num_envs={NUM_ENVS} hidden={CONFIG.hidden} gradient_updates="
        f"{CONFIG.gradient_updates}: {SEEDS_ITERS} iters at {ms:.2f} ms/iter = {SEEDS * NUM_ENVS / (ms / 1e3):.0f} "
        f"env-steps/s; {ratio:.2f}x the one-seed iteration ({one_seed['ms']:.2f} ms), {SEEDS / ratio:.2f}x less time a seed; "
        f"losses {[round(float(x), 4) for x in state.loss]}; peak device memory {peak:.2f} GiB [{smi}]")
    prof = profile_window(lambda: agent.train_segment(state, 3), "train_segment_seeds 3 iters")
    if prof:
        log(f"[train_segment_seeds] {prof['launches'] / 3:.0f} launches an iteration (one seed: {one_seed['launches']:.0f}), "
            f"device busy {prof['busy_ms'] / 3:.2f} ms an iteration, {100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of the "
            f"profiled window (one seed: {one_seed['busy_ms']:.2f} ms, {100 * one_seed['busy_share']:.1f}%)")

    weights_np = equally_spaced_weights(env.reward_dim, 32)
    weights = torch.as_tensor(weights_np, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    fronts = agent._eval_front(state.ts.net, weights, 1, env.max_episode_steps).cpu().numpy()
    eval_s = time.perf_counter() - t0
    if fronts.shape != (SEEDS, 32, env.reward_dim):
        raise AssertionError(f"stacked fronts of shape {fronts.shape}")
    launched = 0
    for s, front in enumerate(fronts):
        host = multi_policy_metrics(front, REF_POINT, weights_np)
        log(f"[train_segment_seeds] seed {s}: " + ", ".join(f"{k}={v:.6g}" for k, v in host.items()))
        launched += score_on_card(front, host, REF_POINT)
    log(f"[train_segment_seeds] {SEEDS} fronts of 32 weights x {env.max_episode_steps} steps evaluated as one batch of "
        f"{SEEDS * 32} episodes in {eval_s:.2f} s, each scored on the card")
    del agent, state
    torch.cuda.empty_cache()
    return launched


def phase_sweep_seeds(smi: str) -> int:
    """``cli.sweep.main`` with successive halving over ``configs/sweeps/envelope.json``
    on deep-sea-treasure with the stacked trial (the default): 4 trials x
    ``SEEDS`` seeds, 2 rungs; every seed's front scored on the card; the JSONL
    checked as ``phase_sweep`` checks it."""
    import tempfile

    scored = []

    class SeedScoredEnvelope(ScoredEnvelope):
        """Envelope whose stacked evaluation also scores every seed's front on the card."""

        def _eval_front(self, net, weights, rep, max_steps, gen=None):
            fronts = super()._eval_front(net, weights, rep, max_steps, gen)
            if net.members is not None:
                w = weights.cpu().numpy()
                for front in fronts.cpu().numpy():
                    scored.append(score_on_card(front, multi_policy_metrics(front, DST_REF_POINT, w), DST_REF_POINT))
            return fronts

    before = experiments.ALGOS["envelope"]
    experiments.ALGOS["envelope"] = SeedScoredEnvelope
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "sweep.jsonl"
            t0 = time.perf_counter()
            sweep.main(["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", *map(str, DST_REF_POINT),
                        "--space-file", str(SWEEP_SPACE), "--halving", "--num-trials", "4", "--num-seeds", str(SEEDS),
                        "--rungs", "2", "--num-timesteps", str(SWEEP_STEPS), "--out", str(out), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            recs = [json.loads(line) for line in out.read_text().splitlines()]
    finally:
        experiments.ALGOS["envelope"] = before
    trials = [r["trial"] for r in recs]
    if len(recs) != 6 or sorted(t for t in trials if t.endswith("-r0")) != [f"t{i}-r0" for i in range(4)]:
        raise AssertionError(f"the sweep wrote {trials}")
    for r in recs:
        hvs = r["seed_hypervolumes"]
        if len(hvs) != SEEDS or not all(math.isfinite(h) for h in hvs) or r["avg_hypervolume"] != float(np.mean(hvs)):
            raise AssertionError(f"bad sweep record {r}")
    if len(scored) != 6 * SEEDS:
        raise AssertionError(f"{len(scored)} fronts scored on the card, {6 * SEEDS} expected")
    log(f"[sweep_seeds] 4 trials x {SEEDS} seeds stacked, 2 rungs of {SWEEP_STEPS // 2} and {SWEEP_STEPS} steps in "
        f"{wall:.2f} s, {len(scored)} fronts scored on the card: "
        + "; ".join(f"{r['trial']} {r['avg_hypervolume']:.4g} ({r['wall_s']:.1f} s)" for r in recs) + f" [{smi}]")
    return len(recs)


def phase_trial_both_ways(smi: str) -> dict:
    """One fixed trial (Envelope's defaults on deep-sea-treasure, ``SEEDS``
    seeds, ``SWEEP_STEPS`` steps) through ``sweep.run_trial`` stacked and with
    the seeds one after another, in turns (stacked, sequential, sequential,
    stacked); then the launches of a stacked iteration of the ``SEEDS`` seeds
    and of a one-seed iteration, each from 3 profiled iterations past
    ``learning_starts``."""
    walls = {"stacked": [], "sequential": []}
    for mode in ("stacked", "sequential", "sequential", "stacked"):
        t0 = time.perf_counter()
        _, scores = sweep.run_trial("envelope", "deep-sea-treasure-v0", DST_REF_POINT, {}, SEEDS, SWEEP_STEPS,
                                    device="cuda", vmap_seeds=mode == "stacked")
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        if len(scores) != SEEDS or not all(math.isfinite(h) for h in scores):
            raise AssertionError(f"{mode} trial scored {scores}")
    agent = Envelope(make("deep-sea-treasure-v0"), EnvelopeConfig())
    warm = agent.cfg.learning_starts // agent.cfg.num_envs + 2
    launches = {}
    for mode, state in (("stacked", agent.init_state_seeds(range(SEEDS))), ("one seed", agent.init_state(0))):
        agent.train_segment(state, warm)
        prof = profile_window(lambda: agent.train_segment(state, 3), f"deep-sea-treasure {mode} 3 iters", top=0)
        launches[mode] = prof and prof["launches"] / 3
    res = dict(seeds=SEEDS, steps=SWEEP_STEPS, stacked_s=walls["stacked"], sequential_s=walls["sequential"],
               launches_stacked=launches["stacked"], launches_one_seed=launches["one seed"])
    log(f"[sweep_seeds] one trial of {SEEDS} seeds x {SWEEP_STEPS} steps (Envelope defaults, deep-sea-treasure): stacked "
        f"{', '.join(f'{x:.2f}' for x in walls['stacked'])} s, sequential {', '.join(f'{x:.2f}' for x in walls['sequential'])} s; "
        f"launches an iteration: stacked {launches['stacked']} for {SEEDS} seeds, one seed {launches['one seed']} [{smi}]")
    return res


def _transition_bytes(n: int, obs_dim: int, reward_dim: int) -> int:
    """Bytes of one step's n transitions as ``gather_rows`` packs them: obs and
    next obs float32, the int64 action, the float32 reward and termination."""
    return n * (2 * 4 * obs_dim + 8 + 4 * reward_dim + 4)


def _nets_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def phase_mesh(smi: str) -> dict:
    """``parallel/`` on the card: a world-size-1 NCCL group (one card; NCCL
    takes one rank a GPU), initialised here through a ``file://`` rendezvous
    in a temporary directory and destroyed at the end.  Envelope at the main
    path's config (32768 envs), one run sharded through ``make_mesh`` and
    ``shard_agent_state`` and one unsharded, both from seed 0: 2 warm-up
    iterations, ``MESH_ITERS`` timed, then 3 profiled on the sharded run (the
    all-gather's device time and launches); the two runs' Q-nets, targets and
    buffers must be bitwise equal.  Then ``MORLD.train`` at ``MORLD_CONFIG``
    for 2 rounds with ``mesh=`` over ``pop`` and without: states, archives and
    weights bitwise equal, the front scored on the card."""
    import tempfile

    import torch.distributed as dist

    env = make("minecart-v0")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        try:
            mesh = make_mesh(1, ("data",), device="cuda")
            runs = {}
            for mode in ("unsharded", "sharded"):
                agent = Envelope(env, CONFIG)
                state = agent.init_state(0)
                if mode == "sharded":
                    state = shard_agent_state(state, mesh, MESH_BATCHED)
                    if state.shard is None or state.obs.shape[0] != NUM_ENVS:
                        raise AssertionError("shard_agent_state did not attach a one-rank shard of all the envs")
                agent.train_segment(state, 2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                agent.train_segment(state, MESH_ITERS)
                torch.cuda.synchronize()
                runs[mode] = (agent, state, 1e3 * (time.perf_counter() - t0) / MESH_ITERS)
            (_, one, ms_one), (agent, sharded, ms_sharded) = runs["unsharded"], runs["sharded"]
            steps = (2 + MESH_ITERS) * NUM_ENVS
            if sharded.global_step != steps or one.global_step != steps:
                raise AssertionError(f"global_step {sharded.global_step} / {one.global_step} != {steps}")
            if not (_nets_equal(one.ts.net, sharded.ts.net) and _nets_equal(one.ts.target_net, sharded.ts.target_net)):
                raise AssertionError("the sharded Envelope's Q-net differs from the unsharded one")
            if not all(torch.equal(a, b) for a, b in zip(one.buffer.data, sharded.buffer.data)):
                raise AssertionError("the sharded Envelope's buffer differs from the unsharded one")
            assert_replicas_synced(sharded.ts.net)
            gathered = _transition_bytes(NUM_ENVS, env.obs_dim, env.reward_dim)
            launches = {}
            for mode, (ag, st, _) in runs.items():
                prof = profile_window(lambda: ag.train_segment(st, 3), f"mesh {mode} Envelope 3 iters", top=4)
                launches[mode] = prof and prof["launches"] / 3
            # the all-gather of one step's transitions (packing, the collective, unpacking): once an iteration
            tr = Transition(sharded.obs, torch.zeros(NUM_ENVS, dtype=torch.int64, device="cuda"),
                            torch.zeros(NUM_ENVS, env.reward_dim, device="cuda"), sharded.obs,
                            torch.zeros(NUM_ENVS, device="cuda"))
            gather_ms = time_ms(lambda: sharded.shard.gather_rows(tr), warmup=3, runs=5, reps=10)
            prof = profile_window(lambda: [sharded.shard.gather_rows(tr) for _ in range(10)], "mesh all-gather x10", top=4)
            out["envelope"] = dict(ms_unsharded=ms_one, ms_sharded=ms_sharded, launches_unsharded=launches["unsharded"],
                                   launches_sharded=launches["sharded"], gather_bytes_a_step=gathered,
                                   gather_ms_events=gather_ms, gather_device_ms=prof and prof["busy_ms"] / 10,
                                   gather_launches=prof and prof["launches"] / 10)
            e = out["envelope"]
            log(f"[mesh] Envelope minecart num_envs={NUM_ENVS} on a 1-rank NCCL mesh: sharded {ms_sharded:.2f} ms and "
                f"{e['launches_sharded']} launches an iteration, unsharded {ms_one:.2f} ms and {e['launches_unsharded']}; "
                f"Q-net, target and buffer bitwise equal; the all-gather of {gathered} bytes a step {gather_ms:.4f} ms "
                f"(events), {e['gather_device_ms']} ms of device time and {e['gather_launches']} launches [{smi}]")
            del runs, one, sharded, agent, tr
            torch.cuda.empty_cache()

            pop_mesh = make_mesh(1, ("pop",), device="cuda")
            morld = {}
            for mode, m in (("unsharded", None), ("sharded", pop_mesh)):
                algo = MORLD(make("mo-halfcheetah-jx-v5"), MORLD_CONFIG)
                t0 = time.perf_counter()
                st = algo.train(total_timesteps=2 * POP * MORLD_CONFIG.exchange_every, ref_point=CHEETAH_REF_POINT,
                                mesh=m, eval_max_steps=POP_EVAL_STEPS)
                torch.cuda.synchronize()
                morld[mode] = (algo, st, time.perf_counter() - t0)
            (a1, s1, w1), (a2, s2, w2) = morld["unsharded"], morld["sharded"]
            for x, y in ((s1.actor, s2.actor), (s1.critic.net, s2.critic.net), (s1.critic.target_net, s2.critic.target_net)):
                if not _nets_equal(x, y):
                    raise AssertionError("the sharded MORL/D population differs from the unsharded one")
            if not (torch.equal(s1.log_alpha, s2.log_alpha) and np.array_equal(np.stack(a1.weights), np.stack(a2.weights))
                    and np.array_equal(np.stack(a1.archive.evaluations), np.stack(a2.archive.evaluations))):
                raise AssertionError("the sharded MORL/D run's alpha, weights or archive differ")
            if next(s2.actor.parameters()).shape[0] != POP:
                raise AssertionError("the sharded MORL/D state is not gathered to all members")
            out["morld"] = dict(s_unsharded=w1, s_sharded=w2)
            log(f"[mesh] MORLD.train 2 rounds ({POP} members x {MORLD_CONFIG.sac.num_envs} envs) with mesh=('pop',) "
                f"{w2:.2f} s, without {w1:.2f} s: populations, archives and weights bitwise equal; "
                + ", ".join(f"{k}={v:.6g}" for k, v in a2._last_metrics.items()) + f" [{smi}]")
            out["scored"] = score_on_card(a2._last_front, a2._last_metrics, CHEETAH_REF_POINT)
        finally:
            dist.destroy_process_group()
    return out


def _member_pixel_net(agent: Envelope, stacked, s: int):
    """A one-seed pixel Q-net holding member s of a stacked one."""
    net = agent.make_q_net()
    with torch.no_grad():
        for conv, member in zip(net.cnn.convs, stacked.cnn.convs):
            conv.weight.copy_(member.weight[s])
            conv.bias.copy_(member.bias[s])
        net.cnn.out.weight.copy_(stacked.cnn.out.weight[s].T)
        net.cnn.out.bias.copy_(stacked.cnn.out.bias[s])
        for lin, ens in zip(net.mlp.layers, stacked.mlp.layers):
            lin.weight.copy_(ens.weight[s].T)
            lin.bias.copy_(ens.bias[s])
    return net


def trunk_both_ways(cnn, frames: torch.Tensor) -> dict:
    """The stacked NatureCNN trunk's forward and backward on ``frames`` (S,
    M, obs_dim) as the port computes it (one ``conv2d`` a member a layer)
    beside one grouped ``conv2d`` a layer on a (M, S·k, H, W) view of the
    same params: event ms, device ms, launches and the outputs' max abs
    difference."""
    import torch.nn.functional as F

    S, M = frames.shape[:2]
    x = frames.reshape(S, M, *PIXEL_CONFIG.image_shape)

    def grouped():
        y = x.transpose(0, 1).reshape(M, -1, *x.shape[3:]) / 255.0
        for layer in cnn.convs:
            w = layer.weight
            y = torch.relu(F.conv2d(y, w.reshape(-1, *w.shape[2:]), layer.bias.reshape(-1), layer.stride, groups=S))
        y = y.reshape(M, S, -1, *y.shape[2:]).permute(1, 0, 3, 4, 2).flatten(2)
        return torch.relu(torch.baddbmm(cnn.out.bias[:, None, :], y, cnn.out.weight))

    res = {}
    for name, fn in (("per_member", lambda: cnn(x)), ("grouped", grouped)):
        def fwd_bwd():
            cnn.zero_grad(set_to_none=True)
            fn().sum().backward()

        res[name] = dict(ms=time_ms(fwd_bwd, warmup=2, runs=5, reps=3))
        prof = profile_window(fwd_bwd, f"stacked trunk {name} forward + backward", top=3)
        res[name]["launches"] = prof and prof["launches"]
        res[name]["device_ms"] = prof and prof["busy_ms"]
    with torch.no_grad():
        res["max_abs_diff"] = float((cnn(x) - grouped()).abs().max())
    cnn.zero_grad(set_to_none=True)
    return res


def phase_envelope_pixel_seeds(smi: str, one_seed: dict) -> dict:
    """Envelope with the stacked NatureCNN trunk: ``PIXEL_SEEDS`` seeds at
    ``PIXEL_CONFIG``'s widths (64 envs a seed, a 50,000-row buffer of (4, 84,
    84) float32 frames a seed), the buffer's bytes reckoned first.  Past
    ``learning_starts``, ``PIXEL_SEEDS_ITERS`` timed iterations and 3
    profiled beside ``[envelope_pixel]``'s one-seed iteration of this run;
    the peak memory; member s's Q-values on one batch against a one-seed net
    holding member s's params; the ``PIXEL_SEEDS`` fronts of 32 weights
    evaluated as one batch, each scored on the card.  Then one pixel trial
    through ``sweep.run_trial``, which must dispatch it to ``run_trial_vmapped``."""
    gc.collect()
    torch.cuda.empty_cache()
    env = make("deep-sea-treasure-pixel-stack-v0")
    cfg, N, S = PIXEL_CONFIG, PIXEL_CONFIG.num_envs, PIXEL_SEEDS
    buffer_bytes = 2 * S * cfg.buffer_size * env.obs_dim * 4
    free, total = torch.cuda.mem_get_info()
    log(f"[envelope_pixel_seeds] the {S} seeds' frame buffers take {buffer_bytes / 2**30:.2f} GiB "
        f"(2 x {S} x {cfg.buffer_size} x {env.obs_dim} x 4 B); {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
    if buffer_bytes > free:
        raise AssertionError("the stacked pixel buffers do not fit the free device memory")
    torch.cuda.reset_peak_memory_stats()
    agent = Envelope(env, cfg)
    state = agent.init_state_seeds(range(S))
    agent.train_segment(state, cfg.learning_starts // N + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.train_segment(state, PIXEL_SEEDS_ITERS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PIXEL_SEEDS_ITERS
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not _params_finite(state.ts.net) or not bool(torch.isfinite(state.loss).all()):
        raise AssertionError(f"non-finite Q-net params or losses {state.loss.tolist()}")
    rows = state.buffer.data.obs[:, : state.buffer.size]
    if any(torch.equal(rows[a], rows[b]) for a in range(S) for b in range(a + 1, S)):
        raise AssertionError("two seeds hold the same buffer rows")
    ratio = ms / one_seed["ms"]
    log(f"[envelope_pixel_seeds] {S} seeds x num_envs={N} image={cfg.image_shape} hidden={cfg.hidden} "
        f"buffer={cfg.buffer_size}: {ms:.2f} ms/iteration, {ratio:.2f}x the one-seed pixel iteration "
        f"({one_seed['ms']:.2f} ms), {S / ratio:.2f}x less time a seed; losses {[round(float(x), 4) for x in state.loss]}; "
        f"peak device memory {peak:.2f} GiB (one seed {one_seed['peak_gib']:.2f}) [{smi}]")
    prof = profile_window(lambda: agent.train_segment(state, 3), "envelope_pixel_seeds 3 iterations")
    if prof:
        log(f"[envelope_pixel_seeds] {prof['launches'] / 3:.0f} launches an iteration (one seed {one_seed['launches']:.0f}), "
            f"device busy {prof['busy_ms'] / 3:.2f} ms an iteration, {100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of "
            f"the profiled window's {prof['wall_ms'] / 3:.2f} ms an iteration (one seed {one_seed['busy_ms']:.2f} ms, "
            f"{100 * one_seed['busy_share']:.1f}%)")

    batch = state.buffer.data.obs[:, :64]  # (S, 64, obs_dim) stored frames
    w = torch.softmax(torch.randn(S, 64, env.reward_dim, generator=torch.Generator("cuda").manual_seed(0),
                                  device="cuda"), dim=-1)
    with torch.no_grad():
        q = state.ts.net(batch, w)
        err = 0.0
        for s in range(S):
            q1 = _member_pixel_net(agent, state.ts.net, s)(batch[s], w[s])
            torch.testing.assert_close(q[s], q1, **PIXEL_SEEDS_QTOL)
            err = max(err, float((q[s] - q1).abs().max()))
    log(f"[envelope_pixel_seeds] member s's Q-values on 64 stored frames equal its one-seed net's: max abs err {err:.3g} "
        f"(tolerance {PIXEL_SEEDS_QTOL})")
    # the rows a seed of the update's forwards: the batch tiled over the sampled weights
    trunk = trunk_both_ways(state.ts.net.cnn, state.buffer.data.obs[:, : cfg.batch_size * cfg.num_sample_w])
    log(f"[envelope_pixel_seeds] the stacked trunk's forward + backward at {S} x {cfg.batch_size * cfg.num_sample_w} "
        f"rows: one conv2d a member (the port) {trunk['per_member']['ms']:.3f} ms ({trunk['per_member']['device_ms']} ms "
        f"device, {trunk['per_member']['launches']} launches), one grouped conv2d a layer {trunk['grouped']['ms']:.3f} ms "
        f"({trunk['grouped']['device_ms']} ms device, {trunk['grouped']['launches']} launches); outputs differ by "
        f"{trunk['max_abs_diff']:.3g} [{smi}]")

    weights_np = equally_spaced_weights(env.reward_dim, 32)
    weights = torch.as_tensor(weights_np, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    fronts = agent._eval_front(state.ts.net, weights, 1, env.max_episode_steps).cpu().numpy()
    eval_s = time.perf_counter() - t0
    if fronts.shape != (S, 32, env.reward_dim):
        raise AssertionError(f"stacked fronts of shape {fronts.shape}")
    for front in fronts:
        score_on_card(front, multi_policy_metrics(front, DST_REF_POINT, weights_np), DST_REF_POINT)
    log(f"[envelope_pixel_seeds] {S} fronts of 32 weights evaluated as one batch of {S * 32} episodes in {eval_s:.2f} s, "
        f"each scored on the card")
    res = dict(ms=ms, one_seed_ms=one_seed["ms"], launches=prof and prof["launches"] / 3,
               one_seed_launches=one_seed["launches"], busy_ms=prof and prof["busy_ms"] / 3,
               busy_share=prof and prof["busy_ms"] / prof["wall_ms"], peak_gib=peak,
               buffer_gib=buffer_bytes / 2**30, eval_s=eval_s, q_max_abs_err=err, trunk=trunk)
    del agent, state, rows, batch, q
    gc.collect()
    torch.cuda.empty_cache()

    vmapped = []
    inner = sweep.run_trial_vmapped

    def counted(*args, **kwargs):
        vmapped.append(args[1])
        return inner(*args, **kwargs)

    overrides = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "seed"}
    sweep.run_trial_vmapped = counted
    try:
        t0 = time.perf_counter()
        mean_hv, hvs = sweep.run_trial("envelope", "deep-sea-treasure-pixel-stack-v0", DST_REF_POINT, overrides, S,
                                       PIXEL_TRIAL_STEPS, device="cuda")
        torch.cuda.synchronize()
        trial_s = time.perf_counter() - t0
    finally:
        sweep.run_trial_vmapped = inner
    if vmapped != ["deep-sea-treasure-pixel-stack-v0"] or len(hvs) != S or not all(math.isfinite(h) for h in hvs):
        raise AssertionError(f"the pixel trial took {vmapped or 'the sequential path'}, scores {hvs}")
    res.update(trial_s=trial_s, trial_hvs=hvs)
    log(f"[envelope_pixel_seeds] sweep.run_trial on deep-sea-treasure-pixel-stack-v0 went stacked: {S} seeds x "
        f"{PIXEL_TRIAL_STEPS} steps at the example's widths in {trial_s:.2f} s, hypervolumes {hvs} [{smi}]")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_mujoco(smi: str) -> dict:
    """The host-stepped MuJoCo envs through ``VectorMOEnv``'s hooks: ``MUJOCO_STEPS``
    vector steps from CUDA action tensors, episodes cut to
    ``MUJOCO_EPISODE_STEPS`` steps so that the host autoreset fires; ms a step,
    shapes, finiteness, and every finished env reset (t = 0, a new obs).  Runs
    only where gymnasium and mujoco are installed."""
    import importlib.util

    if any(importlib.util.find_spec(m) is None for m in ("gymnasium", "mujoco")):
        log("[mujoco] not run: gymnasium/mujoco not installed on this host")
        return {}
    out = {}
    for env_id, n in MUJOCO_ENVS.items():
        env = make(env_id, max_episode_steps=MUJOCO_EPISODE_STEPS)
        venv = VectorMOEnv(env, n)
        gen = torch.Generator("cuda").manual_seed(0)
        state, obs = venv.reset(gen)
        if obs.shape != (n, env.obs_dim) or obs.device.type != "cuda":
            raise AssertionError(f"{env_id}: reset obs {tuple(obs.shape)} on {obs.device}")
        ok = torch.ones((), dtype=torch.bool, device="cuda")
        resets = torch.zeros((), dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MUJOCO_STEPS):
            o = venv.step(state, env.action_space.sample(gen, n), gen)
            state = o.state
            done = o.terminated | o.truncated
            ok &= torch.isfinite(o.obs).all() & torch.isfinite(o.reward).all() & torch.isfinite(o.final_obs).all()
            ok &= ((state.t == 0) & (o.obs != o.final_obs).any(dim=1) | ~done).all()
            resets += done.sum()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / MUJOCO_STEPS
        if o.obs.shape != (n, env.obs_dim) or o.reward.shape != (n, env.reward_dim) or o.obs.device.type != "cuda":
            raise AssertionError(f"{env_id}: step obs {tuple(o.obs.shape)}, reward {tuple(o.reward.shape)}")
        if not bool(ok) or int(resets) < 2 * n or len(env._pool.envs) != n:
            raise AssertionError(f"{env_id}: non-finite values or a failed autoreset ({int(resets)} resets of {n} envs, "
                                 f"pool of {len(env._pool.envs)})")
        env.close()
        out[env_id] = dict(envs=n, ms=ms, resets=int(resets))
        log(f"[mujoco] {env_id} x {n}: {ms:.3f} ms a vector step ({n / (ms / 1e3):.0f} env-steps/s), {int(resets)} host "
            f"autoresets in {MUJOCO_STEPS} steps [{smi}]")
    return out


PARITY_CONFIGS = ("pql_dst", "capql_hopper")
PARITY_METRICS = ("eval/hypervolume", "eval/eum", "eval/cardinality")


def phase_parity(smi: str) -> dict:
    """``cli.parity.main`` as a user runs it, on ``PARITY_CONFIGS`` at the
    JAX runner's smoke budgets, seed 0, into a temporary directory: no
    ``exception`` record, the reference metrics in every curve, each front
    of the summary scored on the card.  Returns each config's wall time."""
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = parity.main([*PARITY_CONFIGS, "--seeds=0", "--smoke", "--out", tmp])
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in open(Path(tmp) / "parity_summary.jsonl")]
        if rc != 0 or [r["config"] for r in recs] != list(PARITY_CONFIGS) or any("exception" in r for r in recs):
            raise AssertionError(f"the runner returned {rc}: {[(r['config'], r.get('exception')) for r in recs]}")
        for r in recs:
            name = r["config"]
            last = [json.loads(line) for line in open(Path(tmp) / f"parity_{name}_seed0.jsonl")][-1]
            missing = [m for m in PARITY_METRICS if m not in last or m not in r["metrics"]]
            if missing or r["device"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"{name}: reference metrics {missing} missing, or device {r['device']}")
            front = np.asarray(r["front"], dtype=np.float32)
            launched = score_on_card(front, r["metrics"], parity.spec(name, 0, smoke=True).train["ref_point"])
            walls[name] = r["wall"]
            log(f"[parity] {name} seed 0 --smoke: {r['wall']} s, global_step {r['global_step']}, front of {len(front)} "
                f"scored on the card ({launched} launches); " + ", ".join(f"{m}={r['metrics'][m]:.6g}" for m in PARITY_METRICS)
                + f" [{smi}]")
    log(f"[parity] cli.parity.main over {len(recs)} configs in {wall:.1f} s")
    return walls


# the tuning sweep's six variants at full width, cut to 2 outer iterations of 1280 steps (the gradient
# updates start in the second, at learning_starts 2048).  On one H100 80GB HBM3 at 700 W the six took
# 498.0 s at --total 20480 (2 iterations of 10,000 steps; 369.7 s of it variant F's 72k updates), and
# 135.6 s at --total 4096 --timesteps-per-iter 2048 (74.3 s of it F's 8k updates) on a slower host
TUNE_VARIANTS = ("A", "B", "C", "D", "E", "F")
TUNE_TOTAL = 2560
TUNE_STEPS_PER_ITER = 1280
TUNE_METRICS = ("eval/hypervolume", "eval/eum", "eval/igd", "eval/mul", "eval/cardinality")


def phase_gpils_tune(smi: str) -> dict:
    """``cli.gpils_minecart_tune.main`` as a user runs it, on ``TUNE_VARIANTS``
    at full width, ``--total TUNE_TOTAL --timesteps-per-iter
    TUNE_STEPS_PER_ITER``, into a temporary directory: no
    ``exception`` record, the reference metrics in every record and curve,
    ``sale_rows <= buffer_size``, each variant's CCS scored on the card.
    Returns each variant's wall time."""
    walls = {}
    ref = np.asarray(gpils_minecart_tune.REF_POINT)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        argv = [*TUNE_VARIANTS, "--total", str(TUNE_TOTAL), "--timesteps-per-iter", str(TUNE_STEPS_PER_ITER), "--out", tmp]
        rc, _ = _captured(gpils_minecart_tune.main, argv)
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in open(Path(tmp) / "gpils_minecart_tune.jsonl")]
        if rc != 0 or [r["variant"] for r in recs] != list(TUNE_VARIANTS) or any("exception" in r for r in recs):
            raise AssertionError(f"the tune returned {rc}: {[(r['variant'], r.get('exception')) for r in recs]}")
        for r in recs:
            name = r["variant"]
            last = [json.loads(line) for line in open(Path(tmp) / f"gpils_minecart_tune_{name}_seed0.jsonl")][-1]
            missing = [m for m in TUNE_METRICS if m not in last or m not in r["metrics"]]
            if missing or r["device"] != torch.cuda.get_device_name(0) or r["total"] != TUNE_TOTAL:
                raise AssertionError(f"{name}: reference metrics {missing} missing, device {r['device']}, total {r['total']}")
            if not 0 <= r["sale_rows"] <= r["buffer_size"] <= TUNE_TOTAL or r["buffer_size"] == 0:
                raise AssertionError(f"{name}: {r['sale_rows']} sale rows in a buffer of {r['buffer_size']}")
            ccs = np.asarray(r["ccs"], dtype=np.float32)
            host = multi_policy_metrics(ccs, ref, equally_spaced_weights(3, 32), None)
            launched = score_on_card(ccs, host, ref)
            walls[name] = r["wall"]
            log(f"[gpils_tune] {name} seed 0 --total {TUNE_TOTAL}: {r['wall']} s, buffer {r['buffer_size']} rows of which "
                f"{r['sale_rows']} sales, CCS of {len(ccs)} scored on the card ({launched} launches); "
                + ", ".join(f"{m}={r['metrics'][m]:.6g}" for m in TUNE_METRICS) + f" [{smi}]")
    log(f"[gpils_tune] cli.gpils_minecart_tune.main over {len(recs)} variants in {wall:.1f} s")
    return walls


# bench.py's six lines, in its order, the headline last (the Pareto line at the accelerator's N=8192)
BENCH_METRICS = (
    "gpils_minecart_env_steps_per_sec_per_chip",
    "gpils_cont_hopper_env_steps_per_sec_per_chip",
    "pgmorl_halfcheetah_env_steps_per_sec_per_chip",
    "morld_halfcheetah_env_steps_per_sec_per_chip",
    "pareto_nd_mask_n8192_rows_per_sec",
    "envelope_minecart_env_steps_per_sec_per_chip",
)
# the timed functions of cli.bench, in the order it times them (the Pareto line times two)
BENCH_CALLS = ("gpils_minecart", "gpils_cont_hopper", "pgmorl_halfcheetah", "morld_halfcheetah",
               "pareto_nd kernel", "pareto (N, N) torch mask", "envelope_minecart")


def _captured(fn, *args):
    """(fn's return value, the lines it printed to stdout); the lines are logged too."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    lines = out.getvalue().splitlines()
    for line in lines:
        log(line)
    return ret, lines


def _records(lines: list) -> list:
    return [json.loads(line) for line in lines if line.startswith("{")]


def phase_bench(smi: str, profile: bool = False) -> dict:
    """``cli.bench.main([])`` as a user runs it: the six lines in bench.py's
    order with finite positive values; the Pareto line asserts the kernel
    bitwise against the (N, N) torch mask before it times both.  With
    ``profile`` (``python3 chip_smoke.py --bench-profile``), beside each timed
    function (its warm-up and 3 timed calls) one more call on a fresh state is
    profiled: its launches, and its device busy time over the median timed
    call (the profiler's tracing about doubles the call's own wall time).  The
    bench's own lines carry no profile."""
    profiles = []
    timed = bench._time

    def timed_and_profiled(run, fresh, device, reps=3):
        dt = timed(run, fresh, device, reps)
        state = fresh()
        what = BENCH_CALLS[len(profiles)] if len(profiles) < len(BENCH_CALLS) else "?"
        # the kernel's calls are short: trace the host too, or the trace may miss it
        prof = profile_window(lambda: run(state), f"bench {what}, one call", cpu=what.startswith("pareto"))
        profiles.append(prof and dict(prof, median_ms=1e3 * dt, busy_share=prof["busy_ms"] / (1e3 * dt)))
        return dt

    before = non_dominated_mask_cuda.launches
    if profile:
        bench._time = timed_and_profiled
    t0 = time.perf_counter()
    try:
        rc, lines = _captured(bench.main, [])
    finally:
        bench._time = timed
    wall = time.perf_counter() - t0
    recs = _records(lines)
    if rc != 0 or tuple(r["metric"] for r in recs) != BENCH_METRICS:
        raise AssertionError(f"cli.bench.main returned {rc}, lines {[r['metric'] for r in recs]}")
    if not all(math.isfinite(r["value"]) and r["value"] > 0 and math.isfinite(r["vs_baseline"]) for r in recs):
        raise AssertionError(f"non-finite or non-positive bench values {recs}")
    launched = non_dominated_mask_cuda.launches - before
    # the Pareto line: 1 bitwise check, 1 warm-up and 3 timed kernel calls (and 1 profiled)
    if launched != 5 + profile or len(profiles) != (len(BENCH_CALLS) if profile else 0):
        raise AssertionError(f"the Pareto line launched the kernel {launched} times, {len(profiles)} calls profiled")
    per_call = dict(zip(BENCH_CALLS, profiles))
    for what, prof in per_call.items():
        if prof:
            log(f"[bench] {what}: one call {prof['launches']} launches, device busy {prof['busy_ms']:.2f} ms = "
                f"{100 * prof['busy_share']:.1f}% of the median timed call's {prof['median_ms']:.2f} ms "
                f"({prof['wall_ms']:.2f} ms under the profiler)")
    log(f"[bench] cli.bench.main in {wall:.1f} s; the Pareto line's kernel bitwise equal to the (N, N) torch mask "
        f"({launched} launches) [{smi}]")
    return dict(lines=recs, profiles=per_call, wall=wall)


def phase_bench_probes(smi: str) -> dict:
    """The four breakdowns of the bench at their small sizes (``profile_gpils
    --small``, ``profile_population --small``, ``bench_gpils_ab --small``,
    ``probe_planar`` at 2048 envs): their lines under the JAX scripts' keys,
    finite, and both 9x9 eliminations matching ``torch.linalg.solve``."""
    want = {
        profile_gpils: (["--small"], 9),
        profile_population: (["--small"], 2),
        bench_gpils_ab: (["--small"], 2),
        probe_planar: (["2048"], 6),
    }
    walls = {}
    for module, (argv, n) in want.items():
        name = module.__name__.rsplit(".", 1)[-1]
        t0 = time.perf_counter()
        rc, lines = _captured(module.main, argv)
        walls[name] = time.perf_counter() - t0
        recs = _records(lines)
        numbers = [v for r in recs for v in r.values() if isinstance(v, float)]
        if rc != 0 or len(recs) != n or not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"{name} {argv}: rc {rc}, {len(recs)} lines of {n}, or non-finite numbers: {recs}")
        if name == "probe_planar" and [r["matches_solve"] for r in recs if "matches_solve" in r] != [True, True]:
            raise AssertionError(f"probe_planar: an elimination disagrees with torch.linalg.solve: {recs}")
        log(f"[bench_probes] {name} {' '.join(argv)}: {len(recs)} lines in {walls[name]:.1f} s [{smi}]")
    return walls


def add_plain(front: DeviceParetoFront, cand: torch.Tensor) -> DeviceParetoFront:
    """``DeviceParetoFront.add`` (core/archive.py) with the plain mask in place of the kernel."""
    all_vals = torch.cat([front.values, cand], dim=0)
    all_valid = torch.cat([front.valid, torch.ones(cand.shape[0], dtype=torch.bool, device=cand.device)])
    nd = non_dominated_mask_plain(all_vals, all_valid, keep_duplicates=False)
    score = nd.to(torch.float32) * 1e6 + torch.where(nd, all_vals.sum(dim=-1), 0.0)
    _, top = torch.topk(score, front.values.shape[0])
    return DeviceParetoFront(values=all_vals[top], valid=nd[top])


def phase_archive_add(smi: str, n: int = 131072, d: int = 3) -> dict:
    """The archive path at archive scale, through the entry point: a full
    archive of n // 2 front points takes n // 2 candidates (``archive_add``)."""
    pts, _ = nd_inputs(ND_INPUTS.index(("archive_add", n, d)), n, d, "archive_add")
    front, cand = pts[: n // 2], pts[n // 2 :]
    before = non_dominated_mask_cuda.launches
    archive = DeviceParetoFront.create(n // 2, d, device="cuda").add(front)
    full = archive.add(cand)
    torch.cuda.synchronize()
    launched = non_dominated_mask_cuda.launches - before
    if launched < 2:
        raise AssertionError(f"two archive adds launched the kernel {launched} times, expected >= 2")
    got = np.unique(full.values[full.valid].cpu().numpy(), axis=0)
    want_front = add_plain(archive, cand)
    want = np.unique(want_front.values[want_front.valid].cpu().numpy(), axis=0)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"archive add keeps {len(got)} points, the plain path {len(want)}, or other ones")
    all_vals = torch.cat([archive.values, cand])
    all_valid = torch.cat([archive.valid, torch.ones(cand.shape[0], dtype=torch.bool, device="cuda")])
    add_ms = time_ms(lambda: archive.add(cand), warmup=1, runs=5, reps=3)
    mask_ms = time_ms(lambda: non_dominated_mask_cuda(all_vals, all_valid, False), warmup=1, runs=5, reps=3)
    res = dict(n=n, d=d, held=int(archive.valid.sum()), kept=len(got), launched=launched, add_ms=add_ms, mask_ms=mask_ms)
    log(f"[archive] DeviceParetoFront.create({n // 2}, {d}) holding {res['held']} front points .add({n // 2} candidates): "
        f"keeps {len(got)} points, the same set as the plain path; kernel launched {launched} times over two adds; "
        f"add {add_ms:.4f} ms, of which the mask {mask_ms:.4f} ms ({100 * mask_ms / add_ms:.1f}%) [{smi}]")
    return res


def main(argv: list | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--bench-profile"]):
        print("usage: python3 chip_smoke.py [--bench-profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = phase_environment()
    phase_build()
    if argv:  # the bench path alone, each workload's call profiled
        print(json.dumps({"bench_profiles": phase_bench(smi, profile=True)["profiles"]}))
        return 0
    timed = phase_kernel_vs_plain(smi)
    archive = phase_archive_add(smi)
    planar = phase_planar(smi)
    envs = phase_envs(smi)
    mujoco = phase_mujoco(smi)
    host_hv = phase_native(smi)
    timings = {}

    # each path's launches, counted from 0 just before it and read just after
    paths = {
        "envelope": lambda: (timings.update(one_seed=phase_train_segment(smi)), phase_train_and_score()),
        "gpils": lambda: (phase_gpils_segment(smi), phase_gpils_train(smi)),
        "gpipd": lambda: phase_gpipd_train(smi),
        "gpils_cont": lambda: (phase_gpils_cont_segment(smi), phase_gpils_cont_train(smi)),
        "gpipd_cont": lambda: phase_gpipd_cont_train(smi),
        "pgmorl": lambda: (phase_pgmorl_iter(smi), phase_pgmorl_train(smi)),
        "morld": lambda: (phase_morld_step(smi), phase_morld_train(smi)),
        "moql": lambda: phase_moql(smi),
        "mpmoql": lambda: phase_mpmoql(smi),
        "pql": lambda: phase_pql(smi),
        "eupg": lambda: phase_eupg(smi),
        "capql": lambda: phase_capql(smi),
        "pcn": lambda: phase_pcn(smi),
        "lcn": lambda: phase_lcn(smi),
        "ipro": lambda: phase_ipro(smi),
        "morld_lunar": lambda: (
            phase_morld_step(smi, "mo-lunar-lander-v3", MORLD_LUNAR_CONFIG, "morld_lunar_step"),
            phase_morld_train(smi, "mo-lunar-lander-v3", MORLD_LUNAR_CONFIG, LUNAR_REF_POINT, "morld_lunar_train"),
        ),
        "envelope_pixel": lambda: timings.update(pixel_one_seed=phase_envelope_pixel(smi)),
        "pql_four_room": lambda: phase_pql(smi, "four-room-v0", PQL4_CONFIG, PQL4_STEPS, FOUR_ROOM_REF_POINT, "pql_four_room"),
        "launch": lambda: (phase_train_segment(smi, BF16_CONFIG, "train_segment_bf16"), phase_launch(smi)),
        "checkpoint": lambda: phase_checkpoint(smi),
        "sweep": lambda: phase_sweep(smi),
        "sweep_seeds": lambda: (
            phase_train_segment_seeds(smi, timings["one_seed"]),
            phase_sweep_seeds(smi),
            timings.update(trial=phase_trial_both_ways(smi)),
        ),
        "mesh": lambda: timings.update(mesh=phase_mesh(smi)),
        "envelope_pixel_seeds": lambda: timings.update(pixel_seeds=phase_envelope_pixel_seeds(smi, timings["pixel_one_seed"])),
        "parity": lambda: timings.update(parity=phase_parity(smi)),
        "gpils_tune": lambda: timings.update(gpils_tune=phase_gpils_tune(smi)),
        "bench": lambda: timings.update(bench=phase_bench(smi)),
        "bench_probes": lambda: timings.update(bench_probes=phase_bench_probes(smi)),
    }
    # MO-Q-Learning and EUPG are single-policy: they score no front, in the JAX package either;
    # nor do the bench's breakdowns, as the JAX scripts do not
    no_front = {"moql", "eupg", "bench_probes"}
    launches_by_path = {}
    for name, drive in paths.items():
        non_dominated_mask_cuda.launches = 0
        drive()
        launches_by_path[name] = non_dominated_mask_cuda.launches
        if launches_by_path[name] == 0 and name not in no_front:
            raise AssertionError(f"the {name} path never launched the pareto_nd kernel")
    launches = sum(launches_by_path.values())

    main_shape = next(r for r in timed if r["n"] == 96 and not r["keep_duplicates"])
    record = {
        "name": "pareto_nd_mask",
        "route": "cuda",
        "source": "morl_baselines_torch/csrc/pareto_nd.cu",
        "replaces": "morl_baselines_tpu/ops/pareto_kernel.py:33",
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": 0.0,  # every comparison above is bitwise
        "ms": main_shape["ms"],
        "device_ms": main_shape["device_ms"],  # the kernel's own time, from the profiler; ms is host-bound here
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a Pareto mask
        "at": "N=96 d=3 keep_duplicates=False (DeviceParetoFront.add on the scoring steps)",
        "sizes": timed,
        "archive_add": archive,
    }
    log(f"[planar] {json.dumps(planar)}")
    log(f"[envs] {json.dumps(envs)}")
    log(f"[native] {json.dumps(host_hv)}")
    log(f"[mujoco] {json.dumps(mujoco)}")
    log(f"[timings] {json.dumps(timings)}")
    log(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
