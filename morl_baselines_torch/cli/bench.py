"""Throughput bench of the port: the JAX package's ``bench.py`` on one card.

    python -m morl_baselines_torch.cli.bench [--headline-only] [--device cuda|cpu]

Runs the same six workloads in the same order, each at the same sizes, and
prints one JSON line each, ``{"metric", "value", "unit", "vs_baseline"}``,
under the same metric names and units, the Envelope/minecart headline last:

  1. GPI-LS / minecart          (GPI action over a 16-weight support every step, bf16 act on the card)
  2. GPI-LS-continuous / hopper (TD3 with BatchRenorm critics on the planar ``mo-hopper-jx-v5``)
  3. PGMORL / halfcheetah       (one ``MOPPO.train_iteration`` over the 6 workers' member axis)
  4. MORL/D / halfcheetah       (one ``MORLD._pop_step``: 6 MOSAC members and the cooperation passes)
  5. Pareto mask kernel         (on the card: bitwise against the (N, N) torch mask, then both timed)
  6. Envelope / minecart        (headline, printed last so that single-line parsers keep reading it)

Each workload times whole calls of the train loop (act, env step, store,
updates): one warm-up call, then 3 timed calls; the value is their median,
and the repetitions go to stderr.  The agents update their state in place,
so every call gets a state built afresh from the same seed, outside the
timed window; the clock is read only after ``torch.cuda.synchronize()``.

On the card the workloads run at ``bench.py``'s accelerator sizes; under
``--device cpu`` at its CPU sizes.  The device is CUDA unless ``--device
cpu`` is given; without a card the default raises.  ``vs_baseline`` is the
value over ``REFERENCE_SPS``, the order of env-steps/s the reference
PyTorch implementation sustains stepping one host env a Python iteration;
for the Pareto line it is the torch mask's time over the kernel's.  A
workload that raises prints its traceback to stderr, the others still run,
and the process exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from ..agents import (
    GPILS,
    MORLD,
    PGMORL,
    Envelope,
    EnvelopeConfig,
    GPILSConfig,
    GPILSContinuous,
    GPILSContinuousConfig,
    MOPPOConfig,
    MORLDConfig,
    MOSACConfig,
    PGMORLConfig,
)
from ..core.pareto import non_dominated_mask
from ..core.weights import equally_spaced_weights
from ..ops.pareto_kernel import non_dominated_mask_cuda
from ..utils.device import resolve_device
from .experiments import make_env

REFERENCE_SPS = 1000.0


def _emit(metric: str, sps: float) -> None:
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(sps, 1),
                "unit": "env-steps/s/chip",
                "vs_baseline": round(sps / REFERENCE_SPS, 2),
            }
        ),
        flush=True,
    )


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(run: Callable[[Any], Any], fresh: Callable[[], Any], device: torch.device, reps: int = 3) -> float:
    """One warm-up call, then ``reps`` timed calls; returns the MEDIAN seconds.

    Every call runs on ``fresh()``, a state built outside the timed window,
    so that each starts where the first did.  The repetitions go to stderr."""
    run(fresh())
    times = []
    for _ in range(reps):
        state = fresh()
        _sync(device)
        t0 = time.perf_counter()
        run(state)
        _sync(device)
        times.append(time.perf_counter() - t0)
        del state  # freed before the next one is built
    print(f"[bench] repetitions: {[round(t, 4) for t in times]}s", file=sys.stderr, flush=True)
    return float(np.median(times))


def announce(device: torch.device, tag: str = "bench") -> None:
    """The device to stderr; on the card its name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        print(f"[{tag}] device: cpu", file=sys.stderr, flush=True)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"[{tag}] device: {torch.cuda.get_device_name(device)}; nvidia-smi: {'; '.join(smi)}", file=sys.stderr, flush=True)


def bench_gpils_minecart(on_accel: bool, device: torch.device) -> None:
    """GPI-LS on minecart: GPI action selection over a 16-weight support every
    step (the agent's hot op) + 10 DroQ updates per env-iteration."""
    num_envs = 4096 if on_accel else 32
    iters = 50 if on_accel else 4
    env = make_env("minecart-v0", device)
    cfg = GPILSConfig(
        num_envs=num_envs,
        buffer_size=max(4 * num_envs, 16384),
        batch_size=128,
        learning_starts=num_envs,
        gradient_updates=10 if on_accel else 1,
        max_support=16,
        # bf16 GEMMs in the action-selection forward only; TD/update math stays f32
        bf16_act=on_accel,
    )
    agent = GPILS(env, cfg, device=device)

    def fresh():
        # a realistic mid-run support: a full 16-weight CCS/corner set
        return agent.set_weight_support(agent.init_state(0), equally_spaced_weights(3, 16))

    dt = _time(lambda s: agent.train_segment(s, iters, True), fresh, device)
    _emit("gpils_minecart_env_steps_per_sec_per_chip", iters * num_envs / dt)


def bench_gpils_cont_hopper(on_accel: bool, device: torch.device) -> None:
    """Continuous GPI-LS (TD3 + BatchRenorm critics) on the planar hopper (envs/planar.py)."""
    num_envs = 2048 if on_accel else 16
    iters = 50 if on_accel else 2
    env = make_env("mo-hopper-jx-v5", device)
    cfg = GPILSContinuousConfig(
        num_envs=num_envs,
        buffer_size=max(4 * num_envs, 16384),
        learning_starts=num_envs,
        gradient_updates=1,
    )
    agent = GPILSContinuous(env, cfg, device=device)

    def fresh():
        return agent.set_weight_support(agent.init_state(0), equally_spaced_weights(env.reward_dim, 8))

    dt = _time(lambda s: agent.train_segment(s, iters), fresh, device)
    _emit("gpils_cont_hopper_env_steps_per_sec_per_chip", iters * num_envs / dt)


def bench_pgmorl_halfcheetah(on_accel: bool, device: torch.device) -> None:
    """PGMORL vectorized population: all 6 PPO workers (rollout + epochs) in
    one pass over the member axis on the planar mo-halfcheetah-jx."""
    pop = 6
    spi = 8192 if on_accel else 256
    env = make_env("mo-halfcheetah-jx-v5", device)
    cfg = PGMORLConfig(
        pop_size=pop,
        ppo=MOPPOConfig(num_envs=64 if on_accel else 4, steps_per_iteration=spi),
        vectorized=True,
    )
    agent = PGMORL(env, origin=np.zeros(env.reward_dim), config=cfg, device=device)
    proto = agent.agents[0]
    ws = agent._weights()
    dt = _time(lambda st: proto.train_iteration(st, ws), lambda: proto.init_state(list(range(pop))), device)
    _emit("pgmorl_halfcheetah_env_steps_per_sec_per_chip", pop * spi / dt)


def bench_morld_halfcheetah(on_accel: bool, device: torch.device) -> None:
    """MORL/D vectorized population: 6 MOSAC members train, then the
    shared-buffer cooperation passes, on the planar mo-halfcheetah-jx."""
    pop = 6
    num_envs = 256 if on_accel else 4
    seg_iters = 32 if on_accel else 2
    env = make_env("mo-halfcheetah-jx-v5", device)
    cfg = MORLDConfig(
        pop_size=pop,
        vectorized=True,
        sac=MOSACConfig(num_envs=num_envs, learning_starts=num_envs, buffer_size=16384),
    )
    algo = MORLD(env, cfg, device=device)
    agent = algo.population[0]
    weights = torch.as_tensor(np.stack(algo.weights), dtype=torch.float32, device=device)
    dt = _time(
        lambda sb: algo._pop_step(sb[0], sb[1], weights, seg_iters, cfg.update_passes),
        lambda: (agent.init_state(list(range(pop))), agent.make_buffer(pop)),
        device,
    )
    _emit("morld_halfcheetah_env_steps_per_sec_per_chip", pop * seg_iters * num_envs / dt)


def bench_pareto_kernel(on_accel: bool, device: torch.device) -> None:
    """The CUDA non-dominated mask on an archive-scale front (the large-front
    pruning path of DeviceParetoFront/device_front_metrics).  On the card:
    asserts bitwise agreement with the (N, N) torch mask, then times both;
    for this line only, vs_baseline is the kernel's speedup over that mask."""
    n = 8192 if on_accel else 512
    pts = torch.randn((n, 3), generator=torch.Generator(device).manual_seed(0), device=device)
    torch_mask = lambda p: non_dominated_mask(p, None, False)  # noqa: E731
    if on_accel:
        m1 = non_dominated_mask_cuda(pts, None, keep_duplicates=False)
        m2 = torch_mask(pts)
        if not torch.equal(m1, m2):
            raise AssertionError("the CUDA mask disagrees with the torch mask on the card")
        dt_k = _time(lambda p: non_dominated_mask_cuda(p, None, keep_duplicates=False), lambda: pts, device)
        dt_j = _time(torch_mask, lambda: pts, device)
        print(
            json.dumps(
                {
                    "metric": f"pareto_nd_mask_n{n}_rows_per_sec",
                    "value": round(n / dt_k, 1),
                    "unit": "rows/s",
                    "vs_baseline": round(dt_j / dt_k, 2),
                }
            ),
            flush=True,
        )
    else:
        dt_j = _time(torch_mask, lambda: pts, device)
        print(
            json.dumps(
                {
                    "metric": f"pareto_nd_mask_n{n}_rows_per_sec",
                    "value": round(n / dt_j, 1),
                    "unit": "rows/s",
                    "vs_baseline": 1.0,
                }
            ),
            flush=True,
        )


def bench_envelope_minecart(on_accel: bool, device: torch.device) -> None:
    """Headline: the Envelope/minecart full actor-learner workload
    (N vectorized envs + envelope-target updates at 1-update-per-2048-steps)."""
    num_envs = 32768 if on_accel else 64
    grad_updates = 16 if on_accel else 1
    iters = 100 if on_accel else 20
    env = make_env("minecart-v0", device)
    cfg = EnvelopeConfig(
        num_envs=num_envs,
        buffer_size=max(4 * num_envs, 65536) if on_accel else 4096,
        batch_size=128,
        learning_starts=num_envs,
        gradient_updates=grad_updates,
        train_freq=1,
        num_sample_w=4,
    )
    agent = Envelope(env, cfg, device=device)
    dt = _time(lambda s: agent.train_segment(s, iters), lambda: agent.init_state(0), device)
    _emit("envelope_minecart_env_steps_per_sec_per_chip", iters * num_envs / dt)


SUITE = (
    bench_gpils_minecart,
    bench_gpils_cont_hopper,
    bench_pgmorl_halfcheetah,
    bench_morld_halfcheetah,
    bench_pareto_kernel,
    bench_envelope_minecart,  # headline LAST
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headline-only", action="store_true", help="run the Envelope/minecart line alone")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_accel = device.type == "cuda"
    announce(device)
    suite = [bench_envelope_minecart] if args.headline_only else SUITE
    failures = 0
    for fn in suite:
        try:
            fn(on_accel, device)
        except Exception:  # a broken workload must not mask the others
            failures += 1
            traceback.print_exc(file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
