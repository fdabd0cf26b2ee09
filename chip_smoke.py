"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``morl_baselines_torch/csrc`` with nvcc
(sm_90a), holds it bitwise against its plain PyTorch version at several
sizes and times both, then drives the main path — Envelope Q-learning on
minecart at the accelerator config of ``bench.py::bench_envelope_minecart``
(32768 envs, (256,)*4 Q-net) — through ``train_segment`` and ``Envelope.train``
and scores the evaluated front on the card, which runs the kernel.  Every
phase raises on a mismatch; the script exits non-zero without a result when
CUDA is absent.  The second-to-last line is a JSON record of the kernels, the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.core import DeviceParetoFront, equally_spaced_weights, filter_pareto_dominated
from morl_baselines_torch.envs import make
from morl_baselines_torch.evaluation import device_front_metrics
from morl_baselines_torch.ops import _build
from morl_baselines_torch.ops.pareto_kernel import non_dominated_mask_cuda, non_dominated_mask_plain

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# int32 lanes outside the tensor cores (Hopper white paper: 64 per SM, 132 SMs, 1.98 GHz boost)
PEAK_INT32_OPS = 132 * 64 * 1.98e9

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


def nd_inputs(seed: int, n: int, d: int):
    """Normal points with planted groups of exact duplicates and a random valid mask."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    k = max(1, n // 10)
    pts[rng.integers(0, n, size=k)] = pts[rng.integers(0, n, size=k)]
    valid = rng.uniform(size=n) > 0.2
    return torch.as_tensor(pts, device="cuda"), torch.as_tensor(valid, device="cuda")


def nd_bound_ms(points: torch.Tensor, valid: torch.Tensor, keep_duplicates: bool, block_rows: int = 1024):
    """(least time, what sets it, pairs compared) for the mask on these inputs: the larger of
    bytes/HBM rate and ops/f32 rate.  Ops count (3d + 2) per pair actually needed: each
    valid row against the columns up to its first dominator (all N if none)."""
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
        pairs += int(torch.where(valid[start : start + block_rows], first, 0).sum())
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


def phase_kernel_vs_plain(smi: str) -> list[dict]:
    """Bitwise comparison at every size and both dedup modes; timings at the
    sizes the archive and the main path give the kernel."""
    sizes = [(32, 3), (37, 3), (96, 3), (1000, 3), (8192, 3), (131072, 3), (1000, 2), (1000, 4), (1000, 8)]
    timed = {(96, 3), (8192, 3), (131072, 3)}
    rows = []
    for seed, (n, d) in enumerate(sizes):
        pts, valid = nd_inputs(seed, n, d)
        for keep in (True, False):
            got = non_dominated_mask_cuda(pts, valid, keep)
            want = non_dominated_mask_plain(pts, valid, keep)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain at N={n} d={d} keep_duplicates={keep}")
            line = f"[kernel] N={n} d={d} keep_duplicates={keep}: bitwise equal ({int(got.sum())} non-dominated)"
            if (n, d) in timed:
                bound_ms, bound_by, pairs = nd_bound_ms(pts, valid, keep)
                full_ops = n * n * (3 * d + 2)  # every row against every column, no early exit
                row = dict(
                    n=n,
                    d=d,
                    keep_duplicates=keep,
                    ms=time_ms(lambda: non_dominated_mask_cuda(pts, valid, keep)),
                    plain_ms=time_ms(
                        lambda: non_dominated_mask_plain(pts, valid, keep), warmup=1, runs=5, reps=20 if n <= 8192 else 1
                    ),
                    bound_ms=bound_ms,
                    bound_by=bound_by,
                    pairs_needed=pairs,
                    full_scan_ms_f32=1e3 * full_ops / PEAK_F32_OPS,
                    full_scan_ms_int32=1e3 * full_ops / PEAK_INT32_OPS,
                )
                rows.append(row)
                line += f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms [{smi}]"
            log(line)
    return rows


def phase_train_segment(smi: str) -> None:
    env = make("minecart-v0")
    agent = Envelope(env, CONFIG)
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
    if state.buffer.size != min(steps, CONFIG.buffer_size):
        raise AssertionError(f"buffer size {state.buffer.size}")
    if not all(bool(torch.isfinite(p).all()) for p in state.ts.net.parameters()):
        raise AssertionError("non-finite Q-net params")
    if not math.isfinite(float(state.loss)):
        raise AssertionError(f"non-finite loss {float(state.loss)}")
    log(
        f"[train_segment] minecart num_envs={NUM_ENVS} hidden={CONFIG.hidden} gradient_updates=16: "
        f"{iters} iters in {dt:.3f} s = {iters * NUM_ENVS / dt:.0f} env-steps/s, "
        f"{1e3 * dt / iters:.2f} ms/iter, loss {float(state.loss):.4g} [{smi}]"
    )
    profile_window(agent, state)


def profile_window(agent: Envelope, state) -> None:
    """Device busy share and the costliest kernels over 3 iterations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        agent.train_segment(state, 3)
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
        return
    n_launch = sum(e.count for e in events)
    log(f"[profile] 3 iters: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
        f"({100 * busy_us / wall_us:.1f}%), {n_launch} kernel launches")
    for e in sorted(events, key=_device_us, reverse=True)[:8]:
        log(f"[profile]   {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


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
    front_np = agent._last_front
    if front_np.shape != (32, 3) or not np.isfinite(front_np).all():
        raise AssertionError(f"bad front {front_np.shape}")

    before = non_dominated_mask_cuda.launches
    front = torch.as_tensor(front_np, dtype=torch.float32, device="cuda")
    valid = torch.ones(32, dtype=torch.bool, device="cuda")
    weights = torch.as_tensor(equally_spaced_weights(3, 32), dtype=torch.float32, device="cuda")
    dev = device_front_metrics(front, valid, torch.as_tensor(REF_POINT, dtype=torch.float32, device="cuda"), weights)
    archive = DeviceParetoFront.create(64, 3).add(front)
    torch.cuda.synchronize()
    launched = non_dominated_mask_cuda.launches - before
    if launched < 2:
        raise AssertionError(f"scoring launched the kernel {launched} times, expected >= 2")
    card, eum = float(dev["eval/cardinality"]), float(dev["eval/eum"])
    if card != host["eval/cardinality"]:
        raise AssertionError(f"device cardinality {card} != host {host['eval/cardinality']}")
    if not math.isclose(eum, host["eval/eum"], rel_tol=1e-5, abs_tol=1e-7):
        raise AssertionError(f"device eum {eum} != host {host['eval/eum']}")
    distinct = filter_pareto_dominated(front_np.astype(np.float64), keep_duplicates=False)
    got = archive.values[archive.valid].cpu().numpy()
    if len(got) != len(distinct) or not np.array_equal(np.unique(got, axis=0), np.unique(distinct.astype(np.float32), axis=0)):
        raise AssertionError(f"device archive {got} != host front {distinct}")
    log(f"[score] device eval/cardinality={card:g} eval/eum={eum:.6g} (host {host['eval/eum']:.6g}); "
        f"archive holds {len(got)} points; kernel launched {launched} times")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = phase_environment()
    phase_build()
    timed = phase_kernel_vs_plain(smi)

    non_dominated_mask_cuda.launches = 0  # count the main path's launches only
    phase_train_segment(smi)
    phase_train_and_score()
    launches = non_dominated_mask_cuda.launches
    if launches == 0:
        raise AssertionError("the main path never launched the pareto_nd kernel")

    main_shape = next(r for r in timed if r["n"] == 96 and not r["keep_duplicates"])
    record = {
        "name": "pareto_nd_mask",
        "route": "cuda",
        "source": "morl_baselines_torch/csrc/pareto_nd.cu",
        "replaces": "morl_baselines_tpu/ops/pareto_kernel.py:33",
        "launches": launches,
        "max_abs_err": 0.0,  # every comparison above is bitwise
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a Pareto mask
        "at": "N=96 d=3 keep_duplicates=False (DeviceParetoFront.add on the main path)",
        "sizes": timed,
    }
    log(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
