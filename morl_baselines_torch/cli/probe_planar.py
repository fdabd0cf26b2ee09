"""Microbenchmark of the planar env step, to locate the population workloads' bound.

    python -m morl_baselines_torch.cli.probe_planar [BATCH] [--device cuda|cpu]

Counterpart of the JAX package's ``scripts/probe_planar.py``.  Times, at
BATCH envs (24576 by default: the 6 x 4096 of the largest population in
``profile_population --sweep``):

  1. ``full_step``: the vectorized ``mo-halfcheetah-jx-v5`` step (physics,
     observation, reward and the same-step autoreset);
  2. ``substep_only``: one substep of the port's closed-form dynamics
     (``PlanarDynamics.substep``: features, contact and limit torques,
     ``[M | rhs]``, the solve and the Euler update), where the JAX probe
     times its autodiff ``_qdd``; ``per_substep_x_nsub`` scales it by the
     env's ``n_sub`` substeps a control step;
  3. on a batch of SPD 9x9 systems: ``torch.linalg.solve``, a Cholesky solve
     (``cholesky`` + two ``solve_triangular``), the probe's unrolled
     Gauss-Jordan elimination and the env's own ``PlanarDynamics.solve``
     (what the port's step runs), the last two with ``matches_solve``
     against ``torch.linalg.solve``.

One JSON line each, under the JAX script's keys; seconds are medians of 5
calls after a warm-up, the clock read after the card's queue drained, and
not rounded (the solves take tens of microseconds on the card).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..envs import VectorMOEnv
from ..utils.device import resolve_device
from .bench import _time, announce
from .experiments import make_env

MATCH_TOL = dict(rtol=1e-3, atol=1e-4)  # the JAX probe's allclose


def spd_batch(batch: int, nq: int, device: torch.device, seed: int = 0):
    """(M (batch, nq, nq) symmetric positive definite, rhs (batch, nq)), from ``seed``."""
    g = torch.Generator(device).manual_seed(seed)
    eye = torch.eye(nq, device=device)
    M = eye[None] * (1.0 + torch.rand((batch, 1, 1), generator=g, device=device))
    M = M + 0.05 * torch.randn((batch, nq, nq), generator=g, device=device)
    M = M @ M.transpose(1, 2) + 0.1 * eye[None]
    return M, torch.randn((batch, nq), generator=g, device=device)


def cholesky_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(M)
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def gauss(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Unrolled Gauss-Jordan elimination of [M | rhs] over a static n, no pivoting."""
    A = torch.cat([M, rhs[..., None]], dim=-1)
    n = M.shape[-1]
    for k in range(n):
        row = A[:, k, :] / A[:, k, k : k + 1]
        factors = A[:, :, k].clone()
        factors[:, k] = 0.0
        A = A - factors[:, :, None] * row[:, None, :]
        A[:, k, :] = row
    return A[:, :, n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=24576, help="envs and systems a call (default 24576)")
    ap.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    args = ap.parse_args(argv)
    device, batch = resolve_device(args.device), args.batch
    announce(device, "probe_planar")

    def med(fn) -> float:
        return _time(lambda _: fn(), lambda: None, device, reps=5)

    env = make_env("mo-halfcheetah-jx-v5", device)
    venv = VectorMOEnv(env, batch)
    gen = torch.Generator(device).manual_seed(0)
    state, _ = venv.reset(gen)
    acts = torch.zeros((batch, env.nu), device=device)
    dt = med(lambda: venv.step(state, acts, gen))
    print(json.dumps({"probe": "full_step", "batch": batch, "seconds": dt,
                      "rows_per_sec": round(batch / dt, 1)}), flush=True)

    nq = env.nq
    g = torch.Generator(device).manual_seed(1)
    q = torch.randn((batch, nq), generator=g, device=device) * 0.1
    qd = torch.randn((batch, nq), generator=g, device=device) * 0.1
    tau = torch.zeros((batch, nq), device=device)
    dt = med(lambda: env.dyn.substep(q, qd, tau, env._dt_int))
    print(json.dumps({"probe": "substep_only", "batch": batch, "seconds": dt,
                      "per_substep_x_nsub": dt * env.n_sub}), flush=True)

    M, rhs = spd_batch(batch, nq, device)
    want = torch.linalg.solve(M, rhs)
    dt = med(lambda: torch.linalg.solve(M, rhs))
    print(json.dumps({"probe": "linalg_solve_9x9", "batch": batch, "seconds": dt}), flush=True)

    dt = med(lambda: cholesky_solve(M, rhs))
    print(json.dumps({"probe": "cholesky_solve_9x9", "batch": batch, "seconds": dt}), flush=True)

    ok = torch.allclose(gauss(M, rhs), want, **MATCH_TOL)
    dt = med(lambda: gauss(M, rhs))
    print(json.dumps({"probe": "unrolled_gauss_9x9", "batch": batch, "seconds": dt,
                      "matches_solve": bool(ok)}), flush=True)

    aug = torch.cat([M, rhs[..., None]], dim=-1)
    ok = torch.allclose(env.dyn.solve(aug), want, **MATCH_TOL)
    dt = med(lambda: env.dyn.solve(aug))
    print(json.dumps({"probe": "planar_solve_9x9", "batch": batch, "seconds": dt,
                      "matches_solve": bool(ok)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
