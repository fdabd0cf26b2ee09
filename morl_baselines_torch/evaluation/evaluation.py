"""Batched policy evaluation — every episode of a front in one batch.

PyTorch port of ``morl_baselines_tpu/evaluation/evaluation.py`` (reference
common/evaluation.py:23-200).  Where the JAX package vmaps over (weights x
episodes) and scans over steps, the port writes the batch dimension out: the
W·rep episodes of a front step together for ``max_steps`` steps, with
accumulators frozen after each episode's end (no autoreset).

Metric names and semantics are the reference's (eval/hypervolume, eval/eum,
eval/cardinality, eval/igd, eval/mul, eval/sparsity).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.indicators import (
    cardinality,
    expected_utility,
    hypervolume,
    hypervolume_2d,
    igd,
    maximum_utility_loss,
    sparsity,
)
from ..core.pareto import filter_pareto_dominated
from ..envs.base import MOEnv
from ..ops.pareto_kernel import non_dominated_mask_auto
from ..parallel.mesh import global_rows, local
from ..utils.device import resolve_device

# steps between the host reads that end a rollout once every episode is done
_DONE_CHECK_EVERY = 32

# act_fn(obs (M, obs_dim), w (M, d), gen) -> actions (M,)
ActFn = Callable[[torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor]


@torch.no_grad()
def rollout_episode(
    env: MOEnv,
    act_fn: ActFn,
    w: torch.Tensor,
    gen: torch.Generator,
    gamma: float,
    max_steps: int | None = None,
    shard=None,
):
    """One masked episode per row of ``w`` (M, d); returns
    (vec_return (M, d), disc_vec_return (M, d), length (M,)).

    Steps up to ``max_steps`` steps, freezing each row's accumulators after
    its episode ends (reference eval_mo's while-loop, evaluation.py:42-53).
    Every ``_DONE_CHECK_EVERY`` steps one host read asks whether every
    episode has ended, and the loop stops if so; the frozen results are the
    same.  With a ``shard`` (``parallel.RowShard``) the M rows are this
    rank's of the ranks' episodes: the reset and step draws are made for all
    of them and sliced, and the loop stops when every rank's episodes ended.
    """
    max_steps = max_steps or env.max_episode_steps or 1000
    m, d = w.shape
    dev = w.device
    m_all = global_rows(shard, m)
    state, obs = local(shard, env.reset(m_all, gen))
    done = torch.zeros((m,), dtype=torch.bool, device=dev)
    ret = torch.zeros((m, d), device=dev)
    disc = torch.zeros((m, d), device=dev)
    gpow = torch.ones((m,), device=dev)
    length = torch.zeros((m,), dtype=torch.int32, device=dev)
    for t in range(max_steps):
        if t > 0 and t % _DONE_CHECK_EVERY == 0 and (bool(done.all()) if shard is None else shard.all(done)):
            break
        action = act_fn(obs, w, gen)
        out = env.step(state, action, local(shard, env.sample_noise(m_all, gen), env.noise_env_dim))
        live = (~done).to(torch.float32)
        ret = ret + live[:, None] * out.reward
        disc = disc + (live * gpow)[:, None] * out.reward
        gpow = torch.where(done, gpow, gpow * gamma)
        length = length + (~done).to(torch.int32)
        done = done | out.terminated | out.truncated
        state, obs = out.state, out.obs
    return ret, disc, length


def policy_evaluation(
    env: MOEnv,
    act_fn: ActFn,
    w: torch.Tensor,
    gen: torch.Generator,
    rep: int = 5,
    gamma: float = 1.0,
    max_steps: int | None = None,
):
    """Average vec/disc returns of weight ``w`` (d,) over ``rep`` episodes
    (reference evaluation.py:118-145)."""
    rets, discs, _ = rollout_episode(env, act_fn, w[None, :].expand(rep, -1), gen, gamma, max_steps)
    return rets.mean(dim=0), discs.mean(dim=0)


def evaluate_front(
    env: MOEnv,
    act_fn: ActFn,
    weights: torch.Tensor,
    gen: torch.Generator,
    rep: int = 5,
    gamma: float = 1.0,
    max_steps: int | None = None,
) -> torch.Tensor:
    """Discounted return per eval weight, all W·rep episodes in one batch.

    Replaces the reference's ``[policy_evaluation_mo(...) for ew in
    eval_weights]`` host loop.  Returns (W, d) discounted vector returns.
    """
    n_w, d = weights.shape
    _, discs, _ = rollout_episode(env, act_fn, weights.repeat_interleave(rep, dim=0), gen, gamma, max_steps)
    return discs.reshape(n_w, rep, d).mean(dim=1)


def multi_policy_metrics(
    front: np.ndarray,
    ref_point: np.ndarray,
    eval_weights: np.ndarray,
    ref_front: np.ndarray | None = None,
) -> dict:
    """The reference's eval metric bundle (evaluation.py:147-200), host-side.

    ``front`` may contain dominated points; it is pruned first, as the
    reference does (evaluation.py:166).
    """
    pruned = filter_pareto_dominated(np.asarray(front, dtype=np.float64))
    metrics = {
        "eval/hypervolume": float(hypervolume(pruned, ref_point)),
        "eval/eum": float(expected_utility(pruned, eval_weights)),
        "eval/cardinality": float(len(pruned)),
        "eval/sparsity": float(sparsity(pruned)) if len(pruned) > 1 else 0.0,
    }
    if ref_front is not None and len(ref_front):
        metrics["eval/igd"] = float(igd(pruned, ref_front))
        metrics["eval/mul"] = float(maximum_utility_loss(pruned, ref_front, eval_weights))
    return metrics


def device_front_metrics(
    front: torch.Tensor,
    valid: torch.Tensor,
    ref_point: torch.Tensor,
    eval_weights: torch.Tensor,
) -> dict:
    """Metric bundle on the front's device (2-obj exact HV; EUM/cardinality any d).

    The non-dominated mask goes through ``non_dominated_mask_auto``: the CUDA
    kernel for a CUDA front.
    """
    nd = non_dominated_mask_auto(front, valid)
    out = {
        "eval/eum": expected_utility(front, eval_weights, valid=nd),
        "eval/cardinality": cardinality(front, valid),
    }
    if front.shape[-1] == 2:
        out["eval/hypervolume"] = hypervolume_2d(front, ref_point, valid)
    return out


def seed_everything(seed: int, device="cuda") -> torch.Generator:
    """Seed every global RNG and return a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (reference common/evaluation.py:203-219).

    Seeds python's ``random``, ``PYTHONHASHSEED``, numpy's global state and
    torch's (``torch.manual_seed``, every device).  The port's device-side
    randomness flows through explicit generators, as the JAX package's flows
    through the key this returns there; the host-side outer loops (LinearSupport
    tie-breaks, PGMORL's scipy fits) still read the global states.
    """
    import os
    import random

    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(resolve_device(device)).manual_seed(seed)


def log_episode_info(
    finished,
    scalarization: Callable,
    weights: np.ndarray | None,
    global_step: int,
    id: int | None = None,
    verbose: bool = False,
    logger=None,
) -> dict:
    """Log completed-episode statistics (reference common/evaluation.py:221-277).

    ``finished`` is the batched ``EpisodeStats`` row-set emitted by
    ``EpisodeStats.update`` (rows with length 0 are not completed episodes and
    are ignored); the statistics are means over the episodes that finished
    this step, in numpy as the JAX package takes them.  ``scalarization`` gets
    float32 tensors: ``scalarization(ret)``, or ``scalarization(ret, w)`` when
    ``weights`` is given.  Metric keys match the reference.  Returns the metric
    dict; also sends it to ``logger`` (a MetricLogger) when given.
    """
    length_all = finished.length.cpu().numpy()
    mask = length_all > 0
    if not mask.any():
        return {}
    ret = finished.ret.cpu().numpy()[mask].mean(axis=0)
    disc = finished.disc_ret.cpu().numpy()[mask].mean(axis=0)
    length = float(length_all[mask].mean())
    ret_t, disc_t = torch.as_tensor(ret), torch.as_tensor(disc)
    if weights is None:
        scal, disc_scal = scalarization(ret_t), scalarization(disc_t)
    else:
        w = torch.as_tensor(np.asarray(weights), dtype=ret_t.dtype)
        scal, disc_scal = scalarization(ret_t, w), scalarization(disc_t, w)
    idstr = f"_{id}" if id is not None else ""
    metrics = {
        f"charts{idstr}/timesteps_per_episode": length,
        f"metrics{idstr}/scalarized_episode_return": float(scal),
        f"metrics{idstr}/discounted_scalarized_episode_return": float(disc_scal),
    }
    for i in range(ret.shape[0]):
        metrics[f"metrics{idstr}/episode_return_obj_{i}"] = float(ret[i])
        metrics[f"metrics{idstr}/disc_episode_return_obj_{i}"] = float(disc[i])
    if verbose:
        print(
            f"Episode infos (mean over {int(mask.sum())} finished): steps={length:.1f}, "
            f"return={ret}, discounted={disc}, scalarized={float(scal):.4g} "
            f"(disc {float(disc_scal):.4g})"
        )
    if logger is not None:
        logger.log(metrics, global_step)
    return metrics
