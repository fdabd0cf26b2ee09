"""PGMORL — Prediction-Guided MORL: an evolutionary population of MOPPO workers.

PyTorch port of ``morl_baselines_tpu/agents/pgmorl.py`` (reference
multi_policy/pgmorl/pgmorl.py:27-819, Xu et al., 2020):

- ``PerformancePredictor``: per-objective 4-parameter hyperbolic model of
  the performance delta against the weight, fit by weighted scipy
  ``least_squares`` (soft_l1, f_scale) over neighbourhood samples
  (reference :27-202); host numpy, the JAX package's code line for line;
- ``PerformanceBuffer``: the population in angular bins of the objective
  space, each bin sorted by norm (reference :226-368);
- task selection maximizing predicted hypervolume + sparsity_coef *
  sparsity over candidate (policy, weight) pairs (reference :652-731), as
  the JAX package selects them.

Workers are MOPPO members.  Looped mode (``train``): one one-member MOPPO
state per worker, trained in turn.  Vectorized mode (``vectorized=True``):
one MOPPO state of ``pop_size`` members, every worker's PPO iteration in one
pass (the JAX package's ``jax.vmap(train_iteration)``).  "Deep-copying an
agent" (reference :722-726) is copying a member snapshot into a worker's
slot and ``change_weights``.  The port updates states in place, so every
state the buffer or the archive keeps is a copy taken when it was added
(``MOPPO.member_snapshot``, ``MOPPO.member_params``).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import List, Optional

import numpy as np
import torch

from ..core.archive import ParetoArchive
from ..core.indicators import hypervolume, sparsity
from ..core.weights import equally_spaced_weights
from ..envs.base import MOEnv
from ..evaluation.evaluation import multi_policy_metrics
from .base import MOAgentBase
from .moppo import MOPPO, MOPPOConfig


def generate_weights(delta_weight: float, dimensions: int = 2) -> np.ndarray:
    """Uniform simplex lattice with spacing delta_weight (reference :205-223)."""
    possible = np.arange(0.0, 1.0 + delta_weight, delta_weight, dtype=np.float32)
    combos = np.array(list(product(possible, repeat=dimensions)), dtype=np.float32)
    return combos[np.isclose(combos.sum(axis=1), 1.0)]


class PerformancePredictor:
    """Weight & performance -> delta performance (reference :27-202)."""

    def __init__(
        self,
        neighborhood_threshold: float = 0.1,
        sigma: float = 0.03,
        a_bound_min: float = 1.0,
        a_bound_max: float = 500.0,
        f_scale: float = 20.0,
    ):
        self.previous_performance: List[np.ndarray] = []
        self.next_performance: List[np.ndarray] = []
        self.used_weight: List[np.ndarray] = []
        self.neighborhood_threshold = neighborhood_threshold
        self.sigma = sigma
        self.a_bound = (a_bound_min, a_bound_max)
        self.f_scale = f_scale

    def add(self, weight, eval_before, eval_after) -> None:
        self.previous_performance.append(np.asarray(eval_before))
        self.next_performance.append(np.asarray(eval_after))
        self.used_weight.append(np.asarray(weight))

    def predict_next_evaluation(self, weight_candidate: np.ndarray, policy_eval: np.ndarray):
        """Neighborhood-weighted hyperbolic fit per objective (reference :150-202)."""
        from scipy.optimize import least_squares

        neighbor_w, neighbor_delta = [], []
        thr = self.neighborhood_threshold / 2.0
        sig = self.sigma / 2.0
        seen = set()
        while len(neighbor_w) < 4:
            thr *= 2.0
            sig *= 2.0
            if not np.isfinite(thr):
                # degenerate: fall back to zero-delta prediction
                return np.zeros_like(policy_eval), np.asarray(policy_eval)
            for prev, nxt, w in zip(self.previous_performance, self.next_performance, self.used_weight):
                key = tuple(nxt)
                if key in seen:
                    continue
                if np.all(np.abs(prev - policy_eval) < thr * np.maximum(np.abs(policy_eval), 1e-3)):
                    seen.add(key)
                    neighbor_w.append(w)
                    neighbor_delta.append(nxt - prev)
            if len(self.previous_performance) < 4 and len(neighbor_w) < 4:
                return np.zeros_like(policy_eval), np.asarray(policy_eval)

        W = np.stack(neighbor_w)
        D = np.stack(neighbor_delta)
        deltas = []
        for dim in range(len(policy_eval)):
            x = W[:, dim]
            y = D[:, dim]
            kern = np.exp(-((x - weight_candidate[dim]) ** 2) / max(sig, 1e-8))

            def resid(p):
                A, a, b, c = p
                e = np.exp(np.clip(a * (x - b), -50, 50))
                return (A * (e - 1.0) / (e + 1.0) + c - y) * kern

            try:
                sol = least_squares(
                    resid,
                    x0=np.array([1.0, 10.0, 0.5, 0.0]),
                    bounds=(
                        [self.a_bound[0], 0.1, 0.0, -1e3],
                        [self.a_bound[1], 500.0, 1.0, 1e3],
                    ),
                    loss="soft_l1",
                    f_scale=self.f_scale,
                    max_nfev=200,
                )
                A, a, b, c = sol.x
                e = np.exp(np.clip(a * (weight_candidate[dim] - b), -50, 50))
                deltas.append(A * (e - 1.0) / (e + 1.0) + c)
            except Exception:
                deltas.append(float(np.mean(y)))
        deltas = np.asarray(deltas)
        return deltas, deltas + np.asarray(policy_eval)


class PerformanceBuffer:
    """Angular-bin population buffer (reference PerformanceBuffer2d/3d :226-368)."""

    def __init__(self, num_bins: int, max_size: int, origin: np.ndarray):
        self.num_bins_req = num_bins
        self.max_size = max_size
        self.origin = -np.asarray(origin, dtype=np.float64)
        self.dim = len(origin)
        if self.dim == 2:
            self.dtheta = np.pi / 2.0 / num_bins
            self.num_bins = num_bins
            self.dirs = None
        else:
            dirs = generate_weights(1.0 / max(num_bins - 1, 1), self.dim)
            self.dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
            self.num_bins = len(self.dirs)
        self.bins: List[list] = [[] for _ in range(self.num_bins)]
        self.bins_evals: List[list] = [[] for _ in range(self.num_bins)]

    @property
    def evaluations(self) -> List[np.ndarray]:
        return [e for b in self.bins_evals for e in b]

    @property
    def individuals(self) -> list:
        return [i for b in self.bins for i in b]

    def add(self, candidate, evaluation: np.ndarray) -> None:
        ev = np.clip(np.asarray(evaluation, dtype=np.float64) + self.origin, 0.0, np.inf)
        norm = np.linalg.norm(ev)
        if self.dim == 2:
            theta = np.arccos(np.clip(ev[1] / (norm + 1e-3), -1.0, 1.0))
            b = int(theta // self.dtheta)
            if b < 0 or b >= self.num_bins:
                return
        else:
            b = int(np.argmax(self.dirs @ ev))
        inserted = False
        for idx, ex in enumerate(self.bins_evals[b]):
            if norm < np.linalg.norm(np.clip(ex + self.origin, 0.0, np.inf)):
                self.bins[b].insert(idx, candidate)
                self.bins_evals[b].insert(idx, np.asarray(evaluation))
                inserted = True
                break
        if not inserted:
            self.bins[b].append(candidate)
            self.bins_evals[b].append(np.asarray(evaluation))
        if len(self.bins[b]) > self.max_size:
            self.bins[b].pop(0)
            self.bins_evals[b].pop(0)


@dataclass(frozen=True)
class PGMORLConfig:
    pop_size: int = 6
    warmup_iterations: int = 8
    evolutionary_iterations: int = 2
    num_performance_buffer: int = 100
    performance_buffer_size: int = 2
    delta_weight: float = 0.2
    sparsity_coef: float = -1.0
    ppo: MOPPOConfig = MOPPOConfig(num_envs=4, steps_per_iteration=2048)
    vectorized: bool = False  # train all PPO workers as one population state
    seed: int = 0


class PGMORL(MOAgentBase):
    def __init__(
        self, env: MOEnv, origin: np.ndarray, config: PGMORLConfig = PGMORLConfig(), log: bool = False, device="cuda"
    ):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        d = env.reward_dim
        init_weights = generate_weights(config.delta_weight, d)
        if len(init_weights) < config.pop_size:
            reps = int(np.ceil(config.pop_size / len(init_weights)))
            init_weights = np.tile(init_weights, (reps, 1))
        self.agents = [
            MOPPO(env, weights=init_weights[i], config=config.ppo, device=self.device) for i in range(config.pop_size)
        ]
        self.predictor = PerformancePredictor()
        self.population = PerformanceBuffer(config.num_performance_buffer, config.performance_buffer_size, origin)
        self.archive = ParetoArchive()
        self.global_step = 0

    def _weights(self) -> torch.Tensor:
        return torch.stack([a.w for a in self.agents])

    def _record(self, i: int, agent: MOPPO, state, p: int, disc: np.ndarray, evals_before, add_pred: bool) -> None:
        """Member p of ``state`` (worker i) evaluated at ``disc``: into the
        population buffer and the archive as copies, and into the predictor."""
        w = agent.w.cpu().numpy()
        snapshot = (i, agent.member_params(state, p), w)
        self.population.add((snapshot, agent.member_snapshot(state, p)), disc)
        self.archive.add(snapshot, disc)
        if add_pred:
            self.predictor.add(w, evals_before[i], disc)
        evals_before[i] = disc

    def _log_metrics(self, ref_point, known_front) -> None:
        if len(self.archive) and ref_point is not None:
            ew = equally_spaced_weights(self.reward_dim, 32)
            metrics = multi_policy_metrics(self.archive.front, np.asarray(ref_point), ew, known_front)
            self.logger.log(metrics, self.global_step)
            self._last_metrics = metrics

    def _task_weight_selection(self, load, ref_point) -> None:
        """(policy, weight) selection by predicted HV + sparsity (reference
        :652-731); ``load(i, member_snapshot)`` copies the chosen policy into worker i."""
        cfg = self.cfg
        cand_weights = generate_weights(cfg.delta_weight / 2.0, self.reward_dim)
        rng = np.random.default_rng(cfg.seed + self.global_step)
        rng.shuffle(cand_weights)
        current_front = [np.asarray(e) for e in self.archive.evaluations]
        pop = self.population.individuals
        pop_evals = self.population.evaluations
        selected = set()
        for i in range(len(self.agents)):
            best = (-np.inf, None, None)
            for (snapshot, cand_state), ev in zip(pop, pop_evals):
                for wcand in cand_weights:
                    if (tuple(ev), tuple(wcand)) in selected:
                        continue
                    _, pred_eval = self.predictor.predict_next_evaluation(wcand, ev)
                    hv = hypervolume(np.stack(current_front + [pred_eval]), ref_point)
                    sp = float(sparsity(np.stack(current_front + [pred_eval]))) if len(current_front) else 0.0
                    score = hv + cfg.sparsity_coef * sp
                    if score > best[0]:
                        best = (score, (cand_state, wcand), (ev, pred_eval))
            if best[1] is None:
                continue
            cand_state, wcand = best[1]
            selected.add((tuple(best[2][0]), tuple(wcand)))
            current_front.append(best[2][1])
            # copy the candidate state into worker i with the new weight
            load(i, cand_state)
            self.agents[i].change_weights(np.asarray(wcand))

    # ---------------------------------------------------------- looped mode

    def _train_all(self, states) -> None:
        for agent, st in zip(self.agents, states):
            agent.train_iteration(st, agent.w)
            self.global_step += self.cfg.ppo.steps_per_iteration

    def _eval_all(self, states, evals_before, ref_point, known_front, add_pred=True) -> None:
        for i, (agent, st) in enumerate(zip(self.agents, states)):
            gen = torch.Generator(self.device).manual_seed(self.global_step + i)
            _, disc = agent.policy_eval(st, gen, 3)
            self._record(i, agent, st, 0, disc[0].cpu().numpy(), evals_before, add_pred)
        self._log_metrics(ref_point, known_front)

    # ------------------------------------------------------ vectorized mode

    def _eval_all_vec(self, state, evals_before, ref_point, known_front, add_pred=True, eval_max_steps=None) -> None:
        proto = self.agents[0]
        gen = torch.Generator(self.device).manual_seed(self.global_step)
        _, discs = proto.policy_eval(state, gen, 3, self._weights(), max_steps=eval_max_steps)
        discs = discs.cpu().numpy()
        for i, agent in enumerate(self.agents):
            self._record(i, agent, state, i, discs[i], evals_before, add_pred)
        self._log_metrics(ref_point, known_front)

    def _train_vectorized(self, total_timesteps, ref_point, known_pareto_front, eval_max_steps=None):
        cfg = self.cfg
        pop, spi = cfg.pop_size, cfg.ppo.steps_per_iteration
        proto = self.agents[0]
        state = proto.init_state([cfg.seed + i for i in range(pop)])
        evals_before = [np.zeros(self.reward_dim) for _ in self.agents]
        self._eval_all_vec(state, evals_before, ref_point, known_pareto_front, add_pred=False, eval_max_steps=eval_max_steps)

        for _ in range(cfg.warmup_iterations):
            if self.global_step >= total_timesteps:
                break
            proto.train_iteration(state, self._weights())
            self.global_step += pop * spi
            self._eval_all_vec(state, evals_before, ref_point, known_pareto_front, eval_max_steps=eval_max_steps)

        while self.global_step < total_timesteps:
            self._task_weight_selection(lambda i, snap: proto.load_member(state, i, snap), np.asarray(ref_point))
            for _ in range(cfg.evolutionary_iterations):
                if self.global_step >= total_timesteps:
                    break
                proto.train_iteration(state, self._weights())
                self.global_step += pop * spi
            self._eval_all_vec(state, evals_before, ref_point, known_pareto_front, eval_max_steps=eval_max_steps)

        self._state = state
        self._last_front = self.archive.front
        return state

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray,
        known_pareto_front: Optional[np.ndarray] = None,
        eval_max_steps: int | None = None,
    ):
        """Warm-up iterations, then evolution until ``total_timesteps``.
        Returns the vectorized mode's population state, or the looped
        mode's list of one-member states.  ``eval_max_steps`` caps the
        vectorized mode's evaluation episodes (the looped mode runs them to
        the env's limit, as the JAX package does)."""
        cfg = self.cfg
        if cfg.vectorized:
            return self._train_vectorized(total_timesteps, ref_point, known_pareto_front, eval_max_steps)
        states = [a.init_state(cfg.seed + i) for i, a in enumerate(self.agents)]
        evals_before = [np.zeros(self.reward_dim) for _ in self.agents]
        self._eval_all(states, evals_before, ref_point, known_pareto_front, add_pred=False)

        for _ in range(cfg.warmup_iterations):
            if self.global_step >= total_timesteps:
                break
            self._train_all(states)
            self._eval_all(states, evals_before, ref_point, known_pareto_front)

        while self.global_step < total_timesteps:
            self._task_weight_selection(lambda i, snap: self.agents[i].load_member(states[i], 0, snap), np.asarray(ref_point))
            for _ in range(cfg.evolutionary_iterations):
                if self.global_step >= total_timesteps:
                    break
                self._train_all(states)
            self._eval_all(states, evals_before, ref_point, known_pareto_front)

        self._states = states
        self._last_front = self.archive.front
        return states
