"""Linear Support (OLS + GPI-LS) — corner-weight outer loop, host-side.

Copy of ``morl_baselines_tpu/outer/linear_support.py`` for the PyTorch port,
which imports nothing of the JAX package (that module is numpy and scipy
only, so the code is the same and gives identical corner weights,
priorities, CCS and queue).  Behavioral re-implementation of reference
multi_policy/linear_support/linear_support.py:29-382 (Roijers OLS thesis §3.3;
Alegre et al. GPI-LS).  Differences from the reference:

- LPs use scipy.optimize.linprog (the reference uses cvxpy, :258-293).
- Corner weights (vertices of {(w, c): V_i·w <= c, w in simplex}) are
  enumerated with scipy's Qhull HalfspaceIntersection after eliminating the
  simplex equality, with a combinatorial active-set fallback (the reference
  uses pycddlib, :295-349).
- GPI-LS priorities take a *batched* evaluator (weights (K,d) -> values
  (K,d)) so the GPI-expanded set is computed in one batched rollout instead
  of per-corner python evaluation loops (reference :92-95).
- Ties at priority 0 are shuffled with ``rng`` when given (the port's agents
  pass a ``random.Random`` seeded from their config), else with the global
  ``random`` module.
"""

from __future__ import annotations

import itertools
import random
from typing import Callable, List, Optional

import numpy as np

from ..core.weights import extrema_weights


class LinearSupport:
    def __init__(self, num_objectives: int, epsilon: float = 0.0, verbose: bool = False):
        self.num_objectives = num_objectives
        self.epsilon = epsilon
        self.verbose = verbose
        self.visited_weights: List[np.ndarray] = []
        self.ccs: List[np.ndarray] = []
        self.weight_support: List[np.ndarray] = []
        self.queue: List[tuple] = []
        self.iteration = 0
        self.ols_ended = False
        for w in extrema_weights(num_objectives):
            self.queue.append((float("inf"), w))

    # ------------------------------------------------------------- selection

    def next_weight(
        self,
        algo: str = "ols",
        gpi_evaluator: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        rng: Optional[random.Random] = None,
    ) -> Optional[np.ndarray]:
        """Highest-priority corner weight (reference :66-120).

        gpi_evaluator: batched map from corner weights (K, d) to the agent's
        GPI-evaluated value vectors (K, d) (replaces the reference's
        per-corner policy_evaluation_mo loop).
        """
        if len(self.ccs) > 0:
            w_corner = self.compute_corner_weights()
            self.queue = []
            if algo == "gpi-ls":
                if gpi_evaluator is None:
                    raise ValueError("GPI-LS requires a gpi_evaluator")
                expanded = np.asarray(gpi_evaluator(np.stack(w_corner))) if w_corner else np.zeros((0, self.num_objectives))
            for i, wc in enumerate(w_corner):
                if algo == "ols":
                    priority = self.ols_priority(wc)
                elif algo == "gpi-ls":
                    priority = self.gpi_ls_priority(wc, expanded)
                else:
                    raise ValueError(algo)
                if self.epsilon is None or priority >= self.epsilon:
                    if not (algo == "ols" and any(np.allclose(wc, wv) for wv in self.visited_weights)):
                        self.queue.append((priority, wc))
            if self.queue:
                self.queue.sort(key=lambda t: t[0], reverse=True)
                if self.queue[0][0] == 0.0:
                    (rng or random).shuffle(self.queue)
        if not self.queue:
            self.ols_ended = True
            return None
        return self.queue.pop(0)[1]

    def ended(self) -> bool:
        return self.ols_ended

    def get_weight_support(self) -> List[np.ndarray]:
        return [w.copy() for w in self.weight_support]

    def get_corner_weights(self, top_k: Optional[int] = None) -> List[np.ndarray]:
        weights = [w.copy() for (_p, w) in self.queue]
        return weights[:top_k] if top_k is not None else weights

    # -------------------------------------------------------------- solutions

    def add_solution(self, value: np.ndarray, w: np.ndarray) -> List[int]:
        """Insert a value optimal at w; prune obsolete CCS members (reference :156-184)."""
        self.iteration += 1
        value = np.asarray(value, dtype=np.float64)
        self.visited_weights.append(np.asarray(w, dtype=np.float64))
        if self.is_dominated(value):
            return [len(self.ccs)]
        removed = self.remove_obsolete_values(value)
        self.ccs.append(value)
        self.weight_support.append(np.asarray(w, dtype=np.float64))
        return removed

    def max_scalarized_value(self, w: np.ndarray) -> Optional[float]:
        if not self.ccs:
            return None
        return float(np.max(np.stack(self.ccs) @ np.asarray(w)))

    def remove_obsolete_values(self, value: np.ndarray) -> List[int]:
        """Drop CCS members no longer optimal anywhere after adding value (reference :234-256)."""
        removed = []
        for i in reversed(range(len(self.ccs))):
            optimal_somewhere = any(
                np.dot(self.ccs[i], w) == self.max_scalarized_value(w)
                and np.dot(value, w) < np.dot(self.ccs[i], w)
                for w in self.visited_weights
            )
            if not optimal_somewhere:
                removed.append(i)
                self.ccs.pop(i)
                self.weight_support.pop(i)
        return removed

    def is_dominated(self, value: np.ndarray) -> bool:
        """True iff value beats the CCS at no visited weight (reference :351-365)."""
        if not self.ccs:
            return False
        for w in self.visited_weights:
            if np.dot(value, w) >= self.max_scalarized_value(w):
                return False
        return True

    # -------------------------------------------------------------- priorities

    def ols_priority(self, w: np.ndarray) -> float:
        return self.max_value_lp(w) - self.max_scalarized_value(w)

    def gpi_ls_priority(self, w: np.ndarray, gpi_expanded_set: np.ndarray) -> float:
        """max over GPI-expanded values of v·w minus current CCS value (reference :198-220)."""
        if len(gpi_expanded_set) == 0:
            return 0.0
        best = float(np.max(gpi_expanded_set @ np.asarray(w)))
        return best - self.max_scalarized_value(w)

    def max_value_lp(self, w_new: np.ndarray) -> float:
        """LP upper bound: max w·v s.t. W v <= V (reference :258-293, cvxpy there)."""
        from scipy.optimize import linprog

        if not self.ccs:
            return float("inf")
        W = np.stack(self.visited_weights)
        V = np.array([self.max_scalarized_value(w) for w in self.visited_weights])
        res = linprog(
            c=-np.asarray(w_new, dtype=np.float64),
            A_ub=W,
            b_ub=V,
            bounds=[(None, None)] * self.num_objectives,
            method="highs",
        )
        if res.status != 0:  # unbounded or infeasible -> optimistic
            return float("inf")
        return float(-res.fun)

    # ---------------------------------------------------------- corner weights

    def compute_corner_weights(self) -> List[np.ndarray]:
        """Vertices of P = {(w, c): V_i·w <= c, sum w = 1, w >= 0}, projected to w.

        Reference :295-349 (Roijers thesis Def. 19, via pycddlib).  We
        eliminate the equality by substituting w_d = 1 - sum(w_1..d-1) and run
        Qhull halfspace intersection around the Chebyshev center, falling
        back to combinatorial active-set enumeration when Qhull degenerates
        (e.g. d=2 where the reduced polytope is 2-D but thin).
        """
        ccs = np.round(np.stack(self.ccs), 4)
        d = self.num_objectives
        # Reduced variables x = (w_1..w_{d-1}, c).  Halfspaces A x <= b:
        #   (V_i - V_i[d-1]·1_broadcast)·w' + V_i[d-1] - c <= 0
        #   -w_j <= 0 (j < d-1+1?), and sum w' <= 1 (w_d >= 0)
        A_list, b_list = [], []
        for v in ccs:
            a = np.concatenate([v[:-1] - v[-1], [-1.0]])
            A_list.append(a)
            b_list.append(-v[-1])
        for j in range(d - 1):
            e = np.zeros(d)
            e[j] = -1.0
            A_list.append(e)
            b_list.append(0.0)
        a = np.concatenate([np.ones(d - 1), [0.0]])
        A_list.append(a)
        b_list.append(1.0)
        # bound c to keep polytope bounded: c <= max over vertices of max scal + margin
        cmax = float(np.max(np.abs(ccs))) * (1.0 + 1e-6) + 1.0
        a = np.zeros(d)
        a[-1] = 1.0
        A_list.append(a)
        b_list.append(cmax)
        a = np.zeros(d)
        a[-1] = -1.0
        A_list.append(a)
        b_list.append(cmax)
        A = np.stack(A_list)
        b = np.asarray(b_list)

        verts = _polytope_vertices(A, b)
        corners = []
        for x in verts:
            w_red = x[: d - 1]
            w = np.concatenate([w_red, [1.0 - w_red.sum()]])
            w = np.abs(w)
            s = w.sum()
            if s <= 0:
                continue
            w = w / s
            if not any(np.allclose(w, c, atol=1e-6) for c in corners):
                corners.append(w)
        return corners


def _polytope_vertices(A: np.ndarray, b: np.ndarray) -> List[np.ndarray]:
    """Vertices of {x: A x <= b}: Qhull when possible, active-set fallback."""
    from scipy.optimize import linprog

    n, d = A.shape
    # Chebyshev center for Qhull
    try:
        from scipy.spatial import HalfspaceIntersection

        norms = np.linalg.norm(A, axis=1, keepdims=True)
        res = linprog(
            c=np.concatenate([np.zeros(d), [-1.0]]),
            A_ub=np.hstack([A, norms]),
            b_ub=b,
            bounds=[(None, None)] * d + [(0, None)],
            method="highs",
        )
        if res.status == 0 and res.x[-1] > 1e-9:
            center = res.x[:-1]
            hs = HalfspaceIntersection(np.hstack([A, -b[:, None]]), center)
            return [v for v in hs.intersections if np.all(A @ v <= b + 1e-6)]
    except Exception:
        pass
    # combinatorial fallback: all d-subsets of active constraints
    verts = []
    for idx in itertools.combinations(range(n), d):
        M = A[list(idx)]
        if abs(np.linalg.det(M)) < 1e-10:
            continue
        x = np.linalg.solve(M, b[list(idx)])
        if np.all(A @ x <= b + 1e-7):
            verts.append(x)
    return verts
