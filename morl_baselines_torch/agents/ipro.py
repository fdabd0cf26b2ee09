"""IPRO — Iterated Pareto Referent Optimisation (outer loop, 2-D and n-D).

PyTorch port of ``morl_baselines_tpu/agents/ipro.py`` (reference
multi_policy/ipro/outer_loop.py:29-461, ipro.py:23-333, ipro_2d.py:24-269,
box.py:6-133; Röpke et al.):

- the AASF utility u(v) = min(frac) + aug · mean(frac), frac = scale · (v -
  referent) / (ideal - nadir), as a torch closure (``torch.amin``, whose
  gradient splits among ties as ``jnp.min``'s does), so the NL-MOPPO
  oracle takes du/dv by autograd;
- the init phase trains one linear scalarization per objective for the
  extrema, then nadir and ideal with the offset;
- ``IPRO`` (n-D): the lower and upper staircases, referent selection by
  hypervolume improvement over a random subsample of the lower points
  (``np.random.default_rng(seed)``), the completed set, the excluded
  volume, the error estimate and the replay of the subsolution history;
- ``IPRO2D``: a queue of boxes ordered by volume, split at each found point.

The outer loop is host numpy, as in the JAX package: it runs once per oracle
call.  It scores with the port's host ``hypervolume`` (WFG) and
``filter_pareto_dominated``; dominance here is strict (> in every
coordinate).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core.indicators import hypervolume
from ..core.pareto import filter_pareto_dominated, strict_pareto_dominates
from ..envs.base import MOEnv
from .base import MOAgentBase
from .nlmoppo import NLMOPPO, NLMOPPOConfig, NLMOPPOState


def _strict_dom(a: np.ndarray, b: np.ndarray) -> bool:
    """a strictly dominates b: a > b in every coordinate (reference pareto.py:24)."""
    return bool(np.all(np.asarray(a) > np.asarray(b)))


def _strict_dom_f32(a: np.ndarray, b: np.ndarray) -> bool:
    """``_strict_dom`` with both points rounded to float32 first, as IPRO-2D compares."""
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    return bool(strict_pareto_dominates(f32(a), f32(b)))


def _batched_strict_dom(a: np.ndarray, pts: np.ndarray) -> np.ndarray:
    if len(pts) == 0:
        return np.zeros((0,), dtype=bool)
    return np.all(np.asarray(a)[None, :] > np.asarray(pts), axis=-1)


class Box:
    """Axis-aligned box [nadir, ideal] (reference box.py:6-133)."""

    def __init__(self, nadir: np.ndarray, ideal: np.ndarray):
        self.nadir = np.asarray(nadir, dtype=np.float64)
        self.ideal = np.asarray(ideal, dtype=np.float64)

    @property
    def volume(self) -> float:
        return float(np.prod(np.maximum(self.ideal - self.nadir, 0.0)))

    @property
    def max_dist(self) -> float:
        return float(np.max(np.maximum(self.ideal - self.nadir, 0.0)))

    def __repr__(self):
        return f"Box({self.nadir}, {self.ideal})"


def make_aasf(referent, nadir, ideal, aug: float = 0.1, scale: float = 100.0, device="cuda"):
    """The AASF closure over float32 torch tensors (reference outer_loop.py:47-51)."""
    referent = torch.as_tensor(np.asarray(referent), dtype=torch.float32, device=device)
    pos = torch.as_tensor(np.asarray(ideal), dtype=torch.float32, device=device) - torch.as_tensor(
        np.asarray(nadir), dtype=torch.float32, device=device
    )

    def u(v: torch.Tensor) -> torch.Tensor:
        frac = scale * (v - referent) / pos
        return torch.amin(frac, dim=-1) + aug * torch.mean(frac, dim=-1)

    return u


def make_linear_u(weights, device="cuda"):
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=device)

    def u(v: torch.Tensor) -> torch.Tensor:
        return torch.sum(v * w, dim=-1)

    return u


@dataclass
class IPROConfig:
    offset: float = 1.0
    tolerance: float = 1e-2
    max_iterations: Optional[int] = 20
    hvi_samples: int = 50  # lower points scored per HVI recompute (reference :214)
    aug: float = 0.1
    scale: float = 100.0
    iter_total_timesteps: int = 50_000
    ppo: NLMOPPOConfig = field(default_factory=NLMOPPOConfig)
    seed: int = 0


class _IPROBase(MOAgentBase):
    """The init phase and the oracle, shared by the 2-D and n-D outer loops."""

    def __init__(self, env: MOEnv, config: IPROConfig = IPROConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.agent = NLMOPPO(env, config.ppo, device=self.device)
        self.pf: List[np.ndarray] = []
        self.total_hv = 0.0
        self.dominated_hv = 0.0
        self.discarded_hv = 0.0
        self.coverage = 0.0

    def init_phase(self, state: NLMOPPOState) -> NLMOPPOState:
        """One linear scalarization per objective for the extrema (reference
        ipro.py:146-210; the offset stands in for the reference's minimising
        problems)."""
        cfg = self.cfg
        extrema = []
        for k in range(self.reward_dim):
            u = make_linear_u(np.eye(self.reward_dim)[k], self.device)
            state, point = self.agent.train(cfg.iter_total_timesteps, u, state=state)
            extrema.append(point)
            self.pf.append(point)
        extrema = np.asarray(extrema)
        self.nadir = extrema.min(axis=0) - cfg.offset
        self.ideal = extrema.max(axis=0) + cfg.offset
        self.pf = list(filter_pareto_dominated(np.asarray(self.pf)))
        self.total_hv = Box(self.nadir, self.ideal).volume
        return state

    def _oracle(self, state: NLMOPPOState, referent: np.ndarray):
        """One AASF subproblem (reference oracle_train outer_loop.py:377-395),
        trained on from the previous call's agent."""
        cfg = self.cfg
        u = make_aasf(referent, self.nadir, self.ideal, cfg.aug, cfg.scale, self.device)
        return self.agent.train(cfg.iter_total_timesteps, u, state=state)


class IPRO(_IPROBase):
    """n-D IPRO with the lower/upper point sets, HVI referent selection,
    completed-set bookkeeping and replay (reference ipro.py:23-333)."""

    def __init__(self, env: MOEnv, config: IPROConfig = IPROConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        d = env.reward_dim
        self.lower_points = np.empty((0, d))
        self.upper_points = np.empty((0, d))
        self.completed = np.empty((0, d))
        self.robust_points = np.empty((0, d))
        self.error = np.inf
        self.replay_triggered = 0
        self._rng = np.random.default_rng(config.seed)

    # -------------------------------------------------------- point-set algebra
    #
    # Both staircases evolve by one local rule: a corner "hit" by a new point
    # spawns one child per objective, child i keeping every coordinate of the
    # corner but the i-th, which takes the new point's value; the set is then
    # pruned to its extreme corners (reference update_lower_points /
    # update_upper_points, ipro.py:244-270).

    def _corner_children(self, corner: np.ndarray, vec: np.ndarray) -> np.ndarray:
        """(d, d): row i takes vec_i at coordinate i and the corner elsewhere."""
        take_vec = np.eye(self.reward_dim, dtype=bool)
        return np.where(take_vec, np.asarray(vec)[None, :], np.asarray(corner)[None, :])

    @staticmethod
    def _keep_extremes(points: np.ndarray, sign: float) -> np.ndarray:
        """sign=+1 keeps the Pareto-maximal points (upper set), -1 the minimal ones (lower)."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, points.shape[-1])
        return sign * filter_pareto_dominated(sign * pts)

    def update_lower_points(self, vec: np.ndarray) -> None:
        """Corners strictly dominated by ``vec`` are replaced by their children
        strictly below the ideal."""
        dom = _batched_strict_dom(vec, self.lower_points)
        pieces = [self.lower_points[~dom]]
        for corner in self.lower_points[dom]:
            children = self._corner_children(corner, vec)
            pieces.append(children[np.all(children < self.ideal[None, :], axis=-1)])
        self.lower_points = self._keep_extremes(np.vstack(pieces), -1.0)

    def update_upper_points(self, vec: np.ndarray) -> None:
        """Corners strictly dominating ``vec`` are replaced by their children
        strictly above the nadir."""
        up = self.upper_points
        dom = np.all(up > np.asarray(vec)[None, :], axis=-1) if len(up) else np.zeros((0,), bool)
        pieces = [up[~dom]]
        for corner in up[dom]:
            children = self._corner_children(corner, vec)
            pieces.append(children[np.all(children > self.nadir[None, :], axis=-1)])
        self.upper_points = self._keep_extremes(np.vstack(pieces), 1.0)

    # ----------------------------------------------------- referent selection

    def _hv_to_ideal(self, points: np.ndarray) -> float:
        """Volume between ``points`` and the ideal (the minimisation-form HV of
        reference outer_loop.py:249-255), negated into the maximisation form."""
        points = np.asarray(points, dtype=np.float64)
        points = points[np.all(points <= self.ideal, axis=-1)]
        if points.size == 0:
            return 0.0
        return float(hypervolume(-points, -self.ideal))

    def compute_hvis(self) -> None:
        """Order the lower points most promising first (reference ipro.py:212-229:
        HV of pf ∪ completed ∪ {lp} to the ideal).  Only a random subsample of
        at most ``hvi_samples`` is scored; the rest score 0 and sort last."""
        n = len(self.lower_points)
        if n == 0:
            return
        anchors = np.vstack([np.asarray(self.pf).reshape(-1, self.reward_dim), self.completed])
        scores = np.zeros(n)
        for i in self._rng.permutation(n)[: self.cfg.hvi_samples]:
            scores[i] = self._hv_to_ideal(np.vstack((anchors, self.lower_points[i][None])))
        self.lower_points = self.lower_points[np.argsort(-scores, kind="stable")]

    def select_referent(self) -> np.ndarray:
        """The best lower point by HVI (reference select_referent ipro.py:237-242)."""
        return self.lower_points[0]

    # ------------------------------------------------------------ state updates

    def update_found(self, referent: np.ndarray, vec: np.ndarray) -> None:
        """A point strictly dominating its referent joins the front and
        reshapes both staircases (reference ipro.py:306-311)."""
        pf = np.asarray(self.pf).reshape(-1, self.reward_dim)
        self.pf = list(filter_pareto_dominated(np.vstack((pf, vec[None]))))
        self.update_lower_points(vec)
        self.update_upper_points(vec)

    def update_not_found(self, referent: np.ndarray, vec: np.ndarray) -> None:
        """A failed referent is completed: removed from the lower set, its
        region written off through the upper set (reference ipro.py:313-320)."""
        self.completed = np.vstack((self.completed, referent[None]))
        keep = np.any(self.lower_points != referent[None], axis=1)
        self.lower_points = self.lower_points[keep]
        self.update_upper_points(referent)
        if _strict_dom(vec, self.nadir):
            self.robust_points = np.vstack((self.robust_points, vec[None]))

    def update_excluded_volume(self) -> None:
        """dominated = HV(pf) above the nadir; discarded = the volume between
        pf ∪ completed and the ideal (reference ipro.py:329-333)."""
        pf = np.asarray(self.pf).reshape(-1, self.reward_dim)
        above = pf[np.all(pf >= self.nadir, axis=-1)]
        self.dominated_hv = float(hypervolume(above, self.nadir)) if len(above) else 0.0
        self.discarded_hv = self._hv_to_ideal(np.vstack((pf, self.completed)))

    def estimate_error(self) -> None:
        """Max over the upper points of the min Chebyshev gap to the front
        (reference estimate_error ipro.py:231-239)."""
        if len(self.upper_points) == 0 or len(self.pf) == 0:
            self.error = 0.0
            return
        pf = np.asarray(self.pf).reshape(-1, self.reward_dim)
        diffs = self.upper_points[:, None, :] - pf[None, :, :]
        self.error = float(np.max(np.min(np.max(diffs, axis=2), axis=1)))

    # ------------------------------------------------------------------ replay

    def _reset_sets(self) -> None:
        """Re-seed the point sets from the init phase's extrema, which stay in
        the front (reference reset + init_phase(extrema=...) ipro.py:140-144,205-210)."""
        d = self.reward_dim
        self.pf = list(self._init_pf)
        self.completed = np.empty((0, d))
        self.robust_points = np.empty((0, d))
        self.lower_points = self.nadir[None].copy()
        for p in self.pf:
            self.update_lower_points(np.asarray(p))
        self.upper_points = self.ideal[None].copy()
        self.dominated_hv = 0.0
        self.discarded_hv = 0.0

    def replay(self, vec: np.ndarray, subsolutions: list) -> list:
        """Rebuild the state when a new point retro-dominates earlier accepted
        points or completed referents (reference outer_loop.py:313-356):
        re-apply the history, substituting ``vec`` at the first step it
        improves, then re-admit the tail against the rebuilt lower set."""
        self.replay_triggered += 1
        self._reset_sets()
        new_subs: list = []
        idx = 0
        inserted = False
        for referent, old_vec in subsolutions:
            idx += 1
            if _strict_dom(old_vec, referent):
                if _strict_dom(vec, old_vec):
                    self.update_found(referent, vec)
                    new_subs.append((referent, vec))
                    inserted = True
                    break
                self.update_found(referent, old_vec)
                new_subs.append((referent, old_vec))
            else:
                if _strict_dom(vec, referent):
                    self.update_found(referent, vec)
                    new_subs.append((referent, vec))
                    inserted = True
                    break
                self.update_not_found(referent, old_vec)
                new_subs.append((referent, old_vec))
        for referent, old_vec in subsolutions[idx:]:
            for lower in np.copy(self.lower_points):
                if _strict_dom(old_vec, referent):
                    if _strict_dom(old_vec, lower):
                        self.update_found(lower, old_vec)
                        new_subs.append((lower, old_vec))
                        break
                # weak dominance: the rebuilt lower point often equals the original
                # referent, whose completed region must stay in the volume accounting
                # (reference maybe_add_completed ipro.py:294-304)
                elif np.all(np.asarray(lower) >= np.asarray(referent)):
                    self.update_not_found(lower, old_vec)
                    new_subs.append((lower, old_vec))
                    break
        if not inserted and len(subsolutions) > 0 and len(self.lower_points) > 0:
            # vec belongs at the end of the history (an empty lower set is full coverage)
            ref0 = self.select_referent()
            if _strict_dom(vec, ref0):
                self.update_found(ref0, vec)
                new_subs.append((ref0, vec))
        return new_subs

    # ------------------------------------------------------------------- train

    def train(self, total_timesteps: int | None = None, eval_env=None, ref_point=None, known_pareto_front=None):
        """Run IPRO; returns the Pareto front (reference solve loop outer_loop.py:397-461)."""
        cfg = self.cfg
        state = self.init_phase(self.agent.init_state(cfg.seed))
        self._init_pf = [np.asarray(p) for p in self.pf]
        self.lower_points = self.nadir[None].copy()
        for p in self.pf:
            self.update_lower_points(np.asarray(p))
        self.upper_points = self.ideal[None].copy()
        self.error = float(np.max(self.ideal - self.nadir))
        self.compute_hvis()

        subsolutions: list = []
        iteration = 0
        max_iter = cfg.max_iterations or np.inf
        while len(self.lower_points) > 0 and iteration < max_iter and (1.0 - self.coverage) > cfg.tolerance:
            self.compute_hvis()
            referent = self.select_referent()
            state, point = self._oracle(state, referent)
            point = np.asarray(point)
            pf_arr = np.asarray(self.pf).reshape(-1, self.reward_dim)
            if _strict_dom(point, referent):
                if np.any(_batched_strict_dom(point, np.vstack((pf_arr, self.completed)))):
                    subsolutions = self.replay(point, subsolutions)
                else:
                    self.update_found(referent, point)
                    subsolutions.append((referent, point))
            elif np.any(_batched_strict_dom(point, self.completed)):
                subsolutions = self.replay(point, subsolutions)
            else:
                self.update_not_found(referent, point)
                subsolutions.append((referent, point))
            self.update_excluded_volume()
            self.estimate_error()
            self.coverage = (self.dominated_hv + self.discarded_hv) / max(self.total_hv, 1e-12)
            iteration += 1
            self.logger.log(
                {
                    "outer/coverage": self.coverage,
                    "outer/error": self.error,
                    "outer/pf_size": len(self.pf),
                    "outer/lower_points": len(self.lower_points),
                    "outer/replay_triggered": self.replay_triggered,
                },
                iteration,
            )
        # robust points fold into the final front (reference finish :199-205)
        final = np.vstack((np.asarray(self.pf).reshape(-1, self.reward_dim), self.robust_points))
        self.pf = list(filter_pareto_dominated(final))
        self._state = state
        return self.pf


class IPRO2D(_IPROBase):
    """Bi-objective IPRO: a queue of boxes ordered by volume, split at each
    found point (reference ipro_2d.py:24-269)."""

    def __init__(self, env: MOEnv, config: IPROConfig = IPROConfig(), log: bool = False, device="cuda"):
        if env.reward_dim != 2:
            raise ValueError("IPRO2D requires exactly 2 objectives")
        super().__init__(env, config, log=log, device=device)
        self.box_queue: List[Box] = []

    def _split_box(self, box: Box, point: np.ndarray) -> List[Box]:
        """Split at an interior point; add up the dominated and discarded
        volume (reference ipro_2d.py:149-210)."""
        p = np.clip(point, box.nadir, box.ideal)
        self.dominated_hv += Box(box.nadir, p).volume
        self.discarded_hv += Box(p, box.ideal).volume
        boxes = [
            Box(np.array([box.nadir[0], p[1]]), np.array([p[0], box.ideal[1]])),
            Box(np.array([p[0], box.nadir[1]]), np.array([box.ideal[0], p[1]])),
        ]
        return [b for b in boxes if b.volume > self.cfg.tolerance and np.all(b.ideal > b.nadir)]

    def _push_boxes(self, boxes: List[Box]) -> None:
        self.box_queue.extend(boxes)
        self.box_queue.sort(key=lambda b: b.volume)

    def train(self, total_timesteps: int | None = None, eval_env=None, ref_point=None, known_pareto_front=None):
        """Run IPRO-2D; returns the Pareto front."""
        cfg = self.cfg
        state = self.init_phase(self.agent.init_state(cfg.seed))
        self._push_boxes([Box(self.nadir, self.ideal)])
        iteration = 0
        max_iter = cfg.max_iterations or np.inf
        while self.box_queue and iteration < max_iter and (1.0 - self.coverage) > cfg.tolerance:
            box = self.box_queue.pop()  # the largest volume
            referent = box.nadir
            state, point = self._oracle(state, referent)
            if _strict_dom_f32(point, referent):
                # the point may also dominate other open boxes' nadirs: split those too
                self._push_boxes(self._split_box(box, point))
                self.pf.append(point)
                remaining = []
                for ob in self.box_queue:
                    if _strict_dom_f32(point, ob.nadir) and np.all(point < ob.ideal):
                        remaining.extend(self._split_box(ob, point))
                    else:
                        remaining.append(ob)
                self.box_queue = remaining
                self.box_queue.sort(key=lambda b: b.volume)
            else:
                # a failed subproblem: the box's volume is written off as discarded
                self.discarded_hv += box.volume
            self.coverage = (self.dominated_hv + self.discarded_hv) / max(self.total_hv, 1e-12)
            iteration += 1
            self.pf = list(filter_pareto_dominated(np.asarray(self.pf)))
            self.logger.log(
                {
                    "outer/coverage": self.coverage,
                    "outer/pf_size": len(self.pf),
                    "outer/open_boxes": len(self.box_queue),
                },
                iteration,
            )
        self._state = state
        return self.pf
