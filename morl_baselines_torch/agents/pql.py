"""PQL — Pareto Q-Learning (tabular, set-valued), masked fixed-capacity sets.

PyTorch port of ``morl_baselines_tpu/agents/pql.py`` (reference
multi_policy/pareto_q_learning/pql.py:17-354; Van Moffaert & Nowé, 2014):
per (s, a) a SET of non-dominated Q-vectors

    Q_set(s, a) = avg_reward(s, a) + gamma * ND(s')

where ND(s') is the non-dominated union over a' of Q_set(s', a') at the
observed successor (deterministic-env assumption, as the reference's DST
usage).  Action selection scores each action's Q_set by hypervolume or
cardinality (reference :122-154); policy *tracking* follows the closest set
member to a target vector (reference :295-341).

The sets are fixed-capacity (S, A, K, d) tensors with valid masks.  Every
set operation takes a batch of (state, action) pairs, so one step scores
all A actions in one batched call.  ND keeps the top K of the plain
non-dominated mask (``core.pareto``; no Pallas kernel in the JAX package
either); ``torch.topk`` may order tied scores otherwise than ``lax.top_k``,
so a set's slot order may differ while the set is the same.  One env
steps, with no host read inside ``train_segment``; the same-step autoreset
of ``VectorMOEnv`` over one env is the JAX package's reset by hand on done.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.indicators import hypervolume_2d, hypervolume_3d, hypervolume_mc, hypervolume_small_exact
from ..core.pareto import non_dominated_mask
from ..core.weights import equally_spaced_weights
from ..envs.base import MOEnv
from ..envs.vector import VectorMOEnv
from ..evaluation.evaluation import multi_policy_metrics
from .base import MOAgentBase


@dataclass(frozen=True)
class PQLConfig:
    gamma: float = 1.0
    initial_epsilon: float = 1.0
    final_epsilon: float = 0.1
    epsilon_decay_steps: int = 10_000
    set_capacity: int = 16  # K vectors per (s, a) set
    action_eval: str = "hypervolume"  # or "pareto_cardinality"
    seed: int = 0


@dataclass
class PQLState:
    avg_reward: torch.Tensor  # (S, A, d)
    counts: torch.Tensor  # (S, A)
    next_state: torch.Tensor  # (S, A) observed successor
    terminal: torch.Tensor  # (S, A) observed termination flag
    q_sets: torch.Tensor  # (S, A, K, d)
    q_valid: torch.Tensor  # (S, A, K)
    env_state: tuple
    obs: torch.Tensor  # (1, obs_dim)
    gen: torch.Generator
    global_step: int


class PQL(MOAgentBase):
    def __init__(self, env: MOEnv, ref_point: np.ndarray, config: PQLConfig = PQLConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        if env.num_states is None:
            raise ValueError("PQL needs an env with discrete state indexing")
        self.cfg = config
        self.ref_point = torch.as_tensor(np.asarray(ref_point), dtype=torch.float32, device=self.device)
        self.S = int(env.num_states)
        self.A = env.num_actions
        self.venv = VectorMOEnv(env, 1)

    def init_state(self, seed: int | None = None) -> PQLState:
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(dev).manual_seed(cfg.seed if seed is None else seed)
        env_state, obs = self.venv.reset(gen)
        S, A, K, d = self.S, self.A, cfg.set_capacity, self.reward_dim
        return PQLState(
            avg_reward=torch.zeros((S, A, d), device=dev),
            counts=torch.zeros((S, A), device=dev),
            next_state=torch.zeros((S, A), dtype=torch.long, device=dev),
            terminal=torch.zeros((S, A), device=dev),
            q_sets=torch.zeros((S, A, K, d), device=dev),
            q_valid=torch.zeros((S, A, K), dtype=torch.bool, device=dev),
            env_state=env_state,
            obs=obs,
            gen=gen,
            global_step=0,
        )

    # ------------------------------------------------------------- set algebra

    def _nd_of_state(self, q_sets: torch.Tensor, q_valid: torch.Tensor, s_idx: torch.Tensor):
        """ND(s) for each state of ``s_idx`` (...): the non-dominated union over
        actions of Q_set(s, a), top-K kept; returns (..., K, d), (..., K)."""
        K, d = self.cfg.set_capacity, self.reward_dim
        vals = q_sets[s_idx].reshape(*s_idx.shape, self.A * K, d)
        valid = q_valid[s_idx].reshape(*s_idx.shape, self.A * K)
        nd = non_dominated_mask(vals, valid, keep_duplicates=False)
        score = nd.to(torch.float32) * 1e3 + torch.where(nd, vals.sum(dim=-1), -1e9)
        top = torch.topk(score, K, dim=-1).indices
        return torch.gather(vals, -2, top[..., None].expand(*top.shape, d)), torch.gather(nd, -1, top)

    def _q_set_of(self, state: PQLState, s_idx: torch.Tensor, a: torch.Tensor):
        """Q_set(s, a) = avg_r + gamma * ND(s'), or the singleton {avg_r} when s'
        has an empty set or (s, a) ended the episode; (s, a) never seen is
        empty.  ``s_idx`` and ``a`` broadcast to (...); returns (..., K, d), (..., K)."""
        K = self.cfg.set_capacity
        nd_vals, nd_valid = self._nd_of_state(state.q_sets, state.q_valid, state.next_state[s_idx, a])
        r = state.avg_reward[s_idx, a]  # (..., d)
        term = state.terminal[s_idx, a]
        seen = state.counts[s_idx, a] > 0
        vals = r[..., None, :] + self.cfg.gamma * nd_vals * (1.0 - term)[..., None, None]
        any_next = nd_valid.any(dim=-1) & (term < 0.5)
        first = torch.arange(K, device=r.device) == 0
        valid = torch.where(any_next[..., None], nd_valid, first)
        vals = torch.where(any_next[..., None, None], vals, torch.where(first[:, None], r[..., None, :], 0.0))
        return vals, valid & seen[..., None]

    # ------------------------------------------------------------- action eval

    def _score_actions(self, state: PQLState, s_idx: torch.Tensor, gen: torch.Generator | None = None) -> torch.Tensor:
        """Score of Q_set(s, a) for every action a at the state ``s_idx`` (a
        0-d or (1,) tensor), all A sets in one batched call (reference :122-154): exact HV
        (the 2-D or 3-D sweep, inclusion-exclusion up to K = 16 beyond, else
        Monte-Carlo with the same samples for every action), or the
        cardinality of each set."""
        A, K, d = self.A, self.cfg.set_capacity, self.reward_dim
        vals, valid = self._q_set_of(state, s_idx.expand(A), torch.arange(A, device=s_idx.device))  # (A, K, d)
        if self.cfg.action_eval != "hypervolume":
            return non_dominated_mask(vals, valid).sum(dim=-1).to(torch.float32)
        if d == 2:
            return hypervolume_2d(vals, self.ref_point, valid)
        if d == 3:
            return hypervolume_3d(vals, self.ref_point, valid)
        if K <= 16:
            return hypervolume_small_exact(vals, self.ref_point, valid)
        gen = gen if gen is not None else torch.Generator(vals.device).manual_seed(0)
        return hypervolume_mc(vals, self.ref_point, gen, valid, n_samples=2048)

    # ------------------------------------------------------------ train segment

    def _epsilon(self, global_step: int) -> float:
        """Linear from initial to final over ``epsilon_decay_steps`` steps, in float32 as the JAX package."""
        cfg, f32 = self.cfg, np.float32
        eps = f32(cfg.initial_epsilon) - f32(cfg.initial_epsilon - cfg.final_epsilon) * f32(global_step) / f32(cfg.epsilon_decay_steps)
        return float(np.clip(eps, f32(cfg.final_epsilon), f32(cfg.initial_epsilon)))

    def _explore(self, state: PQLState):
        """(uniform (1,), random action (1,)): the epsilon-greedy draws of one step."""
        g = state.gen
        u = torch.rand((1,), generator=g, device=g.device)
        return u, torch.randint(0, self.A, (1,), generator=g, device=g.device)

    def train_segment(self, state: PQLState, num_steps: int) -> PQLState:
        """Run ``num_steps`` steps of the one env, updating ``state`` in place.

        The state and action indices stay (1,) tensors: a 0-d integer tensor
        used as an index would be read to the host at every use."""
        env, cfg, gen = self.env, self.cfg, state.gen
        for _ in range(num_steps):
            s_idx = env.state_index(state.obs)  # (1,)
            greedy = torch.argmax(self._score_actions(state, s_idx, gen), dim=-1, keepdim=True)
            u, rand_a = self._explore(state)
            action = torch.where(u < self._epsilon(state.global_step), rand_a, greedy)
            out = self.venv.step(state.env_state, action, gen)
            ns_idx = env.state_index(out.final_obs)

            cnt = state.counts[s_idx, action] + 1.0
            state.avg_reward[s_idx, action] += (out.reward - state.avg_reward[s_idx, action]) / cnt[:, None]
            state.counts[s_idx, action] = cnt
            state.next_state[s_idx, action] = ns_idx
            state.terminal[s_idx, action] = out.terminated.to(torch.float32)
            # refresh the cached Q_set(s, a) from the new statistics
            vals, valid = self._q_set_of(state, s_idx, action)
            state.q_sets[s_idx, action] = vals
            state.q_valid[s_idx, action] = valid

            state.env_state, state.obs = out.state, out.obs
            state.global_step += 1
        return state

    # ------------------------------------------------------------------ front

    def _start_index(self) -> int:
        _, obs0 = self.env.reset(1, torch.Generator(self.device).manual_seed(self.cfg.seed))
        return int(self.env.state_index(obs0)[0])

    def get_local_pcs(self, state: PQLState, s_idx: int = 0) -> np.ndarray:
        """Pareto coverage set estimate at a state (reference get_local_pcs), host numpy."""
        vals, valid = self._nd_of_state(state.q_sets, state.q_valid, torch.tensor(s_idx, device=self.device))
        return vals.cpu().numpy()[valid.cpu().numpy()]

    @torch.no_grad()
    def track_policy(self, state: PQLState, target: np.ndarray, gen: torch.Generator | None = None, max_steps: int = 200) -> np.ndarray:
        """Execute the policy tracking a target vector (reference :295-341), host loop."""
        env = self.env
        gen = gen if gen is not None else torch.Generator(self.device).manual_seed(1)
        est, obs = env.reset(1, gen)
        total = np.zeros(self.reward_dim)
        target = np.asarray(target, dtype=np.float64).copy()
        actions = torch.arange(self.A, device=self.device)
        for _ in range(max_steps):
            s_idx = env.state_index(obs)[0]
            vals, valid = (x.cpu().numpy() for x in self._q_set_of(state, s_idx.expand(self.A), actions))
            best_a, best_d = 0, np.inf
            for a in range(self.A):
                if not valid[a].any():
                    continue
                dists = np.linalg.norm(vals[a][valid[a]] - target, axis=-1)
                i = int(np.argmin(dists))
                if dists[i] < best_d:
                    best_d, best_a = float(dists[i]), a
            out = env.step(est, torch.tensor([best_a], device=self.device), env.sample_noise(1, gen))
            r = out.reward[0].cpu().numpy()
            total += r
            if bool(out.terminated[0] | out.truncated[0]):
                break
            est, obs = out.state, out.obs
            target = (target - r) / max(self.cfg.gamma, 1e-8)
        return total

    # ------------------------------------------------------------------ train

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        eval_freq: int = 5000,
        state: PQLState | None = None,
    ) -> PQLState:
        state = state if state is not None else self.init_state()
        done_steps = 0
        seg = min(eval_freq, total_timesteps)
        start_idx = self._start_index()
        while done_steps < total_timesteps:
            n = min(seg, total_timesteps - done_steps)
            self.train_segment(state, n)
            done_steps += n
            # local PCS at the env's start state (reference get_local_pcs at s0)
            front = self.get_local_pcs(state, start_idx)
            if ref_point is not None and len(front):
                ew = equally_spaced_weights(self.reward_dim, 32)
                metrics = multi_policy_metrics(front, np.asarray(ref_point), ew, known_pareto_front)
                self.logger.log(metrics, state.global_step)
                self._last_metrics = metrics
            self._last_front = front
        self._final_state = state
        return state
