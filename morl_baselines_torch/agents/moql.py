"""Scalarized tabular MO Q-Learning — N envs and one table on a device.

PyTorch port of ``morl_baselines_tpu/agents/moql.py`` (reference
single_policy/ser/mo_q_learning.py:19-311; Van Moffaert et al., 2013): one
table of Q-*vectors* q[s] in R^{A x d}; the greedy action maximizes the
scalarized Q (reference :160-170); the TD update is vector-valued with the
bootstrap action chosen by scalarized argmax at s' (reference :172-184).
Weighted-sum or Tchebicheff scalarization (with an explicit utopian point),
and optional Dyna planning backed by a dense tabular model (counts, last
next state, running-mean reward and termination per (s, a)).

N envs step together; each step applies N TD updates, all computed from the
table as it was before the step and summed where (s, a) pairs repeat
(``index_put_(..., accumulate=True)``, the JAX package's ``.at[].add``).
Where the JAX package scans, a segment here is a Python loop of tensor ops
that updates the state in place with no host read; ``global_step`` is a
host integer.  The JAX package's episode statistics are updated there but
never read; the port leaves them out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.scalarization import tchebicheff, update_utopian, weighted_sum
from ..envs.base import MOEnv
from ..envs.vector import VectorMOEnv
from ..evaluation.evaluation import policy_evaluation
from ..parallel.mesh import RowShard, gather_rows, local
from ..utils.schedules import linearly_decaying_value
from .base import MOAgentBase


@dataclass(frozen=True)
class MOQLearningConfig:
    learning_rate: float = 0.1
    gamma: float = 0.9
    initial_epsilon: float = 0.1
    final_epsilon: float = 0.1
    epsilon_decay_steps: int | None = None
    learning_starts: int = 0
    num_envs: int = 16
    scalarization: str = "weighted_sum"  # or "tchebicheff"
    dyna: bool = False
    dyna_updates: int = 5
    seed: int = 0


@dataclass
class MOQLState:
    q_table: torch.Tensor  # (S, A, d)
    utopian: torch.Tensor  # (d,) Tchebicheff reference point
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    gen: torch.Generator
    global_step: int  # env steps (N per iteration)
    # Dyna model (dense tabular)
    model_count: torch.Tensor | None = None  # (S, A) visit counts
    model_next: torch.Tensor | None = None  # (S, A) most recent next-state index
    model_reward: torch.Tensor | None = None  # (S, A, d) running-mean reward
    model_term: torch.Tensor | None = None  # (S, A) running-mean termination
    shard: RowShard | None = None  # this rank's rows of the envs (``parallel.shard_agent_state``)


class MOQLearning(MOAgentBase):
    """Single-policy scalarized Q-learning for a fixed weight vector."""

    def __init__(
        self,
        env: MOEnv,
        weights: np.ndarray,
        config: MOQLearningConfig = MOQLearningConfig(),
        log: bool = False,
        device="cuda",
    ):
        super().__init__(env, config, log=log, device=device)
        if env.num_states is None:
            raise ValueError("MOQLearning needs an env with discrete state indexing")
        self.cfg = config
        self.w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)
        self.venv = VectorMOEnv(env, config.num_envs)
        self.num_states = int(env.num_states)
        self.num_actions = env.num_actions

    def _scalarize(self, q: torch.Tensor, utopian: torch.Tensor) -> torch.Tensor:
        """Scalarize the trailing reward dim of q (any leading shape)."""
        if self.cfg.scalarization == "weighted_sum":
            return weighted_sum(q, self.w)
        return tchebicheff(q, self.w, utopian)

    def init_state(self, seed: int | None = None) -> MOQLState:
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(dev).manual_seed(cfg.seed if seed is None else seed)
        env_state, obs = self.venv.reset(gen)
        S, A, d = self.num_states, self.num_actions, self.reward_dim
        dyna = {}
        if cfg.dyna:
            dyna = dict(
                model_count=torch.zeros((S, A), device=dev),
                model_next=torch.zeros((S, A), dtype=torch.long, device=dev),
                model_reward=torch.zeros((S, A, d), device=dev),
                model_term=torch.zeros((S, A), device=dev),
            )
        return MOQLState(
            q_table=torch.zeros((S, A, d), device=dev),
            utopian=torch.full((d,), -torch.inf, device=dev),
            env_state=env_state,
            obs=obs,
            gen=gen,
            global_step=0,
            **dyna,
        )

    def _epsilon(self, global_step: int) -> float:
        # per-env step clock (see Envelope._epsilon)
        cfg = self.cfg
        if cfg.epsilon_decay_steps is None:
            return cfg.initial_epsilon
        return linearly_decaying_value(
            cfg.initial_epsilon,
            cfg.epsilon_decay_steps,
            global_step // cfg.num_envs,
            cfg.learning_starts // cfg.num_envs,
            cfg.final_epsilon,
        )

    def _draws(self, state: MOQLState):
        """The random numbers of one iteration: epsilon-greedy uniforms (N,),
        random actions (N,), and with Dyna the planning uniforms (dyna_updates * N,)."""
        g, n = state.gen, self.cfg.num_envs
        u = torch.rand((n,), generator=g, device=g.device)
        rand_a = torch.randint(0, self.num_actions, (n,), generator=g, device=g.device)
        plan_u = torch.rand((self.cfg.dyna_updates * n,), generator=g, device=g.device) if self.cfg.dyna else None
        return u, rand_a, plan_u

    def _greedy(self, q_table: torch.Tensor, utopian: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
        """Scalarized argmax at each state; all -inf (or NaN) scores pick action 0, as in JAX."""
        return torch.argmax(self._scalarize(q_table[s_idx], utopian), dim=-1)

    def _td_update(self, q_table, utopian, s_idx, actions, rewards, ns_idx, term) -> None:
        """N TD updates of ``q_table`` in place, every delta from the table as it
        was before; duplicate (s, a) pairs sum their updates."""
        cfg = self.cfg
        q_next = q_table[ns_idx]  # (B, A, d)
        a_star = torch.argmax(self._scalarize(q_next, utopian), dim=-1)
        boot = torch.gather(q_next, 1, a_star[:, None, None].expand(-1, 1, q_next.shape[-1])).squeeze(1)
        target = rewards + cfg.gamma * (1.0 - term[:, None]) * boot
        delta = target - q_table[s_idx, actions]
        q_table.index_put_((s_idx, actions), cfg.learning_rate * delta, accumulate=True)

    def _dyna(self, state: MOQLState, s_idx, actions, rewards, ns_idx, term, u: torch.Tensor) -> None:
        """Update the tabular model with the N real transitions, then apply
        ``dyna_updates * N`` planning TD updates on (s, a) pairs drawn in
        proportion to their counts from the uniforms ``u`` (reference
        tabular_model.py).  Counts are summed first; the means divide by the
        count after it.  Where pairs repeat, any one of their next states wins."""
        cnt = state.model_count
        cnt.index_put_((s_idx, actions), torch.ones_like(term), accumulate=True)
        c = cnt[s_idx, actions]
        mr, mt = state.model_reward, state.model_term
        mr.index_put_((s_idx, actions), (rewards - mr[s_idx, actions]) / c[:, None], accumulate=True)
        mt.index_put_((s_idx, actions), (term - mt[s_idx, actions]) / c, accumulate=True)
        state.model_next.index_put_((s_idx, actions), ns_idx)
        # planning: sample visited (s, a) pairs in proportion to their counts (whole numbers: the cumsum is exact)
        flat = cnt.reshape(-1)
        idx = torch.searchsorted(torch.cumsum(flat, 0), u * flat.sum()).clamp_(0, flat.shape[0] - 1)
        ps, pa = idx // self.num_actions, idx % self.num_actions
        self._td_update(state.q_table, state.utopian, ps, pa, mr[ps, pa], state.model_next[ps, pa], mt[ps, pa])

    def train_segment(self, state: MOQLState, num_iters: int) -> MOQLState:
        """Run ``num_iters`` iterations of N env steps and N TD updates, in place.

        Sharded, a rank steps its rows of the envs and all-gathers the N
        transitions; every rank then applies all N TD updates to its replica
        of the table in the one-process order."""
        cfg, env = self.cfg, self.env
        n, gen, shard = cfg.num_envs, state.gen, state.shard
        for _ in range(num_iters):
            s_idx = env.state_index(state.obs)
            greedy = self._greedy(state.q_table, state.utopian, s_idx)
            u, rand_a, plan_u = self._draws(state)
            actions = torch.where(local(shard, u) < self._epsilon(state.global_step), local(shard, rand_a), greedy)

            out = self.venv.step(state.env_state, actions, gen, shard)
            # bootstrap from the pre-reset obs; a truncated episode still bootstraps
            ns_idx = env.state_index(out.final_obs)
            term = out.terminated.to(torch.float32)
            s_idx, actions, reward, ns_idx, term = gather_rows(shard, (s_idx, actions, out.reward, ns_idx, term))
            if cfg.scalarization == "tchebicheff":
                state.utopian = update_utopian(state.utopian, reward)
            self._td_update(state.q_table, state.utopian, s_idx, actions, reward, ns_idx, term)
            if cfg.dyna:
                self._dyna(state, s_idx, actions, reward, ns_idx, term, plan_u)
            state.env_state, state.obs = out.state, out.obs
            state.global_step += n
        return state

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def act_eval(self, q_table: torch.Tensor, utopian: torch.Tensor, obs: torch.Tensor, w=None, gen=None) -> torch.Tensor:
        return self._greedy(q_table, utopian, self.env.state_index(obs))

    def _policy_eval(self, state: MOQLState, gen: torch.Generator, rep: int = 5):
        act = lambda obs, w, g: self.act_eval(state.q_table, state.utopian, obs)  # noqa: E731
        return policy_evaluation(self.env, act, self.w, gen, rep=rep, gamma=self.cfg.gamma)

    def train(self, total_timesteps: int, eval_freq: int = 10_000, state: MOQLState | None = None) -> MOQLState:
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        iters_total = max(1, total_timesteps // cfg.num_envs)
        seg = max(1, min(eval_freq // cfg.num_envs, iters_total))
        done_iters = 0
        while done_iters < iters_total:
            n = min(seg, iters_total - done_iters)
            self.train_segment(state, n)
            done_iters += n
            ret, disc = self._policy_eval(state, torch.Generator(self.device).manual_seed(done_iters))
            self.logger.log(
                {
                    "eval/scalarized_return": float(self._scalarize(ret, state.utopian)),
                    "eval/scalarized_discounted_return": float(self._scalarize(disc, state.utopian)),
                },
                state.global_step,
            )
            self._last_eval = (ret.cpu().numpy(), disc.cpu().numpy())
        return state
