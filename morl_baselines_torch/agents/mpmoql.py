"""MPMOQLearning — multi-policy tabular MOQL driven by LinearSupport.

PyTorch port of ``morl_baselines_tpu/agents/mpmoql.py`` (reference
multi_policy/multi_policy_moqlearning/mp_mo_q_learning.py:22-279): an outer
loop that trains one ``MOQLearning`` policy per weight chosen by random,
OLS or GPI-LS selection, with Q-table transfer from the best CCS policy
(reference :240-242) and GPI action selection over every policy's
scalarized Q-table (reference :125-139).

The GPI policy over P policies is one (P, S, A, d) einsum; the GPI-LS
evaluator rolls out every corner weight in one batch.  A transferred table
is copied, since the port's ``train_segment`` updates its table in place
where the JAX package shares immutable arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.weights import equally_spaced_weights, random_weights
from ..envs.base import MOEnv
from ..evaluation.evaluation import evaluate_front, multi_policy_metrics, policy_evaluation
from ..outer.linear_support import LinearSupport
from .base import MOAgentBase
from .moql import MOQLearning, MOQLearningConfig, MOQLState


@dataclass(frozen=True)
class MPMOQLConfig:
    num_timesteps_per_iteration: int = 10_000
    weight_selection_algo: str = "ols"  # "random" | "ols" | "gpi-ls"
    epsilon_ols: float = 1e-5
    transfer_q_table: bool = True
    moql: MOQLearningConfig = MOQLearningConfig()
    seed: int = 0


class MPMOQLearning(MOAgentBase):
    def __init__(self, env: MOEnv, config: MPMOQLConfig = MPMOQLConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.policies: List[MOQLearning] = []
        self.states: List[MOQLState] = []
        self.policy_weights: List[np.ndarray] = []

    # -- GPI over all trained policies (reference :125-139) -----------------

    @torch.no_grad()
    def gpi_action(self, q_tables: torch.Tensor, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """argmax_a max_p w·Q_p(s, a) for a batch: q_tables (P, S, A, d), obs (M, obs_dim), w (M, d)."""
        q = q_tables[:, self.env.state_index(obs)]  # (P, M, A, d)
        return torch.argmax(torch.einsum("pmad,md->pma", q, w).max(dim=0).values, dim=-1)

    def _eval_weight(self, policy_idx: int, w: np.ndarray, rep: int = 3) -> np.ndarray:
        agent, state = self.policies[policy_idx], self.states[policy_idx]
        act = lambda obs, wv, g: agent.act_eval(state.q_table, state.utopian, obs)  # noqa: E731
        wt = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        gen = torch.Generator(self.device).manual_seed(policy_idx)
        _, disc = policy_evaluation(self.env, act, wt, gen, rep, self.cfg.moql.gamma)
        return disc.cpu().numpy()

    def _gpi_evaluator(self, weights: np.ndarray) -> np.ndarray:
        """GPI-evaluated value of each corner weight (K, d): 2 episodes each, all in one batch."""
        q_tables = torch.stack([s.q_table for s in self.states])
        act = lambda obs, w, g: self.gpi_action(q_tables, obs, w)  # noqa: E731
        ws = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        gen = torch.Generator(self.device).manual_seed(123)
        return evaluate_front(self.env, act, ws, gen, rep=2, gamma=self.cfg.moql.gamma).cpu().numpy()

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        num_eval_weights_for_front: int = 32,
    ) -> List[MOQLState]:
        cfg = self.cfg
        d = self.reward_dim
        linear_support = LinearSupport(num_objectives=d, epsilon=cfg.epsilon_ols)
        max_iters = max(1, total_timesteps // cfg.num_timesteps_per_iteration)

        for it in range(max_iters):
            if cfg.weight_selection_algo == "random":
                w = random_weights(torch.Generator().manual_seed(cfg.seed + it), d).double().numpy()
            elif cfg.weight_selection_algo == "ols":
                w = linear_support.next_weight("ols")
            else:
                w = linear_support.next_weight(
                    "gpi-ls", gpi_evaluator=self._gpi_evaluator if self.states else (lambda ws: np.zeros_like(ws))
                )
            if w is None:
                break

            agent = MOQLearning(self.env, weights=w, config=cfg.moql, device=self.device)
            state = agent.init_state(cfg.seed * 1000 + it)
            # Q-table transfer from the best CCS policy for w (reference :240-242)
            if cfg.transfer_q_table and linear_support.ccs:
                best = int(np.argmax(np.stack(linear_support.ccs) @ np.asarray(w)))
                if best < len(self.states):
                    state.q_table = self.states[best].q_table.clone()
            agent.train_segment(state, max(1, cfg.num_timesteps_per_iteration // cfg.moql.num_envs))

            self.policies.append(agent)
            self.states.append(state)
            self.policy_weights.append(np.asarray(w))
            linear_support.add_solution(self._eval_weight(len(self.policies) - 1, w), w)

            if ref_point is not None and linear_support.ccs:
                ew = equally_spaced_weights(d, num_eval_weights_for_front)
                front = np.stack(linear_support.ccs)
                metrics = multi_policy_metrics(front, np.asarray(ref_point), ew, known_pareto_front)
                self.logger.log(metrics, (it + 1) * cfg.num_timesteps_per_iteration)
                self._last_metrics = metrics
                self._last_front = front

        self._linear_support = linear_support
        return self.states
