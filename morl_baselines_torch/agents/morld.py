"""MORL/D — multi-objective RL based on decomposition (population outer loop), on torch.

PyTorch port of ``morl_baselines_tpu/agents/morld.py`` (reference
multi_policy/morld/morld.py:37-584, Felten et al., 2023): a population of
scalarized MOSAC learners, one per weight vector from the uniform simplex,
with cooperation:

- a shared replay buffer across the population (reference :245-261);
- parameter transfer to higher-id neighbours in the first round
  (reference __share :337-366);
- PSA weight adaptation (reference __adapt_weights :368-417);
- a ``ParetoArchive`` of member snapshots (reference :208).

Two execution modes, as in the JAX package:

- looped (reference semantics): members train round-robin, one one-member
  MOSAC state each, cooperating through one shared buffer with
  ``update_passes`` off-policy updates of every other member per turn;
- ``vectorized=True``: one MOSAC state of ``pop_size`` members, so the P·N
  envs step as one batch and every member's update is one pass over the
  member axis; each member keeps its own buffer, and in each cooperation
  pass member j learns from the batch sampled out of member
  (j - shift) mod P's buffer (``torch.roll`` along the member axis, as
  ``jnp.roll``).  ``train(mesh=...)`` shards the member axis over the mesh's
  first axis (``parallel.make_mesh``): each rank trains P/W members, drawing
  every random number for all P and keeping its block, and the four steps
  that cross members (the cooperation roll, the first round's neighbour
  copy, the evaluation returns and the returned state) all-gather over the
  ranks, so every rank holds the same archive and weights.

The members are ``MOSAC`` on a continuous (Box) action space and
``MOSACDiscrete`` on a discrete one (the lunar lander showcase), in both modes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.archive import ParetoArchive
from ..core.weights import equally_spaced_weights, random_weights
from ..envs.base import Box, MOEnv
from ..evaluation.evaluation import multi_policy_metrics
from ..models.networks import gather_members_
from ..parallel.mesh import gather, gather_rows, global_rows, local, mesh_shard
from ..replay.buffer import Transition
from ..utils.schedules import nearest_neighbors
from .base import MOAgentBase
from .mosac import MOSAC, MOSACConfig, MOSACDiscrete


@dataclass(frozen=True)
class MORLDConfig:
    pop_size: int = 6
    exchange_every: int = 4000
    neighborhood_size: int = 1
    shared_buffer: bool = True
    update_passes: int = 5
    weight_init_method: str = "uniform"  # or "random"
    weight_adaptation_method: str | None = None  # "PSA" or None
    psa_delta: float = 0.1
    sac: MOSACConfig = MOSACConfig(num_envs=8, learning_starts=500)
    vectorized: bool = False  # train the whole population as one state
    seed: int = 0


def cooperation_shift(r: int, pop: int) -> int:
    """The roll of the sampled batches along the member axis in cooperation pass r."""
    return (r % max(pop - 1, 1)) + 1


def neighbor_sources(neighborhoods: np.ndarray, pop: int) -> np.ndarray:
    """One-shot transfer source of each member: its lower neighbour j - 1 when
    that is in its neighbourhood, else itself (batched reference __share :337-366)."""
    src = np.arange(pop)
    for j in range(1, pop):
        if (j - 1) in neighborhoods[j]:
            src[j] = j - 1
    return src


class MORLD(MOAgentBase):
    def __init__(self, env: MOEnv, config: MORLDConfig = MORLDConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        d = env.reward_dim
        if config.weight_init_method == "uniform":
            ws = equally_spaced_weights(d, config.pop_size)
        else:
            ws = random_weights(torch.Generator().manual_seed(config.seed), d, n=config.pop_size).numpy()
        self.weights = [np.asarray(w, dtype=np.float32) for w in ws]
        agent_cls = MOSAC if isinstance(env.action_space, Box) else MOSACDiscrete
        self.population = [agent_cls(env, weights=w, config=config.sac, device=self.device) for w in self.weights]
        self.neighborhoods = nearest_neighbors(np.stack(self.weights), config.neighborhood_size)
        self.archive = ParetoArchive()

    def _log_metrics(self, ref_point, known_front, global_step: int) -> None:
        if ref_point is not None and len(self.archive):
            ew = equally_spaced_weights(self.reward_dim, 32)
            metrics = multi_policy_metrics(self.archive.front, np.asarray(ref_point), ew, known_front)
            self.logger.log(metrics, global_step)
            self._last_metrics = metrics

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        mesh=None,
        eval_max_steps: int | None = None,
    ):
        """Rounds until ``total_timesteps``; returns the vectorized mode's
        population state (all P members, gathered from the ranks of
        ``mesh``, a ``DeviceMesh`` whose first axis shards the members) or
        the looped mode's list of one-member states (which ignores ``mesh``)."""
        if self.cfg.vectorized:
            return self._train_vectorized(total_timesteps, ref_point, known_pareto_front, mesh, eval_max_steps)
        cfg = self.cfg
        states = [agent.init_state(cfg.seed + i) for i, agent in enumerate(self.population)]
        shared_buffer = self.population[0].make_buffer() if cfg.shared_buffer else None
        buffers = [None if cfg.shared_buffer else a.make_buffer() for a in self.population]

        global_step = 0
        iteration = 0
        candidate = 0
        evals: List[np.ndarray] = [np.zeros(self.reward_dim) for _ in self.population]
        seg_iters = max(1, cfg.exchange_every // cfg.sac.num_envs)

        while global_step < total_timesteps:
            agent, state = self.population[candidate], states[candidate]
            agent.train_segment(state, shared_buffer if cfg.shared_buffer else buffers[candidate], seg_iters)
            global_step += seg_iters * cfg.sac.num_envs

            # cooperation: off-policy update passes for the rest on the shared buffer
            if cfg.shared_buffer and cfg.update_passes > 0:
                for j, (other, ostate) in enumerate(zip(self.population, states)):
                    if j == candidate:
                        continue
                    for _ in range(cfg.update_passes):
                        other.update_once(ostate, shared_buffer.sample(ostate.gen, cfg.sac.batch_size))

            # neighbour parameter transfer in the first round (reference :337-366), as copies
            if iteration < len(self.population):
                src = states[candidate]
                for n in self.neighborhoods[candidate]:
                    if n > candidate:
                        dst = states[n]
                        dst.actor.load_state_dict(src.actor.state_dict())
                        dst.critic.net.load_state_dict(src.critic.net.state_dict())
                        dst.critic.target_net.load_state_dict(src.critic.target_net.state_dict())

            # evaluate all policies, refresh the archive (reference :306-335)
            for j, (a, s) in enumerate(zip(self.population, states)):
                gen = torch.Generator(self.device).manual_seed(iteration * 97 + j)
                _, disc = a.policy_eval(s, gen, 3, max_steps=eval_max_steps)
                evals[j] = disc[0].cpu().numpy()
                self.archive.add((j, a.member_params(s, 0)), evals[j])

            if cfg.weight_adaptation_method == "PSA":
                self._adapt_weights_psa(evals)
            self._log_metrics(ref_point, known_pareto_front, global_step)
            candidate = (candidate + 1) % len(self.population)
            iteration += 1

        self._states = states
        self._last_front = self.archive.front
        return states

    def _psa_weight(self, ev: np.ndarray, w: np.ndarray) -> np.ndarray:
        """PSA update for one member's weight given its evaluation (reference :368-417)."""
        delta = self.cfg.psa_delta
        closest_eval, closest_d = None, np.inf
        for cand_eval in self.archive.evaluations:
            dist = float(np.sum((ev - cand_eval) ** 2))
            if 0.01 < dist < closest_d:
                closest_d, closest_eval = dist, cand_eval
        if closest_eval is None:
            return w
        w = w.copy()
        for k in range(len(ev)):
            w[k] = w[k] * (1 + delta) if ev[k] >= closest_eval[k] else w[k] / (1 + delta)
        return (w / np.sum(np.abs(w))).astype(np.float32)

    def _adapt_weights_psa(self, evals: List[np.ndarray]) -> None:
        for i, agent in enumerate(self.population):
            w = self._psa_weight(evals[i], self.weights[i])
            self.weights[i] = w
            agent.set_weights(w)

    # ------------------------------------------------------ vectorized mode

    def _pop_step(self, state, buffer, weights: torch.Tensor, seg_iters: int, update_passes: int) -> None:
        """One population round in place: every member's train segment, then
        the neighbour-batch cooperation passes."""
        agent, shard = self.population[0], state.shard
        agent.train_segment(state, buffer, seg_iters, weights)
        pop = global_rows(shard, weights.shape[0])
        for r in range(update_passes):
            # member j learns from member (j - shift) mod P's experience, as
            # jnp.roll; sharded, the roll runs over every rank's batches
            batches = gather_rows(shard, agent.sample(state, buffer))
            shift = cooperation_shift(r, pop)
            agent._update(state, local(shard, Transition(*(torch.roll(x, shift, dims=0) for x in batches))), weights)

    def _train_vectorized(self, total_timesteps, ref_point, known_pareto_front, mesh=None, eval_max_steps=None):
        cfg = self.cfg
        pop = cfg.pop_size
        agent = self.population[0]
        shard = None if mesh is None else mesh_shard(mesh)
        state = agent.init_state([cfg.seed + i for i in range(pop)], shard)
        buffer = agent.make_buffer(state.members)
        weights = local(shard, torch.as_tensor(np.stack(self.weights), dtype=torch.float32, device=self.device))
        src = neighbor_sources(self.neighborhoods, pop)

        seg_iters = max(1, cfg.exchange_every // cfg.sac.num_envs)
        passes = cfg.update_passes if cfg.shared_buffer else 0
        global_step, iteration = 0, 0
        while global_step < total_timesteps:
            self._pop_step(state, buffer, weights, seg_iters, passes)
            global_step += seg_iters * cfg.sac.num_envs * pop

            if iteration == 0 and cfg.neighborhood_size > 0:
                gather_members_(state.actor, src, shard=shard)
                gather_members_(state.critic.net, src, per=2, shard=shard)
                gather_members_(state.critic.target_net, src, per=2, shard=shard)

            gen = torch.Generator(self.device).manual_seed(cfg.seed + iteration)
            _, discs = agent.policy_eval(state, gen, 3, weights, max_steps=eval_max_steps)
            evals = gather(shard, discs).cpu().numpy()
            for j, params in enumerate(agent.all_member_params(state)):
                self.archive.add((j, params), evals[j])

            if cfg.weight_adaptation_method == "PSA":
                self.weights = [self._psa_weight(evals[j], self.weights[j]) for j in range(pop)]
                weights = local(shard, torch.as_tensor(np.stack(self.weights), device=self.device))

            self._log_metrics(ref_point, known_pareto_front, global_step)
            iteration += 1

        self._pop_state = agent.gather_state(state)
        self._last_front = self.archive.front
        return self._pop_state
