"""GPI-LS — Generalized Policy Improvement with Linear Support (discrete), on torch.

PyTorch port of ``morl_baselines_tpu/agents/gpils.py`` (reference
multi_policy/gpi_ls_jax/gpi_ls_jax.py:33-830, gpi_pd/gpi_pd.py:41-921;
Alegre et al., 2023):

- psi-network ensemble Q(s, a, w) in R^{A x d}: obs-feature x weight-feature
  product, ``n_critics`` critics stacked on a leading axis, DroQ dropout and
  LayerNorm (reference gpi_ls_jax.py:33-128).
- DroQ target: 2 critics (drawn with replacement if more), min over critics
  of the scalarised next psi, greedy action on the min-psi values
  (reference :359-381); threshold-Huber loss.
- Batch weights: half the envs' task weights, half drawn from the weight
  support M (reference one_update :427-433).
- GPI behaviour policy and evaluation: argmax over policies w' in M of
  max_a w·Q(s, a, w') (reference gpi_action :573-588); per-episode task
  weights resampled from M.
- Outer loop: LinearSupport corner weights with GPI-LS priorities; each
  iteration trains on CCS weights + the top-4 corner weights + w
  (reference train :780-830).

As in the port's Envelope, a segment of (act -> step -> store -> learn)
iterations is a Python loop of tensor ops where the JAX package has one
``lax.scan``; the state is updated **in place**; ``global_step``,
``iter_count`` and ``support_size`` are host integers, so the learn gate and
the target sync never wait on the device; randomness comes from one
``torch.Generator`` on the device.  The GPI forward runs over exactly
``support_size`` support rows: the JAX package pads the support to a static
size and masks the padding with -inf, which never wins an argmax, so the
actions are the same.

The update runs in float32 (``resolve_device`` turns TF32 off on CUDA); on
CUDA the loop's update is one CUDA graph replay (``models.graphed``), its
dropout masks drawn from the state's generator as the eager update draws them.
``bf16_act`` casts the action forward's GEMMs to bfloat16, as the JAX
package's ``q_net_act`` does; the update never does.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.weights import equally_spaced_weights
from ..envs.base import MOEnv
from ..envs.vector import EpisodeStats, VectorMOEnv
from ..evaluation.evaluation import evaluate_front, multi_policy_metrics
from ..models.graphed import GraphedUpdate
from ..models.networks import (
    TrainState,
    WeightConditionedQNet,
    huber,
    polyak_update,
)
from ..ops.adam_step import clip_adam_step_
from ..outer.linear_support import LinearSupport
from ..parallel.mesh import RowShard, gather, gather_rows, local
from ..replay.buffer import ReplayBuffer, Transition
from ..replay.prioritized import PrioritizedReplayBuffer
from ..utils.profiling import span
from ..utils.schedules import linearly_decaying_value, unique_tol
from .base import MOAgentBase


@dataclass(frozen=True)
class GPILSConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.98
    batch_size: int = 128
    buffer_size: int = 100_000
    num_envs: int = 32
    learning_starts: int = 200
    gradient_updates: int = 10
    train_freq: int = 1
    target_net_update_freq: int = 200  # env-iterations
    tau: float = 1.0
    n_critics: int = 2
    dropout_rate: float = 0.01
    use_layernorm: bool = True
    hidden: tuple = (256, 256, 256, 256)
    initial_epsilon: float = 1.0
    final_epsilon: float = 0.05
    epsilon_decay_steps: int = 50_000
    max_grad_norm: float | None = None
    min_priority: float = 0.01
    per: bool = False
    per_alpha: float = 0.6
    max_support: int = 32  # capacity of the weight-support set M
    use_gpi: bool = True
    gpi_type: str = "gpi"  # "gpi" | "ugpi" (pessimistic, reference gpi_ls_jax.py:534)
    pessimism: float = 0.95
    bf16_act: bool = False  # bfloat16 GEMMs in the (N x M) GPI action forward only
    seed: int = 0


@dataclass
class GPILSState:
    ts: TrainState
    buffer: ReplayBuffer | PrioritizedReplayBuffer
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    task_w: torch.Tensor  # (N, d) current per-env task weight (resampled from M at done)
    support: torch.Tensor  # (max_support, d) weight support; rows >= support_size are unused
    support_size: int
    stats: EpisodeStats
    gen: torch.Generator
    global_step: int  # env steps (counts individual env transitions)
    iter_count: int  # actor-learner iterations
    loss: torch.Tensor  # last update's loss (NaN before the first)
    shard: RowShard | None = None  # this rank's rows of the envs (``parallel.shard_agent_state``)

    @property
    def valid_support(self) -> torch.Tensor:
        return self.support[: self.support_size]


class LinearSupportLoop:
    """The weight support and the LinearSupport outer loop shared by the GPI
    agents (reference gpi_ls_jax.py:708-830): the agent supplies ``cfg``,
    ``init_state``, ``train_segment`` and ``eval_weights_values``; its state
    has ``task_w``, ``support``, ``support_size`` and ``global_step``."""

    # --------------------------------------------------------------- support

    def set_weight_support(self, state, weights: list[np.ndarray]):
        """Host-side: install the (deduped, reference utils.unique_tol) support set."""
        ws = unique_tol([np.asarray(w) for w in weights])[: self.cfg.max_support]
        support = np.zeros((self.cfg.max_support, self.reward_dim), dtype=np.float32)
        for i, w in enumerate(ws):
            support[i] = w
        state.support = torch.as_tensor(support, device=self.device)
        state.support_size = max(len(ws), 1)
        return state

    def _batch_weights(self, state, batch_size: int, task_w: torch.Tensor | None = None) -> torch.Tensor:
        """(B, d): the first half the task weights of random envs, the rest
        support rows.  With per-episode resampling the envs' task weights
        diverge, so the half-batch is drawn per row across envs (reference
        one_update :427-433 has one env and uses its one current w).
        ``task_w`` is all envs' task weights, a sharded state's gathered
        once for an iteration's updates; by default gathered here."""
        gen, dev = state.gen, self.device
        half = batch_size // 2
        task_w = gather(state.shard, state.task_w) if task_w is None else task_w
        w1 = task_w[torch.randint(0, self.cfg.num_envs, (half,), generator=gen, device=dev)]
        w2 = state.support[torch.randint(0, state.support_size, (batch_size - half,), generator=gen, device=dev)]
        return torch.cat([w1, w2], dim=0)

    def _eval_np(self, state, weights, rep: int, max_steps: int) -> np.ndarray:
        return self.eval_weights_values(state, weights, rep, max_steps).cpu().numpy()

    # ----------------------------------------------------------------- train

    def _corner_support(self, linear_support: LinearSupport, w: np.ndarray, algo: str) -> list[np.ndarray]:
        """The weight support M of an iteration: CCS weights (+ the top-4 corner weights for gpi-ls) + w."""
        if algo == "gpi-ls":
            return linear_support.get_weight_support() + linear_support.get_corner_weights(top_k=4) + [w]
        return linear_support.get_weight_support() + [w]

    def _next_weight(self, state, linear_support: LinearSupport, algo: str, rep: int, max_steps: int):
        if algo == "gpi-ls":
            self.set_weight_support(state, linear_support.get_weight_support())
            evaluator = lambda ws: self._eval_np(state, ws, rep, max_steps)  # noqa: E731
            return linear_support.next_weight("gpi-ls", gpi_evaluator=evaluator, rng=self._rng)
        return linear_support.next_weight("ols", rng=self._rng)

    def _update_ccs(self, state, linear_support: LinearSupport, w, M, algo: str, rep: int, max_steps: int) -> None:
        """Add the evaluated values of this iteration's weights to the CCS: w
        alone for ols, every support weight for gpi-ls; then install the CCS
        weights as the support."""
        if algo == "ols":
            linear_support.add_solution(self._eval_np(state, np.asarray(w)[None], rep, max_steps)[0], w)
        else:
            M_arr = np.stack(unique_tol([np.asarray(m) for m in M]))
            for wcw, val in zip(M_arr, self._eval_np(state, M_arr, rep, max_steps)):
                linear_support.add_solution(val, wcw)
        self.set_weight_support(state, linear_support.get_weight_support())

    def _log_front(self, state, eval_weights, rep, max_steps, ref_point, known_pareto_front, t0) -> None:
        front = self._eval_np(state, eval_weights, rep, max_steps)
        metrics = multi_policy_metrics(front, np.asarray(ref_point), eval_weights, known_pareto_front)
        metrics["charts/SPS"] = state.global_step / (time.time() - t0)
        self.logger.log(metrics, state.global_step)
        self._last_front = front
        self._last_metrics = metrics

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        num_eval_weights_for_front: int = 32,
        num_eval_episodes_for_front: int = 1,
        timesteps_per_iter: int = 10_000,
        weight_selection_algo: str = "gpi-ls",
        eval_max_steps: int | None = None,
        state=None,
    ):
        """Outer loop (reference gpi_ls_jax.py:708-830): LinearSupport picks
        which weights get trained; the inner iterations run on the device."""
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        rep, algo = num_eval_episodes_for_front, weight_selection_algo
        max_steps = eval_max_steps or self.env.max_episode_steps or 500
        linear_support = LinearSupport(num_objectives=self.reward_dim, epsilon=0.0 if algo == "ols" else None)
        self._rng = random.Random(cfg.seed)
        eval_weights = equally_spaced_weights(self.reward_dim, num_eval_weights_for_front).astype(np.float32)
        max_iter = max(1, total_timesteps // timesteps_per_iter)
        t0 = time.time()

        for _ in range(max_iter):
            w = self._next_weight(state, linear_support, algo, rep, max_steps)
            if w is None:
                break
            M = self._corner_support(linear_support, w, algo)
            self.set_weight_support(state, M)
            state.task_w = torch.as_tensor(w, dtype=torch.float32, device=self.device).repeat(state.task_w.shape[0], 1)

            # -- inner iterations on the device
            self.train_segment(state, max(1, timesteps_per_iter // cfg.num_envs), algo == "gpi-ls")

            self._update_ccs(state, linear_support, w, M, algo, rep, max_steps)

            if ref_point is not None:
                self._log_front(state, eval_weights, rep, max_steps, ref_point, known_pareto_front, t0)
        self._linear_support = linear_support
        return state


class GPILS(LinearSupportLoop, MOAgentBase):
    def __init__(self, env: MOEnv, config: GPILSConfig = GPILSConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.venv = VectorMOEnv(env, config.num_envs)
        # compute dtype of the action forward (the JAX package's q_net_act)
        self.act_dtype = torch.bfloat16 if config.bf16_act else None
        self._graphed = GraphedUpdate()  # the loop's update, a CUDA graph replay on the card

    def make_q_net(self, gen: torch.Generator | None = None) -> WeightConditionedQNet:
        """A freshly initialized critic ensemble on the agent's device."""
        cfg = self.cfg
        net = WeightConditionedQNet(
            self.obs_dim,
            self.env.num_actions,
            self.reward_dim,
            hidden=cfg.hidden,
            dropout_rate=cfg.dropout_rate,
            use_layernorm=cfg.use_layernorm,
            members=cfg.n_critics,
            gen=gen,
        )
        return net.to(self.device)

    def make_train_state(self, net: WeightConditionedQNet) -> TrainState:
        """Online net ``net``, a target copy of it, and the Adam optimizer."""
        target = self.make_q_net()
        target.load_state_dict(net.state_dict())
        target.requires_grad_(False)
        opt = torch.optim.Adam(net.parameters(), lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(net=net, target_net=target, optimizer=opt)

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int | None = None) -> GPILSState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        # params are drawn on the host, so a seed gives the same net on any device
        net = self.make_q_net(torch.Generator().manual_seed(seed))
        gen = torch.Generator(self.device).manual_seed(seed)
        buf_cls = PrioritizedReplayBuffer if cfg.per else ReplayBuffer
        buffer = buf_cls.create(cfg.buffer_size, obs_dim=self.obs_dim, reward_dim=self.reward_dim, device=self.device)
        env_state, obs = self.venv.reset(gen)
        d = self.reward_dim
        support = torch.zeros((cfg.max_support, d), device=self.device)
        support[0] = 1.0 / d
        return GPILSState(
            ts=self.make_train_state(net),
            buffer=buffer,
            env_state=env_state,
            obs=obs,
            task_w=support[0].repeat(cfg.num_envs, 1),
            support=support,
            support_size=1,
            stats=EpisodeStats.create(cfg.num_envs, d, self.device),
            gen=gen,
            global_step=0,
            iter_count=0,
            loss=torch.full((), float("nan"), device=self.device),
        )

    # ------------------------------------------------------------------- act

    @torch.no_grad()
    def _q_values(self, net: WeightConditionedQNet, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(n_critics, B, A, d) forward without dropout, for acting; bfloat16
        GEMMs when ``bf16_act``."""
        return net(obs, w, dtype=self.act_dtype)

    def _gpi_psi(self, net, obs: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
        """(C, N, M, A, d): psi of every env's obs under every support weight,
        one (N*M)-row forward."""
        n, m = obs.shape[0], support.shape[0]
        psi = self._q_values(net, obs.repeat_interleave(m, dim=0), support.repeat(n, 1))
        return psi.reshape(psi.shape[0], n, m, -1, self.reward_dim)

    @staticmethod
    def _argmax_over_policies(q: torch.Tensor) -> torch.Tensor:
        """Actions from q (N, M, A): the best action of the support policy whose best value is highest."""
        pol = torch.argmax(q.max(dim=2).values, dim=1)
        return torch.argmax(q[torch.arange(q.shape[0], device=q.device), pol], dim=1)

    def _gpi_actions(self, net, obs: torch.Tensor, w: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
        """Batched GPI action: argmax over the support policies of max_a w·Q.

        obs (N, O), w (N, d), support (M, d): the valid support rows.
        Reference gpi_action :573-588, vectorized over the env batch.
        """
        psi = self._gpi_psi(net, obs, support).mean(dim=0)
        return self._argmax_over_policies(torch.einsum("nd,nmad->nma", w, psi))

    def _max_actions(self, net, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        psi = self._q_values(net, obs, w)  # (C, N, A, d)
        return torch.argmax(torch.einsum("nd,cnad->cna", w, psi).mean(dim=0), dim=-1)

    # Student-t critical values at n=10, as the reference hardcodes
    # (gpi_ls_jax.py ugpi_action :556-563)
    _TINV = {0.9: 1.383029, 0.95: 1.833113, 0.99: 2.821438}

    def _ugpi_actions(self, net, obs, w, support, pessimism: float = 0.95) -> torch.Tensor:
        """Uncertainty-aware GPI: lower-confidence-bound Q over the critic
        ensemble before the max over support policies (reference ugpi_action
        gpi_ls_jax.py:534-570).  The std is the population std, as jnp.std."""
        q = torch.einsum("nd,cnmad->cnma", w, self._gpi_psi(net, obs, support))
        std = q.std(dim=0, correction=0)
        if pessimism == 1.0:
            q_lcb = q.mean(dim=0) - std
        else:
            q_lcb = q.mean(dim=0) - std / float(np.sqrt(q.shape[0])) * self._TINV.get(pessimism, 1.833113)
        return self._argmax_over_policies(q_lcb)

    # ---------------------------------------------------------------- update

    def _update(self, ts: TrainState, batch: Transition, w: torch.Tensor, gen: torch.Generator):
        """DroQ/min-ensemble update (reference _update_q :341-403), in place;
        returns (loss, PER priority base max_c |w·td_c| (B,))."""
        loss, tds, _ = self._update_with_aux(ts, batch, w, gen)
        # PER priority: max over critics of |w·td| (reference one_update :470-472)
        return loss, torch.einsum("cbd,bd->cb", tds, w).abs().max(dim=0).values

    def _update_with_aux(
        self,
        ts: TrainState,
        batch: Transition,
        w: torch.Tensor,
        gen: torch.Generator,
        critic_inds: torch.Tensor | None = None,
    ):
        """Core TD step, in place; returns (loss, the per-critic TD errors
        (C, B, d), the bootstrap target (B, d)), so that GPIPD derives its
        priorities without a second forward.

        Dropout is on in both forwards (masks from ``gen``).  With more than
        2 critics the target uses 2 drawn with replacement; ``critic_inds``
        passes them in (so a test can give both packages the same ones).
        """
        cfg = self.cfg
        b, d = batch.obs.shape[0], self.reward_dim
        rows = torch.arange(b, device=w.device)
        with torch.no_grad():
            psi_next = ts.target_net(batch.next_obs, w, gen)  # (C, B, A, d)
            if cfg.n_critics > 2:
                if critic_inds is None:
                    critic_inds = torch.randint(0, cfg.n_critics, (2,), generator=gen, device=gen.device)
                psi_next = psi_next[critic_inds]
            q_next = torch.einsum("bd,cbad->cba", w, psi_next)
            min_inds = torch.argmin(q_next, dim=0)  # (B, A)
            min_psi = torch.gather(psi_next, 0, min_inds[None, :, :, None].expand(1, -1, -1, d)).squeeze(0)
            max_acts = torch.argmax(torch.einsum("bd,bad->ba", w, min_psi), dim=1)
            target_psi = batch.reward + (1.0 - batch.terminated[:, None]) * cfg.gamma * min_psi[rows, max_acts]

        psi = ts.net(batch.obs, w, gen)
        tds = psi[:, rows, batch.action.long()] - target_psi[None]  # (C, B, d)
        loss = huber(tds, cfg.min_priority).mean()
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_adam_step_(ts.optimizer, cfg.max_grad_norm)
        return loss.detach(), tds.detach(), target_psi

    # ---------------------------------------------------------- train segment

    def _epsilon(self, global_step: int) -> float:
        # per-env step clock: keeps reference decay budgets meaningful at any num_envs
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

    def _epsilon_greedy(self, state: GPILSState, greedy: torch.Tensor) -> torch.Tensor:
        """Each env's action: ``greedy``'s, or with probability epsilon a random one."""
        n, gen, dev, shard = self.cfg.num_envs, state.gen, self.device, state.shard
        # a shard acts on its rows, drawing for all n envs
        rand_a = local(shard, torch.randint(0, self.env.num_actions, (n,), generator=gen, device=dev))
        explore = local(shard, torch.rand((n,), generator=gen, device=dev)) < self._epsilon(state.global_step)
        return torch.where(explore, rand_a, greedy)

    def _step_and_store(self, state: GPILSState, actions: torch.Tensor, change_w_every_episode: bool) -> None:
        """One vector env step on ``actions``, the transitions stored, task
        weights resampled at done; in place."""
        cfg = self.cfg
        n, gen, dev, shard = cfg.num_envs, state.gen, self.device, state.shard
        out = self.venv.step(state.env_state, actions, gen, shard)
        done = out.terminated | out.truncated
        state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)
        # next_obs must be the pre-reset final obs; a shard's rows are all-gathered
        state.buffer.add_batch(
            gather_rows(
                shard,
                Transition(
                    obs=state.obs,
                    action=actions,
                    reward=out.reward,
                    next_obs=out.final_obs,
                    terminated=out.terminated.to(torch.float32),
                ),
            )
        )
        # per-episode task weight resampled uniformly from the support
        if change_w_every_episode:
            idx = local(shard, torch.randint(0, state.support_size, (n,), generator=gen, device=dev))
            state.task_w = torch.where(done[:, None], state.support[idx], state.task_w)
        state.env_state, state.obs = out.state, out.obs
        state.global_step += n
        state.iter_count += 1

    def train_segment(self, state: GPILSState, num_iters: int, change_w_every_episode: bool = True) -> GPILSState:
        """Run ``num_iters`` actor-learner iterations, updating ``state`` in place."""
        cfg = self.cfg
        ts, buffer = state.ts, state.buffer
        for _ in range(num_iters):
            with span("actor"):
                with span("actor.act"):
                    if cfg.use_gpi:
                        greedy = self._gpi_actions(ts.net, state.obs, state.task_w, state.valid_support)
                    else:
                        greedy = self._max_actions(ts.net, state.obs, state.task_w)
                    actions = self._epsilon_greedy(state, greedy)
                self._step_and_store(state, actions, change_w_every_episode)

            if state.global_step >= cfg.learning_starts and state.iter_count % cfg.train_freq == 0:
                with span("learner"):
                    task_w = gather(state.shard, state.task_w)
                    for _ in range(cfg.gradient_updates):
                        if cfg.per:
                            batch, idx, _probs = buffer.sample(state.gen, cfg.batch_size)
                        else:
                            batch = buffer.sample(state.gen, cfg.batch_size)
                        with span("learner.update"):
                            w = self._batch_weights(state, cfg.batch_size, task_w)
                            state.loss, td_w = self._graphed(self._update, ts, batch, w, state.gen)
                        if cfg.per:
                            buffer.update_priorities(idx, torch.clamp(td_w, min=cfg.min_priority) ** cfg.per_alpha)

            if cfg.tau < 1.0:
                polyak_update(ts.net, ts.target_net, cfg.tau)
            elif state.iter_count % cfg.target_net_update_freq == 0:
                polyak_update(ts.net, ts.target_net, 1.0)
        return state

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def act_eval(self, net, support: torch.Tensor, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GPI actions for a batch of evaluation obs; ugpi applies the LCB ensemble bound."""
        if self.cfg.use_gpi:
            if self.cfg.gpi_type == "ugpi":
                return self._ugpi_actions(net, obs, w, support, self.cfg.pessimism)
            return self._gpi_actions(net, obs, w, support)
        return self._max_actions(net, obs, w)

    def eval_weights_values(self, state: GPILSState, weights, rep: int, max_steps: int) -> torch.Tensor:
        """Discounted GPI-policy value per weight (K, d): all K·rep episodes in
        one batch (replaces the reference's per-corner-weight evaluation
        loops, both for LinearSupport's GPI priorities and for the front)."""
        weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)
        support = state.valid_support
        act = lambda obs, w, g: self.act_eval(state.ts.net, support, obs, w)  # noqa: E731
        gen = torch.Generator(self.device).manual_seed(0)
        return evaluate_front(self.env, act, weights, gen, rep=rep, gamma=self.cfg.gamma, max_steps=max_steps)
