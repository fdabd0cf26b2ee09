"""GPI-LS continuous-action — weight-conditioned TD3 with a GPI evaluation policy, on torch.

PyTorch port of ``morl_baselines_tpu/agents/gpils_continuous.py`` (reference
multi_policy/gpi_pd/gpi_pd_continuous_action.py:34-713,
gpi_ls_continuous_action_jax.py:36-1046):

- a deterministic weight-conditioned actor mu(s, w) and ``n_critics``
  critics Q(s, a, w) in R^d, by default with the BatchRenorm + WeightNorm +
  leaky-relu + dropout recipe (``models/continuous.py``);
- the target: the minimum over critics, by scalarized Q, at the smoothed
  target action; the critic loss in train mode (the batch statistics
  update, dropout on); the actor updated every ``policy_freq`` iterations
  against the critic in eval mode; Adam without clipping; Polyak averaging
  of the params and the float batch statistics, step counters copied;
- the PER priority of the JAX package: the pre-update first critic's
  |q - target| * 0.05, scalarized;
- random actions before ``learning_starts``, task weights resampled from the
  support per episode, batch weights half task, half support;
- GPI evaluation: each support policy's action, scored by the critics under
  the evaluation weight, over exactly ``support_size`` support rows;
- the LinearSupport outer loop (``LinearSupportLoop``).

As in the port's discrete agents, a segment is a Python loop of tensor ops
where the JAX package has one ``lax.scan``; the state is updated in place;
``global_step`` and ``iter_count`` are host integers; randomness comes from
one ``torch.Generator`` on the device.  Because the update is in place, the
PER priority is computed before the critic's step, from the same pre-update
critic and statistics the JAX package reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..envs.base import Box, MOEnv
from ..envs.vector import EpisodeStats, VectorMOEnv
from ..evaluation.evaluation import evaluate_front
from ..models.continuous import ContinuousQNet, DeterministicActor, StabilizedActor, StabilizedQNet
from ..models.networks import TrainState, polyak_update
from ..outer.linear_support import LinearSupport
from ..parallel.mesh import RowShard, gather, gather_rows, global_rows, local
from ..replay.buffer import ReplayBuffer, Transition
from ..replay.prioritized import PrioritizedReplayBuffer
from ..utils.schedules import unique_tol
from .base import MOAgentBase
from .gpils import LinearSupportLoop


@dataclass(frozen=True)
class GPILSContinuousConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 128
    buffer_size: int = 400_000
    num_envs: int = 16
    learning_starts: int = 1000
    gradient_updates: int = 1
    policy_freq: int = 2
    n_critics: int = 2
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    exploration_noise: float = 0.1
    hidden: tuple = (256, 256)
    max_support: int = 32
    use_gpi: bool = True
    # the stability recipe of the reference's JAX continuous critics
    # (gpi_ls_continuous_action_jax.py:63-107): BatchRenorm + WeightNorm +
    # leaky-relu + dropout; False gives the plain ReLU nets
    use_batch_renorm: bool = True
    dropout_rate: float = 0.01
    batch_norm_momentum: float = 0.99
    seed: int = 0


@dataclass
class GPILSContState:
    actor: TrainState
    critic: TrainState
    buffer: ReplayBuffer | PrioritizedReplayBuffer
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    task_w: torch.Tensor  # (N, d)
    support: torch.Tensor  # (max_support, d); rows >= support_size are unused
    support_size: int
    stats: EpisodeStats
    gen: torch.Generator
    global_step: int  # env steps
    iter_count: int  # actor-learner iterations
    loss: torch.Tensor  # last critic loss (NaN before the first update)
    shard: RowShard | None = None  # this rank's rows of the envs (``parallel.shard_agent_state``)

    @property
    def valid_support(self) -> torch.Tensor:
        return self.support[: self.support_size]


class GPILSContinuous(LinearSupportLoop, MOAgentBase):
    def __init__(
        self, env: MOEnv, config: GPILSContinuousConfig = GPILSContinuousConfig(), log: bool = False, device="cuda"
    ):
        super().__init__(env, config, log=log, device=device)
        if not isinstance(env.action_space, Box):
            raise ValueError("GPILSContinuous needs a continuous (Box) action space")
        self.cfg = config
        self.venv = VectorMOEnv(env, config.num_envs)
        self.action_dim = env.action_dim

    # ------------------------------------------------------------------ nets

    def make_actor(self, gen: torch.Generator | None = None):
        cfg = self.cfg
        if cfg.use_batch_renorm:
            net = StabilizedActor(
                self.obs_dim, self.reward_dim, self.action_dim, cfg.hidden, cfg.batch_norm_momentum, gen
            )
        else:
            net = DeterministicActor(self.obs_dim, self.reward_dim, self.action_dim, cfg.hidden, gen)
        return net.to(self.device)

    def make_critic(self, gen: torch.Generator | None = None):
        """The ensemble of ``n_critics`` critics, outputs (C, B, d)."""
        cfg = self.cfg
        if cfg.use_batch_renorm:
            net = StabilizedQNet(
                self.obs_dim, self.action_dim, self.reward_dim, cfg.hidden, cfg.dropout_rate,
                cfg.batch_norm_momentum, members=cfg.n_critics, gen=gen,
            )
        else:
            net = ContinuousQNet(self.obs_dim, self.action_dim, self.reward_dim, cfg.hidden, members=cfg.n_critics, gen=gen)
        return net.to(self.device)

    def make_train_state(self, net, make) -> TrainState:
        """``net``, a target copy of it (params and batch statistics), and Adam."""
        target = make()
        target.load_state_dict(net.state_dict())
        target.requires_grad_(False)
        opt = torch.optim.Adam(net.parameters(), lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(net=net, target_net=target, optimizer=opt)

    # ------------------------------------------------------------------ init

    def _make_buffer(self, capacity: int, prioritized: bool = False):
        cls = PrioritizedReplayBuffer if prioritized else ReplayBuffer
        return cls.create(
            capacity, obs_dim=self.obs_dim, action_shape=(self.action_dim,), reward_dim=self.reward_dim,
            action_dtype=torch.float32, device=self.device,
        )

    def init_state(self, seed: int | None = None) -> GPILSContState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        # params are drawn on the host, so a seed gives the same nets on any device
        host = torch.Generator().manual_seed(seed)
        actor, critic = self.make_actor(host), self.make_critic(host)
        gen = torch.Generator(self.device).manual_seed(seed)
        env_state, obs = self.venv.reset(gen)
        d = self.reward_dim
        support = torch.zeros((cfg.max_support, d), device=self.device)
        support[0] = 1.0 / d
        return GPILSContState(
            actor=self.make_train_state(actor, self.make_actor),
            critic=self.make_train_state(critic, self.make_critic),
            buffer=self._make_buffer(cfg.buffer_size),
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

    # ---------------------------------------------------------------- update

    def _explore(self, actions: torch.Tensor, gen: torch.Generator, shard: RowShard | None = None) -> torch.Tensor:
        """Gaussian exploration noise, clipped to the action box (a shard's
        rows of the noise drawn for all envs)."""
        shape = (global_rows(shard, actions.shape[0]), *actions.shape[1:])
        noise = local(shard, torch.randn(shape, generator=gen, device=actions.device)) * self.cfg.exploration_noise
        return torch.clamp(actions + noise, -1.0, 1.0)

    @torch.no_grad()
    def td_target(
        self, state: GPILSContState, batch: Transition, w: torch.Tensor, smoothing_noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        """(B, d): r + gamma (1 - term) Q_c*(s', a'), a' the target actor's
        action plus clipped smoothing noise, c* the critic of least
        scalarized Q (reference :395-403).  ``smoothing_noise`` ((B, A)
        standard normals) is drawn from the state's generator unless given."""
        cfg, gen = self.cfg, state.gen
        if smoothing_noise is None:
            smoothing_noise = torch.randn((batch.obs.shape[0], self.action_dim), generator=gen, device=gen.device)
        noise = torch.clamp(smoothing_noise * cfg.policy_noise, -cfg.noise_clip, cfg.noise_clip)
        next_a = torch.clamp(state.actor.target_net(batch.next_obs, w) + noise, -1.0, 1.0)
        q_next = state.critic.target_net(batch.next_obs, next_a, w)  # (C, B, d)
        min_ind = torch.argmin(torch.einsum("cbd,bd->cb", q_next, w), dim=0)
        min_q = torch.gather(q_next, 0, min_ind[None, :, None].expand(1, -1, q_next.shape[-1])).squeeze(0)
        return batch.reward + (1.0 - batch.terminated[:, None]) * cfg.gamma * min_q

    def _update(
        self,
        state: GPILSContState,
        batch: Transition,
        w: torch.Tensor,
        smoothing_noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One TD3 step in place (JAX ``_update``); returns the PER priority
        base td_w (B,)."""
        cfg = self.cfg
        actor, critic, gen = state.actor, state.critic, state.gen
        brn = cfg.use_batch_renorm
        target = self.td_target(state, batch, w, smoothing_noise)
        with torch.no_grad():
            # the first pre-update critic's per-dim |q - target| * 0.05, scalarized (reference :412-416)
            q_pred = critic.net(batch.obs, batch.action, w)
            td_w = torch.einsum("bd,bd->b", torch.abs(q_pred[0] - target) * 0.05, w)

        q = critic.net(batch.obs, batch.action, w, train=brn, dropout_gen=gen if brn else None)
        state.loss = torch.mean((q - target[None]) ** 2)
        critic.optimizer.zero_grad(set_to_none=True)
        state.loss.backward()
        critic.optimizer.step()
        state.loss = state.loss.detach()

        if state.iter_count % cfg.policy_freq == 0:
            a = actor.net(batch.obs, w, train=brn)
            q = critic.net(batch.obs, a, w)  # eval mode: running statistics, no update
            actor_loss = -torch.mean(torch.einsum("bd,bd->b", q.mean(dim=0), w))
            actor.optimizer.zero_grad(set_to_none=True)
            actor_loss.backward(inputs=list(actor.net.parameters()))
            actor.optimizer.step()
            polyak_update(actor.net, actor.target_net, cfg.tau)
        polyak_update(critic.net, critic.target_net, cfg.tau)
        return td_w

    # ---------------------------------------------------------- train segment

    def _act_and_store(self, state: GPILSContState, change_w_every_episode: bool) -> None:
        """Exploration actions (uniform before ``learning_starts``), one vector
        env step, the transitions stored, task weights resampled at done."""
        cfg = self.cfg
        n, gen, dev, shard = cfg.num_envs, state.gen, self.device, state.shard
        if state.global_step < cfg.learning_starts:
            actions = local(shard, torch.rand((n, self.action_dim), generator=gen, device=dev)) * 2.0 - 1.0
        else:
            with torch.no_grad():
                actions = self._explore(state.actor.net(state.obs, state.task_w), gen, shard)
        out = self.venv.step(state.env_state, actions, gen, shard)
        done = out.terminated | out.truncated
        state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)
        state.buffer.add_batch(
            gather_rows(
                shard,
                Transition(
                    obs=state.obs, action=actions, reward=out.reward, next_obs=out.final_obs,
                    terminated=out.terminated.to(torch.float32),
                ),
            )
        )
        if change_w_every_episode:
            idx = local(shard, torch.randint(0, state.support_size, (n,), generator=gen, device=dev))
            state.task_w = torch.where(done[:, None], state.support[idx], state.task_w)
        state.env_state, state.obs = out.state, out.obs
        state.global_step += n
        state.iter_count += 1

    def train_segment(
        self, state: GPILSContState, num_iters: int, change_w_every_episode: bool = True
    ) -> GPILSContState:
        """Run ``num_iters`` actor-learner iterations, updating ``state`` in place."""
        cfg = self.cfg
        for _ in range(num_iters):
            self._act_and_store(state, change_w_every_episode)
            if state.global_step >= cfg.learning_starts:
                task_w = gather(state.shard, state.task_w)
                for _ in range(cfg.gradient_updates):
                    batch = state.buffer.sample(state.gen, cfg.batch_size)
                    self._update(state, batch, self._batch_weights(state, cfg.batch_size, task_w))
        return state

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def _gpi_actions(self, actor, critic, obs: torch.Tensor, w: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
        """GPI action (reference gpi_pd_continuous_action.py:454-485): each
        support policy's action, scored by the mean over critics of its Q
        under the support weight, scalarized by w; obs (N, O), w (N, d),
        support (M, d) the valid rows; one (N*M)-row forward."""
        n, m = obs.shape[0], support.shape[0]
        obs_m, w_m = obs.repeat_interleave(m, dim=0), support.repeat(n, 1)
        acts = actor(obs_m, w_m)  # (N*M, A)
        q = critic(obs_m, acts, w_m)  # (C, N*M, d)
        scal = torch.einsum("cnmd,nd->cnm", q.reshape(q.shape[0], n, m, -1), w).mean(dim=0)
        best = torch.argmax(scal, dim=1)
        return acts.reshape(n, m, -1)[torch.arange(n, device=obs.device), best]

    @torch.no_grad()
    def act_eval(self, state: GPILSContState, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if not self.cfg.use_gpi:
            return state.actor.net(obs, w)
        return self._gpi_actions(state.actor.net, state.critic.net, obs, w, state.valid_support)

    def eval_weights_values(self, state: GPILSContState, weights, rep: int, max_steps: int) -> torch.Tensor:
        """Discounted GPI-policy value per weight (K, d), all K·rep episodes in one batch."""
        weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)
        act = lambda obs, w, g: self.act_eval(state, obs, w)  # noqa: E731
        gen = torch.Generator(self.device).manual_seed(0)
        return evaluate_front(self.env, act, weights, gen, rep=rep, gamma=self.cfg.gamma, max_steps=max_steps)

    def _update_ccs(self, state, linear_support: LinearSupport, w, M, algo: str, rep: int, max_steps: int) -> None:
        """Every support weight's value joins the CCS, for ols too (JAX ``train``)."""
        M_arr = np.stack(unique_tol([np.asarray(m) for m in M]))
        for wcw, val in zip(M_arr, self._eval_np(state, M_arr, rep, max_steps)):
            linear_support.add_solution(val, wcw)
        self.set_weight_support(state, linear_support.get_weight_support())
