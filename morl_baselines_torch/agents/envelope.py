"""Envelope Q-Learning — device-resident actor-learner on torch.

PyTorch port of ``morl_baselines_tpu/agents/envelope.py`` (reference
multi_policy/envelope/envelope.py:33-573; Yang et al., 2019):

- Q(s, w) in R^{A x d} conditioned on the weight vector (reference :33-77).
- Envelope TD target: online-net argmax over (sampled weights w', actions)
  of w·Q(s', a, w'), evaluated on the target net (reference :404-440).
- Homotopy loss (1-λ)·MSE(Q, y) + λ·MSE(w·Q, w·y), λ linearly scheduled
  (reference :309-313, 348-355).
- Per-episode Gaussian weight resampling (reference :526-569); optional PER
  with priorities (|w·td| + min_priority)^alpha (reference :329-334, 507-525).
- ``image_shape``: a NatureCNN trunk on flat stacked frames (the pixel DST
  under the mario wrapper stack).  The envelope target runs each net's trunk
  once a distinct next frame of the batch, and only the head on the tiled rows.

``num_envs`` envs live on the device and a segment of (act -> step -> store
-> learn) iterations is a Python loop of tensor ops, where the JAX package
has one ``lax.scan``.  The state (nets, optimizer, replay buffer, env state)
is updated **in place**; ``global_step`` and ``iter_count`` are host
integers, so the learn gate and the hard target sync never wait on the
device.  Randomness comes from one ``torch.Generator`` on the device.

The Q-net runs in full float32 (``resolve_device`` turns TF32 off on CUDA),
or with ``bf16`` its Dense layers in bfloat16 at every call (the act
forward, both nets of the envelope target, the loss and the evaluation), as
the JAX package builds its Q-net with ``dtype=bfloat16``; params, optimizer
and Q-values stay float32.
The optimizer is the reference's ``optax.chain(clip_by_global_norm, adam)``:
optax's clip (``clip_grad_global_norm_``), then ``torch.optim.Adam`` with
optax's betas and eps, as one call (``ops.adam_step.clip_adam_step_``: on
CUDA two hand-written kernels).  On CUDA the one-seed
loop's update is one CUDA graph replay (``models.graphed.GraphedUpdate``); on
the CPU it runs eagerly.

A seed axis (``init_state_seeds``, the JAX package's ``jax.vmap`` over
``init_state``/``train_segment``/``_eval_front`` in the sweep's stacked
trial): S seeds train as one ``EnvelopeSeedsState`` whose Q-net, target,
optimizer (``MemberAdam`` after a clip per seed), replay and S·N envs carry
the seed axis first, so the S seeds share one stream of launches.  The
target, the update, the act and the loop are the one-seed ones, written over
an optional leading seed axis; the stacked update stays eager.  Member s
starts from the one-seed init of ``seeds[s]``.  The learn gate, the
schedules and the target sync are shared, as ``global_step`` is equal for
every seed; one generator serves all seeds.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.weights import equally_spaced_weights, random_weights
from ..envs.base import MOEnv
from ..envs.vector import EpisodeStats, VectorMOEnv
from ..evaluation.evaluation import evaluate_front, multi_policy_metrics
from ..models.graphed import GraphedUpdate
from ..models.networks import (
    EnvelopeQNet,
    MemberAdam,
    TrainState,
    clip_grad_global_norm_members_,
    polyak_update,
    stack_members,
)
from ..ops.adam_step import clip_adam_step_
from ..parallel.mesh import RowShard, gather_rows, local
from ..replay.buffer import MemberReplayBuffer, ReplayBuffer, Transition
from ..replay.prioritized import MemberPrioritizedReplayBuffer, PrioritizedReplayBuffer
from ..utils.profiling import span
from ..utils.schedules import linearly_decaying_value
from .base import MOAgentBase


@dataclass(frozen=True)
class EnvelopeConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.98
    batch_size: int = 128
    buffer_size: int = 100_000
    num_envs: int = 32
    learning_starts: int = 200
    train_freq: int = 1  # env-iterations between updates (each steps num_envs envs)
    gradient_updates: int = 1
    target_net_update_freq: int = 200  # in env-iterations
    tau: float = 1.0
    num_sample_w: int = 4
    initial_epsilon: float = 1.0
    final_epsilon: float = 0.05
    epsilon_decay_steps: int = 50_000
    initial_homotopy_lambda: float = 0.0
    final_homotopy_lambda: float = 1.0
    homotopy_decay_steps: int = 100_000
    max_grad_norm: float = 1.0
    per: bool = False
    per_alpha: float = 0.6
    min_priority: float = 0.01
    hidden: tuple = (256, 256, 256, 256)
    bf16: bool = False  # bfloat16 compute in the Q-net's Dense layers (params and outputs stay f32)
    image_shape: tuple | None = None  # (k, H, W): NatureCNN trunk on flat image obs
    seed: int = 0


@dataclass
class EnvelopeState:
    ts: TrainState
    buffer: ReplayBuffer | PrioritizedReplayBuffer
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    weights: torch.Tensor  # (N, d) current per-env episode weight
    stats: EpisodeStats
    gen: torch.Generator
    global_step: int  # env steps (counts individual env transitions)
    iter_count: int  # actor-learner iterations
    loss: torch.Tensor  # last update's loss (NaN before the first)
    shard: RowShard | None = None  # this rank's rows of the envs (``parallel.shard_agent_state``)


@dataclass
class EnvelopeSeedsState:
    """S seeds of ``EnvelopeState`` on a leading seed axis."""

    ts: TrainState  # EnvelopeQNet(members=S), its target copy, MemberAdam
    buffer: MemberReplayBuffer | MemberPrioritizedReplayBuffer
    venv: VectorMOEnv  # S·N envs, seed-major
    env_state: tuple
    obs: torch.Tensor  # (S, N, obs_dim)
    weights: torch.Tensor  # (S, N, d)
    stats: EpisodeStats  # S·N rows
    gen: torch.Generator  # shared by every seed
    global_step: int  # env steps of each seed
    iter_count: int
    loss: torch.Tensor  # (S,) each seed's last loss (NaN before the first)

    @property
    def members(self) -> int:
        return self.obs.shape[0]


class Envelope(MOAgentBase):
    def __init__(self, env: MOEnv, config: EnvelopeConfig = EnvelopeConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.dtype = torch.bfloat16 if config.bf16 else None  # the Q-net's compute dtype at every call
        self.venv = VectorMOEnv(env, config.num_envs)
        self._graphed = GraphedUpdate()  # the one-seed loop's update, a CUDA graph replay on the card

    def make_q_net(self, gen: torch.Generator | None = None) -> EnvelopeQNet:
        """A freshly initialized Q-net on the agent's device."""
        cfg = self.cfg
        net = EnvelopeQNet(self.obs_dim, self.env.num_actions, self.reward_dim, cfg.hidden, gen, cfg.image_shape)
        return net.to(self.device)

    def make_train_state(self, net: EnvelopeQNet) -> TrainState:
        """Online net ``net``, a target copy of it, and the Adam optimizer."""
        target = self.make_q_net()
        target.load_state_dict(net.state_dict())
        target.requires_grad_(False)
        opt = torch.optim.Adam(net.parameters(), lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(net=net, target_net=target, optimizer=opt)

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int | None = None) -> EnvelopeState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        # params are drawn on the host, so a seed gives the same net on any device
        net = self.make_q_net(torch.Generator().manual_seed(seed))
        gen = torch.Generator(self.device).manual_seed(seed)
        buf_cls = PrioritizedReplayBuffer if cfg.per else ReplayBuffer
        buffer = buf_cls.create(cfg.buffer_size, obs_dim=self.obs_dim, reward_dim=self.reward_dim, device=self.device)
        env_state, obs = self.venv.reset(gen)
        return EnvelopeState(
            ts=self.make_train_state(net),
            buffer=buffer,
            env_state=env_state,
            obs=obs,
            weights=random_weights(gen, self.reward_dim, n=cfg.num_envs, dist="gaussian"),
            stats=EpisodeStats.create(cfg.num_envs, self.reward_dim, self.device),
            gen=gen,
            global_step=0,
            iter_count=0,
            loss=torch.full((), float("nan"), device=self.device),
        )

    def init_state_seeds(self, seeds) -> EnvelopeSeedsState:
        """One state of ``len(seeds)`` seeds on a leading axis; member s's
        Q-net (its NatureCNN trunk too, with ``image_shape``) equals
        ``init_state(seeds[s])``'s.  The envs, episode weights and batches
        draw from one generator seeded ``seeds[0]``."""
        cfg = self.cfg
        seeds = [int(x) for x in seeds]
        S, n, dev = len(seeds), cfg.num_envs, self.device
        make = lambda members, gen: EnvelopeQNet(  # noqa: E731
            self.obs_dim, self.env.num_actions, self.reward_dim, cfg.hidden, gen, cfg.image_shape, members=members
        )
        net = stack_members(make, seeds).to(dev)
        target = copy.deepcopy(net).requires_grad_(False)
        gen = torch.Generator(dev).manual_seed(seeds[0])
        buf_cls = MemberPrioritizedReplayBuffer if cfg.per else MemberReplayBuffer
        buffer = buf_cls.create(S, cfg.buffer_size, obs_dim=self.obs_dim, reward_dim=self.reward_dim, device=dev)
        venv = VectorMOEnv(self.env, S * n)
        env_state, obs = venv.reset(gen)
        return EnvelopeSeedsState(
            ts=TrainState(net=net, target_net=target, optimizer=MemberAdam(net.parameters(), lr=cfg.learning_rate)),
            buffer=buffer,
            venv=venv,
            env_state=env_state,
            obs=obs.reshape(S, n, -1),
            weights=random_weights(gen, self.reward_dim, n=S * n, dist="gaussian").reshape(S, n, -1),
            stats=EpisodeStats.create(S * n, self.reward_dim, dev),
            gen=gen,
            global_step=0,
            iter_count=0,
            loss=torch.full((S,), float("nan"), device=dev),
        )

    # ------------------------------------------------------------ update math

    @torch.no_grad()
    def _envelope_target(self, ts: TrainState, next_obs, w, sampled_w) -> torch.Tensor:
        """max over (sampled w', a) of w·Q_online(s',a,w'), read off Q_target.

        Reference envelope.py:404-440.  Shapes, after the seed lead (S,) of a
        stacked net (none for one seed): next_obs (F, O) for B a multiple of
        F, row i's next obs next_obs[i % F] (``_loss`` gives its batch's F
        distinct ones), w (B, d), sampled_w (W, d).  Each net's trunk runs
        once on the F rows of each seed; its head runs on B*W rows, row r
        taking the features of next_obs[(r // W) % F] by broadcast.
        """
        lead, (b, d), n_w = w.shape[:-2], w.shape[-2:], sampled_w.shape[-2]
        ws = sampled_w.repeat(*[1] * len(lead), b, 1)  # (..., B*W, d)
        tile = (*lead, b // next_obs.shape[-2], -1, n_w, -1)

        def q_of(net):
            return net.head(net.features(next_obs)[..., None, :, None, :].expand(tile).flatten(-4, -2), ws, self.dtype)

        q_online = q_of(ts.net).reshape(*lead, b, n_w, -1, d)
        scal = torch.einsum("...bd,...bwad->...bwa", w, q_online)
        best_a = torch.argmax(scal, dim=-1)  # (..., B, W)
        best_w = torch.argmax(torch.max(scal, dim=-1).values, dim=-1)  # (..., B)
        q_target = q_of(ts.target_net).reshape(*lead, b, n_w, -1, d)
        q_at_a = torch.gather(q_target, -2, best_a[..., None, None].expand(*best_a.shape, 1, d)).squeeze(-2)
        return torch.gather(q_at_a, -2, best_w[..., None, None].expand(*best_w.shape, 1, d)).squeeze(-2)  # (..., B, d)

    def _loss(self, ts: TrainState, batch: Transition, sampled_w: torch.Tensor, homotopy_lambda: float):
        """Envelope homotopy loss of ``ts.net`` on ``batch`` tiled over the
        sampled weights (reference :279-291), per seed of the lead; returns
        (loss, td_scal, l_mo)."""
        lead, n_w, b = sampled_w.shape[:-2], sampled_w.shape[-2], batch.obs.shape[-2]
        rows = len(lead)  # the batch's row axis

        def tile(x):  # the batch's rows W times over
            return x.repeat(*[1] * rows, n_w, *[1] * (x.dim() - rows - 1))

        w = sampled_w.repeat_interleave(b, dim=rows)  # (..., W*B, d)
        obs, actions, rewards, dones = map(tile, (batch.obs, batch.action, batch.reward, batch.terminated))

        target_next = self._envelope_target(ts, batch.next_obs, w, sampled_w)
        y = rewards + (1.0 - dones[..., None]) * self.cfg.gamma * target_next

        q = ts.net(obs, w, self.dtype)  # (..., W*B, A, d)
        q_sa = torch.gather(q, -2, actions.long()[..., None, None].expand(*actions.shape, 1, self.reward_dim)).squeeze(-2)
        l_mo = torch.mean((q_sa - y) ** 2, dim=(-2, -1))
        wq = torch.sum(q_sa * w, dim=-1)
        wy = torch.sum(y * w, dim=-1)
        l_scal = torch.mean((wq - wy) ** 2, dim=-1)
        # λ a float or a 0-d tensor: (1 - λ) in float64, each weight rounded to float32
        lam = torch.as_tensor(homotopy_lambda, dtype=torch.float64)
        loss = (1.0 - lam).float() * l_mo + lam.float() * l_scal
        return loss, wq - wy, l_mo

    def _update(self, ts: TrainState, batch: Transition, sampled_w: torch.Tensor, homotopy_lambda: float):
        """One gradient step on the envelope loss, in place; returns (loss, td_scal[..., :B]).

        ``sampled_w`` (num_sample_w, d) are the weights the batch is tiled
        over (drawn inside the JAX package's ``_update``; passed in here so a
        test can give both the same ones).  ``homotopy_lambda`` is a float, or
        inside a CUDA graph (``models.graphed``) a 0-d float64 tensor.  With
        a stacked net every input carries the seed lead: each seed's gradient
        is its own loss's, clipped by its own global norm, and ``MemberAdam``
        keeps each seed's step count.
        """
        loss, td_scal, _ = self._loss(ts, batch, sampled_w, homotopy_lambda)
        ts.optimizer.zero_grad()
        loss.backward(torch.ones_like(loss))  # the seeds share no params
        if ts.net.members is None:
            clip_adam_step_(ts.optimizer, self.cfg.max_grad_norm)
        else:
            clip_grad_global_norm_members_(list(ts.net.parameters()), self.cfg.max_grad_norm)
            ts.optimizer.step()
        return loss.detach(), td_scal[..., : batch.obs.shape[-2]].detach()

    # ---------------------------------------------------------- train segment

    def _epsilon(self, global_step: int) -> float:
        # schedules run on the PER-ENV step clock so reference configs (1 env)
        # keep their meaning at any num_envs
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

    def _homotopy_lambda(self, global_step: int) -> float:
        cfg = self.cfg
        if cfg.homotopy_decay_steps is None:
            return cfg.initial_homotopy_lambda
        return linearly_decaying_value(
            cfg.initial_homotopy_lambda,
            cfg.homotopy_decay_steps,
            global_step // cfg.num_envs,
            cfg.learning_starts // cfg.num_envs,
            cfg.final_homotopy_lambda,
        )

    @torch.no_grad()
    def _greedy_actions(self, net: EnvelopeQNet, obs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        q = net(obs, weights, self.dtype)  # (..., N, A, d)
        return torch.argmax(torch.einsum("...nd,...nad->...na", weights, q), dim=-1)

    def train_segment(self, state: EnvelopeState | EnvelopeSeedsState, num_iters: int):
        """Run ``num_iters`` actor-learner iterations, updating ``state`` in place.

        A stacked state's tensors carry the seed lead (S,): its S·N envs step
        as flat rows, viewed back to the lead, and every draw takes the lead's
        shape, in the one-seed order."""
        cfg = self.cfg
        lead = state.obs.shape[:-2]
        n, d, gen, dev = cfg.num_envs, self.reward_dim, state.gen, self.device
        venv, shard = (state.venv, None) if lead else (self.venv, state.shard)
        ts, buffer = state.ts, state.buffer

        def view(x):  # flat rows (of envs or draws) to the lead
            return x.reshape(*lead, -1, *x.shape[1:]) if lead else x

        for _ in range(num_iters):
            with span("actor"):
                with span("actor.act"):
                    eps = self._epsilon(state.global_step)
                    # epsilon-greedy batched act (a shard acts on its rows, drawing for all n)
                    greedy = self._greedy_actions(ts.net, state.obs, state.weights)
                    rand_a = local(shard, torch.randint(0, self.env.num_actions, (*lead, n), generator=gen, device=dev))
                    explore = local(shard, torch.rand((*lead, n), generator=gen, device=dev)) < eps
                    actions = torch.where(explore, rand_a, greedy)

                out = venv.step(state.env_state, actions.reshape(-1) if lead else actions, gen, shard)
                done = out.terminated | out.truncated
                state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)

                # store transitions: next_obs must be the pre-reset final obs; a
                # shard's rows are all-gathered, so every replica stores all n
                buffer.add_batch(
                    gather_rows(
                        shard,
                        Transition(
                            obs=state.obs,
                            action=actions,
                            reward=view(out.reward),
                            next_obs=view(out.final_obs),
                            terminated=view(out.terminated.to(torch.float32)),
                        ),
                    )
                )

                # per-episode weight resampling (reference :526-569)
                new_w = view(local(shard, random_weights(gen, d, n=math.prod(lead) * n, dist="gaussian")))
                state.weights = torch.where(view(done)[..., None], new_w, state.weights)
                state.env_state, state.obs = out.state, view(out.obs)
                state.global_step += n
                state.iter_count += 1

            # learn
            if state.global_step >= cfg.learning_starts and state.iter_count % cfg.train_freq == 0:
                with span("learner"):
                    lam = self._homotopy_lambda(state.global_step)
                    for _ in range(cfg.gradient_updates):
                        if cfg.per:
                            batch, idx, _probs = buffer.sample(gen, cfg.batch_size)
                        else:
                            batch = buffer.sample(gen, cfg.batch_size)
                        with span("learner.update"):
                            sampled_w = view(random_weights(gen, d, n=math.prod(lead) * cfg.num_sample_w, dist="gaussian"))
                            state.loss, td = self._graphed(self._update, ts, batch, sampled_w, lam)
                        if cfg.per:
                            buffer.update_priorities(idx, (td.abs() + cfg.min_priority) ** cfg.per_alpha)

            # target net update (hard every freq iters, or polyak if tau<1)
            if cfg.tau < 1.0:
                polyak_update(ts.net, ts.target_net, cfg.tau)
            elif state.iter_count % cfg.target_net_update_freq == 0:
                polyak_update(ts.net, ts.target_net, 1.0)
        return state

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def act_eval(self, net: EnvelopeQNet, obs: torch.Tensor, w: torch.Tensor, gen=None) -> torch.Tensor:
        """Greedy scalarized actions for a batch (reference eval/max_action :374-405)."""
        return self._greedy_actions(net, obs, w)

    def _eval_front(self, net: EnvelopeQNet, weights: torch.Tensor, rep: int, max_steps: int, gen=None) -> torch.Tensor:
        """(K, d) discounted returns of the greedy policy at each of the K
        ``weights``; for a Q-net with S members, (S, K, d): the S fronts'
        S·K·rep episodes run as one batch, each member acting on its own rows."""
        gen = gen if gen is not None else torch.Generator(self.device).manual_seed(0)
        if net.members is None:
            act = lambda obs, w, g: self.act_eval(net, obs, w)
            return evaluate_front(self.env, act, weights, gen, rep=rep, gamma=self.cfg.gamma, max_steps=max_steps)
        S = net.members

        def act(obs, w, g):
            return self._greedy_actions(net, obs.reshape(S, -1, obs.shape[-1]), w.reshape(S, -1, w.shape[-1])).reshape(-1)

        front = evaluate_front(self.env, act, weights.repeat(S, 1), gen, rep=rep, gamma=self.cfg.gamma, max_steps=max_steps)
        return front.reshape(S, weights.shape[0], -1)

    # ----------------------------------------------------------------- train

    def train(
        self,
        total_timesteps: int,
        eval_env: MOEnv | None = None,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        eval_freq: int = 10_000,
        num_eval_weights_for_front: int = 32,
        num_eval_episodes_for_front: int = 1,
        eval_max_steps: int | None = None,
        state: EnvelopeState | None = None,
    ) -> EnvelopeState:
        """Host loop: segments of iterations + periodic front evaluation.

        ``eval_env`` is accepted for API parity and unused: the front is
        evaluated on the training env, as in the JAX package.
        """
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        eval_weights_np = equally_spaced_weights(self.reward_dim, num_eval_weights_for_front)
        eval_weights = torch.as_tensor(eval_weights_np, dtype=torch.float32, device=self.device)
        iters_total = max(1, total_timesteps // cfg.num_envs)
        seg = max(1, min(eval_freq // cfg.num_envs, iters_total))
        t0 = time.time()
        done_iters = 0
        while done_iters < iters_total:
            k = min(seg, iters_total - done_iters)
            state = self.train_segment(state, k)
            done_iters += k
            if ref_point is not None:
                front = (
                    self._eval_front(
                        state.ts.net,
                        eval_weights,
                        num_eval_episodes_for_front,
                        eval_max_steps or self.env.max_episode_steps or 500,
                    )
                    .cpu()
                    .numpy()
                )
                metrics = multi_policy_metrics(
                    front, np.asarray(ref_point), eval_weights.cpu().numpy(), known_pareto_front
                )
                metrics["charts/SPS"] = state.global_step / (time.time() - t0)
                self.logger.log(metrics, state.global_step)
                self._last_front = front
                self._last_metrics = metrics
        return state
