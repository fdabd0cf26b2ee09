"""CAPQL — weight-Conditioned Approximately Pareto-optimal Q-Learning, on torch.

PyTorch port of ``morl_baselines_tpu/agents/capql.py`` (reference
multi_policy/capql/capql.py:32-485, Lu et al., 2023): continuous SAC
conditioned on the weight vector.

- Behaviour weights per episode from the normal cone around the 1-vector
  (``sample_angle_weights``, reference :69-99); each transition stores its w
  (``WReplayBuffer``, reference :32-66).  Only the envs whose episode ended
  redraw their weight.
- Critic: 2 Q-nets Q(s, a, w) -> R^d on one leading axis (one ``baddbmm`` a
  layer); the target is the *elementwise* min over the target nets minus
  alpha·logp, a vector MSE (reference :321-338).
- Actor: the scalarized min-Q of the critic after this step's update, minus
  alpha·logp (reference :340-350); then Polyak.  alpha is fixed.

As in the port's other agents, a segment is a Python loop of tensor ops; the
state is updated in place; ``global_step`` is a host integer, so the
learning-starts gate reads nothing from the device; randomness comes from
one ``torch.Generator`` on the device, and ``_update`` takes its normals
explicitly when given.  Each min over the critics is ``torch.amin``, whose
gradient splits among ties as ``jnp.min``'s does.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.weights import equally_spaced_weights
from ..envs.base import MOEnv
from ..envs.vector import EpisodeStats, VectorMOEnv
from ..evaluation.evaluation import evaluate_front, multi_policy_metrics
from ..models.continuous import ContinuousQNet, SquashedGaussianActor
from ..models.networks import TrainState, polyak_update
from ..replay.buffer import ReplayBuffer
from .base import MOAgentBase


def sample_angle_weights(
    gen: torch.Generator | None,
    n: int,
    dim: int,
    angle: float,
    normals: torch.Tensor | None = None,
    uniforms: torch.Tensor | None = None,
) -> torch.Tensor:
    """n weights from the normal cone of half-angle ``angle`` around the
    1-vector (reference :69-99): normals (n, dim) projected off w0 = 1/sqrt(d)
    and normalized (floor 1e-8), w = tan(U · angle) · s + w0 with U (n, 1)
    uniform, then divided by its L1 norm.  ``normals`` and ``uniforms`` are
    drawn from ``gen`` unless given."""
    if normals is None:
        normals = torch.randn((n, dim), generator=gen, device=gen.device)
    if uniforms is None:
        uniforms = torch.rand((n, 1), generator=gen, device=gen.device)
    w0 = torch.ones((dim,), device=normals.device) / torch.sqrt(torch.tensor(float(dim), device=normals.device))
    s = normals - (normals @ w0)[:, None] * w0[None, :]
    s = s / torch.clamp(torch.linalg.norm(s, dim=1, keepdim=True), min=1e-8)
    w = torch.tan(uniforms * angle) * s + w0[None, :]
    return w / torch.sum(torch.abs(w), dim=1, keepdim=True)


class WTransition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    w: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    terminated: torch.Tensor


class WReplayBuffer(ReplayBuffer):
    """The ring buffer over ``WTransition`` rows: each transition carries its
    behaviour weight (reference :32-66)."""

    @staticmethod
    def create(capacity: int, obs_dim: int, action_dim: int, reward_dim: int, device="cuda") -> "WReplayBuffer":
        z = lambda *shape: torch.zeros((capacity, *shape), device=device)  # noqa: E731
        return WReplayBuffer(WTransition(z(obs_dim), z(action_dim), z(reward_dim), z(reward_dim), z(obs_dim), z()))


@dataclass(frozen=True)
class CAPQLConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    alpha: float = 0.2
    batch_size: int = 256
    buffer_size: int = 100_000
    num_envs: int = 16
    learning_starts: int = 1000
    gradient_updates: int = 1
    num_q_nets: int = 2
    angle: float = 0.418  # about 24 degrees, the reference example's default
    hidden: tuple = (256, 256)
    seed: int = 0


@dataclass
class CAPQLState:
    actor: SquashedGaussianActor  # conditioned on w
    actor_optimizer: torch.optim.Optimizer
    critic: TrainState  # ContinuousQNet of num_q_nets members on (obs, a, w), its target and optimizer
    buffer: WReplayBuffer
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    behavior_w: torch.Tensor  # (N, d)
    stats: EpisodeStats
    gen: torch.Generator
    global_step: int
    iter_count: int


class CAPQL(MOAgentBase):
    def __init__(self, env: MOEnv, config: CAPQLConfig = CAPQLConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.venv = VectorMOEnv(env, config.num_envs)
        self.action_dim = env.action_dim

    def make_actor(self, gen: torch.Generator | None = None) -> SquashedGaussianActor:
        return SquashedGaussianActor(self.obs_dim, self.action_dim, self.cfg.hidden, gen=gen, reward_dim=self.reward_dim,
                                     weight_conditioned=True)

    def make_critic(self, gen: torch.Generator | None = None) -> ContinuousQNet:
        cfg = self.cfg
        return ContinuousQNet(self.obs_dim, self.action_dim, self.reward_dim, cfg.hidden, cfg.num_q_nets, gen)

    def init_state(self, seed: int | None = None) -> CAPQLState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        host = torch.Generator().manual_seed(seed)  # params drawn on the host: the same nets on any device
        actor = self.make_actor(host).to(self.device)
        critic = self.make_critic(host).to(self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        gen = torch.Generator(self.device).manual_seed(seed)
        env_state, obs = self.venv.reset(gen)
        return CAPQLState(
            actor=actor,
            actor_optimizer=torch.optim.Adam(actor.parameters(), lr=cfg.learning_rate),
            critic=TrainState(critic, target, torch.optim.Adam(critic.parameters(), lr=cfg.learning_rate)),
            buffer=WReplayBuffer.create(cfg.buffer_size, self.obs_dim, self.action_dim, self.reward_dim, self.device),
            env_state=env_state,
            obs=obs,
            behavior_w=sample_angle_weights(gen, cfg.num_envs, self.reward_dim, cfg.angle),
            stats=EpisodeStats.create(cfg.num_envs, self.reward_dim, self.device),
            gen=gen,
            global_step=0,
            iter_count=0,
        )

    # ---------------------------------------------------------------- update

    def _normals(self, state: CAPQLState, like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=state.gen, device=like.device)

    def _update(
        self,
        state: CAPQLState,
        batch: WTransition,
        eps_next: torch.Tensor | None = None,
        eps_actor: torch.Tensor | None = None,
    ) -> None:
        """One critic step, one actor step against the updated critic, then
        Polyak, in place (JAX ``_update``); ``eps_next`` and ``eps_actor`` are
        the normals (B, A) of the target's and the actor's samples, drawn from
        the state's generator unless given."""
        cfg = self.cfg
        critic = state.critic
        with torch.no_grad():
            mean, log_std = state.actor(batch.next_obs, batch.w)
            eps_next = self._normals(state, mean) if eps_next is None else eps_next
            next_a, next_logp = SquashedGaussianActor.sample(mean, log_std, eps_next)
            q_t = critic.target_net(batch.next_obs, next_a, batch.w)  # (C, B, d)
            min_q_t = torch.amin(q_t, dim=0) - cfg.alpha * next_logp[:, None]
            target = batch.reward + (1.0 - batch.terminated[:, None]) * cfg.gamma * min_q_t
        q = critic.net(batch.obs, batch.action, batch.w)
        closs = torch.mean((q - target[None]) ** 2)
        critic.optimizer.zero_grad(set_to_none=True)
        closs.backward()
        critic.optimizer.step()

        mean, log_std = state.actor(batch.obs, batch.w)
        eps_actor = self._normals(state, mean) if eps_actor is None else eps_actor
        a, logp = SquashedGaussianActor.sample(mean, log_std, eps_actor)
        min_q = torch.amin(critic.net(batch.obs, a, batch.w), dim=0)
        aloss = torch.mean(cfg.alpha * logp - torch.sum(min_q * batch.w, dim=-1))
        state.actor_optimizer.zero_grad(set_to_none=True)
        aloss.backward(inputs=list(state.actor.parameters()))
        state.actor_optimizer.step()
        polyak_update(critic.net, critic.target_net, cfg.tau)

    # ---------------------------------------------------------- train segment

    def train_segment(self, state: CAPQLState, num_iters: int) -> CAPQLState:
        """``num_iters`` act -> step -> store -> update iterations, in place.
        Random actions in [-1, 1] while ``global_step < learning_starts``;
        ``gradient_updates`` updates once ``global_step >= learning_starts``
        (both read before this iteration's increment)."""
        cfg = self.cfg
        N, g = cfg.num_envs, state.gen
        for _ in range(num_iters):
            if state.global_step < cfg.learning_starts:
                actions = torch.rand((N, self.action_dim), generator=g, device=g.device) * 2.0 - 1.0
            else:
                with torch.no_grad():
                    mean, log_std = state.actor(state.obs, state.behavior_w)
                    actions, _ = SquashedGaussianActor.sample(mean, log_std, self._normals(state, mean))
            out = self.venv.step(state.env_state, actions, g)
            done = out.terminated | out.truncated
            state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)
            state.buffer.add_batch(
                WTransition(
                    obs=state.obs,
                    action=actions,
                    w=state.behavior_w,
                    reward=out.reward,
                    next_obs=out.final_obs,
                    terminated=out.terminated.to(torch.float32),
                )
            )
            new_w = sample_angle_weights(g, N, self.reward_dim, cfg.angle)
            state.behavior_w = torch.where(done[:, None], new_w, state.behavior_w)
            if state.global_step >= cfg.learning_starts:
                for _ in range(cfg.gradient_updates):
                    self._update(state, state.buffer.sample(g, cfg.batch_size))
            state.env_state, state.obs = out.state, out.obs
            state.global_step += N
            state.iter_count += 1
        return state

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def act_eval(self, actor: SquashedGaussianActor, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.tanh(actor(obs, w)[0])

    def _eval_front(self, state: CAPQLState, weights: torch.Tensor, rep: int, max_steps: int) -> torch.Tensor:
        """The discounted return of each weight's greedy policy (W, d)."""
        act = lambda obs, w, g: self.act_eval(state.actor, obs, w)  # noqa: E731
        gen = torch.Generator(self.device).manual_seed(0)
        return evaluate_front(self.env, act, weights, gen, rep=rep, gamma=self.cfg.gamma, max_steps=max_steps)

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        eval_freq: int = 10_000,
        num_eval_weights_for_front: int = 32,
        eval_max_steps: int | None = None,
        state: CAPQLState | None = None,
    ) -> CAPQLState:
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        eval_weights = equally_spaced_weights(self.reward_dim, num_eval_weights_for_front)
        eval_w = torch.as_tensor(eval_weights, dtype=torch.float32, device=self.device)
        iters_total = max(1, total_timesteps // cfg.num_envs)
        seg = max(1, min(eval_freq // cfg.num_envs, iters_total))
        done_iters = 0
        while done_iters < iters_total:
            n = min(seg, iters_total - done_iters)
            self.train_segment(state, n)
            done_iters += n
            if ref_point is not None:
                max_steps = eval_max_steps or self.env.max_episode_steps or 500
                front = self._eval_front(state, eval_w, 1, max_steps).cpu().numpy()
                metrics = multi_policy_metrics(front, np.asarray(ref_point), eval_weights, known_pareto_front)
                self.logger.log(metrics, state.global_step)
                self._last_front, self._last_metrics = front, metrics
        return state
