"""MOSAC — multi-objective SAC (continuous and discrete actions), on torch, for one policy or a population.

PyTorch port of ``morl_baselines_tpu/agents/mosac.py`` (reference
single_policy/ser/mosac_continuous_action.py:28-573 and
mosac_discrete_action.py:36-603, CleanRL SAC with vector critics):

- twin critics Q(s, a) -> R^d (continuous) or Q(s) -> (A, d) (discrete);
  the scalarization u(·, w) with the policy's fixed weight comes *before*
  the min over the twins (reference continuous :437-448, discrete :452-464);
- ``MOSAC``: squashed-Gaussian actor, target entropy -|A|;
  ``MOSACDiscrete``: categorical actor with the expectation-based update,
  target entropy ``target_entropy_scale`` · log|A|, Gumbel-max acting;
- the actor and the autotuned entropy alpha (its loss in log_alpha, its own
  Adam at ``q_learning_rate``) update only when ``iter_count % policy_freq
  == 0``, against the critic after its step; Polyak on every update;
- ``set_weights`` and an external buffer for MORL/D (reference morld.py:30-34).

Every tensor of the state carries a leading member axis P (P = 1 is one
agent; MORL/D's vectorized population is P members at once, the JAX
package's ``jax.vmap`` over ``train_segment`` and ``_update``).  The twin
critics and the member axis fold into one leading axis of P·2, so every
critic layer is one ``baddbmm``.  All members step together, so one
``torch.optim.Adam`` over the stacked params equals P optimizers.

As in the port's other agents, a segment is a Python loop of tensor ops; the
state is updated in place; ``global_step`` and ``iter_count`` are host
integers, so the learn gate needs no device read; randomness comes from one
``torch.Generator`` on the device, and ``_update`` takes its normals
explicitly when given (the discrete agent's Gumbel noise through
``_gumbel``).  ``update_once`` does not advance ``iter_count``: the
cooperation passes of one MORL/D round all update the actor or all skip it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..envs.base import Box, MOEnv
from ..envs.vector import EpisodeStats, VectorMOEnv
from ..evaluation.evaluation import rollout_episode
from ..models.continuous import ContinuousQNet, DiscreteQNet, DiscreteSACActor, SquashedGaussianActor
from ..models.networks import TrainState, polyak_update, stack_members
from ..parallel.mesh import RowShard, gather, global_rows, local
from ..replay.buffer import MemberReplayBuffer, Transition
from .base import MOAgentBase


@dataclass(frozen=True)
class MOSACConfig:
    learning_rate: float = 3e-4
    q_learning_rate: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    buffer_size: int = 100_000
    num_envs: int = 16
    learning_starts: int = 1000
    policy_freq: int = 2
    alpha: float = 0.2
    autotune: bool = True
    target_entropy_scale: float = 0.89  # discrete only (reference mosac_discrete_action.py:36-90)
    hidden: tuple = (256, 256)
    seed: int = 0


@dataclass
class MOSACState:
    actor: SquashedGaussianActor | DiscreteSACActor  # members P
    actor_optimizer: torch.optim.Optimizer
    critic: TrainState  # critic of P·2 members (member p's twins at 2p, 2p + 1) and its target
    log_alpha: torch.Tensor  # (P,), a leaf with its own Adam
    alpha_optimizer: torch.optim.Optimizer
    venv: VectorMOEnv  # P·N envs, member-major
    env_state: tuple
    obs: torch.Tensor  # (P, N, obs_dim)
    stats: EpisodeStats  # P·N rows
    gen: torch.Generator
    global_step: int  # env steps per member
    iter_count: int
    shard: RowShard | None = None  # this rank's block of the members (MORL/D's ``mesh``)

    @property
    def members(self) -> int:
        return self.obs.shape[0]


class MOSAC(MOAgentBase):
    """Continuous-action MOSAC with a fixed scalarization weight per member."""

    discrete = False

    def __init__(self, env: MOEnv, weights, config: MOSACConfig = MOSACConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        if isinstance(env.action_space, Box) == self.discrete:
            raise ValueError(f"{type(self).__name__} needs a {'discrete' if self.discrete else 'continuous (Box)'} action space")
        self.cfg = config
        self.w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)
        self.action_dim = env.action_dim
        self.action_shape = () if self.discrete else (self.action_dim,)
        self.target_entropy = -float(self.action_dim)

    def set_weights(self, weights) -> None:
        """MORL/D weight adaptation hook (reference morld.py:368-417)."""
        self.w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ init

    def make_actor(self, members: int = 1, gen: torch.Generator | None = None) -> SquashedGaussianActor:
        return SquashedGaussianActor(self.obs_dim, self.action_dim, self.cfg.hidden, members, gen)

    def make_critic(self, members: int = 2, gen: torch.Generator | None = None) -> ContinuousQNet:
        cfg = self.cfg
        return ContinuousQNet(self.obs_dim, self.action_dim, self.reward_dim, cfg.hidden, members, gen, weight_conditioned=False)

    def init_state(self, seeds: int | Sequence[int] | None = None, shard: RowShard | None = None) -> MOSACState:
        """A state of ``len(seeds)`` members (one for an int or None: the
        config's seed); member p's actor and twin critics are drawn from
        ``seeds[p]``.  With a ``shard`` the state holds this rank's block of
        the members, each as the unsharded state holds it."""
        cfg = self.cfg
        seeds = [cfg.seed] if seeds is None else [seeds] if isinstance(seeds, int) else list(seeds)
        N, dev = cfg.num_envs, self.device
        mine = local(shard, seeds)
        P = len(mine)
        actor = stack_members(self.make_actor, mine).to(dev)
        critic = stack_members(self.make_critic, mine, per_seed=2).to(dev)
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.full((P,), float(np.log(cfg.alpha)), device=dev, requires_grad=True)
        gen = torch.Generator(dev).manual_seed(seeds[0])
        venv = VectorMOEnv(self.env, len(seeds) * N)
        env_state, obs = venv.reset(gen, shard)
        return MOSACState(
            actor=actor,
            actor_optimizer=torch.optim.Adam(actor.parameters(), lr=cfg.learning_rate),
            critic=TrainState(critic, target, torch.optim.Adam(critic.parameters(), lr=cfg.q_learning_rate)),
            log_alpha=log_alpha,
            alpha_optimizer=torch.optim.Adam([log_alpha], lr=cfg.q_learning_rate),
            venv=venv,
            env_state=env_state,
            obs=obs.reshape(P, N, -1),
            stats=EpisodeStats.create(P * N, self.reward_dim, dev),
            gen=gen,
            global_step=0,
            iter_count=0,
            shard=shard,
        )

    @torch.no_grad()
    def gather_state(self, state: MOSACState) -> MOSACState:
        """A sharded state's members from every rank, as one state of all P
        members (the unsharded layout: nets, optimizer moments, log alpha,
        envs); the state itself without a shard.  Shares the generator."""
        shard = state.shard
        if shard is None:
            return state
        P = state.members * shard.world
        host = torch.Generator().manual_seed(0)  # overwritten below; keeps torch's global stream untouched

        def full_module(make, module, members):
            out = make(members, host).to(self.device)
            out.load_state_dict({k: shard.gather(v) for k, v in module.state_dict().items()})
            return out

        def full_adam(opt, params):
            new = torch.optim.Adam(params, **{k: v for k, v in opt.defaults.items() if k in ("lr", "betas", "eps")})
            sd = copy.deepcopy(opt.state_dict())
            for st in sd["state"].values():
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key] = shard.gather(st[key])
            new.load_state_dict(sd)
            return new

        actor = full_module(self.make_actor, state.actor, P)
        critic = full_module(self.make_critic, state.critic.net, 2 * P)
        target = full_module(self.make_critic, state.critic.target_net, 2 * P).requires_grad_(False)
        log_alpha = shard.gather(state.log_alpha.detach()).requires_grad_(True)
        gather_tree = lambda x: type(x)(*(gather_tree(v) for v in x)) if isinstance(x, tuple) else shard.gather(x)  # noqa: E731
        return MOSACState(
            actor=actor,
            actor_optimizer=full_adam(state.actor_optimizer, actor.parameters()),
            critic=TrainState(critic, target, full_adam(state.critic.optimizer, critic.parameters())),
            log_alpha=log_alpha,
            alpha_optimizer=full_adam(state.alpha_optimizer, [log_alpha]),
            venv=state.venv,
            env_state=gather_tree(state.env_state),
            obs=shard.gather(state.obs),
            stats=gather_tree(state.stats),
            gen=state.gen,
            global_step=state.global_step,
            iter_count=state.iter_count,
        )

    def make_buffer(self, members: int = 1) -> MemberReplayBuffer:
        return MemberReplayBuffer.create(
            members, self.cfg.buffer_size, obs_dim=self.obs_dim, action_shape=(self.action_dim,),
            reward_dim=self.reward_dim, action_dtype=torch.float32, device=self.device,
        )

    # ---------------------------------------------------------------- update

    @staticmethod
    def q_values(critic: ContinuousQNet, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Twin critics of every member: obs (P, B, O), action (P, B, A) -> (P, 2, B, d)."""
        P = obs.shape[0]
        twin = lambda x: x[:, None].expand(P, 2, *x.shape[1:]).reshape(2 * P, *x.shape[1:])  # noqa: E731
        q = critic(twin(obs), twin(action))
        return q.reshape(P, 2, *q.shape[1:])

    def _normals(self, state: MOSACState, like: torch.Tensor) -> torch.Tensor:
        """Standard normals of ``like``'s shape (members first; a shard's block of all members' draws)."""
        shape = (global_rows(state.shard, like.shape[0]), *like.shape[1:])
        return local(state.shard, torch.randn(shape, generator=state.gen, device=like.device))

    def _update(
        self,
        state: MOSACState,
        batch: Transition,
        w: torch.Tensor,
        eps_next: torch.Tensor | None = None,
        eps_actor: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One SAC update of every member in place (JAX ``_update``) on
        batch rows (P, B, ...) under weights w (P, d); ``eps_next`` and
        ``eps_actor`` are the normals of the target's and the actor's
        samples (P, B, A), drawn from the state's generator unless given.
        Returns the critic losses (P,)."""
        cfg = self.cfg
        critic = state.critic
        alpha = torch.exp(state.log_alpha.detach())[:, None]

        # critic update: scalarize-then-min target (reference :437-448)
        with torch.no_grad():
            mean, log_std = state.actor(batch.next_obs)
            eps_next = self._normals(state, mean) if eps_next is None else eps_next
            next_a, next_logp = SquashedGaussianActor.sample(mean, log_std, eps_next)
            q_next = torch.einsum("pcbd,pd->pcb", self.q_values(critic.target_net, batch.next_obs, next_a), w)
            min_q_next = q_next.min(dim=1).values - alpha * next_logp
            target = torch.einsum("pbd,pd->pb", batch.reward, w) + (1.0 - batch.terminated) * cfg.gamma * min_q_next
        q = torch.einsum("pcbd,pd->pcb", self.q_values(critic.net, batch.obs, batch.action), w)
        closs = ((q - target[:, None]) ** 2).mean(dim=(1, 2))
        critic.optimizer.zero_grad(set_to_none=True)
        closs.sum().backward()
        critic.optimizer.step()

        # delayed actor + alpha update (reference :450-480), against the updated critic
        if state.iter_count % cfg.policy_freq == 0:
            mean, log_std = state.actor(batch.obs)
            eps_actor = self._normals(state, mean) if eps_actor is None else eps_actor
            a, logp = SquashedGaussianActor.sample(mean, log_std, eps_actor)
            min_q = torch.einsum("pcbd,pd->pcb", self.q_values(critic.net, batch.obs, a), w).min(dim=1).values
            aloss = (alpha * logp - min_q).mean(dim=1)
            state.actor_optimizer.zero_grad(set_to_none=True)
            aloss.sum().backward(inputs=list(state.actor.parameters()))
            state.actor_optimizer.step()
            if cfg.autotune:
                # d/d log_alpha of -mean(log_alpha * (logp + target_entropy)), per member
                state.log_alpha.grad = -(logp.detach() + self.target_entropy).mean(dim=1)
                state.alpha_optimizer.step()
        polyak_update(critic.net, critic.target_net, cfg.tau)
        return closs.detach()

    def update_once(self, state: MOSACState, batch: Transition, w=None) -> torch.Tensor:
        """One off-policy update (MORL/D cooperation passes); ``iter_count`` stays."""
        w = (self.w if w is None else w).reshape(-1, self.reward_dim).expand(state.members, -1)
        return self._update(state, batch, w)

    # ---------------------------------------------------------- train segment

    def train_segment(self, state: MOSACState, buffer: MemberReplayBuffer, num_iters: int, w=None) -> MOSACState:
        """``num_iters`` act -> step -> store -> update iterations in place;
        the buffer (one ring per member) is passed separately so MORL/D can
        share one across its looped population (reference :341-347).  ``w``
        (P, d) overrides the agent's weight, one row per member."""
        cfg = self.cfg
        P, N = state.members, cfg.num_envs
        w = (self.w if w is None else w).reshape(-1, self.reward_dim).expand(P, -1)
        for _ in range(num_iters):
            actions = self._explore(state)
            out = state.venv.step(state.env_state, actions.reshape(P * N, *self.action_shape), state.gen, state.shard)
            done = out.terminated | out.truncated
            state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)
            buffer.add_batch(
                Transition(
                    obs=state.obs,
                    action=actions,
                    reward=out.reward.reshape(P, N, -1),
                    next_obs=out.final_obs.reshape(P, N, -1),
                    terminated=out.terminated.reshape(P, N).to(torch.float32),
                )
            )
            state.env_state, state.obs = out.state, out.obs.reshape(P, N, -1)
            state.global_step += N
            state.iter_count += 1
            if state.global_step >= cfg.learning_starts:
                self._update(state, self.sample(state, buffer), w)
        return state

    def sample(self, state: MOSACState, buffer: MemberReplayBuffer) -> Transition:
        """A batch of ``batch_size`` rows from each member's ring (a sharded
        state's members draw their block of all members' indices)."""
        if state.shard is None:
            return buffer.sample(state.gen, self.cfg.batch_size)
        return buffer.sample(state.gen, self.cfg.batch_size, state.shard)

    @torch.no_grad()
    def _explore(self, state: MOSACState) -> torch.Tensor:
        """The actions (P, N, A) of one training step: uniform before
        ``learning_starts``, then a sample of the policy."""
        if state.global_step < self.cfg.learning_starts:
            P, N = global_rows(state.shard, state.members), self.cfg.num_envs
            u = torch.rand((P, N, self.action_dim), generator=state.gen, device=self.device)
            return local(state.shard, u) * 2.0 - 1.0
        mean, log_std = state.actor(state.obs)
        return SquashedGaussianActor.sample(mean, log_std, self._normals(state, mean))[0]

    def train(self, total_timesteps: int, state: MOSACState | None = None, buffer: MemberReplayBuffer | None = None):
        state = state if state is not None else self.init_state()
        buffer = buffer if buffer is not None else self.make_buffer(state.members)
        self.train_segment(state, buffer, max(1, total_timesteps // self.cfg.num_envs))
        return state, buffer

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def member_params(self, state: MOSACState, p: int) -> dict:
        """Member p's actor params on the host, copied."""
        return {k: v[p].detach().cpu().clone() for k, v in state.actor.named_parameters()}

    @torch.no_grad()
    def all_member_params(self, state: MOSACState) -> list[dict]:
        """Every member's ``member_params``, a sharded state's gathered from all ranks."""
        full = {k: gather(state.shard, v.detach()).cpu() for k, v in state.actor.named_parameters()}
        return [{k: v[p].clone() for k, v in full.items()} for p in range(next(iter(full.values())).shape[0])]

    @torch.no_grad()
    def act_eval(self, actor: SquashedGaussianActor, obs: torch.Tensor) -> torch.Tensor:
        """tanh of each member's mean action for obs (P, M, obs_dim)."""
        return torch.tanh(actor(obs)[0])

    def policy_eval(self, state: MOSACState, gen: torch.Generator, rep: int = 5, w=None, max_steps: int | None = None):
        """(vec return, disc vec return), each (P, d): every member's ``rep``
        episodes under its weight ``w`` (P, d), all P·rep in one batch."""
        P, d = state.members, self.reward_dim
        w = (self.w if w is None else w).reshape(-1, d).expand(P, -1)
        act = lambda obs, w_, g: self.act_eval(state.actor, obs.reshape(P, rep, -1)).reshape(P * rep, *self.action_shape)  # noqa: E731
        rets, discs, _ = rollout_episode(
            self.env, act, w.repeat_interleave(rep, dim=0), gen, self.cfg.gamma, max_steps, state.shard
        )
        return rets.reshape(P, rep, d).mean(dim=1), discs.reshape(P, rep, d).mean(dim=1)


class MOSACDiscrete(MOSAC):
    """Discrete-action MOSAC (reference mosac_discrete_action.py:36-603):
    a categorical actor over the A actions and twin critics Q(s) -> (A, d)."""

    discrete = True

    def __init__(self, env: MOEnv, weights, config: MOSACConfig = MOSACConfig(), log: bool = False, device="cuda"):
        super().__init__(env, weights, config, log=log, device=device)
        self.num_actions = env.num_actions
        self.target_entropy = config.target_entropy_scale * float(np.log(self.num_actions))

    def make_actor(self, members: int = 1, gen: torch.Generator | None = None) -> DiscreteSACActor:
        return DiscreteSACActor(self.obs_dim, self.num_actions, self.cfg.hidden, members, gen)

    def make_critic(self, members: int = 2, gen: torch.Generator | None = None) -> DiscreteQNet:
        return DiscreteQNet(self.obs_dim, self.num_actions, self.reward_dim, self.cfg.hidden, members, gen)

    def make_buffer(self, members: int = 1) -> MemberReplayBuffer:
        return MemberReplayBuffer.create(
            members, self.cfg.buffer_size, obs_dim=self.obs_dim, reward_dim=self.reward_dim, device=self.device
        )

    @staticmethod
    def q_values(critic: DiscreteQNet, obs: torch.Tensor) -> torch.Tensor:
        """Twin critics of every member: obs (P, B, O) -> (P, 2, B, A, d)."""
        P = obs.shape[0]
        q = critic(obs[:, None].expand(P, 2, *obs.shape[1:]).reshape(2 * P, *obs.shape[1:]))
        return q.reshape(P, 2, *q.shape[1:])

    def _gumbel(self, state: MOSACState, like: torch.Tensor) -> torch.Tensor:
        """Gumbel(0, 1) noise of ``like``'s shape: -log(-log(u)), u in [tiny, 1)
        (members first; a shard's block of all members' draws)."""
        shape = (global_rows(state.shard, like.shape[0]), *like.shape[1:])
        u = local(state.shard, torch.rand(shape, generator=state.gen, device=like.device))
        return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))

    @torch.no_grad()
    def _explore(self, state: MOSACState) -> torch.Tensor:
        """Gumbel-max samples (P, N) of the policy (``jax.random.categorical``), from the first step."""
        logits = state.actor(state.obs)
        return torch.argmax(logits + self._gumbel(state, logits), dim=-1)

    def _update(self, state: MOSACState, batch: Transition, w: torch.Tensor) -> torch.Tensor:
        """One expectation-based discrete SAC update of every member in place
        (JAX ``MOSACDiscrete._update``, reference :452-510) on batch rows
        (P, B, ...) under weights w (P, d).  Returns the critic losses (P,)."""
        cfg = self.cfg
        critic = state.critic
        alpha = torch.exp(state.log_alpha.detach())[:, None, None]

        with torch.no_grad():
            logits_next = state.actor(batch.next_obs)
            probs_next, logp_next = torch.softmax(logits_next, -1), torch.log_softmax(logits_next, -1)
            q_next = torch.einsum("pcbad,pd->pcba", self.q_values(critic.target_net, batch.next_obs), w)
            v_next = torch.sum(probs_next * (q_next.amin(dim=1) - alpha * logp_next), dim=-1)
            target = torch.einsum("pbd,pd->pb", batch.reward, w) + (1.0 - batch.terminated) * cfg.gamma * v_next
        q = torch.einsum("pcbad,pd->pcba", self.q_values(critic.net, batch.obs), w)
        idx = batch.action.long()[:, None, :, None].expand(-1, 2, -1, 1)
        q_sa = torch.gather(q, 3, idx).squeeze(3)  # (P, 2, B)
        closs = ((q_sa - target[:, None]) ** 2).mean(dim=(1, 2))
        critic.optimizer.zero_grad(set_to_none=True)
        closs.sum().backward()
        critic.optimizer.step()

        # delayed actor + alpha update, against the updated critic
        if state.iter_count % cfg.policy_freq == 0:
            logits = state.actor(batch.obs)
            probs, logp = torch.softmax(logits, -1), torch.log_softmax(logits, -1)
            with torch.no_grad():
                min_q = torch.einsum("pcbad,pd->pcba", self.q_values(critic.net, batch.obs), w).amin(dim=1)
            aloss = torch.sum(probs * (alpha * logp - min_q), dim=-1).mean(dim=1)
            state.actor_optimizer.zero_grad(set_to_none=True)
            aloss.sum().backward(inputs=list(state.actor.parameters()))
            state.actor_optimizer.step()
            if cfg.autotune:
                # d/d log_alpha of mean(log_alpha * (entropy - target_entropy)), per member
                ent = -torch.sum(probs.detach() * logp.detach(), dim=-1)
                state.log_alpha.grad = (ent - self.target_entropy).mean(dim=1)
                state.alpha_optimizer.step()
        polyak_update(critic.net, critic.target_net, cfg.tau)
        return closs.detach()

    @torch.no_grad()
    def act_eval(self, actor: DiscreteSACActor, obs: torch.Tensor) -> torch.Tensor:
        """Each member's greedy action (argmax of the logits) for obs (P, M, obs_dim)."""
        return torch.argmax(actor(obs), dim=-1)
