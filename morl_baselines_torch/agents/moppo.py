"""MOPPO — multi-objective PPO with a vector-valued critic, on torch, for one policy or a population.

PyTorch port of ``morl_baselines_tpu/agents/moppo.py`` (reference
single_policy/ser/mo_ppo.py:22-613, CleanRL-style PPO used as PGMORL's worker):

- critic V(s) -> R^d; GAE per objective, each transition masked by its own
  done, then advantages scalarized adv @ w (reference :433-476);
- Gaussian actor with a state-independent log-std (or categorical logits);
  PPO clip, clipped vector value MSE, entropy bonus (reference :493-560);
- global-norm clip 0.5, then Adam with eps 1e-5;
- obs and reward normalization as explicit state (the reference's make_env
  wrapper stack, :107-145); ``change_weights`` for PGMORL (reference :572-576).

Every tensor of the state carries a leading member axis P.  P = 1 is one
PPO agent; PGMORL's vectorized population is P members trained at once,
the counterpart of the JAX package's ``jax.vmap(train_iteration)``: each net
layer is one ``baddbmm`` over the members (``EnsembleDense``), the P·N envs
step as one batch, the statistics, the GAE, the advantage normalization, the
minibatch permutations and the gradient clip are per member, and
``MemberAdam`` keeps a step count per member.  Member p's update equals a
one-member update of the same state and batch.

As in the port's other agents, the rollout is a Python loop of tensor ops
where the JAX package has one ``lax.scan``; the state is updated in place;
``global_step`` is a host integer (env steps per member); randomness comes
from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..envs.base import Box, MOEnv
from ..envs.vector import EpisodeStats, RewardNormState, VectorMOEnv, normalize_reward
from ..evaluation.evaluation import rollout_episode
from ..models.networks import MLP, MemberAdam, clip_grad_global_norm_members_, stack_members
from .base import MOAgentBase

_LOG_2PI = float(np.log(2 * np.pi))
_LOG_2PI_E = float(np.log(2 * np.pi * np.e))


class ObsNormState(NamedTuple):
    """Running obs mean/var: mean and var (..., obs_dim), count (...)."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(obs_dim: int, device, lead: tuple = ()) -> "ObsNormState":
        return ObsNormState(
            torch.zeros((*lead, obs_dim), device=device),
            torch.ones((*lead, obs_dim), device=device),
            torch.full(lead, 1e-4, device=device),
        )


def update_obs_norm(s: ObsNormState, obs: torch.Tensor) -> ObsNormState:
    """Merge a batch of obs (..., B, obs_dim) into the running stats
    (population variance, as ``jnp.var``)."""
    bm, bv, bc = obs.mean(dim=-2), obs.var(dim=-2, correction=0), obs.shape[-2]
    count = s.count[..., None]
    delta = bm - s.mean
    tot = count + bc
    mean = s.mean + delta * bc / tot
    m2 = s.var * count + bv * bc + delta**2 * count * bc / tot
    return ObsNormState(mean, m2 / tot, s.count + bc)


class MOPPONet(nn.Module):
    """Actor (Gaussian or categorical) + vector critic (reference :147-230):
    two separate tanh MLPs and, for a continuous actor, a zero-initialized
    ``log_std`` (members, action_dim).  Input (members, B, obs_dim); returns
    (pi (members, B, A), log_std or None, v (members, B, d))."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        reward_dim: int,
        continuous: bool,
        hidden: Sequence[int] = (64, 64),
        members: int = 1,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.critic = MLP(obs_dim, hidden, reward_dim, gen, members=members, activation="tanh")
        self.actor = MLP(obs_dim, hidden, action_dim, gen, members=members, activation="tanh")
        self.log_std = nn.Parameter(torch.zeros(members, action_dim)) if continuous else None

    def forward(self, obs: torch.Tensor):
        return self.actor(obs), self.log_std, self.critic(obs)

    def flax_layout(self) -> dict:
        out = {"MLP_0": self.critic, "MLP_1": self.actor}
        if self.log_std is not None:
            out["log_std"] = self.log_std
        return out


def vector_gae(v_t, rew_t, done_t, last_v, gamma: float, gae_lambda: float) -> torch.Tensor:
    """Per-objective GAE over a (T, ..., N, d) rollout (reference mo_ppo.py:433-476,
    CleanRL ppo.py semantics).

    The boundary mask is each transition's OWN done flag: ``delta_t = r_t +
    gamma * V(s_{t+1}) * (1 - done_t) - V(s_t)``, and the advantage chain
    also cuts at done_t.
    """
    adv_next, v_next = torch.zeros_like(last_v), last_v
    out = []
    for t in reversed(range(v_t.shape[0])):
        nonterm = (1.0 - done_t[t])[..., None]
        delta = rew_t[t] + gamma * v_next * nonterm - v_t[t]
        adv_next = delta + gamma * gae_lambda * nonterm * adv_next
        v_next = v_t[t]
        out.append(adv_next)
    return torch.stack(out[::-1])


@dataclass(frozen=True)
class MOPPOConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.995
    gae_lambda: float = 0.95
    clip_coef: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_envs: int = 4
    steps_per_iteration: int = 2048
    update_epochs: int = 10
    num_minibatches: int = 32
    norm_adv: bool = True
    clip_vloss: bool = True
    normalize_obs: bool = True
    normalize_reward: bool = True
    hidden: tuple = (64, 64)
    seed: int = 0


class Rollout(NamedTuple):
    """A flattened rollout, per member: obs (P, B, O), act (P, B, A) or (P, B),
    logp (P, B), adv (P, B) scalarized, ret and val (P, B, d)."""

    obs: torch.Tensor
    act: torch.Tensor
    logp: torch.Tensor
    adv: torch.Tensor
    ret: torch.Tensor
    val: torch.Tensor


class MOPPOMember(NamedTuple):
    """Copies of one member's whole training state: what PGMORL stores and
    later copies back into a worker."""

    params: list
    adam: dict
    obs_norm: ObsNormState
    rew_norm: RewardNormState
    env_state: tuple
    obs: torch.Tensor
    stats: EpisodeStats


@dataclass
class MOPPOState:
    net: MOPPONet
    optimizer: MemberAdam
    venv: VectorMOEnv  # P·N envs, member-major
    env_state: tuple
    obs: torch.Tensor  # (P, N, obs_dim) raw obs
    obs_norm: ObsNormState
    rew_norm: RewardNormState
    stats: EpisodeStats  # P·N rows
    gen: torch.Generator
    global_step: int  # env steps per member

    @property
    def members(self) -> int:
        return self.obs.shape[0]


class MOPPO(MOAgentBase):
    def __init__(self, env: MOEnv, weights, config: MOPPOConfig = MOPPOConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)
        self.continuous = isinstance(env.action_space, Box)
        self.action_dim = env.action_dim if self.continuous else env.num_actions

    def change_weights(self, weights) -> None:
        """PGMORL weight reassignment (reference :572-576)."""
        self.w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=self.device)

    def make_net(self, members: int = 1, gen: torch.Generator | None = None) -> MOPPONet:
        return MOPPONet(self.obs_dim, self.action_dim, self.reward_dim, self.continuous, self.cfg.hidden, members, gen)

    def init_state(self, seeds: int | Sequence[int] | None = None) -> MOPPOState:
        """A state of ``len(seeds)`` members (one for an int or None: the
        config's seed); member p's params are drawn from ``seeds[p]``."""
        cfg = self.cfg
        seeds = [cfg.seed] if seeds is None else [seeds] if isinstance(seeds, int) else list(seeds)
        P, N = len(seeds), cfg.num_envs
        net = stack_members(lambda m, g: self.make_net(m, g), seeds).to(self.device)
        gen = torch.Generator(self.device).manual_seed(seeds[0])
        venv = VectorMOEnv(self.env, P * N)
        env_state, obs = venv.reset(gen)
        return MOPPOState(
            net=net,
            optimizer=MemberAdam(net.parameters(), cfg.learning_rate, eps=1e-5),
            venv=venv,
            env_state=env_state,
            obs=obs.reshape(P, N, -1),
            obs_norm=ObsNormState.create(self.obs_dim, self.device, (P,)),
            rew_norm=RewardNormState.create(N, self.reward_dim, self.device, (P,)),
            stats=EpisodeStats.create(P * N, self.reward_dim, self.device),
            gen=gen,
            global_step=0,
        )

    # ---------------------------------------------------------------- policy

    def _norm_obs(self, obs_norm: ObsNormState, obs: torch.Tensor) -> torch.Tensor:
        if not self.cfg.normalize_obs:
            return obs
        return torch.clamp((obs - obs_norm.mean[:, None]) / torch.sqrt(obs_norm.var + 1e-8)[:, None], -10.0, 10.0)

    def _gaussian_logp(self, pi, log_std, actions):
        std = torch.exp(log_std)[:, None]
        return torch.sum(-0.5 * ((actions - pi) / std) ** 2 - log_std[:, None] - 0.5 * _LOG_2PI, dim=-1)

    def _dist(self, net: MOPPONet, obs: torch.Tensor, noise: torch.Tensor):
        """Sampled action, its log-prob and the values; ``noise`` is standard
        normals (Gaussian) or uniforms in (0, 1) for Gumbel-max (categorical)."""
        pi, log_std, v = net(obs)
        if self.continuous:
            a = pi + torch.exp(log_std)[:, None] * noise
            return a, self._gaussian_logp(pi, log_std, a), v
        logp_all = F.log_softmax(pi, dim=-1)
        a = torch.argmax(pi - torch.log(-torch.log(noise)), dim=-1)
        return a, torch.gather(logp_all, -1, a[..., None]).squeeze(-1), v

    def _logp_entropy(self, net: MOPPONet, obs: torch.Tensor, actions: torch.Tensor):
        pi, log_std, v = net(obs)
        if self.continuous:
            logp = self._gaussian_logp(pi, log_std, actions)
            ent = torch.sum(log_std + 0.5 * _LOG_2PI_E, dim=-1)[:, None].expand_as(logp)
            return logp, ent, v
        logp_all = F.log_softmax(pi, dim=-1)
        logp = torch.gather(logp_all, -1, actions[..., None].long()).squeeze(-1)
        return logp, -torch.sum(torch.exp(logp_all) * logp_all, dim=-1), v

    def _noise(self, state: MOPPOState) -> torch.Tensor:
        shape, g = (state.members, self.cfg.num_envs, self.action_dim), state.gen
        if self.continuous:
            return torch.randn(shape, generator=g, device=g.device)
        return torch.rand(shape, generator=g, device=g.device).clamp_(min=1e-12)

    # ------------------------------------------------------------ iteration

    @torch.no_grad()
    def rollout(self, state: MOPPOState, w: torch.Tensor) -> Rollout:
        """T = steps_per_iteration // num_envs steps of all P·N envs (reference
        :580-600): obs normalized with the statistics before this step's
        update, the env given the clipped action while the unclipped one and
        its log-prob are stored, rewards normalized (clip 10); then the
        bootstrap, per-objective GAE and the advantage scalarized by ``w`` (P, d)."""
        cfg = self.cfg
        P, N, T = state.members, cfg.num_envs, cfg.steps_per_iteration // cfg.num_envs
        recs = []
        for _ in range(T):
            nobs = self._norm_obs(state.obs_norm, state.obs)
            a, logp, v = self._dist(state.net, nobs, self._noise(state))
            act_env = torch.clamp(a, -1.0, 1.0).reshape(P * N, -1) if self.continuous else a.reshape(P * N)
            out = state.venv.step(state.env_state, act_env, state.gen)
            done = out.terminated | out.truncated
            state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)
            reward, done = out.reward.reshape(P, N, -1), done.reshape(P, N)
            if cfg.normalize_reward:
                state.rew_norm, reward = normalize_reward(state.rew_norm, reward, done, cfg.gamma, clip=10.0)
            if cfg.normalize_obs:
                state.obs_norm = update_obs_norm(state.obs_norm, state.obs)
            state.env_state, state.obs = out.state, out.obs.reshape(P, N, -1)
            state.global_step += N
            recs.append((nobs, a, logp, v, reward, done.to(torch.float32)))
        obs_t, act_t, logp_t, v_t, rew_t, done_t = (torch.stack(x) for x in zip(*recs))

        _, _, last_v = state.net(self._norm_obs(state.obs_norm, state.obs))
        adv_t = vector_gae(v_t, rew_t, done_t, last_v, cfg.gamma, cfg.gae_lambda)

        def flat(x):  # (T, P, N, ...) -> (P, T·N, ...), row t·N + n as the JAX package flattens
            return x.transpose(0, 1).reshape(P, T * N, *x.shape[3:])

        adv_vec = flat(adv_t)
        return Rollout(
            obs=flat(obs_t),
            act=flat(act_t),
            logp=flat(logp_t),
            adv=torch.einsum("pbd,pd->pb", adv_vec, w),
            ret=flat(adv_t + v_t),
            val=flat(v_t),
        )

    def minibatch_loss(self, net: MOPPONet, batch: Rollout, idx: torch.Tensor) -> torch.Tensor:
        """Per-member PPO loss (P,) on the rows ``idx`` (P, mb) of each member's batch."""
        cfg = self.cfg
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        obs, act, old_logp, mb_adv, ret, val = (x[rows, idx] for x in batch)
        if cfg.norm_adv:
            mb_adv = (mb_adv - mb_adv.mean(dim=-1, keepdim=True)) / (mb_adv.std(dim=-1, correction=0, keepdim=True) + 1e-8)
        logp, ent, v = self._logp_entropy(net, obs, act)
        ratio = torch.exp(logp - old_logp)
        pg1 = -mb_adv * ratio
        pg2 = -mb_adv * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
        pg_loss = torch.maximum(pg1, pg2).mean(dim=-1)
        if cfg.clip_vloss:
            v_clip = val + torch.clamp(v - val, -cfg.clip_coef, cfg.clip_coef)
            v_loss = 0.5 * torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2).mean(dim=(-2, -1))
        else:
            v_loss = 0.5 * ((v - ret) ** 2).mean(dim=(-2, -1))
        return pg_loss - cfg.ent_coef * ent.mean(dim=-1) + cfg.vf_coef * v_loss

    def minibatch_step(self, state: MOPPOState, batch: Rollout, idx: torch.Tensor) -> torch.Tensor:
        """One clipped Adam step of every member on its minibatch; returns the losses (P,)."""
        state.optimizer.zero_grad()
        loss = self.minibatch_loss(state.net, batch, idx)
        loss.sum().backward()
        clip_grad_global_norm_members_(state.optimizer.params, self.cfg.max_grad_norm)
        state.optimizer.step()
        return loss.detach()

    def update(self, state: MOPPOState, batch: Rollout, perms: torch.Tensor | None = None) -> torch.Tensor:
        """``update_epochs`` epochs of ``num_minibatches`` contiguous slices of
        one random permutation per member and epoch (reference :265-296);
        ``perms`` (epochs, P, B) is drawn from the state's generator unless
        given.  Returns the mean loss per member (P,)."""
        cfg = self.cfg
        P, B = batch.adv.shape
        mb = B // cfg.num_minibatches
        g = state.gen
        losses = []
        for e in range(cfg.update_epochs):
            perm = perms[e] if perms is not None else torch.argsort(torch.rand((P, B), generator=g, device=g.device), dim=1)
            for i in range(cfg.num_minibatches):
                losses.append(self.minibatch_step(state, batch, perm[:, i * mb : (i + 1) * mb]))
        return torch.stack(losses).mean(dim=0)

    def train_iteration(self, state: MOPPOState, w: torch.Tensor) -> torch.Tensor:
        """One PPO iteration of every member, in place: rollout + GAE +
        clipped updates (reference :580-613); ``w`` (P, d) or (d,)."""
        w = w.reshape(-1, self.reward_dim).expand(state.members, -1)
        return self.update(state, self.rollout(state, w))

    def train(self, total_timesteps: int, state: MOPPOState | None = None) -> MOPPOState:
        state = state if state is not None else self.init_state()
        for _ in range(max(1, total_timesteps // self.cfg.steps_per_iteration)):
            self.train_iteration(state, self.w)
        return state

    # ------------------------------------------------------------- snapshots

    @torch.no_grad()
    def member_params(self, state: MOPPOState, p: int) -> dict:
        """Member p's params on the host, copied."""
        return {k: v[p].detach().cpu().clone() for k, v in state.net.named_parameters()}

    @torch.no_grad()
    def member_snapshot(self, state: MOPPOState, p: int) -> MOPPOMember:
        """Copies of member p's params, Adam state, obs and reward statistics,
        envs and episode accumulators: later updates of ``state`` leave it as it is."""
        rows = slice(p * self.cfg.num_envs, (p + 1) * self.cfg.num_envs)
        return MOPPOMember(
            params=[t[p].clone() for t in state.net.parameters()],
            adam=state.optimizer.member_state(p),
            obs_norm=ObsNormState(*(x[p].clone() for x in state.obs_norm)),
            rew_norm=RewardNormState(*(x[p].clone() for x in state.rew_norm)),
            env_state=type(state.env_state)(*(x[rows].clone() for x in state.env_state)),
            obs=state.obs[p].clone(),
            stats=EpisodeStats(*(x[rows].clone() for x in state.stats)),
        )

    @torch.no_grad()
    def load_member(self, state: MOPPOState, p: int, snap: MOPPOMember) -> None:
        """Copy a snapshot into member p of ``state`` (PGMORL's "deep-copying an agent")."""
        rows = slice(p * self.cfg.num_envs, (p + 1) * self.cfg.num_envs)
        for dst, src in zip(state.net.parameters(), snap.params):
            dst[p].copy_(src)
        state.optimizer.load_member_state(p, snap.adam)
        for group, src in ((state.obs_norm, snap.obs_norm), (state.rew_norm, snap.rew_norm)):
            for dst, x in zip(group, src):
                dst[p].copy_(x)
        for group, src in ((state.env_state, snap.env_state), (state.stats, snap.stats)):
            for dst, x in zip(group, src):
                dst[rows].copy_(x)
        state.obs[p].copy_(snap.obs)

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def act_eval(self, net: MOPPONet, obs_norm: ObsNormState, obs: torch.Tensor) -> torch.Tensor:
        """Deterministic action of each member for obs (P, M, obs_dim)."""
        pi = net.actor(self._norm_obs(obs_norm, obs))
        return torch.clamp(pi, -1.0, 1.0) if self.continuous else torch.argmax(pi, dim=-1)

    def policy_eval(self, state: MOPPOState, gen: torch.Generator, rep: int = 5, w=None, max_steps: int | None = None):
        """(vec return, disc vec return), each (P, d): every member's ``rep``
        episodes under its weight ``w`` (P, d), all P·rep in one batch."""
        P, d = state.members, self.reward_dim
        w = (self.w if w is None else w).reshape(-1, d).expand(P, -1)

        def act(obs, w_, g):
            a = self.act_eval(state.net, state.obs_norm, obs.reshape(P, rep, -1))
            return a.reshape(P * rep, -1) if self.continuous else a.reshape(P * rep)

        rets, discs, _ = rollout_episode(self.env, act, w.repeat_interleave(rep, dim=0), gen, self.cfg.gamma, max_steps)
        return rets.reshape(P, rep, d).mean(dim=1), discs.reshape(P, rep, d).mean(dim=1)
