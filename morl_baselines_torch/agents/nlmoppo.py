"""NL-MOPPO — PPO for non-linear utilities (IPRO's inner oracle), on torch.

PyTorch port of ``morl_baselines_tpu/agents/nlmoppo.py`` (reference
single_policy/ser/nl_mo_ppo.py:26-489):

- actor and vector critic on obs ⊕ the discounted accrued reward
  (reference :40-41);
- per-objective GAE (``moppo.vector_gae``, reference :290-309); the PPO
  surrogate per objective, combined with the loss weights w = du/dv at the
  mean value of the initial states, taken with ``torch.autograd.grad``
  (reference :310-323);
- the advantages normalized per objective over the minibatch (std with
  ddof 0); global-norm clip, then Adam with eps 1e-5, the update scaled by
  ``lr_frac`` after Adam (lr annealing without rebuilding the optimizer:
  the moments are unscaled);
- ``train`` against any torch utility ``u_func``, with per-call lr annealing,
  the entropy ramp, and the best-utility evaluated iterate as its point.

A rollout is a Python loop of tensor ops where the JAX package has one
``lax.scan``; the state is updated in place; ``global_step`` is a host
integer.  Actions are Gumbel-max samples (``jax.random.categorical``'s form)
from the agent's generator; ``update`` takes the epochs' permutations when
given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..envs.base import MOEnv
from ..envs.vector import EpisodeStats, VectorMOEnv
from ..evaluation.evaluation import _DONE_CHECK_EVERY
from ..models.networks import MLP, clip_grad_global_norm_
from .base import MOAgentBase
from .moppo import vector_gae

UFunc = Callable[[torch.Tensor], torch.Tensor]


class NLAgentNet(nn.Module):
    """Actor logits and vector critic over obs ⊕ accrued (reference
    :40-120): two tanh MLPs, ``MLP_0`` for the logits and ``MLP_1`` for V."""

    def __init__(
        self,
        obs_dim: int,
        reward_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.actor = MLP(obs_dim + reward_dim, hidden, num_actions, gen, activation="tanh")
        self.critic = MLP(obs_dim + reward_dim, hidden, reward_dim, gen, activation="tanh")

    def forward(self, obs: torch.Tensor, acc: torch.Tensor):
        x = torch.cat([obs, acc], dim=-1)
        return self.actor(x), self.critic(x)

    def flax_layout(self) -> dict:
        return {"MLP_0": self.actor, "MLP_1": self.critic}


@dataclass(frozen=True)
class NLMOPPOConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_coef: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_envs: int = 8
    num_steps: int = 256  # rollout length per env
    update_epochs: int = 4
    num_minibatches: int = 4
    mc_k: int = 32  # initial states the loss weights are taken at
    hidden: tuple = (64, 64)
    # each oracle call ramps the entropy coefficient ent_coef_start -> ent_coef
    # over its first half (and anneals lr 1 -> 0)
    ent_coef_start: float | None = None  # None = constant ent_coef
    seed: int = 0


class NLRollout(NamedTuple):
    """A flattened rollout, row t·N + n: obs (B, O), acc (B, d), act (B,),
    logp (B,), adv, ret and val (B, d); ``loss_w`` (d,) = du/dv at the mean V(s0)."""

    obs: torch.Tensor
    acc: torch.Tensor
    act: torch.Tensor
    logp: torch.Tensor
    adv: torch.Tensor
    ret: torch.Tensor
    val: torch.Tensor
    loss_w: torch.Tensor


@dataclass
class NLMOPPOState:
    net: NLAgentNet
    optimizer: torch.optim.Optimizer
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    acc: torch.Tensor  # (N, d) discounted accrued reward
    gamma_pow: torch.Tensor  # (N,)
    init_obs: torch.Tensor  # (mc_k, obs_dim) sampled initial states
    stats: EpisodeStats
    gen: torch.Generator
    global_step: int


def loss_weights(u_func: UFunc, v: torch.Tensor) -> torch.Tensor:
    """du/dv at ``v`` (d,): the per-objective weights of the PPO surrogate."""
    v = v.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(u_func(v), v)
    return grad


class NLMOPPO(MOAgentBase):
    def __init__(self, env: MOEnv, config: NLMOPPOConfig = NLMOPPOConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.venv = VectorMOEnv(env, config.num_envs)

    def make_net(self, gen: torch.Generator | None = None) -> NLAgentNet:
        return NLAgentNet(self.obs_dim, self.reward_dim, self.env.num_actions, self.cfg.hidden, gen).to(self.device)

    def init_state(self, seed: int | None = None) -> NLMOPPOState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        net = self.make_net(torch.Generator().manual_seed(seed))  # drawn on the host: the same net on any device
        gen = torch.Generator(self.device).manual_seed(seed)
        env_state, obs = self.venv.reset(gen)
        _, init_obs = self.env.reset(cfg.mc_k, gen)
        return NLMOPPOState(
            net=net,
            optimizer=torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, eps=1e-5),
            env_state=env_state,
            obs=obs,
            acc=torch.zeros((cfg.num_envs, self.reward_dim), device=self.device),
            gamma_pow=torch.ones((cfg.num_envs,), device=self.device),
            init_obs=init_obs,
            stats=EpisodeStats.create(cfg.num_envs, self.reward_dim, self.device),
            gen=gen,
            global_step=0,
        )

    # ------------------------------------------------------------ iteration

    def _gumbel(self, state: NLMOPPOState) -> torch.Tensor:
        """Gumbel(0, 1) noise (N, A) of one rollout step."""
        g = state.gen
        u = torch.rand((self.cfg.num_envs, self.env.num_actions), generator=g, device=g.device)
        return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))

    @torch.no_grad()
    def rollout(self, state: NLMOPPOState, u_func: UFunc) -> NLRollout:
        """``num_steps`` steps of the N envs in place, the bootstrap, GAE and
        the loss weights at the mean V of the initial states."""
        cfg = self.cfg
        recs = []
        for _ in range(cfg.num_steps):
            logits, v = state.net(state.obs, state.acc)
            actions = torch.argmax(logits + self._gumbel(state), dim=-1)
            logp = torch.gather(F.log_softmax(logits, dim=-1), 1, actions[:, None]).squeeze(1)
            out = self.venv.step(state.env_state, actions, state.gen)
            done = out.terminated | out.truncated
            state.stats, _ = state.stats.update(out.reward, done, cfg.gamma)
            recs.append((state.obs, state.acc, actions, logp, v, out.reward, done.to(torch.float32)))
            state.acc = torch.where(done[:, None], 0.0, state.acc + state.gamma_pow[:, None] * out.reward)
            state.gamma_pow = torch.where(done, 1.0, state.gamma_pow * cfg.gamma)
            state.env_state, state.obs = out.state, out.obs
            state.global_step += cfg.num_envs
        obs_t, acc_t, act_t, logp_t, v_t, rew_t, done_t = (torch.stack(x) for x in zip(*recs))
        _, last_v = state.net(state.obs, state.acc)
        adv_t = vector_gae(v_t, rew_t, done_t, last_v, cfg.gamma, cfg.gae_lambda)
        _, v0 = state.net(state.init_obs, torch.zeros((state.init_obs.shape[0], self.reward_dim), device=self.device))
        flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731  (T, N, ...) -> row t·N + n
        return NLRollout(
            obs=flat(obs_t),
            acc=flat(acc_t),
            act=flat(act_t),
            logp=flat(logp_t),
            adv=flat(adv_t),
            ret=flat(adv_t + v_t),
            val=flat(v_t),
            loss_w=loss_weights(u_func, v0.mean(dim=0)),
        )

    def minibatch_loss(self, net: NLAgentNet, batch: NLRollout, idx: torch.Tensor, ent_coef: float) -> torch.Tensor:
        cfg = self.cfg
        adv = batch.adv[idx]  # normalized per objective over the minibatch
        adv = (adv - adv.mean(dim=0, keepdim=True)) / (adv.std(dim=0, correction=0, keepdim=True) + 1e-8)
        logits, v = net(batch.obs[idx], batch.acc[idx])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, 1, batch.act[idx][:, None].long()).squeeze(1)
        ratio = torch.exp(logp - batch.logp[idx])
        pg1 = -adv * ratio[:, None]
        pg2 = -adv * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)[:, None]
        pg_loss = torch.sum(torch.maximum(pg1, pg2).mean(dim=0) * batch.loss_w)
        val, ret = batch.val[idx], batch.ret[idx]
        v_clip = val + torch.clamp(v - val, -cfg.clip_coef, cfg.clip_coef)
        v_loss = 0.5 * torch.mean(torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2))
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        return pg_loss - ent_coef * ent + cfg.vf_coef * v_loss

    def update(
        self,
        state: NLMOPPOState,
        batch: NLRollout,
        ent_coef: float | None = None,
        lr_frac: float = 1.0,
        perms: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``update_epochs`` epochs of ``num_minibatches`` contiguous slices of
        one permutation per epoch (``perms`` (epochs, B), drawn from the
        state's generator unless given); each minibatch one clipped Adam step
        scaled by ``lr_frac``.  Returns the mean loss."""
        cfg = self.cfg
        ent_coef = cfg.ent_coef if ent_coef is None else ent_coef
        B = batch.obs.shape[0]
        mb = B // cfg.num_minibatches
        params = list(state.net.parameters())
        for group in state.optimizer.param_groups:
            group["lr"] = cfg.learning_rate * lr_frac
        g = state.gen
        losses = []
        for e in range(cfg.update_epochs):
            perm = perms[e] if perms is not None else torch.argsort(torch.rand((B,), generator=g, device=g.device))
            for i in range(cfg.num_minibatches):
                loss = self.minibatch_loss(state.net, batch, perm[i * mb : (i + 1) * mb], ent_coef)
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_grad_global_norm_(params, cfg.max_grad_norm)
                state.optimizer.step()
                losses.append(loss.detach())
        return torch.stack(losses).mean()

    def train_iteration(
        self, state: NLMOPPOState, u_func: UFunc, ent_coef: float | None = None, lr_frac: float = 1.0
    ) -> torch.Tensor:
        """One PPO iteration in place: rollout, GAE, loss weights, clipped updates."""
        return self.update(state, self.rollout(state, u_func), ent_coef, lr_frac)

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def policy_evaluate(self, state: NLMOPPOState, gen: torch.Generator, rep: int = 5, max_steps: int | None = None):
        """Mean discounted vector return (d,) of ``rep`` greedy episodes, the
        rows of one batch with no autoreset (reference :410-443).  Every
        ``_DONE_CHECK_EVERY`` steps one host read ends the loop once every
        episode is done; the frozen returns are the same."""
        env, d = self.env, self.reward_dim
        T = max_steps or env.max_episode_steps or 500
        st, obs = env.reset(rep, gen)
        acc = torch.zeros((rep, d), device=obs.device)
        gpow = torch.ones((rep,), device=obs.device)
        done = torch.zeros((rep,), device=obs.device)
        for t in range(T):
            if t > 0 and t % _DONE_CHECK_EVERY == 0 and bool((done > 0).all()):
                break
            logits, _ = state.net(obs, acc)
            out = env.step(st, torch.argmax(logits, dim=-1), env.sample_noise(rep, gen))
            acc = acc + ((1.0 - done) * gpow)[:, None] * out.reward
            gpow = torch.where(done > 0, gpow, gpow * self.cfg.gamma)
            done = torch.maximum(done, (out.terminated | out.truncated).to(torch.float32))
            st, obs = out.state, out.obs
        return acc.mean(dim=0)

    def train(self, total_timesteps: int, u_func: UFunc, state: NLMOPPOState | None = None):
        """Train against the utility; returns (state, pareto point (d,) numpy).

        Per call, lr anneals 1 -> 0 and the entropy coefficient ramps
        ent_coef_start -> ent_coef (when set) over the first half; the point
        is the best-by-u of the evaluated iterates (each iteration's and the
        final one's).  Evaluation i draws from a generator seeded
        ``seed + 7 + i``, the final one ``seed + 7``."""
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        n_iters = max(1, total_timesteps // (cfg.num_envs * cfg.num_steps))
        utility = lambda p: float(u_func(torch.as_tensor(p, dtype=torch.float32, device=self.device)))  # noqa: E731
        evaluate = lambda s: self.policy_evaluate(state, torch.Generator(self.device).manual_seed(s)).cpu().numpy()  # noqa: E731
        best_point, best_u = None, -np.inf
        for i in range(n_iters):
            ramp = min(i / max(n_iters - 1, 1) / 0.5, 1.0)
            ent = cfg.ent_coef if cfg.ent_coef_start is None else cfg.ent_coef_start + (cfg.ent_coef - cfg.ent_coef_start) * ramp
            self.train_iteration(state, u_func, ent, lr_frac=1.0 - i / n_iters)
            if n_iters > 1:
                pt = evaluate(cfg.seed + 7 + i)
                u_val = utility(pt)
                if u_val > best_u:
                    best_u, best_point = u_val, pt
        point = evaluate(cfg.seed + 7)
        if best_point is not None and best_u > utility(point):
            point = best_point
        return state, point
