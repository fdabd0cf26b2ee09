"""EUPG — Expected Utility Policy Gradient (ESR criterion), N envs on a device.

PyTorch port of ``morl_baselines_tpu/agents/eupg.py`` (reference
single_policy/esr/eupg.py:22-398; Roijers et al., 2018): REINFORCE with a
policy conditioned on the *accrued reward* (the ESR state), loss
-E[log pi(a | s, R_acc) * u(discounted forward rewards)] with an arbitrary,
possibly non-linear, utility u (reference :237-251).

N envs collect a fixed-length on-policy chunk (chunk >= the max episode
length); the discounted reward-to-go is a reverse recursion that resets at
episode ends; the update runs over the steps of episodes *completed* inside
the chunk (incomplete tails are masked out), one Adam step per chunk with
optax ``adam``'s defaults.  Actions are Gumbel-max samples: argmax(logits +
Gumbel noise), the form ``jax.random.categorical`` takes, with the noise
drawn from the agent's generator (``_gumbel``).  The utility ``u`` takes
torch tensors; it is the whole preference, so the JAX package's unread
``weights`` argument is not ported.  The JAX package's episode statistics are updated there but
never read; the port leaves them out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import torch
from torch import nn

from ..envs.base import MOEnv
from ..envs.vector import VectorMOEnv
from ..models.networks import MLP, dense
from .base import MOAgentBase


class PolicyNet(nn.Module):
    """pi(a | s, accrued_reward): logits over actions from obs ⊕ accrued
    through a tanh MLP (reference eupg.py:33-76; JAX ``eupg.py:35-45``)."""

    def __init__(
        self,
        obs_dim: int,
        reward_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.mlp = MLP(obs_dim + reward_dim, hidden, None, gen, activation="tanh")
        self.head = dense(hidden[-1], num_actions, gen)

    def forward(self, obs: torch.Tensor, accrued: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(torch.cat([obs, accrued], dim=-1)))

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp, "Dense_0": self.head}


@dataclass(frozen=True)
class EUPGConfig:
    learning_rate: float = 1e-3
    gamma: float = 0.99
    num_envs: int = 16
    chunk_len: int = 200  # >= env max episode length for unbiased episode updates
    hidden: tuple = (64, 64)
    seed: int = 0


class Chunk(NamedTuple):
    """One on-policy chunk, each (T, N, ...): the obs and accrued reward from
    before each step, the action, the step's reward and its done."""

    obs: torch.Tensor
    accrued: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclass
class EUPGState:
    net: PolicyNet
    optimizer: torch.optim.Optimizer
    env_state: tuple
    obs: torch.Tensor  # (N, obs_dim)
    accrued: torch.Tensor  # (N, d)
    gen: torch.Generator
    global_step: int


def reward_to_go(reward: torch.Tensor, done: torch.Tensor, gamma: float) -> torch.Tensor:
    """Forward discounted reward within each episode (reference :263-271):
    rtg_t = r_t + gamma * rtg_{t+1} * (1 - done_t), over (T, N, d) rewards."""
    keep = gamma * (1.0 - done.to(torch.float32))[..., None]  # (T, N, 1)
    rtg = torch.empty_like(reward)
    nxt = torch.zeros_like(reward[0])
    for t in range(reward.shape[0] - 1, -1, -1):
        nxt = torch.addcmul(reward[t], nxt, keep[t])
        rtg[t] = nxt
    return rtg


def completed_mask(done: torch.Tensor) -> torch.Tensor:
    """1 where the step belongs to an episode that ends inside the chunk: a
    reverse cummax of done over time (T, N)."""
    return torch.cummax(done.to(torch.float32).flip(0), dim=0).values.flip(0)


class EUPG(MOAgentBase):
    def __init__(
        self,
        env: MOEnv,
        scalarization: Callable[[torch.Tensor], torch.Tensor],
        config: EUPGConfig = EUPGConfig(),
        log: bool = False,
        device="cuda",
    ):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.u = scalarization  # u(vec_return) -> scalar, batched over leading dims
        self.venv = VectorMOEnv(env, config.num_envs)

    def make_net(self, gen: torch.Generator | None = None) -> PolicyNet:
        return PolicyNet(self.obs_dim, self.reward_dim, self.env.num_actions, self.cfg.hidden, gen).to(self.device)

    def init_state(self, seed: int | None = None) -> EUPGState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        # params are drawn on the host, so a seed gives the same net on any device
        net = self.make_net(torch.Generator().manual_seed(seed))
        gen = torch.Generator(self.device).manual_seed(seed)
        env_state, obs = self.venv.reset(gen)
        return EUPGState(
            net=net,
            optimizer=torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8),
            env_state=env_state,
            obs=obs,
            accrued=torch.zeros((cfg.num_envs, self.reward_dim), device=self.device),
            gen=gen,
            global_step=0,
        )

    def _gumbel(self, state: EUPGState) -> torch.Tensor:
        """Gumbel(0, 1) noise (N, A) of one sampling step: -log(-log(u)), u in [tiny, 1)."""
        g = state.gen
        u = torch.rand((self.cfg.num_envs, self.env.num_actions), generator=g, device=g.device)
        return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))

    @torch.no_grad()
    def collect(self, state: EUPGState) -> Chunk:
        """Step the N envs ``chunk_len`` times on the policy, in place; returns the chunk."""
        cfg = self.cfg
        rows = []
        for _ in range(cfg.chunk_len):
            actions = torch.argmax(state.net(state.obs, state.accrued) + self._gumbel(state), dim=-1)
            out = self.venv.step(state.env_state, actions, state.gen)
            done = out.terminated | out.truncated
            rows.append((state.obs, state.accrued, actions, out.reward, done))
            state.accrued = torch.where(done[:, None], 0.0, state.accrued + out.reward)
            state.env_state, state.obs = out.state, out.obs
            state.global_step += cfg.num_envs
        return Chunk(*(torch.stack(x) for x in zip(*rows)))

    def loss(self, net: PolicyNet, chunk: Chunk) -> torch.Tensor:
        """-sum(log pi(a) * u(reward-to-go) * completed) / max(sum(completed), 1)."""
        utilities = self.u(reward_to_go(chunk.reward, chunk.done, self.cfg.gamma))  # (T, N)
        completed = completed_mask(chunk.done)
        logp = torch.log_softmax(net(chunk.obs, chunk.accrued), dim=-1)
        lp_a = torch.gather(logp, -1, chunk.action[..., None]).squeeze(-1)
        return -torch.sum(lp_a * utilities * completed) / torch.clamp(torch.sum(completed), min=1.0)

    def train_segment(self, state: EUPGState) -> torch.Tensor:
        """Collect one on-policy chunk and apply one REINFORCE update; returns the loss."""
        chunk = self.collect(state)
        loss = self.loss(state.net, chunk)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return loss.detach()

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def act_eval(self, net: PolicyNet, obs: torch.Tensor, accrued: torch.Tensor, gen=None) -> torch.Tensor:
        return torch.argmax(net(obs, accrued), dim=-1)

    @torch.no_grad()
    def _eval_esr(self, net: PolicyNet, gen: torch.Generator, rep: int = 5):
        """ESR evaluation (reference eval_mo_reward_conditioned, evaluation.py:70):
        ``rep`` greedy episodes conditioned on their accrued reward, the rows of
        one batch, ``max_episode_steps`` (or 500) steps with no autoreset;
        returns the mean vector return and discounted return."""
        env, d = self.env, self.reward_dim
        state, obs = env.reset(rep, gen)
        acc = torch.zeros((rep, d), device=obs.device)
        ret, disc = torch.zeros_like(acc), torch.zeros_like(acc)
        done = torch.zeros((rep,), device=obs.device)
        gpow = torch.ones((rep,), device=obs.device)
        for _ in range(env.max_episode_steps or 500):
            out = env.step(state, self.act_eval(net, obs, acc), env.sample_noise(rep, gen))
            live = (1.0 - done)[:, None]
            ret = ret + live * out.reward
            disc = disc + live * gpow[:, None] * out.reward
            gpow = torch.where(done > 0, gpow, gpow * self.cfg.gamma)
            acc = acc + live * out.reward
            done = torch.maximum(done, (out.terminated | out.truncated).to(torch.float32))
            state, obs = out.state, out.obs
        return ret.mean(dim=0), disc.mean(dim=0)

    def train(self, total_timesteps: int, eval_freq: int = 10_000, state: EUPGState | None = None) -> EUPGState:
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        n_segs = max(1, total_timesteps // (cfg.num_envs * cfg.chunk_len))
        next_eval = eval_freq
        for i in range(n_segs):
            loss = self.train_segment(state)
            if state.global_step >= next_eval:
                next_eval += eval_freq
                ret, disc = self._eval_esr(state.net, torch.Generator(self.device).manual_seed(i))
                self.logger.log(
                    {
                        "eval/scalarized_return": float(self.u(ret)),
                        "eval/discounted_scalarized_return": float(self.u(disc)),
                        "losses/loss": float(loss),
                    },
                    state.global_step,
                )
                self._last_eval = (ret.cpu().numpy(), disc.cpu().numpy())
        return state
