"""PCN — Pareto Conditioned Networks, N episodes collected in one batch.

PyTorch port of ``morl_baselines_tpu/agents/pcn.py`` (reference
multi_policy/pcn/pcn.py:22-539, Reymond et al., 2022): supervised learning
of pi(a | s, desired_return, desired_horizon).

- Model: a sigmoid state embedding times a sigmoid command embedding, the
  command scaled by a fixed per-env ``scaling_factor`` (reference :51-103).
- Episodic replay ranked by distance to the front with a crowding term
  (``replay/episodic.py``; reference :240-279).
- Commands: a random non-dominated episode among the 20 best; desired
  horizon its length - 2; desired return its return with uniform noise on
  one random objective, scaled by the across-episode std (reference
  :281-300).  The host draws from ``np.random.default_rng(seed)``, the seed
  an integer drawn from the agent's generator.
- In-episode command update: r <- clip((r - reward) / gamma, +-1e5),
  h <- max(h - 1, 1), frozen once the episode is done.
- Cross-entropy on discrete actions, MSE on continuous ones (reference
  :202-236), one Adam step per sampled batch.

``collect_episodes`` steps all N envs for ``max_episode_len`` steps with no
autoreset: a done env keeps stepping and its records are masked by ``live``,
as the JAX package's masked scan.  Discrete actions are Gumbel-max samples
from the agent's generator (``greedy`` takes the argmax).  The state is
updated in place; ``global_step`` is a host integer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.pareto import non_dominated_mask
from ..core.weights import equally_spaced_weights
from ..envs.base import Box, MOEnv
from ..evaluation.evaluation import multi_policy_metrics
from ..models.networks import dense
from ..replay.episodic import EpisodeBatch, EpisodicBuffer
from .base import MOAgentBase


class PCNModel(nn.Module):
    """pi(a | s, command) from a state embedding times a command embedding
    (reference pcn.py:51-103; JAX ``PCNModel``): logits, or raw actions for a
    continuous action space."""

    def __init__(
        self,
        obs_dim: int,
        reward_dim: int,
        action_dim: int,
        scaling_factor: Sequence[float],
        hidden_dim: int = 64,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.register_buffer("scaling", torch.as_tensor(scaling_factor, dtype=torch.float32))
        self.obs_embed = dense(obs_dim, hidden_dim, gen)
        self.cmd_embed = dense(reward_dim + 1, hidden_dim, gen)
        self.hidden = dense(hidden_dim, hidden_dim, gen)
        self.out = dense(hidden_dim, action_dim, gen)

    def forward(self, obs: torch.Tensor, desired_return: torch.Tensor, desired_horizon: torch.Tensor) -> torch.Tensor:
        c = torch.cat([desired_return, desired_horizon[..., None]], dim=-1) * self.scaling
        s = torch.sigmoid(self.obs_embed(obs))
        c = torch.sigmoid(self.cmd_embed(c))
        return self.out(torch.relu(self.hidden(s * c)))

    def flax_layout(self) -> dict:
        return {"Dense_0": self.obs_embed, "Dense_1": self.cmd_embed, "Dense_2": self.hidden, "Dense_3": self.out}


@dataclass(frozen=True)
class PCNConfig:
    learning_rate: float = 1e-3
    gamma: float = 1.0
    batch_size: int = 256
    hidden_dim: int = 64
    scaling_factor: tuple = (0.1, 0.1, 0.01)  # (d objectives..., horizon)
    max_buffer_episodes: int = 128
    max_episode_len: int = 128
    num_envs: int = 8  # episodes collected in parallel per round
    num_model_updates: int = 50
    noise_std_scale: float = 1.0
    seed: int = 0


@dataclass
class PCNState:
    model: PCNModel
    optimizer: torch.optim.Optimizer
    buffer: EpisodicBuffer
    gen: torch.Generator
    global_step: int
    desired_return: torch.Tensor  # (d,) the latest round's first command
    desired_horizon: torch.Tensor  # ()


class PCN(MOAgentBase):
    def __init__(self, env: MOEnv, config: PCNConfig = PCNConfig(), log: bool = False, device="cuda"):
        super().__init__(env, config, log=log, device=device)
        self.cfg = config
        self.continuous = isinstance(env.action_space, Box)
        self.action_dim = env.action_dim if self.continuous else env.num_actions
        if len(config.scaling_factor) != env.reward_dim + 1:
            raise ValueError(f"scaling_factor needs {env.reward_dim + 1} entries, got {len(config.scaling_factor)}")
        self._buffer_rank_lambda = None  # LCN ranks by Lorenz dominance

    def make_model(self, gen: torch.Generator | None = None) -> PCNModel:
        cfg = self.cfg
        return PCNModel(self.obs_dim, self.reward_dim, self.action_dim, cfg.scaling_factor, cfg.hidden_dim, gen).to(self.device)

    def init_state(self, seed: int | None = None) -> PCNState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        # params are drawn on the host, so a seed gives the same net on any device
        model = self.make_model(torch.Generator().manual_seed(seed))
        buffer = EpisodicBuffer.create(
            cfg.max_buffer_episodes,
            cfg.max_episode_len,
            self.obs_dim,
            self.reward_dim,
            action_shape=(self.action_dim,) if self.continuous else (),
            action_dtype=torch.float32 if self.continuous else torch.int64,
            device=self.device,
        )
        return PCNState(
            model=model,
            optimizer=torch.optim.Adam(model.parameters(), lr=cfg.learning_rate),
            buffer=buffer,
            gen=torch.Generator(self.device).manual_seed(seed),
            global_step=0,
            desired_return=torch.zeros((self.reward_dim,), device=self.device),
            desired_horizon=torch.tensor(float(cfg.max_episode_len), device=self.device),
        )

    # ------------------------------------------------------- episode collection

    def _gumbel(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """Gumbel(0, 1) noise (n, A) of one sampling step."""
        u = torch.rand((n, self.action_dim), generator=gen, device=gen.device)
        return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))

    @torch.no_grad()
    def collect_episodes(self, model: PCNModel, commands: torch.Tensor, gen: torch.Generator, greedy: bool = False) -> EpisodeBatch:
        """One episode per row of ``commands`` (N, d+1), each env with its own
        (return, horizon) command, all N stepped together for ``max_episode_len``
        steps; returns the padded episodes."""
        cfg, env, d = self.cfg, self.env, self.reward_dim
        n, T = commands.shape[0], cfg.max_episode_len
        st, obs = env.reset(n, gen)
        dr, dh = commands[:, :d], commands[:, d]
        done = torch.zeros((n,), device=commands.device)
        recs = []
        for _ in range(T):
            pred = model(obs, dr, dh)
            if self.continuous:
                action = pred
            elif greedy:
                action = torch.argmax(pred, dim=-1)
            else:
                action = torch.argmax(pred + self._gumbel(gen, n), dim=-1)
            out = env.step(st, action, env.sample_noise(n, gen))
            # command update (reference _run_episode), frozen once done
            ndr = torch.clamp((dr - out.reward) / max(cfg.gamma, 1e-8), -1e5, 1e5)
            ndh = torch.clamp(dh - 1.0, min=1.0)
            frozen = done > 0
            recs.append((obs, action, out.reward, 1.0 - done))
            done = torch.maximum(done, (out.terminated | out.truncated).to(torch.float32))
            dr = torch.where(frozen[:, None], dr, ndr)
            dh = torch.where(frozen, dh, ndh)
            st, obs = out.state, out.obs
        obs_t, act_t, rew_t, live_t = (torch.stack(x, dim=1) for x in zip(*recs))  # (N, T, ...)
        length = torch.clamp(live_t.sum(dim=1).to(torch.int32), min=1)
        disc = cfg.gamma ** torch.arange(T, dtype=torch.float32, device=commands.device)
        return EpisodeBatch(
            obs=obs_t,
            action=act_t,
            reward=rew_t * live_t[..., None],
            length=length,
            vec_return=torch.einsum("ntd,nt->nd", rew_t, disc * live_t),
            horizon=length.to(torch.float32),
        )

    # ---------------------------------------------------------------- commands

    def _command_mask(self, vals: np.ndarray) -> np.ndarray:
        """Which candidate returns commands are drawn from: the non-dominated ones."""
        return non_dominated_mask(torch.as_tensor(vals)).numpy()

    def choose_commands(self, buffer: EpisodicBuffer, n: int, seed: int) -> torch.Tensor:
        """(n, d+1) commands from the non-dominated episodes among the 20 best
        (reference :281-300), drawn on the host from ``default_rng(seed)``."""
        cfg = self.cfg
        vals, hors, valid = (x.cpu().numpy() for x in buffer.top_returns(min(buffer.size, 20) or 1))
        finite = np.isfinite(vals).all(axis=1)
        vals, hors = vals[valid & finite], hors[valid & finite]
        if len(vals) == 0:
            vals = np.zeros((1, self.reward_dim))
            hors = np.ones((1,)) * cfg.max_episode_len
        keep = self._command_mask(vals)
        vals, hors = vals[keep], hors[keep]
        rng = np.random.default_rng(seed)
        std = np.nan_to_num(vals.std(axis=0), nan=0.0, posinf=0.0, neginf=0.0)
        cmds = []
        for _ in range(n):
            i = rng.integers(0, len(vals))
            dr = vals[i].copy()
            j = rng.integers(0, self.reward_dim)
            dr[j] += rng.uniform(0, max(std[j], 1e-3)) * cfg.noise_std_scale
            dh = max(hors[i] - 2.0, 1.0)
            cmds.append(np.concatenate([dr, [dh]]))
        return torch.as_tensor(np.stack(cmds), dtype=torch.float32, device=self.device)

    def _draw_seed(self, gen: torch.Generator) -> int:
        return int(torch.randint(0, 2**30, (1,), generator=gen, device=gen.device))

    # ------------------------------------------------------------------ update

    def model_loss(self, model: PCNModel, obs, action, rtg, horizon) -> torch.Tensor:
        pred = model(obs, rtg, horizon)
        if self.continuous:
            return torch.mean((pred - action) ** 2)
        logp = F.log_softmax(pred, dim=-1)
        return -torch.mean(torch.gather(logp, 1, action[:, None].long()))

    def update_step(self, state: PCNState, batch) -> torch.Tensor:
        """One Adam step on a sampled (obs, action, return-to-go, horizon) batch."""
        loss = self.model_loss(state.model, *batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return loss.detach()

    def update_model(self, state: PCNState) -> torch.Tensor:
        """``num_model_updates`` steps, each on a fresh batch; returns the mean loss."""
        cfg = self.cfg
        losses = [
            self.update_step(state, state.buffer.sample_steps(state.gen, cfg.batch_size, cfg.gamma))
            for _ in range(cfg.num_model_updates)
        ]
        return torch.stack(losses).mean()

    # ------------------------------------------------------------------- train

    def _add(self, state: PCNState, eps: EpisodeBatch) -> None:
        state.buffer.add_episodes(eps, lorenz_lambda=self._buffer_rank_lambda)
        state.global_step += int(eps.length.sum())

    def train_round(self, state: PCNState) -> torch.Tensor:
        """One round in place: ``num_model_updates`` model updates, then
        ``num_envs`` new commands, their episodes collected and added;
        returns the mean loss."""
        cfg, g = self.cfg, state.gen
        loss = self.update_model(state)
        cmds = self.choose_commands(state.buffer, cfg.num_envs, self._draw_seed(g))
        self._add(state, self.collect_episodes(state.model, cmds, g))
        state.desired_return, state.desired_horizon = cmds[0, : self.reward_dim], cmds[0, self.reward_dim]
        return loss

    def train(
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        num_er_episodes: int = 32,
        eval_freq: int | None = None,
        state: PCNState | None = None,
    ) -> PCNState:
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        g = state.gen
        # warm-up: episodes under random commands of the full horizon
        warm_cmds = torch.cat(
            [
                torch.randn((num_er_episodes, self.reward_dim), generator=g, device=g.device),
                torch.full((num_er_episodes, 1), float(cfg.max_episode_len), device=g.device),
            ],
            dim=1,
        )
        for i in range(0, num_er_episodes, cfg.num_envs):
            self._add(state, self.collect_episodes(state.model, warm_cmds[i : i + cfg.num_envs], g))

        last_eval = -(10**18)
        while state.global_step < total_timesteps:
            self.train_round(state)
            if eval_freq is not None and state.global_step - last_eval < eval_freq:
                continue
            last_eval = state.global_step
            if ref_point is not None:
                front = state.buffer.data.vec_return.cpu().numpy()
                front = front[state.buffer.valid().cpu().numpy() & np.isfinite(front).all(axis=1)]
                ew = equally_spaced_weights(self.reward_dim, 32)
                metrics = multi_policy_metrics(front, np.asarray(ref_point), ew, known_pareto_front)
                self.logger.log(metrics, state.global_step)
                self._last_front, self._last_metrics = front, metrics
        return state

    # -------------------------------------------------------------------- eval

    def eval_commands(self, model: PCNModel, commands: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Returns of the episodes that re-execute ``commands`` greedily (reference :360-376)."""
        return self.collect_episodes(model, commands, gen, greedy=True).vec_return
