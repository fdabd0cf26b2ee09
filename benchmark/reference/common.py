"""Plain PyTorch pieces of the reference: minecart, replay, Adam, the GEMM.

Written from the published descriptions (MO-Gymnasium's minecart, DQN replay,
proportional PER, Adam as optax computes it) in plain tensor operations.  It
imports nothing of the program under test.  The reference draws its random
numbers from its own ``torch.Generator``, seeded as the program's, in the
order, shapes and dtypes in which the program's actor-learner iteration draws
them: that order is part of what the comparison holds the program to.

``Precision("tf32")`` is the control: every Q-net GEMM rounds its operands to
TF32 (10 mantissa bits, round to nearest even) and accumulates in float32, as
the tensor cores do when ``allow_tf32`` is on, in the forward and the backward.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# ----------------------------------------------------------------- precision


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(round_tf32(x), round_tf32(w))

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = round_tf32(gy)
        gx = torch.matmul(gy, round_tf32(w).transpose(-1, -2))
        gw = torch.matmul(round_tf32(x).transpose(-1, -2), gy)
        # broadcast leading axes of x (a shared input) are summed back
        while gw.dim() > w.dim():
            gw = gw.sum(0)
        while gx.dim() > x.dim():
            gx = gx.sum(0)
        return gx, gw


class Precision:
    """How the reference computes its Q-net GEMMs: ``"f32"`` in full float32
    (TF32 off), ``"tf32"`` with TF32 operands (the control)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _TF32MatMul.apply(x, w)
        return torch.matmul(x, w)


def full_float32() -> None:
    """cuBLAS and cuDNN in full float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ schedules


def linear_decay(initial: float, decay: int | None, step: int, warmup: int, final: float) -> float:
    """DQN's linearly decaying value, in float32; ``decay`` None holds ``initial``."""
    if decay is None:
        return float(initial)
    f32 = np.float32
    bonus = f32(initial - final) * (f32(decay + warmup) - f32(step)) / f32(decay)
    return float(np.clip(bonus + f32(final), f32(min(initial, final)), f32(max(initial, final))))


def gaussian_weights(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """``n`` weight vectors |N(0, 1)| normalized to sum 1."""
    g = torch.randn((n, d), generator=gen, device=gen.device).abs()
    return g / g.sum(dim=-1, keepdim=True)


# ------------------------------------------------------------------- minecart

_MINE_ANGLES = np.deg2rad(np.linspace(15.0, 75.0, 5)).astype(np.float32)
_MINE_POS = np.stack([0.7 * np.cos(_MINE_ANGLES), 0.7 * np.sin(_MINE_ANGLES)], axis=-1)
_T = np.linspace(0.0, 1.0, 5, dtype=np.float32)
_MINE_MEANS = np.stack([0.65 * (1 - _T) + 0.05 * _T, 0.05 * (1 - _T) + 0.65 * _T], axis=-1)


class Cart(NamedTuple):
    pos: torch.Tensor
    speed: torch.Tensor
    angle: torch.Tensor
    cargo: torch.Tensor
    departed: torch.Tensor
    t: torch.Tensor


class Minecart:
    """Minecart (Abels et al., 2019) over ``n`` carts with same-step autoreset.

    Home is the origin of the unit square; 5 mines on an arc of radius 0.7;
    actions 0 mine, 1 left, 2 right, 3 accelerate, 4 brake, 5 none; the
    observation is (x, y, speed / max speed, sin, cos, cargo1, cargo2); the
    reward (ore1 sold, ore2 sold, fuel); an episode ends on a sale, or is cut
    at ``horizon`` steps.  Ore amounts are N(mine mean, 0.1) clipped at 0 and
    scaled to the room left under a capacity of 1.5."""

    obs_dim, num_actions, reward_dim = 7, 6, 3

    def __init__(self, n: int, device, horizon: int = 1000, stochastic: bool = True):
        self.n, self.horizon, self.stochastic = n, horizon, stochastic
        self.mine_pos = torch.as_tensor(_MINE_POS, device=device)
        self.mine_means = torch.as_tensor(_MINE_MEANS, device=device)
        self.device = device

    def start(self) -> Cart:
        n, dev = self.n, self.device
        return Cart(
            pos=torch.zeros((n, 2), device=dev),
            speed=torch.zeros((n,), device=dev),
            angle=torch.full((n,), float(np.float32(np.deg2rad(45.0))), device=dev),
            cargo=torch.zeros((n, 2), device=dev),
            departed=torch.zeros((n,), dtype=torch.bool, device=dev),
            t=torch.zeros((n,), dtype=torch.int32, device=dev),
        )

    @staticmethod
    def observe(s: Cart) -> torch.Tensor:
        return torch.cat([s.pos, (s.speed / 0.02)[:, None], torch.sin(s.angle)[:, None], torch.cos(s.angle)[:, None], s.cargo], dim=-1)

    def step(self, s: Cart, a: torch.Tensor, gen: torch.Generator):
        """One step of every cart: (next state after autoreset, next obs,
        reward, terminated, truncated, the obs before the reset)."""
        noise = torch.randn((self.n, 2), generator=gen, device=gen.device) if self.stochastic else None
        rot = float(np.float32(np.deg2rad(15.0)))
        angle = s.angle + torch.where(a == 1, rot, 0.0) - torch.where(a == 2, rot, 0.0)
        speed = s.speed + torch.where(a == 3, 0.0025, 0.0)
        speed = torch.clamp(torch.where(a == 4, speed * 0.5, speed), 0.0, 0.02)
        pos = torch.clamp(s.pos + speed[:, None] * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1), 0.0, 1.0)
        d2 = torch.sum((self.mine_pos[None] - pos[:, None]) ** 2, dim=-1)
        can_mine = (a == 0) & torch.any(d2 <= 0.14**2, dim=-1)
        mean = self.mine_means[torch.argmin(d2, dim=-1)]
        ore = torch.clamp(mean + 0.1 * noise, min=0.0) if self.stochastic else mean
        room = 1.5 - torch.sum(s.cargo, dim=-1)
        ore = ore * torch.clamp(room / torch.clamp(torch.sum(ore, dim=-1), min=1e-8), max=1.0)[:, None]
        cargo = s.cargo + torch.where(can_mine[:, None], ore, 0.0)
        home = torch.sum(pos**2, dim=-1) <= 0.15**2
        departed = s.departed | ~home
        sell = home & departed & (torch.sum(cargo, dim=-1) > 0)
        fuel = -0.005 + torch.where(a == 3, -0.025, 0.0) + torch.where(a == 0, -0.05, 0.0)
        reward = torch.cat([torch.where(sell[:, None], cargo, 0.0), fuel[:, None]], dim=-1)
        nxt = Cart(pos, speed, angle, torch.where(sell[:, None], 0.0, cargo), departed, s.t + 1)
        truncated = nxt.t >= self.horizon
        final_obs = self.observe(nxt)
        done = sell | truncated
        fresh = self.start()
        nxt = Cart(*(torch.where(done.reshape(-1, *[1] * (x.dim() - 1)), f, x) for f, x in zip(fresh, nxt)))
        obs = torch.where(done[:, None], self.observe(fresh), final_obs)
        return nxt, obs, reward, sell, truncated, final_obs


# --------------------------------------------------------------------- replay


def proportional(priorities: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rows drawn in proportion to ``priorities`` at uniforms ``u`` in [0, 1):
    the inverse of the cumulative priorities."""
    cdf = torch.cumsum(priorities, dim=0)
    return torch.clamp(torch.searchsorted(cdf, u * torch.clamp(cdf[-1], min=1e-12), right=True), 0, priorities.shape[0] - 1)


class Replay:
    """A ring of transitions with uniform sampling (with replacement), or
    proportional prioritized sampling (``per``); new rows take the running
    maximum priority.  ``drawn`` keeps the rows of every sample; with PER,
    ``follow`` (a list) gives the rows to take in place of the draws, in
    order: another side's, so that both learn on the same batches.  A row
    drawn twice in one batch keeps its last new priority in ``prio``;
    ``prio_lo`` and ``prio_hi`` keep the least and the largest of the values
    written to it, any of which another side may keep."""

    def __init__(self, capacity: int, obs_dim: int, reward_dim: int, device, per: bool):
        self.capacity, self.per, self.ptr, self.size = capacity, per, 0, 0
        self.drawn, self.follow = [], None
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        self.obs, self.next_obs = z(capacity, obs_dim), z(capacity, obs_dim)
        self.action, self.reward, self.term = z(capacity, dtype=torch.int64), z(capacity, reward_dim), z(capacity)
        if per:
            self.prio, self.prio_lo, self.prio_hi = z(capacity), z(capacity), z(capacity)
            self.max_prio = torch.ones((), device=device)

    def add(self, obs, action, reward, next_obs, terminated) -> None:
        n = obs.shape[0]
        idx = (self.ptr + torch.arange(n, device=obs.device)) % self.capacity
        if self.per:
            for prio in (self.prio, self.prio_lo, self.prio_hi):
                prio[idx] = self.max_prio
        self.obs[idx], self.action[idx], self.reward[idx] = obs, action.long(), reward
        self.next_obs[idx], self.term[idx] = next_obs, terminated.float()
        self.ptr, self.size = (self.ptr + n) % self.capacity, min(self.size + n, self.capacity)

    def sample(self, gen: torch.Generator, b: int) -> torch.Tensor:
        """``b`` row indices."""
        if not self.per:
            idx = torch.randint(0, max(self.size, 1), (b,), generator=gen, device=gen.device)
        else:
            idx = proportional(self.prio, torch.rand((b,), generator=gen, device=gen.device))
            if self.follow is not None:
                idx = self.follow.pop(0)
        self.drawn.append(idx)
        return idx

    def rows(self, idx: torch.Tensor):
        return self.obs[idx], self.action[idx], self.reward[idx], self.next_obs[idx], self.term[idx]

    def set_priorities(self, idx: torch.Tensor, p: torch.Tensor) -> None:
        p = torch.clamp(p, min=1e-12)
        rows, order = torch.sort(idx, stable=True)
        last = torch.ones_like(rows, dtype=torch.bool)
        last[:-1] = rows[1:] != rows[:-1]
        self.prio[rows[last]] = p[order[last]]
        self.prio_lo.scatter_reduce_(0, idx, p, "amin", include_self=False)
        self.prio_hi.scatter_reduce_(0, idx, p, "amax", include_self=False)
        self.max_prio = torch.maximum(self.max_prio, p.max())


# ----------------------------------------------------------------------- Adam


class Adam:
    """Adam as optax computes it: lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps, self.t = params, lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps))


def clip_global_norm(grads: dict, max_norm: float | None) -> dict:
    """Gradients scaled by max_norm / |g| where the global norm |g| reaches max_norm."""
    if max_norm is None:
        return grads
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    return {k: g * scale for k, g in grads.items()}


def lecun_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in)
