"""Envelope Q-learning (Yang et al., 2019) with a NatureCNN Q-net on stacked
frames of the pixel Deep Sea Treasure, in plain PyTorch.

The Q-net is morl-baselines' Envelope ``QNet`` for image observations: the
``NatureCNN`` trunk of Mnih et al. (2015) on the 4 stacked 84 x 84 frames
divided by 255 (convolutions of 32 filters 8 x 8 at stride 4, 64 filters
4 x 4 at stride 2, 64 filters 3 x 3 at stride 1, each with a ReLU, the
output flattened in (C, H, W) order as ``nn.Flatten`` does, then a dense
layer of 512 with a ReLU), and the conditioned head on features||w.
Convolutions are ``F.conv2d``, dense layers a matrix product.

The iteration is ``reference/envelope.py``'s: the act, one step of every env
(``reference/pixel.py``), the transitions stored, the episode weights
redrawn, the updates of the envelope loss over ``num_sample_w`` sampled
weights, the global-norm clip, Adam and the hard target copy.  The update
is computed as the published code computes it: the batch tiled over the W
sampled weights (B·W rows), and the target side's every tiled row under
each sampled weight (B·W·W rows) through both nets.  (Each distinct frame
once is the same mathematics in another order of summation, but cuDNN picks
other algorithms at other batch sizes, and Adam's first steps, near
lr·sign(g), turn that rounding into a divergence at the TF32 control's size
on some seeds: 1.85e-2 on the first loss in 1 of 12 runs on an H100.)

``Precision("tf32")`` (the control) rounds the convolutions' inputs and
kernels to TF32 too, in the forward and the backward, as cuDNN does with
``allow_tf32`` on.

Replay keeps the frame rows it has been given: its storage grows with the
rows stored, to ``buffer_size`` at most, so a run of a few iterations holds
a few iterations' rows whatever the capacity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Adam, Precision, Replay, clip_global_norm, gaussian_weights, round_tf32
from .envelope import EnvelopeReference
from .pixel import PixelStack


def trunk_spec(cfg: dict) -> list[tuple[int, int, int, int, int, int]]:
    """(in channels, out channels, kernel, stride, height in, height out) of
    each convolution; frames are square."""
    c, h, w = cfg["image_shape"]
    if h != w:
        raise ValueError(f"square frames only, not {h}x{w}")
    out = []
    for filters, kernel, stride in cfg["trunk"]["convs"]:
        ho = (h - kernel) // stride + 1
        out.append((c, filters, kernel, stride, h, ho))
        c, h = filters, ho
    return out


def flat_dim(cfg: dict) -> int:
    *_, cout, _, _, _, ho = trunk_spec(cfg)[-1]
    return cout * ho * ho


def param_shapes(cfg: dict, reward_dim: int, num_actions: int) -> dict:
    """Leaf name -> (shape, fan_in): ``cnn.0``..``cnn.2`` the convolutions
    (out, in, kh, kw) with fan-in in·kh·kw, ``cnn.3`` the dense layer (in,
    out), ``mlp.i`` the head's layers (in, out)."""
    out = {}
    for i, (cin, cout, k, _, _, _) in enumerate(trunk_spec(cfg)):
        out[f"cnn.{i}.weight"] = ((cout, cin, k, k), cin * k * k)
        out[f"cnn.{i}.bias"] = ((cout,), None)
    i = len(cfg["trunk"]["convs"])
    features = cfg["trunk"]["features"]
    out[f"cnn.{i}.weight"] = ((flat_dim(cfg), features), flat_dim(cfg))
    out[f"cnn.{i}.bias"] = ((features,), None)
    sizes = [features + reward_dim, *cfg["hidden"], num_actions * reward_dim]
    for j, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"mlp.{j}.weight"] = ((a, b), a)
        out[f"mlp.{j}.bias"] = ((b,), None)
    return out


class _TF32Conv(torch.autograd.Function):
    """A convolution with TF32 operands and float32 accumulation, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv2d(round_tf32(x), round_tf32(w), stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = round_tf32(gy)
        gx = torch.nn.grad.conv2d_input(x.shape, round_tf32(w), gy, stride=ctx.stride)
        gw = torch.nn.grad.conv2d_weight(round_tf32(x), w.shape, gy, stride=ctx.stride)
        return gx, gw, None


class FrameReplay(Replay):
    """``Replay`` over frame rows, its storage allocated as rows arrive."""

    def __init__(self, capacity: int, obs_dim: int, reward_dim: int, device, per: bool):
        super().__init__(capacity, 0, reward_dim, device, per)
        self.obs, self.next_obs = (torch.zeros((0, obs_dim), device=device) for _ in range(2))

    def add(self, obs, action, reward, next_obs, terminated) -> None:
        need = min(self.capacity, self.size + obs.shape[0])
        if self.obs.shape[0] < need:
            grow = lambda x: torch.cat([x, x.new_zeros((need - x.shape[0], x.shape[1]))])  # noqa: E731
            self.obs, self.next_obs = grow(self.obs), grow(self.next_obs)
        super().add(obs, action, reward, next_obs, terminated)


class EnvelopePixelReference(EnvelopeReference):
    def __init__(self, cfg: dict, traffic: dict, params: dict, seed: int, device, precision: str = "f32"):
        self.cfg, self.tr, self.prec = cfg, traffic, Precision(precision)
        n = traffic["num_envs"]
        self.env = PixelStack(n, device)
        self.d, self.A = self.env.reward_dim, self.env.num_actions
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.target = {k: v.detach().clone() for k, v in params.items()}
        self.opt = Adam(self.params, cfg["learning_rate"])
        self.gen = torch.Generator(device).manual_seed(seed)
        self.buffer = FrameReplay(traffic["buffer_size"], self.env.obs_dim, self.d, device, traffic["per"])
        self.state = self.env.start()
        self.obs = PixelStack.observe(self.state)
        self.weights = gaussian_weights(self.gen, n, self.d)
        self.global_step, self.iters, self.loss = 0, 0, None
        self.n_layers = len(cfg["hidden"]) + 1
        self.spec = trunk_spec(cfg)

    def conv(self, x, w, b, stride):
        if self.prec.name == "tf32":
            return _TF32Conv.apply(x, w, stride) + b[:, None, None]
        return F.conv2d(x, w, b, stride=stride)

    def trunk(self, p: dict, obs: torch.Tensor) -> torch.Tensor:
        """(N, features) of the flat stacked frames ``obs`` (N, k·H·W)."""
        c, h, w = self.cfg["image_shape"]
        x = obs.reshape(-1, c, h, w) / 255.0
        for i, (_, _, _, stride, _, _) in enumerate(self.spec):
            x = torch.relu(self.conv(x, p[f"cnn.{i}.weight"], p[f"cnn.{i}.bias"], stride))
        i = len(self.spec)
        return torch.relu(self.prec.mm(x.flatten(1), p[f"cnn.{i}.weight"]) + p[f"cnn.{i}.bias"])

    def q(self, p: dict, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return super().q(p, self.trunk(p, obs), w)

    def update(self, rows, sampled_w: torch.Tensor, lam: float):
        obs, action, reward, next_obs, term = rows
        b, nw, d = obs.shape[0], sampled_w.shape[0], self.d
        r = nw * b
        w = sampled_w.repeat_interleave(b, dim=0)  # tiled row i: sample i % b under weight i // b
        obs, action, reward = obs.repeat(nw, 1), action.repeat(nw), reward.repeat(nw, 1)
        next_obs, term = next_obs.repeat(nw, 1), term.repeat(nw)
        rows_r = torch.arange(r, device=obs.device)
        with torch.no_grad():
            # each tiled row's next frame under every sampled weight, through each net
            pairs, pairs_w = next_obs.repeat_interleave(nw, dim=0), sampled_w.repeat(r, 1)
            q_on = self.q(self.params, pairs, pairs_w).reshape(r, nw, self.A, d)
            q_tg = self.q(self.target, pairs, pairs_w).reshape(r, nw, self.A, d)
            scal = torch.einsum("rd,rkad->rka", w, q_on)
            best_a = torch.argmax(scal, dim=2)
            best_w = torch.argmax(scal.max(dim=2).values, dim=1)
            y = reward + (1.0 - term)[:, None] * self.cfg["gamma"] * q_tg[rows_r, best_w, best_a[rows_r, best_w]]
        q_sa = self.q(self.params, obs, w)[rows_r, action]
        l_mo = torch.mean((q_sa - y) ** 2)
        td = torch.sum(q_sa * w, dim=-1) - torch.sum(y * w, dim=-1)
        loss = (1.0 - lam) * l_mo + lam * torch.mean(td**2)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        grads = clip_global_norm(dict(zip(self.params, grads)), self.cfg["max_grad_norm"])
        self.opt.step(grads)
        return loss.detach(), td[:b].detach()

