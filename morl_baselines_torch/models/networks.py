"""Network building blocks for MORL on torch.

PyTorch port of ``morl_baselines_tpu/models/networks.py`` (reference
common/networks.py:10-157, envelope.py:33-77, gpi_ls_jax.py:33-128):

- ``MLP``: ReLU (or tanh) trunk with an optional linear output layer,
  dropout and LayerNorm options, and an optional ensemble axis (``members``).
- ``EnsembleDense``: ``members`` Dense layers stacked on a leading axis and
  computed as one batched GEMM (``torch.baddbmm``), in place of flax's
  ``nn.vmap`` over unshared params.
- ``NatureCNN``: the DQN-Nature conv trunk with /255 input normalization;
  with ``members`` its convolutions are ``MemberConv2d`` (one ``conv2d``
  a member, on stacked params) and its Dense an ``EnsembleDense``.
- ``EnvelopeQNet``: Q(s, w) in R^{A x d} from the concatenation obs||w; with
  ``image_shape`` the flat obs are k stacked frames that go through a
  ``NatureCNN`` first.
- ``WeightConditionedQNet``: the psi-network Q(s, w) in R^{A x d} from the
  product of an obs embedding and a weight embedding; ``members`` stacks
  critics of it (the JAX package's ``ensemble``).
- ``BatchRenorm`` and ``WeightNormDense``: the stability recipe of the
  continuous critics (flax ``nn.WeightNorm(nn.Dense)``), each with an
  optional ensemble axis; BatchRenorm's running statistics are buffers.
- ``TrainState``: online net, target net and optimizer together, in place of
  flax's ``TrainState`` with ``target_params``.
- ``polyak_update``, ``clip_grad_global_norm_``, ``huber``.
- For a population on a leading member axis: ``stack_members`` (each
  member's init from its own seed), ``gather_members_``,
  ``clip_grad_global_norm_members_`` (one clip per member) and
  ``MemberAdam`` (Adam with a step count per member).
- ``load_flax_params`` / ``load_flax_variables``: carry a flax parameter tree
  (and a ``batch_stats`` tree) into a port module.

Linear layers are initialized as flax ``nn.Dense`` is: lecun-normal weights
(a normal truncated at two standard deviations, rescaled so the variance is
1/fan_in) and zero biases, and so are convolutions (flax ``nn.Conv``, fan-in
kh·kw·in).  Torch's own ``Linear`` init would change the learning curves.

A forward given ``dtype`` (bfloat16) computes as a flax module built with
that ``dtype`` does: each Dense casts its input and params to it, LayerNorm
computes in float32, and the trunk returns float32.  The casts are written
out (no autocast), so a CPU run makes the same ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import gather, local
from ..utils.profiling import span

# std of a standard normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978
# flax nn.LayerNorm's epsilon (torch's default is 1e-5)
_LN_EPS = 1e-6


def _lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator | None) -> None:
    std = float(np.sqrt(1.0 / fan_in)) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def dense(in_features: int, out_features: int, gen: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` initialized like flax ``nn.Dense`` (lecun_normal, zero bias)."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        _lecun_normal_(layer.weight, in_features, gen)
        layer.bias.zero_()
    return layer


class EnsembleDense(nn.Module):
    """``members`` flax Dense layers with unshared params, one batched GEMM.

    ``weight`` is (members, in, out), the layout of a flax kernel under
    ``nn.vmap``; ``bias`` is (members, out).  The input is (B, in), shared by
    every member, or (members, B, in); the output is (members, B, out).
    ``linear_init`` draws each member's kernel as ``dense`` draws an
    ``nn.Linear`` weight, (out, in), and stores its transpose, so a member
    drawn from a seed equals a one-member ``dense`` layer of that seed.
    """

    def __init__(
        self,
        members: int,
        in_features: int,
        out_features: int,
        gen: torch.Generator | None = None,
        linear_init: bool = False,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(members, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(members, out_features))
        with torch.no_grad():
            if linear_init:
                w = torch.empty(members, out_features, in_features)
                _lecun_normal_(w, in_features, gen)
                self.weight.copy_(w.transpose(1, 2))
            else:
                _lecun_normal_(self.weight, in_features, gen)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        w, b = self.weight, self.bias
        if dtype is not None:
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        if x.dim() == 2:
            x = x.expand(w.shape[0], *x.shape)
        return torch.baddbmm(b[:, None, :], x, w)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: epsilon 1e-6, statistics and
    output in float32; ``members`` gives scale and bias a leading ensemble axis."""

    def __init__(self, features: int, members: int | None = None):
        super().__init__()
        shape = (features,) if members is None else (members, 1, features)
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], eps=_LN_EPS)
        return y * self.scale + self.bias


_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept by 1/(1 - rate).
    The mask is drawn from ``gen``, so every element (every critic) draws its own."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class MLP(nn.Module):
    """MLP trunk (reference networks.py:10-48); output_dim None returns the
    last hidden features.

    Each hidden layer is Dense -> Dropout -> LayerNorm -> activation (ReLU,
    or "tanh" for MOPPO's nets), the middle two as the options ask.  Dropout
    runs only when the forward is given a generator (flax
    ``deterministic=False``).  With ``members`` every layer
    carries a leading ensemble axis and the output is (members, B, ...);
    ``linear_init`` draws each member as the one-member ``dense`` trunk does
    (``EnsembleDense``).
    """

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int] = (256, 256),
        output_dim: int | None = None,
        gen: torch.Generator | None = None,
        dropout_rate: float = 0.0,
        use_layernorm: bool = False,
        members: int | None = None,
        activation: str = "relu",
        linear_init: bool = False,
    ):
        super().__init__()
        self.act = _ACTS[activation]
        sizes = [in_features, *hidden] + ([output_dim] if output_dim is not None else [])
        if members is None:
            self.layers = nn.ModuleList(dense(a, b, gen) for a, b in zip(sizes[:-1], sizes[1:]))
        else:
            self.layers = nn.ModuleList(
                EnsembleDense(members, a, b, gen, linear_init) for a, b in zip(sizes[:-1], sizes[1:])
            )
        self.norms = nn.ModuleList(LayerNorm(h, members) for h in hidden) if use_layernorm else None
        self.n_hidden = len(hidden)
        self.dropout_rate = dropout_rate

    def forward(
        self, x: torch.Tensor, dropout_gen: torch.Generator | None = None, dtype: torch.dtype | None = None
    ) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if dtype is None:
                x = layer(x)
            elif isinstance(layer, nn.Linear):  # flax Dense(dtype=...): input and params cast
                x = F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
            else:
                x = layer(x, dtype)
            if i < self.n_hidden:
                if self.dropout_rate > 0 and dropout_gen is not None:
                    x = dropout(x, self.dropout_rate, dropout_gen)
                if self.norms is not None:
                    x = self.norms[i](x)
                x = self.act(x)
        return x if dtype is None else x.float()

    def flax_layout(self) -> dict:
        out = {f"Dense_{i}": layer for i, layer in enumerate(self.layers)}
        if self.norms is not None:
            out.update({f"LayerNorm_{i}": norm for i, norm in enumerate(self.norms)})
        return out


class BatchRenorm(nn.Module):
    """Batch Renormalization (Ioffe, 2017), as the JAX package's ``BatchRenorm``.

    Train mode normalizes with the batch statistics (population variance,
    epsilon 1e-3 under the square root), corrected toward the running ones by
    the clipped, gradient-free factors r and d once ``steps`` exceeds
    ``warmup_steps`` (read before this call's increment), and updates the
    running statistics; eval mode uses the running statistics.  The running
    statistics are buffers.  With ``members`` every statistic and parameter
    carries a leading ensemble axis, (members, 1, features), and the input is
    (members, B, features).
    """

    def __init__(
        self,
        features: int,
        members: int | None = None,
        momentum: float = 0.99,
        epsilon: float = 1e-3,
        warmup_steps: int = 100_000,
        rmax: float = 3.0,
        dmax: float = 5.0,
    ):
        super().__init__()
        shape = (features,) if members is None else (members, 1, features)
        self.momentum, self.epsilon, self.warmup_steps, self.rmax, self.dmax = momentum, epsilon, warmup_steps, rmax, dmax
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))
        self.register_buffer("steps", torch.zeros(() if members is None else (members, 1, 1), dtype=torch.int32))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return (x - self.mean) / torch.sqrt(self.var + self.epsilon) * self.scale + self.bias
        b_mean = x.mean(dim=-2, keepdim=True)
        b_var = x.var(dim=-2, unbiased=False, keepdim=True)
        b_std = torch.sqrt(b_var + self.epsilon)
        with torch.no_grad():
            ra_std = torch.sqrt(self.var + self.epsilon)
            warm = self.steps > self.warmup_steps
            r = torch.clamp(b_std / ra_std, 1.0 / self.rmax, self.rmax)
            d = torch.clamp((b_mean - self.mean) / ra_std, -self.dmax, self.dmax)
            r = torch.where(warm, r, 1.0)
            d = torch.where(warm, d, 0.0)
        y = (x - b_mean) / b_std * r + d
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_((m * self.mean + (1.0 - m) * b_mean).reshape(self.mean.shape))
            self.var.copy_((m * self.var + (1.0 - m) * b_var).reshape(self.var.shape))
            self.steps.add_(1)
        return y * self.scale + self.bias


class WeightNormDense(nn.Module):
    """flax ``nn.WeightNorm(nn.Dense(out))``: the kernel divided by its L2 norm
    over the input axis (``x * rsqrt(sum x^2 + 1e-12)``), times a per-output
    ``scale``; the bias is left alone.  ``weight`` keeps flax's layout, (in,
    out), or (members, in, out) with ``members`` (then the output is
    (members, B, out))."""

    def __init__(self, in_features: int, out_features: int, members: int | None = None, gen: torch.Generator | None = None):
        super().__init__()
        lead = () if members is None else (members,)
        self.weight = nn.Parameter(torch.empty(*lead, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(*lead, out_features))
        self.scale = nn.Parameter(torch.ones(*lead, out_features))
        with torch.no_grad():
            _lecun_normal_(self.weight, in_features, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        w = w * torch.rsqrt(torch.sum(w * w, dim=-2, keepdim=True) + 1e-12) * self.scale[..., None, :]
        if w.dim() == 2:
            return x @ w + self.bias
        if x.dim() == 2:
            x = x.expand(w.shape[0], *x.shape)
        return torch.baddbmm(self.bias[:, None, :], x, w)


def conv(in_channels: int, out_channels: int, kernel: int, stride: int, gen: torch.Generator | None = None) -> nn.Conv2d:
    """``nn.Conv2d`` with ``VALID`` padding, initialized like flax ``nn.Conv``
    (lecun_normal over the fan-in kh·kw·in, zero bias)."""
    layer = nn.Conv2d(in_channels, out_channels, kernel, stride)
    with torch.no_grad():
        _lecun_normal_(layer.weight, in_channels * kernel * kernel, gen)
        layer.bias.zero_()
    return layer


class MemberConv2d(nn.Module):
    """``members`` flax ``VALID`` convolutions with unshared params, one
    ``conv2d`` a member.  ``weight`` is (members, out, in, k, k) and ``bias``
    (members, out); the input is (members, B, in, H, W), the output
    (members, B, out, h, w).  Each member draws its kernel as ``conv`` draws
    a ``Conv2d``'s, so a member drawn from a seed equals that seed's
    one-member convolution.  (One ``conv2d(groups=members)`` on a (B,
    members·in, H, W) view took two to three times the device time on an
    H100 80GB HBM3 at 700 W: cuDNN transposes grouped NCHW convolutions.)"""

    def __init__(self, members: int, in_channels: int, out_channels: int, kernel: int, stride: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.members, self.stride = members, stride
        self.weight = nn.Parameter(torch.empty(members, out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(members, out_channels))
        with torch.no_grad():
            _lecun_normal_(self.weight, in_channels * kernel * kernel, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([F.conv2d(x[m], self.weight[m], self.bias[m], self.stride) for m in range(self.members)])


class NatureCNN(nn.Module):
    """DQN-Nature conv trunk with /255 input normalization (reference networks.py:51-88).

    Input (B, k, H, W), the k frames as channels; three ``VALID`` convs
    (84 -> 20 -> 9 -> 7 for 84x84 frames) and Dense(``features_dim``), each
    with ReLU.  The last conv's output is flattened in (H, W, C) order, as
    flax flattens its NHWC activations, so a carried Dense kernel fits.

    ``members=S`` stacks S trunks (the JAX package's ``jax.vmap`` over
    unshared params): input (S, B, k, H, W), output (S, B, features_dim);
    the convolutions are ``MemberConv2d`` and the Dense an ``EnsembleDense``.  Each member draws its params in the
    one-trunk order, so ``stack_members`` gives each seed's one-trunk init.
    A forward is a ``qnet.trunk`` span (inside a replayed CUDA graph no span
    opens, so a trace of the loop holds the act's trunk alone)."""

    def __init__(
        self,
        image_shape: Sequence[int],
        features_dim: int = 512,
        gen: torch.Generator | None = None,
        members: int | None = None,
    ):
        super().__init__()
        k, h, w = image_shape
        self.members = members
        spec = ((k, 32, 8, 4), (32, 64, 4, 2), (64, 64, 3, 1))
        if members is None:
            self.convs = nn.ModuleList(conv(i, o, kk, st, gen) for i, o, kk, st in spec)
        else:
            self.convs = nn.ModuleList(MemberConv2d(members, i, o, kk, st, gen) for i, o, kk, st in spec)
        for _, _, kernel, stride in spec:
            h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        if members is None:
            self.out = dense(64 * h * w, features_dim, gen)
        else:
            self.out = EnsembleDense(members, 64 * h * w, features_dim, gen, linear_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("qnet.trunk"):
            x = x.to(torch.float32) / 255.0
            for layer in self.convs:
                x = torch.relu(layer(x))
            return torch.relu(self.out(x.movedim(-3, -1).flatten(-3)))

    def flax_layout(self) -> dict:
        return {**{f"Conv_{i}": c for i, c in enumerate(self.convs)}, "Dense_0": self.out}


class EnvelopeQNet(nn.Module):
    """Q(s, w) -> (A, d) with concat obs||w input (reference envelope.py:33-77).

    ``image_shape=(k, H, W)``: the flat obs are k stacked grayscale frames,
    which go through a ``NatureCNN`` trunk of ``cnn_features`` outputs
    before the conditioned MLP head (the reference's mario path).  Flat obs
    keep the replay buffer and the batches 1-D.

    ``members=S`` stacks S Q-nets on a leading axis (the seed axis of the
    sweep's stacked trial): obs (S, M, O) and w (S, M, d) give (S, M, A, d),
    one ``baddbmm`` a layer, and one convolution a member a conv layer of
    the stacked NatureCNN trunk.  Each member draws its trunk and head as the
    one-seed net does, so ``stack_members`` puts seed s's one-seed params in
    member s."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        reward_dim: int,
        hidden: Sequence[int] = (256, 256, 256, 256),
        gen: torch.Generator | None = None,
        image_shape: Sequence[int] | None = None,
        cnn_features: int = 512,
        members: int | None = None,
    ):
        super().__init__()
        self.num_actions = num_actions
        self.reward_dim = reward_dim
        self.members = members
        self.image_shape = None if image_shape is None else tuple(image_shape)
        if self.image_shape is not None:
            if obs_dim != int(np.prod(self.image_shape)):
                raise ValueError(f"obs_dim {obs_dim} is not the size of image_shape {self.image_shape}")
            self.cnn = NatureCNN(self.image_shape, cnn_features, gen, members)
            obs_dim = cnn_features
        self.mlp = MLP(obs_dim + reward_dim, hidden, num_actions * reward_dim, gen, members=members, linear_init=True)

    def forward(self, obs: torch.Tensor, w: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``dtype`` (bfloat16) computes the MLP head's Dense layers in it, with
        float32 outputs; the NatureCNN trunk stays float32, as in the JAX package."""
        return self.head(self.features(obs), w, dtype)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        """The head's state input: the NatureCNN trunk's features of the flat
        frames ``obs`` (float32), or ``obs`` itself without a trunk."""
        if self.image_shape is None:
            return obs
        lead = obs.shape[:-1]
        frames = obs.reshape(-1, *self.image_shape) if self.members is None else obs.reshape(lead[0], -1, *self.image_shape)
        return self.cnn(frames).reshape(*lead, -1)

    def head(self, features: torch.Tensor, w: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Q-values (..., A, d) of the MLP head on features||w."""
        x = self.mlp(torch.cat([features, w], dim=-1), dtype=dtype)
        return x.reshape(*x.shape[:-1], self.num_actions, self.reward_dim)

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp} if self.image_shape is None else {"NatureCNN_0": self.cnn, "MLP_0": self.mlp}


class WeightConditionedQNet(nn.Module):
    """Q(s, w) -> (A, d): state-feature x weight-feature product psi-network
    (reference gpi_ls_jax.py:33-93 / gpi_pd.py QNet:41-76).

    The obs and the weight each go through Dense(hidden[0]) -> ReLU; their
    product goes through the head ``hidden[1:]`` (with the dropout and
    LayerNorm options) and Dense(A·d).  With ``members`` the critics are
    stacked and the output is (members, B, A, d).  ``dtype`` (bfloat16)
    casts as the JAX package's ``dtype`` field does; Q-values come back in
    float32.
    """

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        reward_dim: int,
        hidden: Sequence[int] = (256, 256, 256, 256),
        dropout_rate: float = 0.0,
        use_layernorm: bool = False,
        members: int | None = None,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_actions = num_actions
        self.reward_dim = reward_dim
        h = hidden[0]
        self.obs_embed = MLP(obs_dim, (h,), gen=gen, members=members)
        self.w_embed = MLP(reward_dim, (h,), gen=gen, members=members)
        self.head = MLP(
            h, hidden[1:], num_actions * reward_dim, gen, dropout_rate, use_layernorm, members=members
        )

    def forward(
        self,
        obs: torch.Tensor,
        w: torch.Tensor,
        dropout_gen: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ) -> torch.Tensor:
        x = self.obs_embed(obs, dtype=dtype) * self.w_embed(w, dtype=dtype)
        x = self.head(x, dropout_gen, dtype)
        return x.reshape(*x.shape[:-1], self.num_actions, self.reward_dim)

    def flax_layout(self) -> dict:
        return {"MLP_0": self.obs_embed, "MLP_1": self.w_embed, "MLP_2": self.head}


@dataclass
class TrainState:
    """Online net, target net and their optimizer (flax TrainState + target_params)."""

    net: nn.Module
    target_net: nn.Module
    optimizer: torch.optim.Optimizer


@torch.no_grad()
def polyak_update(net: nn.Module, target_net: nn.Module, tau: float) -> None:
    """Soft target update in place: target <- tau * online + (1 - tau) * target
    (reference networks.py:120-139); tau=1 is a hard copy.  Float buffers
    (BatchRenorm statistics) are averaged too, integer ones copied, as the JAX
    package's ``_polyak_stats`` does."""
    with span("learner.target_copy"):
        src, dst = list(net.parameters()), list(target_net.parameters())
        # BatchRenorm running statistics track the same way; step counters copy hard
        for b, tb in zip(net.buffers(), target_net.buffers()):
            if b.is_floating_point():
                src.append(b)
                dst.append(tb)
            else:
                tb.copy_(b)
        if tau >= 1.0:
            for s, d in zip(src, dst):
                d.copy_(s)
        elif dst:
            torch._foreach_mul_(dst, 1.0 - tau)
            torch._foreach_add_(dst, src, alpha=tau)


@torch.no_grad()
def clip_grad_global_norm_(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the ``.grad`` of ``params``, in place:
    scale by max_norm/‖g‖ when ‖g‖ >= max_norm, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)


def _lead(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (P,) tensor viewed to broadcast against ``like`` (P, ...)."""
    return x.reshape(x.shape[0], *([1] * (like.dim() - 1)))


@torch.no_grad()
def clip_grad_global_norm_members_(params, max_norm: float) -> None:
    """``clip_grad_global_norm_`` once per member: every tensor of ``params``
    carries the member axis first, and member p's grads are scaled by its own
    global norm, so one member's large gradient rescales no other member
    (``optax.clip_by_global_norm`` under ``jax.vmap``)."""
    grads = [p.grad for p in params]
    sq = sum(torch.sum(g * g, dim=tuple(range(1, g.dim()))) if g.dim() > 1 else g * g for g in grads)
    norm = torch.sqrt(sq)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(_lead(scale, g))


@torch.no_grad()
def stack_members(make, seeds, per_seed: int = 1) -> nn.Module:
    """A population net: ``make(members, gen)`` for ``len(seeds) * per_seed``
    members, whose block p holds the params ``make(per_seed, gen)`` draws
    from a host generator seeded ``seeds[p]``.  So each member starts where
    a net of its own seed does (the JAX package's per-member init keys).
    Every parameter must carry the member axis first."""
    net = make(len(seeds) * per_seed, torch.Generator().manual_seed(0))
    for p, seed in enumerate(seeds):
        one = make(per_seed, torch.Generator().manual_seed(int(seed)))
        for dst, src in zip(net.parameters(), one.parameters()):
            dst[p * per_seed : (p + 1) * per_seed].copy_(src)
    return net


@torch.no_grad()
def gather_members_(net: nn.Module, src, per: int = 1, shard=None) -> None:
    """In place, member p's params become member ``src[p]``'s (blocks of
    ``per`` members each, as ``stack_members`` lays them out).  With a
    ``shard`` (``parallel.RowShard``) the net holds this rank's block of the
    members: every rank's are all-gathered, indexed, and the block kept."""
    for p in net.parameters():
        full = gather(shard, p)
        v = full.view(-1, per, *p.shape[1:])[torch.as_tensor(src, device=p.device)]
        p.copy_(local(shard, v.reshape(full.shape)))


class MemberAdam:
    """``optax.adam`` per member under ``jax.vmap``, for params that carry the
    member axis first: the moments are elementwise, and each member keeps its
    own step count, so a member whose state was copied from an older snapshot
    keeps that snapshot's bias correction.  ``update = lr * m_hat /
    (sqrt(v_hat) + eps)``, as optax and ``torch.optim.Adam`` compute it."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        p0 = self.params[0]
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.step_count = torch.zeros(p0.shape[0], dtype=torch.int32, device=p0.device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        self.step_count += 1
        t = self.step_count.to(torch.float32)
        bc1, bc2_sqrt = 1.0 - self.b1**t, torch.sqrt(1.0 - self.b2**t)
        torch._foreach_lerp_(self.exp_avg, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.exp_avg_sq, self.b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1.0 - self.b2)
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            denom = (v.sqrt() / _lead(bc2_sqrt, v)).add_(self.eps)
            p.addcdiv_(m * _lead(-self.lr / bc1, m), denom)

    def state_dict(self) -> dict:
        """The moments and step counts (tensors; the hyperparameters are the constructor's)."""
        return {"exp_avg": list(self.exp_avg), "exp_avg_sq": list(self.exp_avg_sq), "step_count": self.step_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict``'s moments and step counts in, onto this optimizer's device."""
        for dst, src in zip(self.exp_avg + self.exp_avg_sq, state["exp_avg"] + state["exp_avg_sq"]):
            dst.copy_(src)
        self.step_count.copy_(state["step_count"])

    def member_state(self, p: int) -> dict:
        """Copies of member p's moments and step count."""
        return {
            "exp_avg": [m[p].clone() for m in self.exp_avg],
            "exp_avg_sq": [v[p].clone() for v in self.exp_avg_sq],
            "step": self.step_count[p].clone(),
        }

    @torch.no_grad()
    def load_member_state(self, p: int, state: dict) -> None:
        for dst, src in zip(self.exp_avg, state["exp_avg"]):
            dst[p].copy_(src)
        for dst, src in zip(self.exp_avg_sq, state["exp_avg_sq"]):
            dst[p].copy_(src)
        self.step_count[p] = state["step"]


def huber(x: torch.Tensor, min_priority: float = 0.01) -> torch.Tensor:
    """Elementwise huber with the reference's threshold semantics (networks.py:90-100)."""
    ax = torch.abs(x)
    return torch.where(ax < min_priority, 0.5 * x**2, min_priority * ax)


@torch.no_grad()
def load_flax_params(module: nn.Module, flax_params) -> nn.Module:
    """Copy a flax parameter tree of numpy arrays into ``module`` in place.

    ``flax_params`` is what the matching JAX module's ``init`` returns (with
    or without the top-level ``"params"``), with every leaf as a numpy array:
    ``MLP``, ``EnvelopeQNet``, an ``ensemble`` of ``WeightConditionedQNet``
    (``members`` critics), the dynamics' ``GaussianMLP`` members stacked by
    ``jax.vmap``, ``MOPPONet`` (its two MLPs and ``log_std``),
    ``SquashedGaussianActor``, the discrete SAC nets, EUPG's ``PolicyNet``,
    ``EnvelopeQNet`` with its ``NatureCNN`` trunk, or a population tree whose leaves carry a
    leading member axis (PGMORL's stacked states, MORL/D's ``jax.vmap`` of
    the inits): a (P, in, out) or (P, 2, in, out) kernel fills a port
    weight of P or P·2 members, as ``stack_members`` lays them out.  Each
    port module names its flax children in ``flax_layout()``.  A flax
    ``Dense`` kernel is (in, out); a torch ``Linear.weight`` is (out, in), so
    those kernels are transposed, while ``EnsembleDense`` keeps flax's layout.
    A flax ``Conv`` kernel (kh, kw, in, out) becomes a torch ``Conv2d.weight``
    (out, in, kh, kw), and a stacked one (S, kh, kw, in, out) a
    ``MemberConv2d.weight`` (S, out, in, kh, kw).
    """
    _load(module, flax_params.get("params", flax_params), type(module).__name__)
    return module


@torch.no_grad()
def to_flax_params(module: nn.Module, grads: bool = False) -> dict:
    """The inverse of ``load_flax_params``: ``module``'s params (or, with
    ``grads``, their ``.grad``) as a flax-layout tree of numpy arrays, without
    the top-level ``"params"``."""
    get = (lambda p: p.grad) if grads else (lambda p: p)
    np_ = lambda t: get(t).detach().cpu().numpy()  # noqa: E731
    if isinstance(module, nn.Linear):
        return {"kernel": np_(module.weight).T, "bias": np_(module.bias)}
    if isinstance(module, nn.Conv2d):  # torch (out, in, kh, kw) -> flax (kh, kw, in, out)
        return {"kernel": np_(module.weight).transpose(2, 3, 1, 0), "bias": np_(module.bias)}
    if isinstance(module, MemberConv2d):  # (S, out, in, kh, kw) -> flax under vmap (S, kh, kw, in, out)
        return {"kernel": np_(module.weight).transpose(0, 3, 4, 2, 1), "bias": np_(module.bias)}
    if isinstance(module, EnsembleDense):
        return {"kernel": np_(module.weight), "bias": np_(module.bias)}
    if isinstance(module, WeightNormDense):
        return {"kernel": np_(module.weight), "bias": np_(module.bias)}
    if isinstance(module, (LayerNorm, BatchRenorm)):
        lead = module.scale.shape[:1] if module.scale.dim() == 3 else ()  # (members, 1, h) -> (members, h)
        return {"scale": np_(module.scale).reshape(*lead, -1), "bias": np_(module.bias).reshape(*lead, -1)}
    out = {}
    for name, child in module.flax_layout().items():
        if isinstance(child, nn.Parameter):
            out[name] = np_(child)
        elif isinstance(child, dict):
            out[name] = {k: np_(p) for k, p in child.items()}
        else:
            out[name] = to_flax_params(child, grads)
    return out


@torch.no_grad()
def to_flax_variables(module: nn.Module) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of ``module`` as flax-layout numpy trees."""
    return {"params": to_flax_params(module), "batch_stats": _stats_tree(module)}


def _stats_tree(module) -> dict:
    out = {}
    for name, child in getattr(module, "flax_layout", dict)().items():
        if isinstance(child, BatchRenorm):
            lead = child.mean.shape[:1] if child.mean.dim() == 3 else ()
            out[name] = {
                "mean": child.mean.cpu().numpy().reshape(*lead, -1),
                "var": child.var.cpu().numpy().reshape(*lead, -1),
                "steps": child.steps.cpu().numpy().reshape(lead),
            }
        elif isinstance(child, nn.Module):
            sub = _stats_tree(child)
            if sub:
                out[name] = sub
    return out


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy flax ``{"params", "batch_stats"}`` (numpy leaves) into ``module`` in
    place: the params as ``load_flax_params`` does, and each BatchRenorm's
    running ``mean``, ``var`` and ``steps`` (with the ensemble's leading axis)."""
    _load(module, variables["params"], type(module).__name__)
    stats = variables.get("batch_stats", {})
    want = _stats_tree(module)
    if _key_structure(stats) != _key_structure(want):
        raise ValueError(f"batch_stats tree {_key_structure(stats)} does not fit {_key_structure(want)}")
    _load_stats(module, stats)
    return module


def _key_structure(tree) -> dict:
    """The nested key structure of a dict tree (leaves dropped)."""
    return {k: _key_structure(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def _load_stats(module, tree) -> None:
    for name, child in module.flax_layout().items():
        if name not in tree:
            continue
        if isinstance(child, BatchRenorm):
            for key in ("mean", "var", "steps"):
                dst = getattr(child, key)
                dst.copy_(torch.as_tensor(np.array(tree[name][key])).to(dst.dtype).reshape(dst.shape))
        else:
            _load_stats(child, tree[name])


def _copy(dst: torch.Tensor, src, path: str) -> None:
    src = torch.as_tensor(np.array(src), dtype=dst.dtype)
    if src.numel() != dst.numel() or src.shape[-1] != dst.shape[-1]:
        raise ValueError(f"{path}: flax shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src.reshape(dst.shape))


def _load(module, tree, path: str) -> None:
    if isinstance(module, nn.Linear):
        _copy(module.weight, np.array(tree["kernel"]).T, f"{path}.kernel")
        _copy(module.bias, tree["bias"], f"{path}.bias")
        return
    if isinstance(module, nn.Conv2d):  # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
        kernel = np.array(tree["kernel"])
        if kernel.ndim != 4 or kernel.transpose(3, 2, 0, 1).shape != tuple(module.weight.shape):
            raise ValueError(f"{path}.kernel: flax shape {kernel.shape} does not fit {tuple(module.weight.shape)}")
        _copy(module.weight, kernel.transpose(3, 2, 0, 1), f"{path}.kernel")
        _copy(module.bias, tree["bias"], f"{path}.bias")
        return
    if isinstance(module, MemberConv2d):  # flax under vmap (S, kh, kw, in, out) -> (S, out, in, kh, kw)
        kernel = np.array(tree["kernel"])
        if kernel.ndim != 5 or kernel.transpose(0, 4, 3, 1, 2).shape != tuple(module.weight.shape):
            raise ValueError(f"{path}.kernel: flax shape {kernel.shape} does not fit {tuple(module.weight.shape)}")
        _copy(module.weight, kernel.transpose(0, 4, 3, 1, 2), f"{path}.kernel")
        _copy(module.bias, tree["bias"], f"{path}.bias")
        return
    if isinstance(module, EnsembleDense):
        _copy(module.weight, tree["kernel"], f"{path}.kernel")
        _copy(module.bias, tree["bias"], f"{path}.bias")
        return
    if isinstance(module, WeightNormDense):
        _copy(module.weight, tree["kernel"], f"{path}.kernel")
        _copy(module.bias, tree["bias"], f"{path}.bias")
        return
    if isinstance(module, (LayerNorm, BatchRenorm)):
        _copy(module.scale, tree["scale"], f"{path}.scale")
        _copy(module.bias, tree["bias"], f"{path}.bias")
        return
    if not hasattr(module, "flax_layout"):
        raise TypeError(f"no flax layout known for {type(module).__name__}")
    layout = module.flax_layout()
    if set(tree) != set(layout):
        raise ValueError(f"{path}: flax tree has {sorted(tree)}, module has {sorted(layout)}")
    for name, child in layout.items():
        if isinstance(child, nn.Parameter):
            _copy(child.data, tree[name], f"{path}.{name}")
        elif isinstance(child, dict):  # flax WeightNorm: {"Dense_i/kernel/scale": scale}
            if set(tree[name]) != set(child):
                raise ValueError(f"{path}.{name}: flax tree has {sorted(tree[name])}, module has {sorted(child)}")
            for key, p in child.items():
                _copy(p.data, tree[name][key], f"{path}.{name}.{key}")
        else:
            _load(child, tree[name], f"{path}.{name}")
