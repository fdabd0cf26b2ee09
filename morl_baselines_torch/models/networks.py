"""Network building blocks for MORL on torch.

PyTorch port of the parts of ``morl_baselines_tpu/models/networks.py`` that
Envelope uses (reference common/networks.py:10-157, envelope.py:33-77):

- ``MLP``: ReLU trunk with an optional linear output layer.
- ``EnvelopeQNet``: Q(s, w) in R^{A x d} from the concatenation obs||w
  (flat observations).
- ``TrainState``: online net, target net and optimizer together, in place of
  flax's ``TrainState`` with ``target_params``.
- ``polyak_update``: soft target update (optax.incremental_update).
- ``load_flax_params``: carry a flax parameter tree into a port module.

Linear layers are initialized as flax ``nn.Dense`` is: lecun-normal weights
(a normal truncated at two standard deviations, rescaled so the variance is
1/fan_in) and zero biases.  Torch's own ``Linear`` init would change the
learning curves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

# std of a standard normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def dense(in_features: int, out_features: int, gen: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` initialized like flax ``nn.Dense`` (lecun_normal, zero bias)."""
    layer = nn.Linear(in_features, out_features)
    std = float(np.sqrt(1.0 / in_features)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """ReLU MLP trunk (reference networks.py:10-48); output_dim None returns
    the last hidden features."""

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int] = (256, 256),
        output_dim: int | None = None,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        sizes = [in_features, *hidden] + ([output_dim] if output_dim is not None else [])
        self.layers = nn.ModuleList(dense(a, b, gen) for a, b in zip(sizes[:-1], sizes[1:]))
        self.n_hidden = len(hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < self.n_hidden:
                x = torch.relu(x)
        return x


class EnvelopeQNet(nn.Module):
    """Q(s, w) -> (A, d) with concat obs||w input (reference envelope.py:33-77)."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        reward_dim: int,
        hidden: Sequence[int] = (256, 256, 256, 256),
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_actions = num_actions
        self.reward_dim = reward_dim
        self.mlp = MLP(obs_dim + reward_dim, hidden, num_actions * reward_dim, gen)

    def forward(self, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = self.mlp(torch.cat([obs, w], dim=-1))
        return x.reshape(*x.shape[:-1], self.num_actions, self.reward_dim)


@dataclass
class TrainState:
    """Online net, target net and their optimizer (flax TrainState + target_params)."""

    net: nn.Module
    target_net: nn.Module
    optimizer: torch.optim.Optimizer


@torch.no_grad()
def polyak_update(net: nn.Module, target_net: nn.Module, tau: float) -> None:
    """Soft target update in place: target <- tau * online + (1 - tau) * target
    (reference networks.py:120-139); tau=1 is a hard copy."""
    for p, tp in zip(net.parameters(), target_net.parameters()):
        if tau >= 1.0:
            tp.copy_(p)
        else:
            tp.copy_(tau * p + (1.0 - tau) * tp)


@torch.no_grad()
def load_flax_params(module: nn.Module, flax_params) -> nn.Module:
    """Copy a flax parameter tree of numpy arrays into ``module`` in place.

    ``flax_params`` is what the JAX package's ``MLP`` or ``EnvelopeQNet``
    ``init`` returns (with or without the top-level ``"params"``), with every
    leaf as a numpy array.  A flax ``Dense`` kernel is (in, out); a torch
    ``Linear.weight`` is (out, in), so kernels are transposed.
    """
    tree = flax_params.get("params", flax_params)
    mlp = module
    if isinstance(module, EnvelopeQNet):
        mlp, tree = module.mlp, tree["MLP_0"]
    if not isinstance(mlp, MLP):
        raise TypeError(f"no flax layout known for {type(module).__name__}")
    if len(tree) != len(mlp.layers):
        raise ValueError(f"flax tree has {len(tree)} Dense layers, module has {len(mlp.layers)}")
    for i, layer in enumerate(mlp.layers):
        dense_p = tree[f"Dense_{i}"]
        kernel = torch.as_tensor(np.array(dense_p["kernel"]), dtype=layer.weight.dtype)
        if kernel.T.shape != layer.weight.shape:
            raise ValueError(f"Dense_{i}: kernel {tuple(kernel.shape)} does not fit weight {tuple(layer.weight.shape)}")
        layer.weight.copy_(kernel.T)
        layer.bias.copy_(torch.as_tensor(np.array(dense_p["bias"]), dtype=layer.bias.dtype))
    return module
