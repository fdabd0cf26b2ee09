"""Continuous-control actors and critics (TD3 and SAC families), on torch.

PyTorch port of the TD3 and SAC nets of ``morl_baselines_tpu/models/continuous.py``
(reference gpi_pd_continuous_action.py:34-73, gpi_ls_continuous_action_jax.py:56-107,
mosac_continuous_action.py:28-115):

- ``StabilizedQNet``: Q(s, a, w) -> R^d with BatchRenorm between layers,
  WeightNorm dense layers, dropout and leaky-relu (slope 0.01);
- ``StabilizedActor``: mu(s, w) in [-1, 1]^A with the same recipe, no dropout;
- ``DeterministicActor`` and ``ContinuousQNet``: the plain ReLU versions;
  ``ContinuousQNet(weight_conditioned=False)`` is MOSAC's Q(s, a) critic;
- ``SquashedGaussianActor``: MOSAC's tanh-squashed Gaussian policy, with
  ``members`` for a population (outputs (members, B, A)), and CAPQL's
  weight-conditioned one with ``reward_dim``;
- ``DiscreteSACActor`` and ``DiscreteQNet``: discrete MOSAC's categorical
  logits pi(a|s) and vector critic Q(s) -> (A, d), each with ``members``.

The layer order is the JAX package's.  ``train=True`` normalizes with batch
statistics and updates the BatchRenorm running statistics; dropout runs only
when a forward is given a generator.  The critics take ``members`` for the
ensemble (outputs (members, B, d)), as ``ensemble(...)`` of the flax module.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .networks import MLP, BatchRenorm, EnsembleDense, WeightNormDense, dense, dropout

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0
_LOG_2PI = float(np.log(2 * np.pi))


class _Stabilized(nn.Module):
    """BatchRenorm -> [WeightNorm Dense -> (Dropout) -> leaky-relu -> BatchRenorm]* -> Dense."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        hidden: Sequence[int],
        dropout_rate: float,
        momentum: float,
        members: int | None,
        gen: torch.Generator | None,
    ):
        super().__init__()
        self.members = members
        self.dropout_rate = dropout_rate
        self.norms = nn.ModuleList(BatchRenorm(f, members, momentum) for f in (in_features, *hidden))
        self.layers = nn.ModuleList(
            WeightNormDense(a, b, members, gen) for a, b in zip((in_features, *hidden[:-1]), hidden)
        )
        self.out = dense(hidden[-1], out_features, gen) if members is None else EnsembleDense(members, hidden[-1], out_features, gen)

    def trunk(self, x: torch.Tensor, train: bool, dropout_gen: torch.Generator | None) -> torch.Tensor:
        if self.members is not None and x.dim() == 2:
            x = x.expand(self.members, *x.shape)
        x = self.norms[0](x, train)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.dropout_rate > 0 and dropout_gen is not None:
                x = dropout(x, self.dropout_rate, dropout_gen)
            x = F.leaky_relu(x, 0.01)
            x = self.norms[i + 1](x, train)
        return self.out(x)

    def flax_layout(self) -> dict:
        n = len(self.layers)
        out = {f"BatchRenorm_{i}": norm for i, norm in enumerate(self.norms)}
        for i, layer in enumerate(self.layers):
            out[f"Dense_{i}"] = layer
            out[f"WeightNorm_{i}"] = {f"Dense_{i}/kernel/scale": layer.scale}
        out[f"Dense_{n}"] = self.out
        return out


class StabilizedQNet(_Stabilized):
    """Q(s, a, w) -> R^d (reference gpi_ls_continuous_action_jax.py:83-107 QNetwork)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        reward_dim: int,
        hidden: Sequence[int] = (256, 256),
        dropout_rate: float = 0.01,
        momentum: float = 0.99,
        members: int | None = None,
        gen: torch.Generator | None = None,
    ):
        super().__init__(obs_dim + action_dim + reward_dim, reward_dim, hidden, dropout_rate, momentum, members, gen)

    def forward(self, obs, action, w, train: bool = False, dropout_gen: torch.Generator | None = None):
        return self.trunk(torch.cat([obs, action, w], dim=-1), train, dropout_gen)


class StabilizedActor(_Stabilized):
    """mu(s, w) -> a in [-1, 1] (reference gpi_ls_continuous_action_jax.py:56-81 Policy)."""

    def __init__(
        self,
        obs_dim: int,
        reward_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        momentum: float = 0.99,
        gen: torch.Generator | None = None,
    ):
        super().__init__(obs_dim + reward_dim, action_dim, hidden, 0.0, momentum, None, gen)

    def forward(self, obs, w, train: bool = False):
        return torch.tanh(self.trunk(torch.cat([obs, w], dim=-1), train, None))


class DeterministicActor(nn.Module):
    """mu(s, w) -> a in [-1, 1], ReLU MLP (TD3, reference gpi_pd_continuous_action.py:34-56)."""

    def __init__(
        self, obs_dim: int, reward_dim: int, action_dim: int, hidden: Sequence[int] = (256, 256), gen: torch.Generator | None = None
    ):
        super().__init__()
        self.mlp = MLP(obs_dim + reward_dim, hidden, gen=gen)
        self.out = dense(hidden[-1], action_dim, gen)

    def forward(self, obs, w, train: bool = False):
        return torch.tanh(self.out(self.mlp(torch.cat([obs, w], dim=-1))))

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp, "Dense_0": self.out}


class ContinuousQNet(nn.Module):
    """Vector critic Q(s, a[, w]) -> R^d, ReLU MLP (reference mosac_continuous_action.py:28-66).

    ``weight_conditioned=False`` drops w from the input: MOSAC's per-policy
    critics, each policy with a fixed weight."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        reward_dim: int,
        hidden: Sequence[int] = (256, 256),
        members: int | None = None,
        gen: torch.Generator | None = None,
        weight_conditioned: bool = True,
    ):
        super().__init__()
        self.weight_conditioned = weight_conditioned
        in_features = obs_dim + action_dim + (reward_dim if weight_conditioned else 0)
        self.mlp = MLP(in_features, hidden, gen=gen, members=members)
        self.out = dense(hidden[-1], reward_dim, gen) if members is None else EnsembleDense(members, hidden[-1], reward_dim, gen)

    def forward(self, obs, action, w=None, train: bool = False, dropout_gen: torch.Generator | None = None):
        """``train`` and ``dropout_gen`` are accepted for the stabilized critic's signature; this net has neither."""
        x = torch.cat([obs, action, w] if self.weight_conditioned else [obs, action], dim=-1)
        return self.out(self.mlp(x))

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp, "Dense_0": self.out}


class SquashedGaussianActor(nn.Module):
    """pi(a|s[, w]): tanh-squashed Gaussian (reference mosac_continuous_action.py:69-115).

    ReLU trunk, then a mean head and a log-std head; the log-std is squashed
    into [LOG_STD_MIN, LOG_STD_MAX] through tanh.  With ``members`` the input
    is (members, B, obs_dim) (or (B, obs_dim), shared) and the outputs are
    (members, B, A).  ``weight_conditioned=True`` conditions the policy on a
    weight of ``reward_dim`` objectives, as ``ContinuousQNet``'s flag does: the
    trunk takes obs ⊕ w (CAPQL, reference capql.py:69-140).  The default is
    MOSAC's pi(a|s).
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        members: int | None = None,
        gen: torch.Generator | None = None,
        reward_dim: int = 0,
        weight_conditioned: bool = False,
    ):
        super().__init__()
        if weight_conditioned and reward_dim < 1:
            raise ValueError("a weight-conditioned actor needs reward_dim >= 1")
        self.weight_conditioned = weight_conditioned
        in_features = obs_dim + (reward_dim if weight_conditioned else 0)
        self.mlp = MLP(in_features, hidden, gen=gen, members=members)
        head = (lambda: dense(hidden[-1], action_dim, gen)) if members is None else (
            lambda: EnsembleDense(members, hidden[-1], action_dim, gen)
        )
        self.mean, self.log_std = head(), head()

    def forward(self, obs, w=None):
        if (w is not None) != self.weight_conditioned:
            raise ValueError("pass w exactly when the actor is weight-conditioned")
        x = self.mlp(torch.cat([obs, w], dim=-1) if self.weight_conditioned else obs)
        log_std = torch.tanh(self.log_std(x))
        return self.mean(x), LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1.0)

    @staticmethod
    def sample(mean: torch.Tensor, log_std: torch.Tensor, eps: torch.Tensor):
        """Reparameterized tanh-Gaussian sample from standard normals ``eps``
        (mean's shape) and its log-prob, in the eps form, with the squash
        correction log(max(1 - a^2, 1e-6))."""
        a = torch.tanh(mean + torch.exp(log_std) * eps)
        logp = -0.5 * (eps**2 + 2 * log_std + _LOG_2PI) - torch.log(torch.clamp(1 - a**2, min=1e-6))
        return a, logp.sum(dim=-1)

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp, "Dense_0": self.mean, "Dense_1": self.log_std}


class DiscreteSACActor(nn.Module):
    """pi(a|s) categorical logits (reference mosac_discrete_action.py:36-90):
    a ReLU trunk and Dense(A).  With ``members`` the input is (members, B,
    obs_dim) (or (B, obs_dim), shared) and the logits are (members, B, A)."""

    def __init__(
        self, obs_dim: int, num_actions: int, hidden: Sequence[int] = (256, 256), members: int | None = None,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, gen=gen, members=members)
        self.out = dense(hidden[-1], num_actions, gen) if members is None else EnsembleDense(members, hidden[-1], num_actions, gen)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.out(self.mlp(obs))

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp, "Dense_0": self.out}


class DiscreteQNet(nn.Module):
    """Q(s) -> (A, d) for discrete SAC (reference mosac_discrete_action.py:36-77):
    a ReLU MLP with a Dense(A·d) output.  With ``members`` the output is
    (members, B, A, d)."""

    def __init__(
        self, obs_dim: int, num_actions: int, reward_dim: int, hidden: Sequence[int] = (256, 256),
        members: int | None = None, gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_actions, self.reward_dim = num_actions, reward_dim
        self.mlp = MLP(obs_dim, hidden, num_actions * reward_dim, gen, members=members)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.mlp(obs)
        return x.reshape(*x.shape[:-1], self.num_actions, self.reward_dim)

    def flax_layout(self) -> dict:
        return {"MLP_0": self.mlp}
