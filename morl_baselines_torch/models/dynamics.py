"""Learned dynamics: probabilistic ensemble + model env for Dyna rollouts, on torch.

PyTorch port of ``morl_baselines_tpu/models/dynamics.py`` (reference
common/model_based/probabilistic_ensemble.py:11-290 and
model_based/utils.py:13-187, the GPI-PD machinery):

- ``GaussianMLP``: the E members of the ensemble as one batched module (every
  weight carries a leading member axis), (obs ⊕ action) -> (delta_obs ⊕
  reward_vec) mean and log-variance with soft log-variance bounds
  (reference :60-85).
- ``ProbabilisticEnsemble.fit``: fixed epoch budget with per-member bootstrap
  batches and a best-on-holdout snapshot per member; ``fit_converged``: the
  reference's protocol on the whole buffer with holdout early stopping
  (reference :196-290); ``predict``: elite-mixture sample and ensemble-std
  uncertainty (reference :131-194).
- ``ModelEnv``: steps the ensemble as an env for imagined rollouts
  (reference utils.py:139-187); termination by the per-env predicates of the
  reference's termination_fn_* table (utils.py:13-102).

Host integers replace the JAX package's traced counts: the valid row count
``n``, the holdout size and the epoch loop's stop, which reads one host bool
per epoch.  Every standard deviation is the population one (``jnp.std``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .networks import MLP, EnsembleDense


class GaussianMLP(nn.Module):
    """E ensemble members: MLP -> (mean, logvar) with soft logvar bounds.

    The input is (B, in), shared by every member, or (E, B, in); mean and
    logvar are (E, B, out).
    """

    def __init__(
        self,
        members: int,
        in_features: int,
        output_dim: int,
        hidden: tuple = (200, 200, 200, 200),
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        self.trunk = MLP(in_features, hidden, gen=gen, members=members)
        self.mean = EnsembleDense(members, hidden[-1], output_dim, gen)
        self.logvar = EnsembleDense(members, hidden[-1], output_dim, gen)
        self.min_logvar = nn.Parameter(torch.full((members, output_dim), -10.0))
        self.max_logvar = nn.Parameter(torch.full((members, output_dim), 0.5))

    def forward(self, x: torch.Tensor):
        h = self.trunk(x)
        mean, logvar = self.mean(h), self.logvar(h)
        max_lv, min_lv = self.max_logvar[:, None, :], self.min_logvar[:, None, :]
        logvar = max_lv - F.softplus(max_lv - logvar)
        logvar = min_lv + F.softplus(logvar - min_lv)
        return mean, logvar

    def flax_layout(self) -> dict:
        return {
            "MLP_0": self.trunk,
            "Dense_0": self.mean,
            "Dense_1": self.logvar,
            "min_logvar": self.min_logvar,
            "max_logvar": self.max_logvar,
        }


@dataclass(frozen=True)
class EnsembleConfig:
    num_members: int = 5
    num_elites: int = 2
    hidden: tuple = (200, 200, 200, 200)
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 20  # fixed budget of the legacy ``fit`` path
    holdout_frac: float = 0.1
    # ``fit_converged`` (the reference protocol, probabilistic_ensemble.py:196-290)
    max_epochs: int = 200
    patience: int = 5  # epochs without >improvement_tol relative holdout gain
    improvement_tol: float = 0.01
    max_holdout: int = 5000
    weight_decay: float = 7.5e-5  # reference :223 uses per-layer 2.5e-5..1e-4


@dataclass
class EnsembleState:
    net: GaussianMLP
    elite_idx: torch.Tensor  # (num_elites,) member indices
    in_mean: torch.Tensor
    in_std: torch.Tensor


def gaussian_nll(mean: torch.Tensor, logvar: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise Gaussian negative log-likelihood, up to its constant."""
    return 0.5 * (((mean - y) ** 2) * torch.exp(-logvar) + logvar)


class ProbabilisticEnsemble:
    """E-member Gaussian dynamics model p(delta_s, r | s, a)."""

    def __init__(self, input_dim: int, output_dim: int, cfg: EnsembleConfig = EnsembleConfig(), device="cuda"):
        self.cfg = cfg
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.device = torch.device(device)

    def init_state(self, seed: int = 0) -> EnsembleState:
        cfg = self.cfg
        # params are drawn on the host, so a seed gives the same net on any device
        net = GaussianMLP(cfg.num_members, self.input_dim, self.output_dim, cfg.hidden, torch.Generator().manual_seed(seed))
        return EnsembleState(
            net=net.to(self.device),
            elite_idx=torch.arange(self.cfg.num_elites, device=self.device),
            in_mean=torch.zeros((self.input_dim,), device=self.device),
            in_std=torch.ones((self.input_dim,), device=self.device),
        )

    def make_optimizer(self, net: GaussianMLP, weight_decay: float = 0.0) -> torch.optim.Adam:
        """A fresh Adam.  ``weight_decay`` is added to the gradient of the
        kernels only, before Adam's moments (optax ``add_decayed_weights`` with
        the JAX package's kernel mask, chained before ``adam``): the biases
        and the logvar bounds take none (reference :223-229)."""
        kernels = [m.weight for m in net.modules() if isinstance(m, EnsembleDense)]
        ids = {id(p) for p in kernels}
        rest = [p for p in net.parameters() if id(p) not in ids]
        groups = [{"params": kernels, "weight_decay": weight_decay}, {"params": rest, "weight_decay": 0.0}]
        return torch.optim.Adam(groups, lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def fit_step(self, net, opt, xb: torch.Tensor, yb: torch.Tensor, rw: torch.Tensor | None = None) -> torch.Tensor:
        """One optimizer step on member-specific batches xb (E, B, in), yb
        (E, B, out): the sum over members of the mean NLL, each row weighted
        by ``rw`` (E, B) when given.  Returns the loss."""
        mean, logvar = net(xb)
        nll = gaussian_nll(mean, logvar, yb)
        if rw is not None:
            nll = nll * rw[..., None]
        loss = nll.mean(dim=(1, 2)).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @staticmethod
    def _normalizer(X: torch.Tensor):
        in_mean = X.mean(dim=0)
        in_std = torch.clamp(X.std(dim=0, correction=0), min=1e-6)
        return in_mean, in_std

    @torch.no_grad()
    def holdout_mse(self, net, x_hold: torch.Tensor, y_hold: torch.Tensor) -> torch.Tensor:
        """(E,) mean squared error of each member's mean on the holdout rows."""
        mean_h, _ = net(x_hold)
        return ((mean_h - y_hold[None]) ** 2).mean(dim=(1, 2))

    def fit(self, state: EnsembleState, X: torch.Tensor, Y: torch.Tensor, gen: torch.Generator):
        """Fixed-budget fit on (X raw, Y); refreshes the normalizer and the elites.

        Per-member bootstrap: each member draws its own with-replacement batch
        every step (reference :232-242).  Each member keeps the params of its
        best holdout epoch (the static-shape analog of the reference's early
        stopping).  Returns (state, mean training loss).
        """
        cfg = self.cfg
        E, B = cfg.num_members, cfg.batch_size
        n = X.shape[0]
        n_hold = max(int(n * cfg.holdout_frac), 1)
        in_mean, in_std = self._normalizer(X)
        perm = torch.randperm(n, generator=gen, device=gen.device)
        Xn, Y = ((X - in_mean) / in_std)[perm], Y[perm]
        x_hold, y_hold, x_tr, y_tr = Xn[:n_hold], Y[:n_hold], Xn[n_hold:], Y[n_hold:]
        n_tr = x_tr.shape[0]
        steps = max(n_tr // B, 1)
        net = state.net
        opt = self.make_optimizer(net)
        best = [p.detach().clone() for p in net.parameters()]
        best_mse = torch.full((E,), float("inf"), device=X.device)
        epoch_losses = []
        for _ in range(cfg.epochs):
            losses = []
            for _ in range(steps):
                idx = torch.randint(0, n_tr, (E, B), generator=gen, device=gen.device)
                losses.append(self.fit_step(net, opt, x_tr[idx], y_tr[idx]))
            epoch_losses.append(torch.stack(losses).mean())
            mse = self.holdout_mse(net, x_hold, y_hold)
            improved = mse < best_mse
            best_mse = torch.where(improved, mse, best_mse)
            with torch.no_grad():
                for b, p in zip(best, net.parameters()):
                    b.copy_(torch.where(improved.reshape((-1,) + (1,) * (p.dim() - 1)), p, b))
        with torch.no_grad():
            for b, p in zip(best, net.parameters()):
                p.copy_(b)
        elites = torch.topk(-best_mse, cfg.num_elites).indices
        return EnsembleState(net, elites, in_mean, in_std), torch.stack(epoch_losses).mean()

    def fit_converged(
        self,
        state: EnsembleState,
        X: torch.Tensor,
        Y: torch.Tensor,
        n: int,
        gen: torch.Generator,
        row_weights: torch.Tensor | None = None,
    ):
        """Whole-buffer fit to convergence — the reference's fit protocol
        (probabilistic_ensemble.py:196-290):

        - ``X``/``Y`` are (capacity, ...) buffers whose first ``n`` rows are valid.
        - A disjoint holdout of min(n//10, max_holdout) rows; each member's
          bootstrap of the remaining rows is drawn with replacement ONCE per
          fit (reference :242 ``idxs = randint(n_train, size=(E, n_train))``),
          and each batch resamples within its member's fixed multiset.
        - Epochs run until no member improves its best holdout MSE by more
          than ``improvement_tol`` (relative) for ``patience`` epochs in a row,
          or ``max_epochs``; epoch 0 always counts as a gain.  Each epoch
          runs ceil(n_train / batch) steps.
        - A fresh Adam with kernel weight decay every fit (reference
          :225-229); the final params are kept, elites by the last holdout MSE.
        - ``row_weights`` (optional, (capacity,)): per-row NLL loss weights,
          normalized per member batch; None is the reference's uniform loss.

        Returns (new_state, mean last holdout MSE, epochs run).
        """
        cfg = self.cfg
        E, B = cfg.num_members, cfg.batch_size
        cap = X.shape[0]
        n = min(max(int(n), 2), cap)
        in_mean, in_std = self._normalizer(X[:n])
        Xn = (X[:n] - in_mean) / in_std
        Y = Y[:n]
        perm = torch.randperm(n, generator=gen, device=gen.device)
        hold_cap = min(max(int(cap * cfg.holdout_frac), 1), cfg.max_holdout)
        n_hold = min(max(n // 10, 1), hold_cap)
        x_hold, y_hold = Xn[perm[:n_hold]], Y[perm[:n_hold]]
        n_tr = max(n - n_hold, 1)
        boot_rows = perm[n_hold + torch.randint(0, n_tr, (E, n_tr), generator=gen, device=gen.device)]
        num_batches = max((n_tr + B - 1) // B, 1)

        net = state.net
        opt = self.make_optimizer(net, cfg.weight_decay)
        best = torch.full((E,), float("inf"), device=X.device)
        no_imp = epoch = 0
        mse = best
        while epoch < cfg.max_epochs and no_imp < cfg.patience:
            for _ in range(num_batches):
                pos = torch.randint(0, n_tr, (E, B), generator=gen, device=gen.device)
                rows = torch.gather(boot_rows, 1, pos)  # (E, B)
                rw = None
                if row_weights is not None:
                    rw = row_weights[rows]
                    rw = rw / torch.clamp(rw.mean(dim=1, keepdim=True), min=1e-8)
                self.fit_step(net, opt, Xn[rows], Y[rows], rw)
            mse = self.holdout_mse(net, x_hold, y_hold)
            if epoch == 0:
                improved = torch.ones_like(mse, dtype=torch.bool)
            else:
                improved = (best - mse) / torch.clamp(best, min=1e-12) > cfg.improvement_tol
            best = torch.where(improved, mse, best)
            no_imp = 0 if bool(improved.any()) else no_imp + 1
            epoch += 1
        elites = torch.topk(-mse, cfg.num_elites).indices
        return EnsembleState(net, elites, in_mean, in_std), mse.mean(), epoch

    @torch.no_grad()
    def predict(
        self,
        state: EnsembleState,
        x: torch.Tensor,
        gen: torch.Generator | None = None,
        choice: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
    ):
        """Elite-mixture sample and epistemic uncertainty (reference :131-194).

        Each row's member is drawn uniformly from the elites (``choice``, (B,)
        member indices) and its sample is mean + std * ``noise`` ((B, out)
        standard normals); both are drawn from ``gen`` unless given.  The
        uncertainty is the max over outputs of the std of the elites' means.
        """
        xn = (x - state.in_mean) / state.in_std
        mean, logvar = state.net(xn)  # (E, B, out)
        b = x.shape[0]
        rows = torch.arange(b, device=x.device)
        if choice is None:
            choice = state.elite_idx[torch.randint(0, self.cfg.num_elites, (b,), generator=gen, device=gen.device)]
        m = mean[choice, rows]
        s = torch.exp(0.5 * logvar[choice, rows])
        if noise is None:
            noise = torch.randn(m.shape, generator=gen, device=gen.device)
        unc = mean[state.elite_idx].std(dim=0, correction=0).max(dim=-1).values
        return m + s * noise, unc


def termination_fn_false(obs, act, next_obs, rew=None):
    """Never terminate (reference common/model_based/utils.py:96-102)."""
    return torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)


def termination_fn_dst(obs, act, next_obs, rew=None):
    """Deep-sea-treasure: collecting any treasure ends the episode.

    The reference keys on the predicted treasure reward being non-zero
    (termination_fn_dst utils.py:9-22); on a sampled Gaussian prediction a
    literal != 0 always fires, so the threshold is half the smallest treasure
    (0.7/2)."""
    return torch.abs(rew[:, 0]) > 0.35


def termination_fn_hopper(obs, act, next_obs, rew=None):
    """Healthy check of the planar hopper (obs = [q[1:], qd], so z = obs[0],
    angle = obs[1]; reference termination_fn_hopper)."""
    healthy = (
        (next_obs[:, 0] > 0.7)
        & (torch.abs(next_obs[:, 1]) < 0.2)
        & torch.all(torch.abs(next_obs[:, 1:]) < 100.0, dim=-1)
    )
    return ~healthy


def termination_fn_mountaincar(obs, act, next_obs, rew=None):
    """mo-mountaincarcontinuous goal."""
    return (next_obs[:, 0] >= 0.45) & (next_obs[:, 1] >= 0.0)


def termination_fn_minecart(obs, act, next_obs, rew=None):
    """Minecart sale: the episode ends when the cart crosses back into the
    home base carrying ore (reference termination_fn_minecart
    common/model_based/utils.py:35-45: out->in base crossing; the env also
    requires cargo to sell).  Also when the model itself predicts a sale
    reward, since its reward and position heads need not agree: a predicted
    sale just outside the base radius would otherwise bootstrap into a
    hallucinated post-sale state.

    obs layout: [pos(2), speed, sin, cos, cargo(2)], cargo at obs[5:7].
    """
    in_base = torch.sqrt(torch.sum(next_obs[:, 0:2] ** 2, dim=-1)) < 0.15
    was_out = torch.sqrt(torch.sum(obs[:, 0:2] ** 2, dim=-1)) >= 0.15
    has_cargo = torch.sum(obs[:, 5:7], dim=-1) > 0.0
    geo = in_base & was_out & has_cargo
    if rew is None:
        return geo
    return geo | (torch.sum(rew[:, 0:2], dim=-1) > 0.15)


def get_termination_fn(env_name: str):
    """Substring-keyed resolver, as the reference's per-env table
    (common/model_based/utils.py:13-102); unknown envs never terminate."""
    if "hopper" in env_name:
        return termination_fn_hopper
    if "deep-sea-treasure" in env_name or "dst" in env_name:
        return termination_fn_dst
    if "mountaincar" in env_name:
        return termination_fn_mountaincar
    if "minecart" in env_name:
        return termination_fn_minecart
    return termination_fn_false


class ModelEnv:
    """Imagined-transition generator over the learned model (reference utils.py:139-187)."""

    def __init__(self, model: ProbabilisticEnsemble, termination_fn: Callable | None = None):
        self.model = model
        self.termination_fn = termination_fn

    def step(self, state: EnsembleState, obs: torch.Tensor, actions: torch.Tensor, gen: torch.Generator):
        """obs (B, O), actions (B, A_feat) -> (next_obs, reward_vec, term, uncertainty)."""
        sample, unc = self.model.predict(state, torch.cat([obs, actions], dim=-1), gen)
        obs_dim = obs.shape[-1]
        next_obs = obs + sample[:, :obs_dim]
        reward = sample[:, obs_dim:]
        if self.termination_fn is not None:
            term = self.termination_fn(obs, actions, next_obs, reward)
        else:
            term = torch.zeros((obs.shape[0],), dtype=torch.bool, device=obs.device)
        return next_obs, reward, term, unc


@torch.no_grad()
def visualize_eval(
    act_fn,
    env,
    model: ProbabilisticEnsemble | None = None,
    model_state: EnsembleState | None = None,
    w=None,
    horizon: int = 10,
    gen: torch.Generator | None = None,
    compound: bool = True,
    save_path: str | None = None,
):
    """Diagnostic plot of model predictions against a real-env rollout.

    Reference common/model_based/utils.py:190-337 drives the real env with
    the agent for ``horizon`` steps and overlays the learned model's
    (compounded or one-step) predictions per obs/reward dimension.  One env
    on the generator's device; ``act_fn(obs (1, obs_dim), w, gen) -> action
    (1, ...)`` is the evaluation contract.  Returns the matplotlib figure
    (also saved to ``save_path`` when given).  matplotlib is imported here.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    state, obs = env.reset(1, gen)
    real_obs, real_rew, acts = [obs[0].cpu().numpy()], [], []
    for _ in range(horizon):
        a = act_fn(obs, w, gen)
        out = env.step(state, a, env.sample_noise(1, gen))
        acts.append(a.to(torch.float32).reshape(-1))
        real_obs.append(out.obs[0].cpu().numpy())
        real_rew.append(out.reward[0].cpu().numpy())
        state, obs = out.state, out.obs
    real_obs, real_rew = np.stack(real_obs), np.stack(real_rew)

    pred_obs = pred_rew = None
    if model is not None and model_state is not None:
        menv = ModelEnv(model)
        dev = model_state.in_mean.device
        cur = torch.as_tensor(real_obs[0], device=dev)[None]
        po, pr = [real_obs[0]], []
        for t in range(horizon):
            src = cur if compound else torch.as_tensor(real_obs[t], device=dev)[None]
            nxt, rew, _, _ = menv.step(model_state, src, acts[t].to(dev)[None], gen)
            po.append(nxt[0].cpu().numpy())
            pr.append(rew[0].cpu().numpy())
            cur = nxt
        pred_obs, pred_rew = np.stack(po), np.stack(pr)

    obs_dim, rew_dim = real_obs.shape[-1], real_rew.shape[-1]
    n = obs_dim + rew_dim
    ncols = min(4, n)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.2 * nrows), squeeze=False)
    flat = axes.ravel()
    for i in range(obs_dim):
        flat[i].plot(real_obs[:, i], label="real")
        if pred_obs is not None:
            flat[i].plot(pred_obs[:, i], "--", label="model")
        flat[i].set_title(f"obs[{i}]", fontsize=8)
    for j in range(rew_dim):
        ax = flat[obs_dim + j]
        ax.plot(real_rew[:, j], label="real")
        if pred_rew is not None:
            ax.plot(pred_rew[:, j], "--", label="model")
        ax.set_title(f"reward[{j}]", fontsize=8)
    for ax in flat[n:]:
        ax.axis("off")
    flat[0].legend(fontsize=7)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=80)
    return fig
