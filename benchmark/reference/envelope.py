"""Envelope Q-learning (Yang et al., 2019) on minecart, in plain PyTorch.

The actor-learner iteration the benchmark compares against: an
epsilon-greedy act over Q(s, w) in R^{A x d} from an MLP on obs||w, one
minecart step of every env, the transitions stored, each ended episode's
weight redrawn as |N(0, 1)| normalized; once ``learning_starts`` env steps are
stored, ``gradient_updates`` updates of the envelope loss on a sampled batch
tiled over ``num_sample_w`` sampled weights: the target is Q_target(s', w*)[a*]
at the (w*, a*) that maximise w·Q_online(s', w')[a'] over the sampled w' and
the actions; the loss (1 - lambda)·MSE(Q, y) + lambda·MSE(w·Q, w·y); the
global-norm clip, Adam, and with PER the priorities (|w·td| + min_priority)^alpha
of the first weight's rows; the hard target copy every
``target_net_update_freq`` iterations.
"""

from __future__ import annotations

import torch

from .common import Adam, Minecart, Precision, Replay, clip_global_norm, gaussian_weights, linear_decay


def layer_sizes(cfg: dict, obs_dim: int, reward_dim: int, num_actions: int) -> list[tuple[int, int]]:
    sizes = [obs_dim + reward_dim, *cfg["hidden"], num_actions * reward_dim]
    return list(zip(sizes[:-1], sizes[1:]))


def param_shapes(cfg: dict, obs_dim: int, reward_dim: int, num_actions: int) -> dict:
    """Leaf name -> (shape, fan_in); kernels are (in, out)."""
    out = {}
    for i, (a, b) in enumerate(layer_sizes(cfg, obs_dim, reward_dim, num_actions)):
        out[f"mlp.{i}.weight"] = ((a, b), a)
        out[f"mlp.{i}.bias"] = ((b,), None)
    return out


class EnvelopeReference:
    def __init__(self, cfg: dict, traffic: dict, params: dict, seed: int, device, precision: str = "f32"):
        self.cfg, self.tr, self.prec = cfg, traffic, Precision(precision)
        n = traffic["num_envs"]
        self.env = Minecart(n, device, stochastic=cfg["env_id"] == "minecart-v0")
        self.d, self.A = self.env.reward_dim, self.env.num_actions
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.target = {k: v.detach().clone() for k, v in params.items()}
        self.opt = Adam(self.params, cfg["learning_rate"])
        self.gen = torch.Generator(device).manual_seed(seed)
        self.buffer = Replay(traffic["buffer_size"], self.env.obs_dim, self.d, device, traffic["per"])
        self.state = self.env.start()
        self.obs = Minecart.observe(self.state)
        self.weights = gaussian_weights(self.gen, n, self.d)
        self.global_step, self.iters, self.loss = 0, 0, None
        self.n_layers = len(cfg["hidden"]) + 1

    def q(self, p: dict, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, w], dim=-1)
        for i in range(self.n_layers):
            x = self.prec.mm(x, p[f"mlp.{i}.weight"]) + p[f"mlp.{i}.bias"]
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x.reshape(*x.shape[:-1], self.A, self.d)

    def _schedule(self, initial: str, final: str, decay: str) -> float:
        n, c = self.tr["num_envs"], self.cfg
        return linear_decay(c[initial], c[decay], self.global_step // n, self.tr["learning_starts"] // n, c[final])

    def act(self) -> torch.Tensor:
        with torch.no_grad():
            greedy = torch.argmax(torch.einsum("nd,nad->na", self.weights, self.q(self.params, self.obs, self.weights)), dim=-1)
        return greedy

    def iterate(self) -> None:
        """One actor-learner iteration."""
        cfg, tr, gen, n = self.cfg, self.tr, self.gen, self.tr["num_envs"]
        eps = self._schedule("initial_epsilon", "final_epsilon", "epsilon_decay_steps")
        greedy = self.act()
        rand_a = torch.randint(0, self.A, (n,), generator=gen, device=gen.device)
        explore = torch.rand((n,), generator=gen, device=gen.device) < eps
        actions = torch.where(explore, rand_a, greedy)
        self.state, obs, reward, term, trunc, final_obs = self.env.step(self.state, actions, gen)
        self.buffer.add(self.obs, actions, reward, final_obs, term)
        new_w = gaussian_weights(gen, n, self.d)
        self.weights = torch.where((term | trunc)[:, None], new_w, self.weights)
        self.obs = obs
        self.global_step += n
        self.iters += 1
        if self.global_step >= tr["learning_starts"] and self.iters % cfg["train_freq"] == 0:
            lam = self._schedule("initial_homotopy_lambda", "final_homotopy_lambda", "homotopy_decay_steps")
            for _ in range(tr["gradient_updates"]):
                idx = self.buffer.sample(gen, tr["batch_size"])
                sampled_w = gaussian_weights(gen, cfg["num_sample_w"], self.d)
                self.loss, td = self.update(self.buffer.rows(idx), sampled_w, lam)
                if tr["per"]:
                    self.buffer.set_priorities(idx, (td.abs() + cfg["min_priority"]) ** cfg["per_alpha"])
        if self.iters % cfg["target_net_update_freq"] == 0:
            self.target = {k: v.detach().clone() for k, v in self.params.items()}

    def update(self, rows, sampled_w: torch.Tensor, lam: float):
        obs, action, reward, next_obs, term = rows
        b, nw, d = obs.shape[0], sampled_w.shape[0], self.d
        w = sampled_w.repeat_interleave(b, dim=0)  # row r: sample r % b under weight r // b
        bidx = torch.arange(nw * b, device=obs.device) % b
        with torch.no_grad():
            # every (s'_b, w'_k) once through each net
            pairs_obs = next_obs.repeat_interleave(nw, dim=0)
            pairs_w = sampled_w.repeat(b, 1)
            q_on = self.q(self.params, pairs_obs, pairs_w).reshape(b, nw, self.A, d)[bidx]  # (W*B, W', A, d)
            q_tg = self.q(self.target, pairs_obs, pairs_w).reshape(b, nw, self.A, d)[bidx]
            scal = torch.einsum("rd,rkad->rka", w, q_on)
            best_a = torch.argmax(scal, dim=2)
            best_w = torch.argmax(scal.max(dim=2).values, dim=1)
            rows_r = torch.arange(nw * b, device=obs.device)
            target = q_tg[rows_r, best_w, best_a[rows_r, best_w]]
            y = reward[bidx] + (1.0 - term[bidx])[:, None] * self.cfg["gamma"] * target
        q = self.q(self.params, obs[bidx], w)
        q_sa = q[torch.arange(nw * b, device=obs.device), action[bidx]]
        l_mo = torch.mean((q_sa - y) ** 2)
        td = torch.sum(q_sa * w, dim=-1) - torch.sum(y * w, dim=-1)
        loss = (1.0 - lam) * l_mo + lam * torch.mean(td**2)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        grads = clip_global_norm(dict(zip(self.params, grads)), self.cfg["max_grad_norm"])
        self.opt.step(grads)
        return loss.detach(), td[:b].detach()
