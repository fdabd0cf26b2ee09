"""GPI-LS (Alegre et al., 2023) on minecart with DroQ critics, in plain PyTorch.

The actor-learner iteration the benchmark compares against.  Each of C
critics is a psi-network: relu(Dense(obs)) * relu(Dense(w)) through a head of
Dense -> dropout -> LayerNorm -> ReLU layers and a Dense to A·d outputs.  The
act is GPI over the weight support M: the best action of the support policy
w' whose mean-over-critics value max_a w·psi(s, a, w') is highest; each
ended episode's task weight is redrawn from M.  An update draws a batch (and
the batch's weights: half the task weights of random envs, half support
rows), forms the DroQ target (per action the critic with the least w·psi',
its greedy action, r + gamma·psi'), takes the mean Huber loss of every
critic's TD error with dropout on in both forwards, Adam, and with PER sets
the priorities max_c |w·td_c| clipped below at min_priority, to the alpha.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Adam, Minecart, Precision, Replay, clip_global_norm, linear_decay

_LN_EPS = 1e-6  # flax's LayerNorm epsilon


def param_shapes(cfg: dict, obs_dim: int, reward_dim: int, num_actions: int) -> dict:
    """Leaf name -> (shape, fan_in); every leaf carries the critic axis first."""
    c, hidden = cfg["n_critics"], cfg["hidden"]
    h = hidden[0]
    out = {
        "obs_embed.weight": ((c, obs_dim, h), obs_dim),
        "obs_embed.bias": ((c, h), None),
        "w_embed.weight": ((c, reward_dim, h), reward_dim),
        "w_embed.bias": ((c, h), None),
    }
    sizes = [h, *hidden[1:], num_actions * reward_dim]
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"head.{i}.weight"] = ((c, a, b), a)
        out[f"head.{i}.bias"] = ((c, b), None)
        if i < len(hidden) - 1 and cfg["use_layernorm"]:
            out[f"head_norm.{i}.scale"] = ((c, 1, b), "scale")
            out[f"head_norm.{i}.bias"] = ((c, 1, b), None)
    return out


class GPILSReference:
    def __init__(self, cfg: dict, traffic: dict, params: dict, seed: int, device, support: torch.Tensor, precision: str = "f32"):
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
        self.support = support.to(device)
        self.task_w = torch.full((n, self.d), 1.0 / self.d, device=device)
        self.global_step, self.iters, self.loss = 0, 0, None
        self.n_head = len(cfg["hidden"])  # hidden[1:] head layers and the output layer

    def _dense(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.prec.mm(x, p[f"{name}.weight"]) + p[f"{name}.bias"][:, None, :]

    def head(self, p: dict, x: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        """(C, R, h) features -> (C, R, A, d)."""
        rate = self.cfg["dropout_rate"]
        for i in range(self.n_head):
            x = self._dense(p, f"head.{i}", x)
            if i < self.n_head - 1:
                if gen is not None and rate > 0:
                    keep = torch.rand(x.shape, generator=gen, device=gen.device) < 1.0 - rate
                    x = torch.where(keep, x / (1.0 - rate), 0.0)
                if self.cfg["use_layernorm"]:
                    x = F.layer_norm(x, x.shape[-1:], eps=_LN_EPS) * p[f"head_norm.{i}.scale"] + p[f"head_norm.{i}.bias"]
                x = torch.relu(x)
        return x.reshape(*x.shape[:-1], self.A, self.d)

    def psi(self, p: dict, obs: torch.Tensor, w: torch.Tensor, gen: torch.Generator | None = None) -> torch.Tensor:
        """Row-paired obs (B, O) and weights (B, d) -> (C, B, A, d)."""
        x = torch.relu(self._dense(p, "obs_embed", obs)) * torch.relu(self._dense(p, "w_embed", w))
        return self.head(p, x, gen)

    def act(self) -> torch.Tensor:
        """GPI actions of every env over the support, without dropout."""
        with torch.no_grad():
            n, m = self.obs.shape[0], self.support.shape[0]
            oe = torch.relu(self._dense(self.params, "obs_embed", self.obs))  # (C, N, h)
            we = torch.relu(self._dense(self.params, "w_embed", self.support))  # (C, M, h)
            x = (oe[:, :, None, :] * we[:, None, :, :]).reshape(oe.shape[0], n * m, -1)
            psi = self.head(self.params, x, None).mean(dim=0).reshape(n, m, self.A, self.d)
            q = torch.einsum("nd,nmad->nma", self.task_w, psi)
            pol = torch.argmax(q.max(dim=2).values, dim=1)
            return torch.argmax(q[torch.arange(n, device=q.device), pol], dim=1)

    def iterate(self) -> None:
        """One actor-learner iteration."""
        cfg, tr, gen, n = self.cfg, self.tr, self.gen, self.tr["num_envs"]
        greedy = self.act()
        eps = linear_decay(cfg["initial_epsilon"], cfg["epsilon_decay_steps"], self.global_step // n, tr["learning_starts"] // n, cfg["final_epsilon"])
        rand_a = torch.randint(0, self.A, (n,), generator=gen, device=gen.device)
        explore = torch.rand((n,), generator=gen, device=gen.device) < eps
        actions = torch.where(explore, rand_a, greedy)
        self.state, obs, reward, term, trunc, final_obs = self.env.step(self.state, actions, gen)
        self.buffer.add(self.obs, actions, reward, final_obs, term)
        pick = torch.randint(0, self.support.shape[0], (n,), generator=gen, device=gen.device)
        self.task_w = torch.where((term | trunc)[:, None], self.support[pick], self.task_w)
        self.obs = obs
        self.global_step += n
        self.iters += 1
        if self.global_step >= tr["learning_starts"] and self.iters % cfg["train_freq"] == 0:
            b = tr["batch_size"]
            for _ in range(tr["gradient_updates"]):
                idx = self.buffer.sample(gen, b)
                w1 = self.task_w[torch.randint(0, n, (b // 2,), generator=gen, device=gen.device)]
                w2 = self.support[torch.randint(0, self.support.shape[0], (b - b // 2,), generator=gen, device=gen.device)]
                self.loss, prio = self.update(self.buffer.rows(idx), torch.cat([w1, w2]))
                if tr["per"]:
                    self.buffer.set_priorities(idx, torch.clamp(prio, min=cfg["min_priority"]) ** cfg["per_alpha"])
        if self.iters % cfg["target_net_update_freq"] == 0:
            self.target = {k: v.detach().clone() for k, v in self.params.items()}

    def update(self, rows, w: torch.Tensor):
        obs, action, reward, next_obs, term = rows
        cfg, gen, d = self.cfg, self.gen, self.d
        b = obs.shape[0]
        r = torch.arange(b, device=obs.device)
        with torch.no_grad():
            psi_next = self.psi(self.target, next_obs, w, gen)  # (C, B, A, d)
            q_next = torch.einsum("bd,cbad->cba", w, psi_next)
            least = torch.argmin(q_next, dim=0)  # (B, A)
            min_psi = psi_next[least, r[:, None], torch.arange(self.A, device=obs.device)[None, :]]  # (B, A, d)
            best = torch.argmax(torch.einsum("bd,bad->ba", w, min_psi), dim=1)
            target = reward + (1.0 - term)[:, None] * cfg["gamma"] * min_psi[r, best]
        tds = self.psi(self.params, obs, w, gen)[:, r, action] - target[None]  # (C, B, d)
        a = tds.abs()
        loss = torch.where(a < cfg["min_priority"], 0.5 * tds**2, cfg["min_priority"] * a).mean()
        grads = torch.autograd.grad(loss, list(self.params.values()))
        self.opt.step(clip_global_norm(dict(zip(self.params, grads)), cfg["max_grad_norm"]))
        return loss.detach(), torch.einsum("cbd,bd->cb", tds.detach(), w).abs().max(dim=0).values
