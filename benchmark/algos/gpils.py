"""GPI-LS on the program: ``GPILS.init_state``, ``set_weight_support`` and
``GPILS.train_segment`` of ``morl_baselines_torch``, its critics loaded with
the benchmark's weights and its support filled with the benchmark's weights;
the reference; and the Q-net GEMMs an iteration needs."""

from __future__ import annotations

from ..reference.common import Minecart
from ..reference.gpils import GPILSReference, param_shapes
from ..weights import support_weights

CONFIG_KEYS = (
    "learning_rate", "gamma", "hidden", "n_critics", "dropout_rate", "use_layernorm", "max_grad_norm", "tau",
    "target_net_update_freq", "train_freq", "initial_epsilon", "final_epsilon", "epsilon_decay_steps",
    "per_alpha", "min_priority", "max_support", "use_gpi", "gpi_type", "bf16_act",
)
TRAFFIC_KEYS = ("num_envs", "gradient_updates", "batch_size", "buffer_size", "per", "learning_starts")


def shapes(cfg: dict) -> dict:
    return param_shapes(cfg, Minecart.obs_dim, Minecart.reward_dim, Minecart.num_actions)


def port_name(name: str) -> str:
    """The program's parameter of a reference leaf."""
    if name.startswith("head_norm."):
        return name.replace("head_norm.", "head.norms.", 1)
    if name.startswith("head."):
        return name.replace("head.", "head.layers.", 1)
    module, leaf = name.split(".")
    return f"{module}.layers.0.{leaf}"


def to_port(name: str, x):
    return x  # the program's ensemble layers keep the (C, in, out) layout


def support(cfg: dict, seed: int):
    return support_weights(Minecart.reward_dim, cfg["max_support"], seed)


def build(cfg: dict, traffic: dict, seed: int, device):
    """(agent, state, online net, target net) through the program's public API."""
    from morl_baselines_torch.agents import GPILS, GPILSConfig
    from morl_baselines_torch.envs import make

    kw = {k: cfg[k] for k in CONFIG_KEYS} | {k: traffic[k] for k in TRAFFIC_KEYS}
    kw["hidden"] = tuple(kw["hidden"])
    agent = GPILS(make(cfg["env_id"]), GPILSConfig(**kw, seed=seed), device=device)
    state = agent.set_weight_support(agent.init_state(seed), list(support(cfg, seed)))
    if state.support_size != cfg["max_support"]:
        raise RuntimeError(f"the program kept {state.support_size} of {cfg['max_support']} support weights")
    return agent, state, state.ts.net, state.ts.target_net


def reference(cfg: dict, traffic: dict, params: dict, seed: int, device, precision: str):
    import torch

    w = torch.as_tensor(support(cfg, seed), device=device)
    return GPILSReference(cfg, traffic, params, seed, device, w, precision)


def gemms(cfg: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """(m, k, n) of every Q-net GEMM that one learning iteration needs, per critic.

    The act: each env's obs once through the obs embedding, each support
    weight once through the weight embedding (the program may repeat them
    per pair; those repeats are not needed work), and the N·M pairs through
    the head.  An update: the B rows through the target and the online
    critics, and the online backward: every kernel's gradient and the input
    gradient of every head layer (the embeddings' inputs are data)."""
    c, hidden = cfg["n_critics"], cfg["hidden"]
    o, d, a, h = Minecart.obs_dim, Minecart.reward_dim, Minecart.num_actions, hidden[0]
    sizes = [h, *hidden[1:], a * d]
    head = list(zip(sizes[:-1], sizes[1:]))
    n, m, b = traffic["num_envs"], cfg["max_support"], traffic["batch_size"]
    act = [(n, o, h), (m, d, h)] + [(n * m, i, j) for i, j in head]
    fwd = [(b, o, h), (b, d, h)] + [(b, i, j) for i, j in head]
    bwd = [(o, b, h), (d, b, h)] + [(i, b, j) for i, j in head] + [(b, j, i) for i, j in head]
    return (act + (fwd * 2 + bwd) * traffic["gradient_updates"]) * c
