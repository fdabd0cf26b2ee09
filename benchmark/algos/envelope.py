"""Envelope on the program: ``Envelope.init_state`` and ``Envelope.train_segment``
of ``morl_baselines_torch``, its Q-net loaded with the benchmark's weights;
the reference; and the Q-net GEMMs an iteration needs."""

from __future__ import annotations

from ..reference.common import Minecart
from ..reference.envelope import EnvelopeReference, layer_sizes, param_shapes

CONFIG_KEYS = (
    "learning_rate", "gamma", "hidden", "num_sample_w", "max_grad_norm", "tau", "target_net_update_freq",
    "train_freq", "initial_epsilon", "final_epsilon", "epsilon_decay_steps", "initial_homotopy_lambda",
    "final_homotopy_lambda", "homotopy_decay_steps", "per_alpha", "min_priority",
)
TRAFFIC_KEYS = ("num_envs", "gradient_updates", "batch_size", "buffer_size", "per", "learning_starts")


def shapes(cfg: dict) -> dict:
    return param_shapes(cfg, Minecart.obs_dim, Minecart.reward_dim, Minecart.num_actions)


def port_name(name: str) -> str:
    """The program's parameter of a reference leaf: ``mlp.i.*`` is ``mlp.layers.i.*``."""
    return name.replace("mlp.", "mlp.layers.", 1)


def to_port(name: str, x):
    """A reference leaf in the program's layout: a torch Linear kernel is (out, in)."""
    return x.t() if name.endswith("weight") else x


def build(cfg: dict, traffic: dict, seed: int, device):
    """(agent, state, online net, target net) through the program's public API."""
    from morl_baselines_torch.agents import Envelope, EnvelopeConfig
    from morl_baselines_torch.envs import make

    kw = {k: cfg[k] for k in CONFIG_KEYS} | {k: traffic[k] for k in TRAFFIC_KEYS}
    kw["hidden"] = tuple(kw["hidden"])
    agent = Envelope(make(cfg["env_id"]), EnvelopeConfig(**kw, seed=seed), device=device)
    state = agent.init_state(seed)
    return agent, state, state.ts.net, state.ts.target_net


def reference(cfg: dict, traffic: dict, params: dict, seed: int, device, precision: str):
    return EnvelopeReference(cfg, traffic, params, seed, device, precision)


def gemms(cfg: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """(m, k, n) of every Q-net GEMM that one learning iteration needs.

    The act: every env's (obs, w) once.  An update: each of the B·W distinct
    (s', w') pairs once through the online net and once through the target
    net (the program may tile them W times more; those repeats are not
    needed work), the loss's B·W rows forward, and their backward: each
    layer's kernel gradient, and the input gradient of every layer but the
    first (its input is data)."""
    layers = layer_sizes(cfg, Minecart.obs_dim, Minecart.reward_dim, Minecart.num_actions)
    rows = traffic["batch_size"] * cfg["num_sample_w"]
    out = [(traffic["num_envs"], a, b) for a, b in layers]
    upd = [(rows, a, b) for a, b in layers] * 3  # target side online and target nets, loss forward
    upd += [(a, rows, b) for a, b in layers]  # kernel gradients
    upd += [(rows, b, a) for a, b in layers[1:]]  # input gradients
    return out + upd * traffic["gradient_updates"]
