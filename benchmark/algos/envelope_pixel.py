"""Envelope with the NatureCNN Q-net on the pixel stack: ``Envelope.init_state``
and ``Envelope.train_segment`` of ``morl_baselines_torch`` with ``image_shape``,
its Q-net loaded with the benchmark's weights; the reference; and the work an
iteration needs."""

from __future__ import annotations

from ..reference.envelope_pixel import EnvelopePixelReference, flat_dim, param_shapes, trunk_spec
from ..reference.pixel import PixelStack
from .envelope import CONFIG_KEYS, TRAFFIC_KEYS

# the trunk the program builds (models/networks.py::NatureCNN): (filters, kernel, stride), features
PROGRAM_TRUNK = {"convs": [[32, 8, 4], [64, 4, 2], [64, 3, 1]], "features": 512}


class Work(list):
    """(m, k, n) of every Q-net GEMM an iteration needs, each convolution as
    its implicit GEMM; ``trunk`` holds (operations, bytes) of each of the
    trunk's convolutions and dense products at their true tensor sizes."""

    trunk: list


def shapes(cfg: dict) -> dict:
    return param_shapes(cfg, PixelStack.reward_dim, PixelStack.num_actions)


def port_name(name: str) -> str:
    """The program's parameter of a reference leaf: ``cnn.i`` is
    ``cnn.convs.i`` for a convolution and ``cnn.out`` for the dense layer;
    ``mlp.i`` is ``mlp.layers.i``."""
    group, i, leaf = name.split(".")
    if group == "mlp":
        return f"mlp.layers.{i}.{leaf}"
    return f"cnn.convs.{i}.{leaf}" if int(i) < 3 else f"cnn.out.{leaf}"


def to_port(name: str, x):
    """A reference leaf in the program's layout: a convolution's kernel is
    already torch's (out, in, kh, kw); a dense kernel (in, out) becomes (out,
    in), and the trunk's dense layer reads its input in the program's (H, W,
    C) order where the reference flattens (C, H, W)."""
    if not name.endswith("weight") or x.dim() != 2:
        return x
    if name.startswith("cnn."):
        (flat, out), channels = x.shape, PROGRAM_TRUNK["convs"][-1][0]
        side = round((flat // channels) ** 0.5)
        return x.t().reshape(out, channels, side, side).permute(0, 2, 3, 1).reshape(out, flat)
    return x.t()


def build(cfg: dict, traffic: dict, seed: int, device):
    """(agent, state, online net, target net) through the program's public API."""
    from morl_baselines_torch.agents import Envelope, EnvelopeConfig
    from morl_baselines_torch.envs import make

    if cfg["trunk"] != PROGRAM_TRUNK:
        raise ValueError(f"the program builds the trunk {PROGRAM_TRUNK}, the configuration asks for {cfg['trunk']}")
    kw = {k: cfg[k] for k in CONFIG_KEYS} | {k: traffic[k] for k in TRAFFIC_KEYS}
    kw["hidden"] = tuple(kw["hidden"])
    agent = Envelope(make(cfg["env_id"]), EnvelopeConfig(**kw, image_shape=tuple(cfg["image_shape"]), seed=seed), device=device)
    state = agent.init_state(seed)
    return agent, state, state.ts.net, state.ts.target_net


def reference(cfg: dict, traffic: dict, params: dict, seed: int, device, precision: str):
    return EnvelopePixelReference(cfg, traffic, params, seed, device, precision)


def gemms(cfg: dict, traffic: dict) -> Work:
    """The Q-net work one learning iteration needs (not the program's code,
    which tiles the batch over the sampled weights).

    The act: every env's frames through the trunk and the head.  An update:
    the B next frames once through the online trunk and once through the
    target trunk and the B·W distinct (s', w') rows through each head; the
    loss's B frames through the trunk and its B·W rows through the head; then
    the backward: every layer's kernel gradient, and the input gradients of
    the head's layers (of the first, the part that reaches the features) and
    of the trunk's down to the second convolution (the first's input is data).

    A convolution of N frames is the GEMM (N·Ho·Wo, Cin·kh·kw, Cout): its
    forward, its kernel gradient (Cin·kh·kw, N·Ho·Wo, Cout) and its input
    gradient (N·Ho·Wo, Cout, Cin·kh·kw) each need 2·N·Ho·Wo·Cin·kh·kw·Cout
    operations and move 4·(N·Cin·H·W + Cout·Cin·kh·kw + N·Cout·Ho·Wo) bytes."""
    feats, fdim = cfg["trunk"]["features"], flat_dim(cfg)
    d, actions = PixelStack.reward_dim, PixelStack.num_actions
    head = list(zip([feats + d, *cfg["hidden"]], [*cfg["hidden"], actions * d]))
    b, rows = traffic["batch_size"], traffic["batch_size"] * cfg["num_sample_w"]

    def trunk(n: int, backward: bool = False) -> tuple[list, list]:
        """(GEMMs, (operations, bytes)) of n frames through the trunk, or back through it."""
        out = []
        for i, (cin, cout, k, _, h, ho) in enumerate(trunk_spec(cfg)):
            m, kk = n * ho * ho, cin * k * k
            size = 4 * (n * cin * h * h + cout * kk + n * cout * ho * ho)
            if not backward:
                out.append(((m, kk, cout), size))
            else:
                out.append(((kk, m, cout), size))
                if i > 0:
                    out.append(((m, cout, kk), size))
        dense = [(fdim, n, feats), (n, feats, fdim)] if backward else [(n, fdim, feats)]
        out += [((m, k, nn), 4 * (m * k + k * nn + m * nn)) for m, k, nn in dense]
        return [g for g, _ in out], [(2 * m * k * nn, size) for (m, k, nn), size in out]

    def heads(n: int, backward: bool = False) -> list:
        if not backward:
            return [(n, a, o) for a, o in head]
        return [(a, n, o) for a, o in head] + [(n, head[0][1], feats)] + [(n, o, a) for a, o in head[1:]]

    act, act_ops = trunk(traffic["num_envs"])
    fwd, fwd_ops = trunk(b)
    bwd, bwd_ops = trunk(b, backward=True)
    update = fwd * 3 + heads(rows) * 3 + bwd + heads(rows, backward=True)
    work = Work(act + heads(traffic["num_envs"]) + update * traffic["gradient_updates"])
    work.trunk = act_ops + (fwd_ops * 3 + bwd_ops) * traffic["gradient_updates"]
    return work
