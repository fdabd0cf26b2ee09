"""A test-only algorithm module: the program's MOSAC (``agents/mosac.py``) on
``mo-mountaincarcontinuous-v0``, a population of ``cfg["members"]``,
driven through the harness's algorithm contract where the defaults do not
fit: its own ``step`` (the buffer is passed in), ``env_steps`` (members x
envs), ``reads`` (three optimizers, no PER), the ``"polyak"`` target rule and
a mapping of named modules (the actor, the twin critics with their target,
the entropy temperature).

Its "reference" is a second, independent build of the same program from the
same seed and weights, so a run tests the harness's plumbing and not the
program.  A configuration with ``"frozen_target": true`` makes the program
side's Polyak update do nothing (the reference's still moves); one with
``"target_rule"`` names that rule in place of ``"polyak"``.

``test_bench_contract.py`` registers it as ``benchmark.algos.mosac_stub``."""

from __future__ import annotations

import contextlib
import sys
import types
from unittest import mock

CONFIG_KEYS = ("learning_rate", "q_learning_rate", "gamma", "tau", "policy_freq", "alpha", "autotune")
TRAFFIC_KEYS = ("num_envs", "batch_size", "buffer_size", "learning_starts")


class Run:
    """The state the harness drives: MOSAC's state, its buffer, and the last update's loss."""

    def __init__(self, agent, seed: int, members: int):
        self.sac = agent.init_state([seed + p for p in range(members)])
        self.buffer = agent.make_buffer(members)
        self.loss = None


def _agent(cfg: dict, traffic: dict, seed: int, device):
    from morl_baselines_torch.agents.mosac import MOSAC, MOSACConfig
    from morl_baselines_torch.envs import make

    kw = {k: cfg[k] for k in CONFIG_KEYS} | {k: traffic[k] for k in TRAFFIC_KEYS}
    return MOSAC(make(cfg["env_id"]), cfg["weight"], MOSACConfig(**kw, hidden=tuple(cfg["hidden"]), seed=seed), device=device)


def _nets(run: Run) -> dict:
    s = run.sac
    return {"actor": s.actor, "critic": (s.critic.net, s.critic.target_net), "log_alpha": s.log_alpha}


def build(cfg: dict, traffic: dict, seed: int, device):
    """(agent, run, named modules); each update's loss is kept in ``run.loss``."""
    from morl_baselines_torch.agents import mosac

    agent = _agent(cfg, traffic, seed, device)
    run = Run(agent, seed, cfg["members"])
    update = agent._update

    def kept(*args, **kwargs):
        frozen = cfg.get("frozen_target")
        with mock.patch.object(mosac, "polyak_update", lambda net, target, tau: None) if frozen else contextlib.nullcontext():
            closs = update(*args, **kwargs)
        run.loss = closs.mean()
        return closs

    agent._update = kept
    return agent, run, _nets(run)


def step(agent, run: Run) -> None:
    agent.train_segment(run.sac, run.buffer, 1)


def env_steps(cfg: dict, traffic: dict) -> int:
    return cfg["members"] * traffic["num_envs"]


def reads(run: Run):
    s = run.sac
    return run.loss, [s.critic.optimizer, s.actor_optimizer, s.alpha_optimizer], run.buffer


def target_rule(cfg: dict):
    return (cfg["target_rule"], None) if "target_rule" in cfg else ("polyak", cfg["tau"])


def shapes(cfg: dict) -> dict:
    """Every learnable leaf, read from a build on the CPU: kernels (members, in, out)."""
    import torch

    traffic = {"num_envs": 1, "batch_size": 1, "buffer_size": 1, "learning_starts": 1}
    agent = _agent(cfg, traffic, 0, torch.device("cpu"))
    out = {}
    for key, entry in _nets(Run(agent, 0, cfg["members"])).items():
        module = entry[0] if isinstance(entry, tuple) else entry
        leaves = [(key, module)] if isinstance(module, torch.Tensor) else [(f"{key}.{n}", p) for n, p in module.named_parameters()]
        for name, p in leaves:
            out[name] = (tuple(p.shape), p.shape[-2] if name.endswith("weight") else None)
    return out


def port_name(name: str) -> str:
    return name


def to_port(name: str, x):
    return x


class Reference:
    """The program built a second time, with the benchmark's weights."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, seed: int, device):
        from benchmark import harness

        algo = sys.modules[__name__]
        self.agent, self.run, nets = build(dict(cfg, frozen_target=False), traffic, seed, device)
        harness.load_params(algo, params, nets)
        self.params, self.target_params = harness.program_leaves(algo, params, nets)

    def iterate(self) -> None:
        step(self.agent, self.run)

    @property
    def loss(self):
        return self.run.loss

    @property
    def opt(self):
        from benchmark import harness

        return types.SimpleNamespace(m=harness.first_moments(reads(self.run)[1], self.params))


def reference(cfg: dict, traffic: dict, params: dict, seed: int, device, precision: str):
    return Reference(cfg, traffic, params, seed, device)


def gemms(cfg: dict, traffic: dict) -> list:
    return []
