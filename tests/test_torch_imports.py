"""The port stands alone: no JAX, and no silent CPU fallback.

Every module of ``morl_baselines_torch`` and ``chip_smoke.py`` is imported in a
fresh interpreter, which must then hold no ``jax``, ``flax``, ``optax``,
``orbax``, ``mujoco``, ``gymnasium`` or ``morl_baselines_tpu`` module.  An
entry point given no device asks for CUDA and raises where there is none.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from morl_baselines_torch.agents import (
    CAPQL,
    EUPG,
    GPILS,
    GPIPD,
    IPRO,
    IPRO2D,
    LCN,
    MOPPO,
    MORLD,
    MOSAC,
    NLMOPPO,
    PCN,
    PGMORL,
    PQL,
    CAPQLConfig,
    Envelope,
    EUPGConfig,
    EnvelopeConfig,
    GPILSConfig,
    GPILSContinuous,
    GPILSContinuousConfig,
    GPIPDConfig,
    GPIPDContinuous,
    GPIPDContinuousConfig,
    IPROConfig,
    LCNConfig,
    MOPPOConfig,
    MOQLearning,
    MOQLearningConfig,
    MORLDConfig,
    MOSACConfig,
    MOSACDiscrete,
    MPMOQLConfig,
    MPMOQLearning,
    NLMOPPOConfig,
    PCNConfig,
    PGMORLConfig,
    PQLConfig,
)
from morl_baselines_torch.core import DeviceParetoFront
from morl_baselines_torch.envs import fishwood_utility, make

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import morl_baselines_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "mujoco", "gymnasium", "morl_baselines_tpu")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(json.dumps({"modules": len(names), "names": names, "leaked": leaked}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["modules"] >= 20, got
    assert got["leaked"] == [], f"the port pulled in {got['leaked']}"
    later = {f"morl_baselines_torch.agents.{m}" for m in ("moppo", "pgmorl", "mosac", "morld", "moql", "mpmoql", "pql", "eupg")}
    later |= {f"morl_baselines_torch.agents.{m}" for m in ("pcn", "lcn", "capql", "nlmoppo", "ipro")}
    later |= {"morl_baselines_torch.replay.episodic", "morl_baselines_torch.envs.fruit_tree"}
    later |= {f"morl_baselines_torch.envs.{m}" for m in ("lunar_lander", "four_room", "resource_gathering",
                                                          "breakable_bottles", "highway", "pixel", "wrappers")}
    later |= {f"morl_baselines_torch.cli.{m}" for m in ("experiments", "launch", "sweep", "parity", "bench", "profile_gpils",
                                                         "profile_population", "bench_gpils_ab", "probe_planar",
                                                         "gpils_minecart_tune")}
    later |= {"morl_baselines_torch.utils.native", "morl_baselines_torch.utils.profiling",
              "morl_baselines_torch.replay.accrued", "morl_baselines_torch.replay.diverse"}
    assert later <= set(got["names"]), later - set(got["names"])


def test_entry_points_need_cuda_by_default(monkeypatch):
    """With no ``device`` an entry point asks for CUDA and, without it, raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EnvelopeConfig(num_envs=4, buffer_size=64, batch_size=8, hidden=(8,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Envelope(make("minecart-v0"), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceParetoFront.create(8, 3)
    gcfg = dict(num_envs=4, buffer_size=64, batch_size=8, hidden=(8,), max_support=4)
    for cls, config in ((GPILS, GPILSConfig(**gcfg)), (GPIPD, GPIPDConfig(**gcfg))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(make("minecart-v0"), config)
    # asking for the CPU explicitly works
    assert Envelope(make("minecart-v0"), cfg, device="cpu").device.type == "cpu"
    for cls, config in ((GPILS, GPILSConfig(**gcfg)), (GPIPD, GPIPDConfig(**gcfg))):
        agent = cls(make("minecart-v0"), config, device="cpu")
        state = agent.init_state()
        assert agent.device.type == "cpu" and (state.base if cls is GPIPD else state).obs.device.type == "cpu"


def test_continuous_entry_points_need_cuda_by_default(monkeypatch):
    """The planar envs (their constants live on a device) and the continuous
    agents ask for CUDA unless told otherwise, and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for env_id in ("mo-hopper-jx-v5", "mo-halfcheetah-jx-v5"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(env_id)
    cfg = dict(num_envs=4, buffer_size=64, batch_size=8, hidden=(8,), max_support=4)
    for cls, config in ((GPILSContinuous, GPILSContinuousConfig(**cfg)), (GPIPDContinuous, GPIPDContinuousConfig(**cfg))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(make("water-reservoir-v0"), config)
        agent = cls(make("mo-hopper-jx-v5", device="cpu"), config, device="cpu")
        state = agent.init_state()
        base = state.base if cls is GPIPDContinuous else state
        assert agent.device.type == "cpu" and base.obs.device.type == "cpu" and base.obs.shape == (4, 11)


def test_population_entry_points_need_cuda_by_default(monkeypatch):
    """MOPPO, PGMORL, MOSAC and MORL/D ask for CUDA unless told otherwise, and
    raise without it; on the CPU, when asked, their states live there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = make("mo-mountaincarcontinuous-v0")
    ppo = MOPPOConfig(num_envs=4, steps_per_iteration=16, hidden=(8,))
    sac = MOSACConfig(num_envs=4, buffer_size=64, batch_size=8, hidden=(8,))
    makers = {
        MOPPO: lambda **kw: MOPPO(env, [0.5, 0.5], ppo, **kw),
        PGMORL: lambda **kw: PGMORL(env, [-120.0, -120.0], PGMORLConfig(pop_size=2, ppo=ppo), **kw),
        MOSAC: lambda **kw: MOSAC(env, [0.5, 0.5], sac, **kw),
        MORLD: lambda **kw: MORLD(env, MORLDConfig(pop_size=2, sac=sac), **kw),
    }
    for cls, make_agent in makers.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_agent()
        agent = make_agent(device="cpu")
        single = agent if cls in (MOPPO, MOSAC) else (agent.agents if cls is PGMORL else agent.population)[0]
        state = single.init_state([0, 1])
        assert agent.device.type == "cpu" and state.obs.device.type == "cpu" and state.obs.shape == (2, 4, 2)


def test_tabular_and_esr_entry_points_need_cuda_by_default(monkeypatch):
    """MOQLearning, MPMOQLearning, PQL and EUPG ask for CUDA unless told
    otherwise, and raise without it; on the CPU, when asked, their tables and
    states live there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dst, fishwood = make("deep-sea-treasure-v0"), make("fishwood-v0")
    makers = {
        MOQLearning: lambda **kw: MOQLearning(dst, [0.5, 0.5], MOQLearningConfig(num_envs=4), **kw),
        MPMOQLearning: lambda **kw: MPMOQLearning(dst, MPMOQLConfig(), **kw),
        PQL: lambda **kw: PQL(dst, [0.0, -50.0], PQLConfig(), **kw),
        EUPG: lambda **kw: EUPG(fishwood, fishwood_utility, config=EUPGConfig(num_envs=4, hidden=(8,)), **kw),
    }
    for cls, make_agent in makers.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_agent()
        agent = make_agent(device="cpu")
        assert agent.device.type == "cpu"
        if cls is MPMOQLearning:
            continue
        state = agent.init_state()
        table = {MOQLearning: "q_table", PQL: "q_sets"}.get(cls)
        assert state.obs.device.type == "cpu" and (table is None or getattr(state, table).device.type == "cpu")


def test_multi_policy_entry_points_need_cuda_by_default(monkeypatch):
    """PCN, LCN, CAPQL, NL-MOPPO, IPRO and IPRO-2D ask for CUDA unless told
    otherwise, and raise without it; on the CPU, when asked, their states
    live there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dst, fruit, car = make("deep-sea-treasure-v0"), make("fruit-tree-v0"), make("mo-mountaincarcontinuous-v0")
    ppo = NLMOPPOConfig(num_envs=4, num_steps=8, hidden=(8,))
    makers = {
        PCN: lambda **kw: PCN(dst, PCNConfig(num_envs=4, max_episode_len=8, hidden_dim=8), **kw),
        LCN: lambda **kw: LCN(fruit, LCNConfig(num_envs=4, max_episode_len=8, hidden_dim=8, scaling_factor=(0.1,) * 7), **kw),
        CAPQL: lambda **kw: CAPQL(car, CAPQLConfig(num_envs=4, buffer_size=64, batch_size=8, hidden=(8,)), **kw),
        NLMOPPO: lambda **kw: NLMOPPO(dst, ppo, **kw),
        IPRO: lambda **kw: IPRO(dst, IPROConfig(ppo=ppo), **kw),
        IPRO2D: lambda **kw: IPRO2D(dst, IPROConfig(ppo=ppo), **kw),
    }
    for cls, make_agent in makers.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_agent()
        agent = make_agent(device="cpu")
        assert agent.device.type == "cpu"
        if cls in (IPRO, IPRO2D):
            assert agent.agent.device.type == "cpu" and agent.agent.init_state().obs.device.type == "cpu"
            continue
        state = agent.init_state()
        where = state.buffer.data.obs if cls in (PCN, LCN) else state.obs
        assert where.device.type == "cpu"


def test_discrete_and_pixel_entry_points_need_cuda_by_default(monkeypatch):
    """MOSACDiscrete, MORL/D on a discrete action space and Envelope with the
    NatureCNN trunk ask for CUDA unless told otherwise, and raise without it;
    on the CPU, when asked, their states live there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lander, pixels = make("mo-lunar-lander-v3"), make("deep-sea-treasure-pixel-stack-v0")
    sac = MOSACConfig(num_envs=4, buffer_size=64, batch_size=8, hidden=(8,))
    makers = {
        MOSACDiscrete: lambda **kw: MOSACDiscrete(lander, [0.25] * 4, sac, **kw),
        MORLD: lambda **kw: MORLD(lander, MORLDConfig(pop_size=2, sac=sac), **kw),
        Envelope: lambda **kw: Envelope(
            pixels, EnvelopeConfig(num_envs=2, buffer_size=8, batch_size=4, hidden=(8,), image_shape=(4, 84, 84)), **kw
        ),
    }
    for cls, make_agent in makers.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_agent()
        agent = make_agent(device="cpu")
        single = agent.population[0] if cls is MORLD else agent
        state = single.init_state()
        assert agent.device.type == "cpu" and state.obs.device.type == "cpu"
        assert state.obs.shape[-1] == (4 * 84 * 84 if cls is Envelope else 8)


def test_cli_entry_points_need_cuda_by_default(monkeypatch, tmp_path):
    """``launch.main`` and ``sweep.main`` without ``--device`` ask for CUDA and,
    without it, raise before building anything; ``--device cpu`` runs there.
    ``seed_everything`` asks for CUDA the same way."""
    from morl_baselines_torch.cli import launch, sweep
    from morl_baselines_torch.evaluation import seed_everything

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = ["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", "0", "-50"]
    space = '{"learning_rate": {"values": [0.001]}}'
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(common)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main([*common, "--space", space, "--out", str(tmp_path / "s.jsonl")])
    assert not (tmp_path / "s.jsonl").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seed_everything(0)
    tiny = ["num_envs:2", "buffer_size:32", "batch_size:4", "hidden:(8,)", "learning_starts:8"]
    agent = launch.main([*common, "--num-timesteps", "32", "--device", "cpu", "--init-hyperparams", *tiny])
    assert agent.device.type == "cpu" and agent.cfg.num_envs == 2
