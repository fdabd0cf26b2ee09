"""The port's launch and sweep CLIs against the JAX package's.

The pure-numpy parts (``StoreDict``, ``sample_config``, ``tpe_suggest``) and
the successive-halving schedule must equal the JAX package's exactly for the
same seed; the launcher and a sweep then run at tiny widths on the CPU
(``--device cpu``).
"""

import argparse
import json

import numpy as np
import pytest
import torch

from morl_baselines_tpu.cli import StoreDict as JStoreDict
from morl_baselines_tpu.cli import sweep as jsweep
from morl_baselines_torch.agents import Envelope, MOPPOConfig, PGMORLConfig
from morl_baselines_torch.cli import ALGOS, StoreDict, launch, sweep

torch.set_num_threads(1)

SPACE = {
    "learning_rate": {"min": 1e-4, "max": 1e-2, "log": True},
    "tau": {"min": 0.0, "max": 1.0},
    "gradient_updates": {"min": 1, "max": 10, "int": True},
    "buffer_size": {"min": 1000, "max": 2_000_000, "int": True, "log": True},
    "batch_size": {"values": [32, 64, 128]},
    "per": {"values": [True, False]},
}
TINY = ["num_envs:4", "buffer_size:256", "batch_size:8", "hidden:(16,16)", "learning_starts:16", "num_sample_w:2"]


def test_algos_and_store_dict():
    assert sorted(ALGOS) == sorted(jsweep.ALGOS)
    assert {k: v.__name__ for k, v in ALGOS.items()} == {k: v.__name__ for k, v in jsweep.ALGOS.items()}
    args = ["num_envs:128", "hidden:(64, 64)", "lr:1e-3", "name:'a:b'", "per:True"]
    got, want = (argparse.ArgumentParser(), argparse.ArgumentParser())
    got.add_argument("--h", nargs="+", action=StoreDict, default={})
    want.add_argument("--h", nargs="+", action=JStoreDict, default={})
    assert got.parse_args(["--h", *args]).h == want.parse_args(["--h", *args]).h == {
        "num_envs": 128, "hidden": (64, 64), "lr": 1e-3, "name": "a:b", "per": True}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_config_and_tpe_suggest_equal_jax(seed):
    """Same generator state in, same suggestions out: random samples, the cold
    start and TPE over a history, with the generators in step throughout."""
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    history = []
    for i in range(10):
        got, want = sweep.sample_config(SPACE, rng), jsweep.sample_config(SPACE, jrng)
        assert got == want and all(type(got[k]) is type(want[k]) for k in got)
        history.append((got, float(np.sin(i + seed))))
        got, want = sweep.tpe_suggest(SPACE, history, rng), jsweep.tpe_suggest(SPACE, history, jrng)
        assert got == want
    assert rng.bit_generator.state == jrng.bit_generator.state
    for k, spec in SPACE.items():
        v = history[0][0][k]
        assert sweep._from_unit(sweep._to_unit(v, spec), spec) == pytest.approx(v)


def test_tpe_suggest_concentrates_on_good_region():
    """Mirror of tests/test_extras.py::test_tpe_suggest_concentrates_on_good_region."""
    rng = np.random.default_rng(0)
    lr_space = {"learning_rate": {"min": 1e-4, "max": 1e-1, "log": True}}
    lr_hist = []
    for _ in range(30):
        lr = float(np.exp(rng.uniform(np.log(1e-4), np.log(1e-1))))
        lr_hist.append(({"learning_rate": lr}, 1.0 if lr > 1e-2 else 0.0))
    lrs = np.array([sweep.tpe_suggest(lr_space, lr_hist, rng)["learning_rate"] for _ in range(20)])
    assert (lrs > 1e-2).mean() >= 0.7, lrs
    bs_space = {"batch_size": {"values": [32, 64, 128]}}
    bs_hist = []
    for _ in range(30):
        bs = [32, 64, 128][rng.integers(0, 3)]
        bs_hist.append(({"batch_size": bs}, 0.5 if bs == 128 else 0.0))
    bss = np.array([sweep.tpe_suggest(bs_space, bs_hist, rng)["batch_size"] for _ in range(20)])
    assert (bss == 128).mean() >= 0.7, bss
    cold = sweep.tpe_suggest(lr_space | bs_space, [], rng)
    assert 1e-4 <= cold["learning_rate"] <= 1e-1 and cold["batch_size"] in (32, 64, 128)


def test_apply_overrides_dotted_keys():
    cfg = sweep._apply_overrides(PGMORLConfig(), {"pop_size": 4, "ppo.learning_rate": 1e-3, "ppo.num_envs": 2})
    assert cfg.pop_size == 4 and cfg.ppo == MOPPOConfig(learning_rate=1e-3, num_envs=2)


def _fake_trial(algo, env_id, ref_point, overrides, num_seeds, num_timesteps, **kwargs):
    """A deterministic score from the overrides and the budget."""
    scores = [overrides["learning_rate"] * 1e3 + overrides["gradient_updates"] + num_timesteps * 1e-4 + s for s in range(num_seeds)]
    return float(np.mean(scores)), scores


@pytest.mark.parametrize("mode", [["--halving", "--rungs", "3", "--eta", "2"], ["--tpe"], []])
def test_schedule_equal_jax(mode, tmp_path, monkeypatch):
    """``run_trial`` patched in both packages to one deterministic score: the
    trial ids, overrides, budgets, promotions and the best equal the JAX
    ``main``'s."""
    monkeypatch.setattr(sweep, "run_trial", _fake_trial)
    monkeypatch.setattr(jsweep, "run_trial", _fake_trial)
    common = ["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", "0", "-50", "--space",
              json.dumps(SPACE), "--num-trials", "6", "--num-seeds", "2", "--num-timesteps", "8000", "--sweep-seed", "3", *mode]
    got_best = sweep.main([*common, "--out", str(tmp_path / "t.jsonl"), "--device", "cpu"])
    want_best = jsweep.main([*common, "--out", str(tmp_path / "j.jsonl")])
    assert got_best == want_best
    drop = lambda r: {k: v for k, v in r.items() if k != "wall_s"}  # noqa: E731
    got = [drop(json.loads(x)) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    want = [drop(json.loads(x)) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert got == want and len(got) == (6 + 3 + 1 if mode and mode[0] == "--halving" else 6)


def test_launch_envelope_on_cpu():
    """``launch.main`` with Envelope at tiny widths (bf16 Q-net) on
    deep-sea-treasure, whose known front gives ``eval/igd`` and ``eval/mul``."""
    agent = launch.main(["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", "0", "-50",
                         "--num-timesteps", "800", "--device", "cpu", "--init-hyperparams", *TINY, "bf16:True",
                         "--train-hyperparams", "eval_freq:400", "num_eval_weights_for_front:4", "eval_max_steps:40"])
    assert isinstance(agent, Envelope) and agent.device.type == "cpu" and agent.cfg.bf16 and agent.cfg.hidden == (16, 16)
    m = agent._last_metrics
    assert {"eval/hypervolume", "eval/eum", "eval/igd", "eval/mul"} <= set(m) and np.isfinite(list(m.values())).all()
    assert agent._last_front.shape == (4, 2)


def test_sweep_on_cpu(tmp_path):
    """``sweep.main`` with successive halving at tiny widths: one JSONL line per
    (trial, rung), each mean the mean of its seeds' hypervolumes."""
    space = {"learning_rate": {"min": 1e-4, "max": 1e-2, "log": True}, "num_envs": {"values": [4]},
             "buffer_size": {"values": [256]}, "batch_size": {"values": [8]}, "hidden": {"values": [[16, 16]]},
             "learning_starts": {"min": 8, "max": 64, "int": True}}
    out = tmp_path / "sweep.jsonl"
    best = sweep.main(["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", "0", "-50",
                       "--space", json.dumps(space), "--num-trials", "2", "--num-seeds", "2", "--num-timesteps", "320",
                       "--halving", "--rungs", "2", "--out", str(out), "--device", "cpu"])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["trial"] for r in recs][:2] == ["t0-r0", "t1-r0"] and len(recs) == 3
    assert [r["num_timesteps"] for r in recs] == [160, 160, 320]
    for r in recs:
        assert len(r["seed_hypervolumes"]) == 2 and r["avg_hypervolume"] == float(np.mean(r["seed_hypervolumes"]))
    assert best[0] == max(r["avg_hypervolume"] for r in recs)


def test_sweep_vmapped_seeds():
    """Mirror of tests/test_extras.py::test_sweep_vmapped_seeds: the stacked
    trial trains 3 seeds as one state and scores each seed's front."""
    score, scores = sweep.run_trial_vmapped(
        "envelope", "deep-sea-treasure-v0", ref_point=[0.0, -50.0],
        overrides={"num_envs": 4, "buffer_size": 512, "batch_size": 16, "hidden": (32, 32), "learning_starts": 64},
        num_seeds=3, num_timesteps=1000, device="cpu",
    )
    assert len(scores) == 3
    assert all(s >= 0.0 for s in scores)
    assert score == sum(scores) / 3


def _recording(monkeypatch, calls):
    """Record which trial path each trial takes, returning a fixed score."""
    def stacked(algo, env_id, ref_point, overrides, num_seeds, num_timesteps, device="cuda"):
        calls.append(("stacked", algo))
        return 1.0, [1.0] * num_seeds

    def build(algo, env_id, ref_point, overrides, seed, device="cuda"):
        calls.append(("sequential", algo))
        raise StopIteration  # the sequential path was taken; nothing to train

    monkeypatch.setattr(sweep, "run_trial_vmapped", stacked)
    monkeypatch.setattr(sweep, "_build_agent", build)


def test_trial_dispatch(monkeypatch, tmp_path):
    """Envelope goes stacked by default, with flat obs and with an image
    trunk (the stacked NatureCNN); ``--no-vmap-seeds`` and CAPQL (which also
    has ``train_segment`` and ``_eval_front``) go sequential by rule."""
    calls = []
    _recording(monkeypatch, calls)
    assert sweep.run_trial("envelope", "deep-sea-treasure-v0", [0.0, -50.0], {}, 2, 100, device="cpu") == (1.0, [1.0, 1.0])
    assert calls == [("stacked", "envelope")]
    calls.clear()
    pixel = {"image_shape": (4, 84, 84)}
    assert sweep.run_trial("envelope", "deep-sea-treasure-pixel-stack-v0", [0.0, -50.0], pixel, 2, 100,
                           device="cpu") == (1.0, [1.0, 1.0])
    assert calls == [("stacked", "envelope")] and sweep.stacks_seeds("envelope")
    for algo, overrides, vmap in (("envelope", {}, False), ("capql", {}, True)):
        calls.clear()
        with pytest.raises(StopIteration):
            sweep.run_trial(algo, "deep-sea-treasure-v0", [0.0, -50.0], overrides, 2, 100, device="cpu", vmap_seeds=vmap)
        assert calls == [("sequential", algo)]
    assert sweep.stacks_seeds("envelope") and not sweep.stacks_seeds("capql")
    calls.clear()
    args = ["--algo", "envelope", "--env-id", "deep-sea-treasure-v0", "--ref-point", "0", "-50", "--space",
            json.dumps({"learning_rate": {"values": [1e-3]}}), "--num-trials", "1", "--num-seeds", "2",
            "--num-timesteps", "100", "--out", str(tmp_path / "s.jsonl"), "--device", "cpu"]
    sweep.main(args)
    with pytest.raises(StopIteration):
        sweep.main([*args, "--no-vmap-seeds"])
    assert calls == [("stacked", "envelope"), ("sequential", "envelope")]


def test_stacked_seeds_start_where_sequential_seeds_start():
    """Below ``learning_starts`` no seed learns, so each seed's front is its
    initial greedy policy's: the stacked trial's per-seed hypervolumes equal
    the sequential trial's (deterministic deep-sea-treasure, same 32 weights
    and 500-step episodes)."""
    overrides = {"num_envs": 4, "buffer_size": 256, "batch_size": 8, "hidden": (16, 16), "learning_starts": 1000}
    args = ("envelope", "deep-sea-treasure-v0", [0.0, -50.0], overrides, 4, 64)
    stacked = sweep.run_trial(*args, device="cpu")
    sequential = sweep.run_trial(*args, device="cpu", vmap_seeds=False)
    np.testing.assert_allclose(stacked[1], sequential[1], rtol=1e-6)
    assert len(set(stacked[1])) > 1, "the seeds' initial policies must differ"
