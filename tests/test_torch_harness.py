"""The harness helpers of the port against the JAX package's.

``seed_everything`` / ``log_episode_info`` (evaluation), ``reset_wandb_env``
(logging), ``PhaseTimer`` / ``trace`` (profiling), ``non_dominated_count`` and
``filter_convex_dominated`` (core), ``ReplayBuffer.add`` / ``get_all_data``;
``MetricLogger``'s wandb sink (a stub ``wandb`` module records its calls) and
the positional order of ``MetricLogger`` and ``MORLD.train``.
Inputs are made with numpy from a seed and handed to both packages.  The
episode metrics are means in numpy in both packages and equal exactly; the
scalarized ones are float32 sums, held at rtol 1e-6.  Fronts and buffer rows
are compared exactly.
"""

import inspect
import json
import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_tpu.core.pareto import filter_convex_dominated as j_filter_convex
from morl_baselines_tpu.core.pareto import non_dominated_count as j_nd_count
from morl_baselines_tpu.core.scalarization import weighted_sum as j_weighted_sum
from morl_baselines_tpu.envs.vector import EpisodeStats as JEpisodeStats
from morl_baselines_tpu.evaluation import log_episode_info as j_log_episode_info
from morl_baselines_tpu.replay import ReplayBuffer as JReplayBuffer
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_tpu.agents.morld import MORLD as JMORLD
from morl_baselines_tpu.utils.logging import MetricLogger as JMetricLogger
from morl_baselines_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from morl_baselines_torch.agents.morld import MORLD
from morl_baselines_torch.core import filter_convex_dominated, non_dominated_count
from morl_baselines_torch.core.scalarization import weighted_sum
from morl_baselines_torch.envs.vector import EpisodeStats
from morl_baselines_torch.evaluation import log_episode_info, seed_everything
from morl_baselines_torch.replay import ReplayBuffer, Transition
from morl_baselines_torch.utils import MetricLogger, PhaseTimer, reset_wandb_env, trace

torch.set_num_threads(1)


def test_seed_everything():
    """Mirror of tests/test_extras.py::test_seed_everything_and_log_episode_info
    (first half): the global states repeat and the generator is seeded."""
    gen = seed_everything(7, device="cpu")
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu" and gen.initial_seed() == 7
    x1, t1 = np.random.rand(), torch.rand(2)
    g1 = torch.rand(2, generator=gen)
    gen = seed_everything(7, device="cpu")
    assert np.random.rand() == x1 and torch.equal(torch.rand(2), t1) and torch.equal(torch.rand(2, generator=gen), g1)
    assert os.environ["PYTHONHASHSEED"] == "7"


def _episode_rows(seed):
    rng = np.random.default_rng(seed)
    rewards = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(4)]
    dones = [rng.uniform(size=6) < 0.4 for _ in range(4)]
    dones[-1][:2] = True
    return rewards, dones


@pytest.mark.parametrize("weights,ident", [(np.array([0.2, 0.3, 0.5]), None), (None, 3)])
def test_log_episode_info_matches_jax(weights, ident):
    """The same finished rows give the same metric keys and values; with no
    weights the scalarization takes the return alone."""
    rewards, dones = _episode_rows(1)
    jstats, tstats = JEpisodeStats.create(num_envs=6, reward_dim=3), EpisodeStats.create(6, 3, "cpu")
    if weights is None:
        jscal, tscal = (lambda r: jnp.sum(r)), (lambda r: torch.sum(r))
    else:
        jscal, tscal = j_weighted_sum, weighted_sum
    for r, d in zip(rewards, dones):
        jstats, jfin = jstats.update(jnp.asarray(r), jnp.asarray(d), 0.9)
        tstats, tfin = tstats.update(torch.as_tensor(r), torch.as_tensor(d), 0.9)
        want = j_log_episode_info(jfin, jscal, weights, global_step=10, id=ident)
        got = log_episode_info(tfin, tscal, weights, global_step=10, id=ident)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert got  # the last step finished episodes


def test_log_episode_info_mirror(tmp_path):
    """Mirror of tests/test_extras.py::test_seed_everything_and_log_episode_info
    (second half), logging through a MetricLogger."""
    stats = EpisodeStats.create(3, 2, "cpu")
    r = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    _, finished = stats.update(r, torch.tensor([True, False, True]), gamma=0.5)
    logger = MetricLogger(jsonl_path=tmp_path / "log.jsonl", stdout_every=100)
    metrics = log_episode_info(finished, weighted_sum, np.array([0.5, 0.5]), global_step=10, logger=logger)
    logger.close()
    assert metrics["metrics/scalarized_episode_return"] == pytest.approx(3.5)
    assert metrics["charts/timesteps_per_episode"] == pytest.approx(1.0)
    assert metrics["metrics/episode_return_obj_1"] == pytest.approx(4.0)
    assert (tmp_path / "log.jsonl").read_text().count("global_step") == 1
    assert log_episode_info(stats.update(r, torch.zeros(3, dtype=torch.bool), 0.5)[1], weighted_sum, None, 0) == {}


def test_wandb_sink_makes_the_four_calls(monkeypatch, tmp_path):
    """``use_wandb`` calls ``wandb.init(project=, name=experiment, config=)``,
    ``define_metric("*", step_metric="global_step")``, ``log(payload,
    step=global_step)`` and ``finish()`` in ``close``, beside the JSONL sink."""
    calls = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(("init", kw))
    stub.define_metric = lambda *a, **kw: calls.append(("define_metric", a, kw))
    stub.log = lambda payload, step: calls.append(("log", dict(payload), step))
    stub.finish = lambda: calls.append(("finish",))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    logger = MetricLogger("proj", "exp", tmp_path / "log.jsonl", True, {"lr": 0.1}, stdout_every=100)
    logger.log({"eval/hypervolume": torch.tensor(2.5)}, 64)
    logger.close()
    assert calls == [
        ("init", {"project": "proj", "name": "exp", "config": {"lr": 0.1}}),
        ("define_metric", ("*",), {"step_metric": "global_step"}),
        ("log", {"eval/hypervolume": 2.5, "global_step": 64}, 64),
        ("finish",),
    ]
    assert json.loads((tmp_path / "log.jsonl").read_text()) == {"eval/hypervolume": 2.5, "global_step": 64}


def test_wandb_missing_falls_back(monkeypatch, tmp_path, capsys):
    """Without wandb (``import wandb`` raises ``ImportError``) the logger says
    so on stderr, as the JAX package's does, and its JSONL sink still works."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    logger = MetricLogger(jsonl_path=tmp_path / "log.jsonl", use_wandb=True, stdout_every=100)
    logger.log({"x": 1.0}, 3)
    logger.close()
    assert "[logger] wandb not available; falling back to stdout/jsonl" in capsys.readouterr().err
    assert json.loads((tmp_path / "log.jsonl").read_text()) == {"x": 1.0, "global_step": 3}


def test_positional_order_matches_jax():
    """``MetricLogger`` and ``MORLD.train`` take the JAX package's parameter
    names in the JAX order, so a positional call means the same in both."""
    for port, jax_fn in ((MetricLogger.__init__, JMetricLogger.__init__), (MORLD.train, JMORLD.train)):
        assert list(inspect.signature(port).parameters) == list(inspect.signature(jax_fn).parameters)
    assert MetricLogger("p").project == "p" and MetricLogger("p").experiment == "run"


def test_reset_wandb_env(monkeypatch):
    monkeypatch.setenv("WANDB_RUN_ID", "x")
    monkeypatch.setenv("WANDB_SWEEP_ID", "y")
    monkeypatch.setenv("WANDB_PROJECT", "keepme")
    monkeypatch.setenv("WANDB_API_KEY", "k")
    reset_wandb_env()
    assert "WANDB_RUN_ID" not in os.environ and "WANDB_SWEEP_ID" not in os.environ
    assert os.environ["WANDB_PROJECT"] == "keepme" and os.environ["WANDB_API_KEY"] == "k"


def test_phase_timer_and_trace(tmp_path):
    """The same metric keys as the JAX PhaseTimer; totals cover the phase; the
    timer resets on read; ``trace`` writes a Chrome trace."""
    timers = (PhaseTimer(), JPhaseTimer())
    for timer in timers:
        for _ in range(2):
            with timer.phase("collect"):
                time.sleep(0.01)
        with timer.phase("update"):
            pass
    got, want = (t.metrics() for t in timers)
    assert sorted(got) == sorted(want) == ["profile/collect_calls", "profile/collect_s", "profile/update_calls", "profile/update_s"]
    assert got["profile/collect_calls"] == 2 and got["profile/collect_s"] >= 0.02
    assert timers[0].metrics(prefix="x/") == {}
    with trace(tmp_path / "t") as prof:
        torch.ones(8).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0 and prof is not None


def test_non_dominated_count():
    rng = np.random.default_rng(2)
    for n, d in ((40, 2), (64, 3)):
        pts = rng.normal(size=(n, d)).astype(np.float32)
        pts[5] = pts[3]
        valid = rng.uniform(size=n) > 0.3
        got = non_dominated_count(torch.as_tensor(pts), torch.as_tensor(valid))
        assert got.dim() == 0 and int(got) == int(j_nd_count(jnp.asarray(pts), jnp.asarray(valid)))
        assert int(non_dominated_count(torch.as_tensor(pts))) == int(j_nd_count(jnp.asarray(pts)))


def _rows(a):
    return sorted(map(tuple, np.asarray(a).tolist()))


@pytest.mark.parametrize("d,seed", [(2, 0), (2, 1), (3, 2), (3, 3)])
def test_filter_convex_dominated_matches_jax(d, seed):
    """The CCS of a front with concave pockets, dominated points and copies:
    the same set as the JAX package's."""
    rng = np.random.default_rng(seed)
    pts = np.abs(rng.normal(size=(18, d)))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True) ** rng.uniform(0.5, 2.0, size=(18, 1))
    pts = np.vstack([pts, pts[:4] * 0.5, pts[:2]])
    got, want = filter_convex_dominated(pts), j_filter_convex(pts)
    assert _rows(got) == _rows(want)
    assert 2 <= len(got) < len(pts)
    assert _rows(filter_convex_dominated(pts[:2])) == _rows(j_filter_convex(pts[:2]))


def test_replay_add_and_get_all_data_match_jax():
    """``add`` of single transitions and ``get_all_data`` (its subsample drawn
    by ``np.random.default_rng(0)`` in both packages) give the same rows."""
    rng = np.random.default_rng(4)
    jbuf = JReplayBuffer.create(16, obs_dim=3, reward_dim=2)
    tbuf = ReplayBuffer.create(16, obs_dim=3, reward_dim=2, device="cpu")
    for _ in range(21):  # wraps the ring
        tr = dict(obs=rng.normal(size=3).astype(np.float32), action=np.int32(rng.integers(0, 4)),
                  reward=rng.normal(size=2).astype(np.float32), next_obs=rng.normal(size=3).astype(np.float32),
                  terminated=np.float32(rng.uniform() < 0.2))
        jbuf = jbuf.add(JTransition(**tr))
        tbuf.add(Transition(**{k: torch.as_tensor(v) for k, v in tr.items()}))
    assert tbuf.ptr == int(jbuf.ptr) == 5 and tbuf.size == int(jbuf.size) == 16
    for max_samples in (None, 6):
        got, want = tbuf.get_all_data(max_samples), jbuf.get_all_data(max_samples)
        assert isinstance(got.obs, np.ndarray)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
