"""Parity of the port's Pareto Q-learning, MPMOQL and small-set hypervolumes with the JAX package.

The same inputs, made from a numpy seed, go through both packages on the CPU:
the inclusion-exclusion and Monte-Carlo hypervolumes, the batched 2-D / 3-D
sweeps, PQL's set algebra on identical tables (sets compared without their
slot order: ``torch.topk`` and ``lax.top_k`` may order ties otherwise), a
whole PQL ``train_segment`` and a whole MPMOQL OLS run with the JAX key
chains' draws handed over.  Then the learning mirrors of
tests/test_agents_multi.py::test_pql_dst and test_pql_3obj_hypervolume_scoring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import PQL, MOQLearning, MOQLearningConfig, MPMOQLConfig, MPMOQLearning, PQLConfig
from morl_baselines_torch.core import indicators as tind
from morl_baselines_torch.envs import make
from morl_baselines_tpu.agents import PQL as JPQL
from morl_baselines_tpu.agents import MOQLearningConfig as JMOQLearningConfig
from morl_baselines_tpu.agents import MPMOQLConfig as JMPMOQLConfig
from morl_baselines_tpu.agents import MPMOQLearning as JMPMOQLearning
from morl_baselines_tpu.agents import PQLConfig as JPQLConfig
from morl_baselines_tpu.core import indicators as jind
from morl_baselines_tpu.envs import make as jmake

torch.set_num_threads(1)
REF2 = np.array([0.0, -50.0])


def _t(x):
    return torch.as_tensor(np.array(x))


def _as_set(vals, valid) -> np.ndarray:
    """The valid rows of one fixed-capacity set, sorted: the set without its slot order."""
    rows = np.asarray(vals)[np.asarray(valid)]
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows.reshape(0, np.asarray(vals).shape[-1])


def test_hypervolume_small_exact_parity():
    """Inclusion-exclusion HV against the JAX package (rel 1e-5) and the host
    WFG at d = 2..5, with valid masks; a batch of sets equals each set alone."""
    rng = np.random.default_rng(11)
    for d in (2, 3, 4, 5):
        fronts = rng.uniform(0.1, 1.0, size=(3, 10, d)).astype(np.float32)
        valid = rng.uniform(size=(3, 10)) < 0.7
        ref = np.zeros(d, dtype=np.float32)
        batched = tind.hypervolume_small_exact(_t(fronts), _t(ref), _t(valid)).numpy()
        for f, v, got in zip(fronts, valid, batched):
            want = float(jind.hypervolume_small_exact(jnp.asarray(f), jnp.asarray(ref), jnp.asarray(v)))
            assert float(tind.hypervolume_small_exact(_t(f), _t(ref), _t(v))) == pytest.approx(want, rel=1e-5)
            assert got == pytest.approx(want, rel=1e-5), d
            assert got == pytest.approx(tind.hypervolume(f[v].astype(np.float64), ref), rel=1e-5)
    with pytest.raises(ValueError, match="small"):
        tind.hypervolume_small_exact(torch.zeros(21, 2), torch.zeros(2))


def test_hypervolume_mc_against_host():
    """tests/test_core.py::test_hypervolume_3d_exact_vs_mc: 200k samples within 5% of WFG."""
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(size=(20, 3))) + 1e-3
    front = x / np.linalg.norm(x, axis=-1, keepdims=True)
    exact = tind.hypervolume(front, np.zeros(3))
    mc = float(tind.hypervolume_mc(_t(front), torch.zeros(3), torch.Generator().manual_seed(0), n_samples=200_000))
    assert exact > 0 and mc == pytest.approx(exact, rel=0.05)
    # a masked batch: each set against its own host HV
    valid = rng.uniform(size=(2, 20)) < 0.6
    got = tind.hypervolume_mc(_t(front), torch.zeros(3), torch.Generator().manual_seed(1), _t(valid), n_samples=200_000)
    for v, g in zip(valid, got.numpy()):
        assert g == pytest.approx(tind.hypervolume(front[v], np.zeros(3)), rel=0.05)


@pytest.mark.parametrize("d", [2, 3])
def test_batched_sweeps_equal_each_set(d):
    """The 2-D / 3-D sweeps over a (4, 16, d) batch of masked sets equal the
    JAX package's sweep of each set alone (rel 1e-6)."""
    rng = np.random.default_rng(d)
    fronts = np.round(rng.uniform(-1.0, 3.0, size=(4, 16, d)), 1).astype(np.float32)  # ties and dominated points
    valid = rng.uniform(size=(4, 16)) < 0.75
    ref = np.zeros(d, dtype=np.float32)
    fn_t, fn_j = (tind.hypervolume_2d, jind.hypervolume_2d) if d == 2 else (tind.hypervolume_3d, jind.hypervolume_3d)
    got = fn_t(_t(fronts), _t(ref), _t(valid)).numpy()
    want = [float(fn_j(jnp.asarray(f), jnp.asarray(ref), jnp.asarray(v))) for f, v in zip(fronts, valid)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _pql_pair(**cfg):
    agent = PQL(make("deep-sea-treasure-v0"), REF2, PQLConfig(**cfg), device="cpu")
    jagent = JPQL(jmake("deep-sea-treasure-v0"), REF2, JPQLConfig(**cfg))
    return agent, jagent


def _random_tables(rng, S=110, A=4, K=16, d=2):
    """Q-sets with planted exact duplicates, visited and terminal flags, successors."""
    q_sets = np.round(rng.uniform(-5.0, 5.0, size=(S, A, K, d)), 1).astype(np.float32)
    q_sets[:, :, 1] = q_sets[:, :, 0]  # a duplicate in every set
    q_sets[:, 1, 2] = q_sets[:, 0, 3]  # and across actions
    return dict(
        avg_reward=rng.normal(size=(S, A, d)).astype(np.float32),
        counts=rng.integers(0, 3, size=(S, A)).astype(np.float32),
        next_state=rng.integers(0, S, size=(S, A)).astype(np.int32),
        terminal=(rng.uniform(size=(S, A)) < 0.2).astype(np.float32),
        q_sets=q_sets,
        q_valid=rng.uniform(size=(S, A, K)) < 0.6,
    )


def test_pql_set_algebra_parity():
    """``_nd_of_state``, ``_q_set_of`` and ``_score_actions`` on identical
    tables, both action evaluations: sets order-free atol 1e-6, scores rel 1e-6."""
    rng = np.random.default_rng(4)
    tables = _random_tables(rng)
    for action_eval in ("hypervolume", "pareto_cardinality"):
        agent, jagent = _pql_pair(action_eval=action_eval)
        st, js = agent.init_state(), jagent.init_state(jax.random.key(0))
        js = js._replace(**{k: jnp.asarray(v) for k, v in tables.items()})
        for k, v in tables.items():
            setattr(st, k, _t(v).long() if k == "next_state" else _t(v))
        states = np.array([0, 3, 17, 42, 109])
        nd_vals, nd_valid = agent._nd_of_state(st.q_sets, st.q_valid, _t(states))
        for i, s in enumerate(states):
            jv, jm = jagent._nd_of_state(js.q_sets, js.q_valid, jnp.int32(s))
            assert 0 < int(np.asarray(jm).sum()) < 16
            np.testing.assert_allclose(_as_set(nd_vals[i], nd_valid[i]), _as_set(jv, jm), atol=1e-6)
            vals, valid = agent._q_set_of(st, _t(s).expand(4), torch.arange(4))
            for a in range(4):
                jv, jm = jagent._q_set_of(js, jnp.int32(s), jnp.int32(a))
                np.testing.assert_allclose(_as_set(vals[a], valid[a]), _as_set(jv, jm), atol=1e-6, err_msg=f"s={s} a={a}")
            got = agent._score_actions(st, _t(s))
            want = np.asarray(jagent._score_actions(js, jnp.int32(s)))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_pql_train_segment_parity():
    """200 steps on DST from the same start, the JAX key chain's explore draws
    handed over (epsilon 1 -> 0.1 over 150 steps, so the late steps are
    mostly greedy): statistics equal, every Q-set equal as a set (atol 1e-5)."""
    steps = 200
    agent, jagent = _pql_pair(epsilon_decay_steps=150)
    js = jagent.init_state(jax.random.key(3))
    key, draws = js.key, []
    for _ in range(steps):
        key, k_eps, k_act, _k_step, _k_reset, _k_hv = jax.random.split(key, 6)
        draws.append((_t(jax.random.uniform(k_eps)), _t(jax.random.randint(k_act, (), 0, 4))))
    js2 = jagent.train_segment(js, steps)
    st = agent.init_state()
    agent._explore = lambda state: draws.pop(0)
    agent.train_segment(st, steps)
    assert st.global_step == int(js2.global_step) == steps
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(js2.counts))
    np.testing.assert_array_equal(st.next_state.numpy(), np.asarray(js2.next_state))
    np.testing.assert_array_equal(st.terminal.numpy(), np.asarray(js2.terminal))
    np.testing.assert_allclose(st.avg_reward.numpy(), np.asarray(js2.avg_reward), atol=1e-5)
    jq, jm = np.asarray(js2.q_sets), np.asarray(js2.q_valid)
    for s, a in zip(*np.nonzero(np.asarray(js2.counts))):
        np.testing.assert_allclose(_as_set(st.q_sets[s, a], st.q_valid[s, a]), _as_set(jq[s, a], jm[s, a]), atol=1e-5)
    assert int(st.q_valid.sum()) == int(jm.sum()) and float(np.asarray(js2.counts).max()) > 1
    for got, want in zip(st.env_state, js2.env_state):
        np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(want).reshape(-1))


def test_mpmoql_ols_ccs_parity(monkeypatch):
    """Three OLS iterations of MPMOQL on DST (transfer on), each inner MOQL
    segment given its JAX key chain's explore draws: the CCS equals the JAX
    package's at atol 1e-4, and so do the weights it chose."""
    n, per_iter = 8, 800
    moql = dict(num_envs=n, gamma=0.9, initial_epsilon=0.9, final_epsilon=0.1, epsilon_decay_steps=60)
    cfg = dict(num_timesteps_per_iteration=per_iter, weight_selection_algo="ols", transfer_q_table=True)
    agent = MPMOQLearning(make("deep-sea-treasure-v0"), MPMOQLConfig(**cfg, moql=MOQLearningConfig(**moql)), device="cpu")
    jagent = JMPMOQLearning(jmake("deep-sea-treasure-v0"), JMPMOQLConfig(**cfg, moql=JMOQLearningConfig(**moql)))
    jagent.train(3 * per_iter, ref_point=REF2)

    draws = {}
    init_state = MOQLearning.init_state

    def init_with_jax_draws(self, seed=None):
        st = init_state(self, seed)
        key = jax.random.split(jax.random.key(seed))[1]  # the JAX init_state's key after the env reset's split
        draws[id(st)] = []
        for _ in range(per_iter // n):
            key, k_eps, k_act, _k_step, _k_dyna = jax.random.split(key, 5)
            draws[id(st)].append((_t(jax.random.uniform(k_eps, (n,))), _t(jax.random.randint(k_act, (n,), 0, 4)), None))
        return st

    monkeypatch.setattr(MOQLearning, "init_state", init_with_jax_draws)
    monkeypatch.setattr(MOQLearning, "_draws", lambda self, state: draws[id(state)].pop(0))
    agent.train(3 * per_iter, ref_point=REF2)
    assert len(agent.ccs) == len(jagent.ccs) >= 2
    np.testing.assert_allclose(np.stack(agent.ccs), np.stack(jagent.ccs), atol=1e-4)
    np.testing.assert_allclose(np.stack(agent.policy_weights), np.stack(jagent.policy_weights), atol=1e-6)
    for k, v in jagent._last_metrics.items():
        assert agent._last_metrics[k] == pytest.approx(v, rel=1e-4, abs=1e-4), k


def test_mpmoql_gpi_action_batched():
    """The GPI action over P tables for a batch of (obs, w) rows equals the JAX
    package's one-row ``gpi_action`` on each row."""
    rng = np.random.default_rng(6)
    q_tables = rng.normal(size=(3, 110, 4, 2)).astype(np.float32)
    obs = np.stack([rng.integers(0, 11, 16), rng.integers(0, 10, 16)], -1).astype(np.float32)
    w = rng.dirichlet(np.ones(2), size=16).astype(np.float32)
    agent = MPMOQLearning(make("deep-sea-treasure-v0"), device="cpu")
    jagent = JMPMOQLearning(jmake("deep-sea-treasure-v0"))
    got = agent.gpi_action(_t(q_tables), _t(obs), _t(w)).numpy()
    want = [int(jagent.gpi_action(jnp.asarray(q_tables), jnp.asarray(o), jnp.asarray(x))) for o, x in zip(obs, w)]
    np.testing.assert_array_equal(got, want)


def test_pql_dst():
    """tests/test_agents_multi.py::test_pql_dst."""
    pql = PQL(make("deep-sea-treasure-v0"), ref_point=REF2, config=PQLConfig(set_capacity=8, epsilon_decay_steps=1500),
              device="cpu")
    state = pql.train(total_timesteps=2500, ref_point=REF2, eval_freq=2500)
    front = pql._last_front
    assert len(front) >= 1
    tracked = pql.track_policy(state, front[0])
    assert tracked.shape == (2,)


def test_pql_3obj_hypervolume_scoring():
    """tests/test_agents_multi.py::test_pql_3obj_hypervolume_scoring: on
    four-room the hypervolume-scored agent builds a non-empty local PCS of 3-vectors."""
    ref3 = np.array([-1.0, -1.0, -1.0])
    pql = PQL(make("four-room-v0"), ref_point=ref3, device="cpu",
              config=PQLConfig(gamma=0.95, set_capacity=4, epsilon_decay_steps=400, action_eval="hypervolume"))
    pql.train(total_timesteps=800, ref_point=ref3, eval_freq=800)
    front = pql._last_front
    assert front.shape[-1] == 3 and len(front) >= 1
