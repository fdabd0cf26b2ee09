"""Parity of the port's scalarization and tabular MO Q-learning with the JAX package.

The same inputs, made from a numpy seed, go through both packages on the CPU:
the scalarization functions, DST's state index, one batched TD update with
repeated (s, a) pairs, one Dyna step, and whole ``train_segment`` runs with
the JAX key chain's explore draws handed to the port.  Then the learning
mirrors of tests/test_agents.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import MOQLearning, MOQLearningConfig
from morl_baselines_torch.core import tchebicheff, update_utopian, weighted_sum
from morl_baselines_torch.envs import make
from morl_baselines_tpu.agents import MOQLearning as JMOQLearning
from morl_baselines_tpu.agents import MOQLearningConfig as JMOQLearningConfig
from morl_baselines_tpu.core import scalarization as jscal
from morl_baselines_tpu.envs import make as jmake

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _agents(weights, **cfg):
    agent = MOQLearning(make("deep-sea-treasure-v0"), np.asarray(weights), MOQLearningConfig(**cfg), device="cpu")
    jagent = JMOQLearning(jmake("deep-sea-treasure-v0"), np.asarray(weights), JMOQLearningConfig(**cfg))
    return agent, jagent


def jax_draws(key, iters: int, n: int, num_actions: int, dyna_updates: int | None = None):
    """The JAX ``train_segment``'s random numbers, in the order of its body:
    (explore uniforms, random actions, planning uniforms or None) per iteration."""
    out = []
    for _ in range(iters):
        key, k_eps, k_act, _k_step, k_dyna = jax.random.split(key, 5)
        plan = _t(jax.random.uniform(k_dyna, (dyna_updates * n,))) if dyna_updates else None
        out.append((_t(jax.random.uniform(k_eps, (n,))), _t(jax.random.randint(k_act, (n,), 0, num_actions)), plan))
    return out


def test_scalarization():
    # tests/test_core.py::test_scalarization
    r, w = torch.tensor([1.0, 2.0]), torch.tensor([0.5, 0.5])
    assert float(weighted_sum(r, w)) == pytest.approx(1.5)
    ut = torch.tensor([3.0, 3.0])
    assert float(tchebicheff(r, w, ut)) == pytest.approx(-1.0)
    np.testing.assert_allclose(update_utopian(ut, torch.tensor([5.0, 1.0]), tau=0.5).numpy(), [5.5, 3.0])
    # batched, against the JAX package
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(3)).astype(np.float32)
    ut = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(weighted_sum(_t(q), _t(w)).numpy(), np.asarray(jscal.weighted_sum(q, w)), atol=1e-6)
    np.testing.assert_allclose(tchebicheff(_t(q), _t(w), _t(ut)).numpy(), np.asarray(jscal.tchebicheff(q, w, ut)), atol=1e-6)
    for reward in (q, q[0, 0]):  # reduces over every leading dim, or none
        np.testing.assert_array_equal(update_utopian(_t(ut), _t(reward)).numpy(), np.asarray(jscal.update_utopian(ut, reward)))


def test_dst_state_index():
    env, jenv = make("deep-sea-treasure-v0"), jmake("deep-sea-treasure-v0")
    assert env.num_states == jenv.num_states == 110
    cells = np.stack(np.meshgrid(np.arange(11), np.arange(10), indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    got = env.state_index(_t(cells))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jenv.state_index(jnp.asarray(cells))))
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(110))
    assert make("deep-sea-treasure-concave-v0").name == "deep-sea-treasure-concave-v0"
    with pytest.raises(ValueError, match="discrete state indexing"):
        MOQLearning(make("minecart-v0"), np.ones(3) / 3, device="cpu")


@pytest.mark.parametrize("scalarization", ["weighted_sum", "tchebicheff"])
def test_td_update_sums_duplicate_pairs(scalarization):
    """32 updates over 3 states x 4 actions: repeated (s, a) pairs sum their
    updates, every delta taken from the table as it was before (atol 1e-6)."""
    agent, jagent = _agents([0.3, 0.7], scalarization=scalarization, learning_rate=0.1, gamma=0.9)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(110, 4, 2)).astype(np.float32)
    utopian = np.array([2.0, 1.5], dtype=np.float32)
    n = 32
    s_idx = rng.integers(0, 3, size=n).astype(np.int32)
    actions = rng.integers(0, 4, size=n).astype(np.int32)
    rewards = rng.normal(size=(n, 2)).astype(np.float32)
    ns_idx = rng.integers(0, 110, size=n).astype(np.int32)
    term = (rng.uniform(size=n) < 0.3).astype(np.float32)
    assert len({(s, a) for s, a in zip(s_idx, actions)}) < n  # the pairs repeat
    want = np.asarray(jagent._td_update(*(jnp.asarray(x) for x in (q, utopian, s_idx, actions, rewards, ns_idx, term))))
    got = _t(q)
    agent._td_update(got, _t(utopian), _t(s_idx).long(), _t(actions).long(), _t(rewards), _t(ns_idx).long(), _t(term))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # a plain indexed += would keep one update per pair
    plain = _t(q)
    plain[_t(s_idx).long(), _t(actions).long()] += 0.1
    assert not np.allclose(plain.numpy() - q, got.numpy() - q)


@pytest.mark.parametrize("weights", [[0.5, 0.5], [1.0, 0.0]])
def test_first_greedy_step_with_unset_utopian(weights):
    """The utopian point starts at -inf, so the first Tchebicheff scores are
    all -inf (or NaN where a weight is 0): both packages pick action 0."""
    agent, jagent = _agents(weights, scalarization="tchebicheff")
    q = np.random.default_rng(2).normal(size=(110, 4, 2)).astype(np.float32)
    ut = np.full(2, -np.inf, dtype=np.float32)
    s_idx = np.arange(0, 110, 7)
    scores = agent._scalarize(_t(q)[_t(s_idx)], _t(ut))
    assert bool(torch.isneginf(scores).all()) if weights[1] else bool(torch.isnan(scores).all())
    got = agent._greedy(_t(q), _t(ut), _t(s_idx))
    want = np.asarray(jnp.argmax(jagent._scalarize(jnp.asarray(q)[s_idx], jnp.asarray(ut)), axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_dyna_step_distinct_pairs():
    """One iteration with Dyna from a visited model (8 envs on distinct cells,
    so distinct (s, a) pairs), the JAX iteration's explore and planning draws
    handed over: table, counts, means and next states (atol 1e-6)."""
    n, updates = 8, 3
    agent, jagent = _agents([0.4, 0.6], num_envs=n, dyna=True, dyna_updates=updates, initial_epsilon=0.5)
    rng = np.random.default_rng(3)
    rows = np.array([0, 1, 2, 3, 4, 1, 2, 0], dtype=np.int32)
    cols = np.array([0, 1, 2, 3, 4, 5, 7, 9], dtype=np.int32)
    tables = dict(
        q_table=rng.normal(size=(110, 4, 2)).astype(np.float32),
        model_count=rng.integers(0, 4, size=(110, 4)).astype(np.float32),
        model_next=rng.integers(0, 110, size=(110, 4)).astype(np.int32),
        model_reward=rng.normal(size=(110, 4, 2)).astype(np.float32),
        model_term=rng.uniform(size=(110, 4)).astype(np.float32),
    )
    js = jagent.init_state(jax.random.key(5))
    env_state = type(js.env_state)(jnp.asarray(rows), jnp.asarray(cols), jnp.zeros(n, jnp.int32))
    obs = jnp.stack([rows, cols], -1).astype(jnp.float32)
    js = js._replace(env_state=env_state, obs=obs, **{k: jnp.asarray(v) for k, v in tables.items()})
    draws = jax_draws(js.key, 1, n, 4, updates)
    js2 = jagent.train_segment(js, 1)

    st = agent.init_state()
    st.env_state = type(st.env_state)(*(_t(x) for x in env_state))
    st.obs = _t(obs)
    for k, v in tables.items():
        setattr(st, k, _t(v).long() if k == "model_next" else _t(v))
    agent._draws = lambda state: draws.pop(0)
    agent.train_segment(st, 1)
    for k in tables:
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(js2, k)), atol=1e-6, err_msg=k)
    assert float(st.model_count.sum()) == float(tables["model_count"].sum()) + n


@pytest.mark.parametrize("scalarization", ["weighted_sum", "tchebicheff"])
def test_train_segment_parity(scalarization):
    """50 iterations of 8 envs on DST from the same start, the JAX key chain's
    explore uniforms and random actions handed to the port: Q-table and
    utopian point atol 1e-5, and the env states equal."""
    n, iters = 8, 50
    cfg = dict(num_envs=n, scalarization=scalarization, initial_epsilon=0.9, final_epsilon=0.2, epsilon_decay_steps=300)
    agent, jagent = _agents([0.4, 0.6], **cfg)
    js = jagent.init_state(jax.random.key(7))
    draws = jax_draws(js.key, iters, n, 4)
    js2 = jagent.train_segment(js, iters)
    st = agent.init_state()
    agent._draws = lambda state: draws.pop(0)
    agent.train_segment(st, iters)
    assert st.global_step == int(js2.global_step) == n * iters
    np.testing.assert_allclose(st.q_table.numpy(), np.asarray(js2.q_table), atol=1e-5)
    np.testing.assert_allclose(st.utopian.numpy(), np.asarray(js2.utopian), atol=1e-5)
    for got, want in zip(st.env_state, js2.env_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(js2.q_table)).max() > 1.0  # treasures were reached


# -- learning mirrors of tests/test_agents.py -------------------------------


def test_moql_dst():
    agent = MOQLearning(
        make("deep-sea-treasure-v0"),
        weights=np.array([0.5, 0.5]),
        config=MOQLearningConfig(num_envs=8, initial_epsilon=0.5, final_epsilon=0.1, epsilon_decay_steps=2000),
        device="cpu",
    )
    agent.train(total_timesteps=6000, eval_freq=6000)
    ret, disc = agent.last_eval
    assert ret.shape == (2,)
    assert ret[0] > 0.0  # a treasure was reached


def test_moql_tchebicheff():
    agent = MOQLearning(
        make("deep-sea-treasure-v0"), weights=np.array([0.5, 0.5]),
        config=MOQLearningConfig(num_envs=4, scalarization="tchebicheff"), device="cpu",
    )
    state = agent.train_segment(agent.init_state(), 50)
    assert state.global_step == 200
    assert bool(torch.isfinite(state.q_table).all())


def test_moql_dyna():
    agent = MOQLearning(
        make("deep-sea-treasure-v0"), weights=np.array([0.5, 0.5]),
        config=MOQLearningConfig(num_envs=4, dyna=True, dyna_updates=3), device="cpu",
    )
    state = agent.train_segment(agent.init_state(), 30)
    assert float(state.model_count.sum()) == pytest.approx(120.0)
