"""Parity of the port's CAPQL with the JAX package's.

Params come from the flax init (a target critic from another init) and are
carried across with ``load_flax_params``; batches are made with numpy from a
seed, and the normals and uniforms are read off the JAX keys and handed to
the port.  Tolerances: ``sample_angle_weights`` 1e-6; the weight-conditioned
squashed-Gaussian actor 1e-6 on its mean and log-std; the 2-member critic
1e-5; one ``_update`` atol 1e-5 on the actor, critic and target params;
the weight-carrying ring buffer exact.  Then the smoke mirror of
tests/test_agents_multi.py::test_capql.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import CAPQL, CAPQLConfig, sample_angle_weights
from morl_baselines_torch.agents.capql import WReplayBuffer, WTransition
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import ContinuousQNet, SquashedGaussianActor, load_flax_params, to_flax_params
from morl_baselines_tpu.agents import CAPQL as JCAPQL
from morl_baselines_tpu.agents import CAPQLConfig as JCAPQLConfig
from morl_baselines_tpu.agents.capql import WReplayBuffer as JWReplayBuffer
from morl_baselines_tpu.agents.capql import WTransition as JWTransition
from morl_baselines_tpu.agents.capql import sample_angle_weights as jsample_angle_weights
from morl_baselines_tpu.envs import make as jmake

torch.set_num_threads(1)
ATOL = 1e-5
ENV = "mo-hopper-jx-v5"  # obs 11, action 3, reward 3
SMALL = dict(num_envs=4, buffer_size=256, batch_size=32, learning_starts=16, hidden=(32, 32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_trees(port, flax, atol=ATOL):
    flax = _np(flax)
    assert jax.tree.structure(port) == jax.tree.structure(flax)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(port)[0], jax.tree.leaves(flax)):
        np.testing.assert_allclose(a.reshape(b.shape), b, atol=atol, rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dim", [2, 3, 6])
def test_sample_angle_weights(dim):
    """The JAX key's normals and uniforms handed to the port: 1e-6; every row
    has L1 norm 1 and lies within the cone."""
    key, n, angle = jax.random.key(dim), 256, 0.418
    want = np.asarray(jsample_angle_weights(key, n, dim, angle))
    k1, k2 = jax.random.split(key)
    normals, uniforms = jax.random.normal(k1, (n, dim)), jax.random.uniform(k2, (n, 1))
    got = sample_angle_weights(None, n, dim, angle, _t(normals), _t(uniforms)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.abs(got).sum(axis=1), 1.0, atol=1e-6)
    cos = got.sum(axis=1) / (np.linalg.norm(got, axis=1) * np.sqrt(dim))
    assert (np.arccos(np.clip(cos, -1, 1)) <= angle + 1e-4).all()
    drawn = sample_angle_weights(torch.Generator().manual_seed(0), n, dim, angle)
    assert drawn.shape == (n, dim) and torch.allclose(drawn.abs().sum(dim=1), torch.ones(n))


def test_conditioned_actor_and_twin_critic_from_flax():
    jagent = JCAPQL(jmake(ENV), JCAPQLConfig(**SMALL))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(40, 11)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(40, 3)).astype(np.float32)
    w = rng.dirichlet([1.0] * 3, size=40).astype(np.float32)
    aparams = jagent.actor.init(jax.random.key(1), jnp.asarray(obs), jnp.asarray(w))
    cparams = jagent.critic.init(jax.random.key(2), jnp.asarray(obs), jnp.asarray(act), jnp.asarray(w))
    actor = load_flax_params(SquashedGaussianActor(11, 3, (32, 32), reward_dim=3, weight_conditioned=True), _np(aparams))
    critic = load_flax_params(ContinuousQNet(11, 3, 3, (32, 32), members=2), _np(cparams))
    mean, log_std = jax.jit(jagent.actor.apply)(aparams, obs, w)
    with torch.no_grad():
        tmean, tlog_std = actor(_t(obs), _t(w))
        tq = critic(_t(obs), _t(act), _t(w))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), atol=1e-6)
    np.testing.assert_allclose(tlog_std.numpy(), np.asarray(log_std), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jax.jit(jagent.critic.apply)(cparams, obs, act, w)), atol=1e-5)
    _assert_trees(to_flax_params(actor), aparams["params"], atol=0)
    _assert_trees(to_flax_params(critic), cparams["params"], atol=0)


def _batch(rng, B=32):
    f = lambda *s: rng.normal(size=(B, *s)).astype(np.float32)  # noqa: E731
    return dict(
        obs=f(11), action=np.tanh(f(3)), w=rng.dirichlet([1.0] * 3, size=B).astype(np.float32), reward=f(3),
        next_obs=f(11), terminated=(rng.uniform(size=B) < 0.2).astype(np.float32),
    )


def test_capql_update_parity():
    """One ``_update`` (critic, actor against the updated critic, Polyak) on the
    same batch, with the JAX key's two normals: every param atol 1e-5."""
    jagent = JCAPQL(jmake(ENV), JCAPQLConfig(**SMALL))
    js = jagent.init_state(jax.random.key(3))
    other = jagent.critic.init(jax.random.key(4), jnp.zeros((1, 11)), jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    critic_ts = js.critic_ts.replace(target_params=other)
    agent = CAPQL(make(ENV, device="cpu"), CAPQLConfig(**SMALL), device="cpu")
    st = agent.init_state()
    load_flax_params(st.actor, _np(js.actor_ts.params))
    load_flax_params(st.critic.net, _np(critic_ts.params))
    load_flax_params(st.critic.target_net, _np(other))
    batch = _batch(np.random.default_rng(5))
    key = jax.random.key(9)
    actor_ts, critic_ts = jax.jit(jagent._update)(js.actor_ts, critic_ts, JWTransition(**{k: jnp.asarray(v) for k, v in batch.items()}), key)
    k1, k2 = jax.random.split(key)
    eps_next, eps_actor = (np.asarray(jax.random.normal(k, (32, 3))) for k in (k1, k2))
    agent._update(st, WTransition(**{k: _t(v) for k, v in batch.items()}), _t(eps_next), _t(eps_actor))
    _assert_trees(to_flax_params(st.critic.net), critic_ts.params["params"])
    _assert_trees(to_flax_params(st.critic.target_net), critic_ts.target_params["params"])
    _assert_trees(to_flax_params(st.actor), actor_ts.params["params"])


def test_weight_buffer_ring_and_gather():
    """Three adds that wrap the ring, the pointer and size, and a gather: exact."""
    rng = np.random.default_rng(6)
    buf = WReplayBuffer.create(10, 11, 3, 3, device="cpu")
    jbuf = JWReplayBuffer.create(10, 11, 3, 3)
    for n in (4, 4, 5):
        b = _batch(rng, n)
        buf.add_batch(WTransition(**{k: _t(v) for k, v in b.items()}))
        jbuf = jbuf.add_batch(JWTransition(**{k: jnp.asarray(v) for k, v in b.items()}))
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size)) == (3, 10)
    for a, b in zip(buf.data, jbuf.data):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = rng.integers(0, 10, size=16)
    for a, b in zip(buf.gather(_t(idx)), jbuf.data):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[idx])
    sample = buf.sample(torch.Generator().manual_seed(0), 8)
    assert sample.w.shape == (8, 3)


def test_capql_smoke():
    """Mirror of tests/test_agents_multi.py::test_capql at its sizes and seed 0;
    then a short ``train`` with its evaluation."""
    envc = make("mo-mountaincarcontinuous-v0")
    cap = CAPQL(envc, config=CAPQLConfig(num_envs=4, buffer_size=1024, batch_size=16, learning_starts=32, hidden=(32, 32)),
                device="cpu")
    cs = cap.init_state()
    cs = cap.train_segment(cs, 20)
    assert cs.global_step == 80
    assert cs.buffer.size == 80
    assert torch.allclose(cs.behavior_w.abs().sum(dim=1), torch.ones(4))
    cap.train(64, ref_point=np.array([-100.0, -100.0]), eval_freq=32, num_eval_weights_for_front=4, eval_max_steps=20, state=cs)
    assert cs.global_step == 144 and cap._last_front.shape == (4, 2) and np.isfinite(cap._last_front).all()
