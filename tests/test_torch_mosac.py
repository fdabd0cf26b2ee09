"""Parity of the torch port's continuous MOSAC with the JAX package's, and its member axis.

Params come from the flax init (a target critic from another init) and are
carried across with ``load_flax_params``; batches and weights are made with
numpy from a seed, and the actor's and the target's normals are read off
the JAX update key and handed to the port.  Tolerances: the squashed-Gaussian
actor's forward, action and log-prob 1e-6 (the log-std also rtol 1e-6: near
its floor of -5 an ulp is 4.8e-7, and tanh rounds differently; the log-prob
atol 1e-5, a sum of float32 terms near 10, and rtol 1e-3 on the rows with a
near-saturated action, 1 - a^2 < 1e-2, where one ulp of tanh moves
log(1 - a^2) by 1.2e-7 / (1 - a^2) and more); one ``_update``, on an actor step and on a skip step,
atol 1e-5 on the actor, critic and target params and on log_alpha (float32
sums in another order).  Member p of a stacked update equals a one-member
update of the same state and batch at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import MOSAC, MOSACConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import SquashedGaussianActor, load_flax_params, to_flax_params
from morl_baselines_torch.replay import Transition
from morl_baselines_tpu.agents.mosac import MOSAC as JMOSAC
from morl_baselines_tpu.agents.mosac import MOSACConfig as JMOSACConfig
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.models.continuous import SquashedGaussianActor as JSquashedGaussianActor
from morl_baselines_tpu.replay import Transition as JTransition

torch.set_num_threads(1)
ATOL = 1e-5
SMALL = dict(num_envs=4, buffer_size=256, batch_size=32, learning_starts=16, hidden=(32, 32))
W = np.array([0.6, 0.4], np.float32)
ENV = "mo-halfcheetah-jx-v5"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_trees(port, flax, atol=ATOL):
    flax = _np(flax)
    assert jax.tree.structure(port) == jax.tree.structure(flax)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(port)[0], jax.tree.leaves(flax)):
        np.testing.assert_allclose(a.reshape(b.shape), b, atol=atol, rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("members", [None, 1])
def test_squashed_gaussian_actor_parity(members):
    jactor = JSquashedGaussianActor(action_dim=6, hidden=(32, 32))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(50, 17)).astype(np.float32)
    params = jactor.init(jax.random.key(1), jnp.asarray(obs))
    actor = load_flax_params(SquashedGaussianActor(17, 6, (32, 32), members=members), _np(params))
    mean, log_std = jactor.apply(params, jnp.asarray(obs))
    x = _t(obs) if members is None else _t(obs)[None]
    tmean, tlog_std = (y.detach().reshape(50, 6).numpy() for y in actor(x))
    np.testing.assert_allclose(tmean, np.asarray(mean), atol=1e-6)
    np.testing.assert_allclose(tlog_std, np.asarray(log_std), atol=1e-6, rtol=1e-6)
    assert tlog_std.min() >= -5.0 and tlog_std.max() <= 2.0
    key = jax.random.key(2)
    a, logp = JSquashedGaussianActor.sample(mean, log_std, key)
    eps = jax.random.normal(key, mean.shape)
    ta, tlogp = SquashedGaussianActor.sample(_t(tmean), _t(tlog_std), _t(eps))
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), atol=1e-6)
    # log(1 - a^2) near a saturated |a| is ill-conditioned: one ulp of tanh moves it by 1.2e-7 / (1 - a^2)
    sat = np.min(1.0 - np.asarray(a) ** 2, axis=-1) < 1e-2
    assert 0 < sat.sum() < len(sat) // 2
    np.testing.assert_allclose(tlogp.numpy()[~sat], np.asarray(logp)[~sat], atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tlogp.numpy()[sat], np.asarray(logp)[sat], rtol=1e-3)
    _assert_trees(to_flax_params(actor), params["params"], atol=0)


def test_stacked_population_trees_load():
    """A population tree with a leading member axis (``jax.vmap`` of the
    inits, as MORL/D's ``jax.vmap(init_state)`` makes it) loads into a ``members`` actor and a P·2 critic."""
    P = 3
    jagent = JMOSAC(jmake(ENV), W, JMOSACConfig(**SMALL))
    keys = jax.random.split(jax.random.key(0), P)
    actor_params = jax.vmap(lambda k: jagent.actor.init(k, jnp.zeros((1, 17))))(keys)
    critic_params = jax.vmap(lambda k: jagent.critic.init(k, jnp.zeros((1, 17)), jnp.zeros((1, 6))))(keys)
    agent = MOSAC(make(ENV, device="cpu"), W, MOSACConfig(**SMALL), device="cpu")
    actor = load_flax_params(agent.make_actor(P), _np(actor_params))
    critic = load_flax_params(agent.make_critic(2 * P), _np(critic_params))
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(P, 20, 17)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(P, 20, 6)).astype(np.float32)
    mean, _ = jax.vmap(jagent.actor.apply)(actor_params, jnp.asarray(obs))
    np.testing.assert_allclose(actor(_t(obs))[0].detach().numpy(), np.asarray(mean), atol=1e-6)
    q = jax.vmap(jagent.critic.apply)(critic_params, jnp.asarray(obs), jnp.asarray(act))  # (P, 2, B, d)
    tq = MOSAC.q_values(critic, _t(obs), _t(act))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(q), atol=1e-5)


def _pair(iter_count: int):
    """A JAX state (target critic from another init, a random log_alpha) and the port's copy of it."""
    jagent = JMOSAC(jmake(ENV), W, JMOSACConfig(**SMALL))
    js = jagent.init_state(jax.random.key(3))
    other = jagent.critic.init(jax.random.key(4), jnp.zeros((1, 17)), jnp.zeros((1, 6)))
    js = js._replace(
        critic_ts=js.critic_ts.replace(target_params=other),
        log_alpha=jnp.float32(-0.7),
        iter_count=jnp.int32(iter_count),
    )
    js = js._replace(alpha_opt_state=jagent.alpha_tx.init(js.log_alpha))
    agent = MOSAC(make(ENV, device="cpu"), W, MOSACConfig(**SMALL), device="cpu")
    st = agent.init_state(0)
    load_flax_params(st.actor, _np(js.actor_ts.params))
    load_flax_params(st.critic.net, _np(js.critic_ts.params))
    load_flax_params(st.critic.target_net, _np(other))
    with torch.no_grad():
        st.log_alpha.fill_(-0.7)
    st.iter_count = iter_count
    return agent, st, jagent, js


def _batch(rng, B=32, lead=()):
    f = lambda *s: rng.normal(size=(*lead, B, *s)).astype(np.float32)  # noqa: E731
    return dict(
        obs=f(17), action=np.tanh(f(6)), reward=f(2), next_obs=f(17),
        terminated=(rng.uniform(size=(*lead, B)) < 0.2).astype(np.float32),
    )


@pytest.mark.parametrize("iter_count", [0, 1], ids=["actor_step", "skip_step"])
def test_mosac_update_parity(iter_count):
    agent, st, jagent, js = _pair(iter_count)
    batch = _batch(np.random.default_rng(5))
    key = jax.random.key(9)
    js2 = jagent.update_once(js, JTransition(**{k: jnp.asarray(v) for k, v in batch.items()}), key)
    k1, k2, _ = jax.random.split(key, 3)
    eps_next = np.asarray(jax.random.normal(k1, (32, 6)))
    eps_actor = np.asarray(jax.random.normal(k2, (32, 6)))
    tbatch = Transition(**{k: _t(v)[None] for k, v in batch.items()})
    before = jax.tree.map(np.copy, to_flax_params(st.actor))
    agent._update(st, tbatch, _t(W)[None], _t(eps_next)[None], _t(eps_actor)[None])
    _assert_trees(to_flax_params(st.critic.net), js2.critic_ts.params["params"])
    _assert_trees(to_flax_params(st.critic.target_net), js2.critic_ts.target_params["params"])
    _assert_trees(to_flax_params(st.actor), js2.actor_ts.params["params"])
    np.testing.assert_allclose(float(st.log_alpha[0].detach()), float(js2.log_alpha), atol=ATOL)
    moved = any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(to_flax_params(st.actor))))
    assert moved == (iter_count == 0)
    assert st.iter_count == iter_count  # an update leaves the count as it is


def test_member_update_equals_single_member_update():
    """Member p of a 3-member update (an actor step, then a skip step) equals
    a one-member update of the same state and batch."""
    agent = MOSAC(make(ENV, device="cpu"), W, MOSACConfig(**SMALL), device="cpu")
    seeds = [1, 2, 3]
    pop = agent.init_state(seeds)
    rng = np.random.default_rng(6)
    ws = _t(rng.dirichlet([1.0, 1.0], size=3).astype(np.float32))
    steps = []
    for it in range(2):
        b = Transition(**{k: _t(v) for k, v in _batch(rng, lead=(3,)).items()})
        steps.append((b, _t(rng.normal(size=(3, 32, 6)).astype(np.float32)), _t(rng.normal(size=(3, 32, 6)).astype(np.float32))))
        pop.iter_count = it
        agent._update(pop, b, ws, steps[-1][1], steps[-1][2])
    for p, seed in enumerate(seeds):
        one = agent.init_state(seed)
        for it, (b, e1, e2) in enumerate(steps):
            one.iter_count = it
            agent._update(one, Transition(*(x[p : p + 1] for x in b)), ws[p : p + 1], e1[p : p + 1], e2[p : p + 1])
        for net_one, net_pop, per in ((one.actor, pop.actor, 1), (one.critic.net, pop.critic.net, 2), (one.critic.target_net, pop.critic.target_net, 2)):
            for a, b in zip(net_one.parameters(), net_pop.parameters()):
                np.testing.assert_allclose(
                    a.detach().numpy(), b[p * per : (p + 1) * per].detach().numpy(), atol=1e-6, rtol=0
                )
        np.testing.assert_allclose(float(one.log_alpha[0].detach()), float(pop.log_alpha[p].detach()), atol=1e-6)


def test_mosac_policies():
    """Mirror of the MOSAC half of tests/test_agents_multi.py::test_mosac_policies."""
    env = make("mo-mountaincarcontinuous-v0")
    sac = MOSAC(env, weights=np.array([0.5, 0.5]), device="cpu",
                config=MOSACConfig(num_envs=4, buffer_size=1024, batch_size=16, learning_starts=32, hidden=(32, 32)))
    st, buf = sac.train(80)
    assert st.global_step == 80 and st.iter_count == 20 and buf.size == 80
    assert all(bool(torch.isfinite(p).all()) for p in st.actor.parameters())
    assert float(st.log_alpha[0].detach()) != float(np.log(0.2))  # alpha autotuned once learning started
    ret, disc = sac.policy_eval(st, torch.Generator().manual_seed(0), 1, max_steps=50)
    assert ret.shape == (1, 2) and bool(torch.isfinite(disc).all())
