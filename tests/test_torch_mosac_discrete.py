"""Parity of the torch port's discrete MOSAC with the JAX package's, and its member axis.

Params come from the flax init (a target critic from another init) and are
carried across with ``load_flax_params``; batches and weights are made with
numpy from a seed.  The update is deterministic given the batch, so one
``_update`` on an actor step and on a skip step is held at atol 1e-5 on the
actor, critic and target params and on log_alpha (float32 sums in another
order through one Adam step each).  A whole ``train_segment`` on
deep-sea-treasure gets the JAX key chain's Gumbel noise (``_gumbel``) and
batch indices (``buffer.sample``) and is held at the same tolerance, its
buffer too.  Member p of a stacked update equals a one-member update of the
same state and batch at 1e-6.  The nets' forwards at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import MOSACConfig, MOSACDiscrete
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import DiscreteQNet, DiscreteSACActor, load_flax_params, to_flax_params
from morl_baselines_torch.replay import Transition
from morl_baselines_tpu.agents.mosac import MOSACConfig as JMOSACConfig
from morl_baselines_tpu.agents.mosac import MOSACDiscrete as JMOSACDiscrete
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.models.continuous import DiscreteQNet as JDiscreteQNet
from morl_baselines_tpu.models.continuous import DiscreteSACActor as JDiscreteSACActor
from morl_baselines_tpu.replay import Transition as JTransition

torch.set_num_threads(1)
ATOL = 1e-5
SMALL = dict(num_envs=4, buffer_size=256, batch_size=32, learning_starts=16, hidden=(32, 32))
ENV = "mo-lunar-lander-v3"
W = np.array([0.4, 0.3, 0.2, 0.1], np.float32)


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
def test_discrete_nets_parity(members):
    """The actor's logits and both twin critics' Q (A, d) from carried flax params."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(40, 8)).astype(np.float32)
    jactor = JDiscreteSACActor(num_actions=4, hidden=(32, 32))
    jcritic = JMOSACDiscrete(jmake(ENV), W, JMOSACConfig(**SMALL)).critic
    aparams = jactor.init(jax.random.key(1), jnp.asarray(obs))
    cparams = jcritic.init(jax.random.key(2), jnp.asarray(obs))
    actor = load_flax_params(DiscreteSACActor(8, 4, (32, 32), members), _np(aparams))
    x = _t(obs) if members is None else _t(obs)[None]
    np.testing.assert_allclose(actor(x).detach().reshape(40, 4).numpy(), np.asarray(jactor.apply(aparams, obs)), atol=1e-6)
    critic = load_flax_params(DiscreteQNet(8, 4, 4, (32, 32), members=2), _np(cparams))
    q = MOSACDiscrete.q_values(critic, _t(obs)[None])[0]  # (2, B, A, d)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jcritic.apply(cparams, obs)), atol=1e-6)
    one = load_flax_params(DiscreteQNet(8, 4, 4, (32, 32)), _np(JDiscreteQNet(4, 4, (32, 32)).init(jax.random.key(3), obs)))
    assert one(_t(obs)).shape == (40, 4, 4)
    _assert_trees(to_flax_params(actor), aparams["params"], atol=0)


def _pair(iter_count: int):
    """A JAX state (target critic from another init, log_alpha -0.7) and the port's copy of it."""
    jagent = JMOSACDiscrete(jmake(ENV), W, JMOSACConfig(**SMALL))
    js = jagent.init_state(jax.random.key(3))
    other = jagent.critic.init(jax.random.key(4), jnp.zeros((1, 8)))
    js = js._replace(critic_ts=js.critic_ts.replace(target_params=other), log_alpha=jnp.float32(-0.7),
                     iter_count=jnp.int32(iter_count))
    js = js._replace(alpha_opt_state=jagent.alpha_tx.init(js.log_alpha))
    agent = MOSACDiscrete(make(ENV), W, MOSACConfig(**SMALL), device="cpu")
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
        obs=f(8), action=rng.integers(0, 4, size=(*lead, B)), reward=f(4), next_obs=f(8),
        terminated=(rng.uniform(size=(*lead, B)) < 0.2).astype(np.float32),
    )


@pytest.mark.parametrize("iter_count", [0, 1], ids=["actor_step", "skip_step"])
def test_mosac_discrete_update_parity(iter_count):
    agent, st, jagent, js = _pair(iter_count)
    batch = _batch(np.random.default_rng(5))
    jbatch = JTransition(**{k: jnp.asarray(v.astype(np.int32) if k == "action" else v) for k, v in batch.items()})
    js2 = jagent.update_once(js, jbatch, jax.random.key(9))
    before = jax.tree.map(np.copy, to_flax_params(st.actor))
    alpha_before = float(st.log_alpha[0].detach())
    closs = agent._update(st, Transition(**{k: _t(v)[None] for k, v in batch.items()}), _t(W)[None])
    assert closs.shape == (1,) and bool(torch.isfinite(closs).all())
    _assert_trees(to_flax_params(st.critic.net), js2.critic_ts.params["params"])
    _assert_trees(to_flax_params(st.critic.target_net), js2.critic_ts.target_params["params"])
    _assert_trees(to_flax_params(st.actor), js2.actor_ts.params["params"])
    np.testing.assert_allclose(float(st.log_alpha[0].detach()), float(js2.log_alpha), atol=ATOL)
    moved = any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(to_flax_params(st.actor))))
    assert moved == (iter_count == 0) and (float(st.log_alpha[0].detach()) != alpha_before) == (iter_count == 0)
    assert st.iter_count == iter_count


def test_member_update_equals_single_member_update():
    """Member p of a 3-member update (an actor step, then a skip step) equals
    a one-member update of the same state and batch."""
    agent = MOSACDiscrete(make(ENV), W, MOSACConfig(**SMALL), device="cpu")
    seeds = [1, 2, 3]
    pop = agent.init_state(seeds)
    rng = np.random.default_rng(6)
    ws = _t(rng.dirichlet([1.0] * 4, size=3).astype(np.float32))
    steps = []
    for it in range(2):
        steps.append(Transition(**{k: _t(v) for k, v in _batch(rng, lead=(3,)).items()}))
        pop.iter_count = it
        agent._update(pop, steps[-1], ws)
    for p, seed in enumerate(seeds):
        one = agent.init_state(seed)
        for it, b in enumerate(steps):
            one.iter_count = it
            agent._update(one, Transition(*(x[p : p + 1] for x in b)), ws[p : p + 1])
        for net_one, net_pop, per in ((one.actor, pop.actor, 1), (one.critic.net, pop.critic.net, 2),
                                      (one.critic.target_net, pop.critic.target_net, 2)):
            for a, b in zip(net_one.parameters(), net_pop.parameters()):
                np.testing.assert_allclose(a.detach().numpy(), b[p * per : (p + 1) * per].detach().numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(one.log_alpha[0].detach()), float(pop.log_alpha[p].detach()), atol=1e-6)


def test_train_segment_parity():
    """A whole ``train_segment`` on deep-sea-treasure (6 iterations of 4 envs,
    learning from the 4th, so the actor steps on iterations 4 and 6 and skips
    5): the JAX key chain's Gumbel noise and batch indices handed over."""
    cfg = dict(num_envs=4, buffer_size=64, batch_size=8, learning_starts=16, hidden=(16, 16))
    w = np.array([0.7, 0.3], np.float32)
    jagent = JMOSACDiscrete(jmake("deep-sea-treasure-v0"), w, JMOSACConfig(**cfg))
    js = jagent.init_state(jax.random.key(0))
    jbuf = jagent.make_buffer()
    iters = 6
    js2, jbuf2 = jagent.train_segment(js, jbuf, iters)

    gumbels, indices, key = [], [], js.key
    for it in range(iters):
        key, k_act, _, k_upd = jax.random.split(key, 4)
        gumbels.append(_t(jax.random.gumbel(k_act, (4, 4)))[None])
        if (it + 1) * 4 >= 16:
            indices.append(_t(jax.random.randint(k_upd, (8,), 0, min((it + 1) * 4, 64)))[None])

    agent = MOSACDiscrete(make("deep-sea-treasure-v0"), w, MOSACConfig(**cfg), device="cpu")
    st, buf = agent.init_state(0), agent.make_buffer()
    load_flax_params(st.actor, _np(js.actor_ts.params))
    load_flax_params(st.critic.net, _np(js.critic_ts.params))
    load_flax_params(st.critic.target_net, _np(js.critic_ts.target_params))
    agent._gumbel = lambda state, like: gumbels.pop(0)

    def sample(gen, batch_size):
        idx = indices.pop(0)
        return Transition(*(x[torch.arange(1)[:, None], idx] for x in buf.data))

    buf.sample = sample
    agent.train_segment(st, buf, iters)
    assert not gumbels and not indices and st.global_step == 24 and st.iter_count == iters
    _assert_trees(to_flax_params(st.actor), js2.actor_ts.params["params"])
    _assert_trees(to_flax_params(st.critic.net), js2.critic_ts.params["params"])
    _assert_trees(to_flax_params(st.critic.target_net), js2.critic_ts.target_params["params"])
    np.testing.assert_allclose(float(st.log_alpha[0].detach()), float(js2.log_alpha), atol=ATOL)
    for a, b in zip(buf.data, jbuf2.data):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=0)
    np.testing.assert_array_equal(st.obs[0].numpy(), np.asarray(js2.obs))


def test_mosac_discrete_policies():
    """Mirror of the discrete half of tests/test_agents_multi.py::test_mosac_policies."""
    env = make("deep-sea-treasure-v0")
    sacd = MOSACDiscrete(env, weights=np.array([0.5, 0.5]), device="cpu",
                         config=MOSACConfig(num_envs=4, buffer_size=1024, batch_size=16, learning_starts=32, hidden=(32, 32)))
    sd, bd = sacd.init_state(), sacd.make_buffer()
    sacd.train_segment(sd, bd, 20)
    assert sd.global_step == 80 and bd.size == 80 and bd.data.action.dtype == torch.int64
    assert float(sd.log_alpha[0].detach()) != float(np.log(0.2))  # alpha autotuned once learning started
    ret, disc = sacd.policy_eval(sd, torch.Generator().manual_seed(0), 1)
    assert ret.shape == (1, 2) and bool(torch.isfinite(disc).all())
    assert sacd.target_entropy == pytest.approx(0.89 * np.log(4))
    with pytest.raises(ValueError, match="discrete"):
        MOSACDiscrete(make("mo-mountaincarcontinuous-v0"), np.array([0.5, 0.5]), device="cpu")
