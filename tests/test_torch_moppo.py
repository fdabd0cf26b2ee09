"""Parity of the torch port's MOPPO with the JAX package's, and its member axis.

Inputs are made with numpy from a seed; the nets' params come from the flax
init and are carried across with ``load_flax_params``; the sampling noise is
read off the JAX key and handed to the port.  Tolerances: ``update_obs_norm``
rtol 1e-6; ``vector_gae`` rtol 1e-6 with atol 1e-6 (an advantage near zero
is a difference of float32 terms, a few ulps of them apart); the net's forward, log-prob and entropy 1e-6;
one minibatch loss and the params after one and two clipped Adam steps on a
fixed batch and permutation atol 1e-5 (float32 sums in another order).  The
member axis: member p of a stacked update equals a one-member update of the
same state, batch and permutation at 1e-6; a member whose gradient is far
above the clip rescales no other member.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import MOPPO, MOPPOConfig, MOPPONet
from morl_baselines_torch.agents.moppo import ObsNormState, Rollout, update_obs_norm, vector_gae
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import clip_grad_global_norm_members_, load_flax_params, to_flax_params
from morl_baselines_tpu.agents.moppo import MOPPO as JMOPPO
from morl_baselines_tpu.agents.moppo import MOPPOConfig as JMOPPOConfig
from morl_baselines_tpu.agents.moppo import ObsNormState as JObsNormState
from morl_baselines_tpu.agents.moppo import update_obs_norm as j_update_obs_norm
from morl_baselines_tpu.agents.moppo import vector_gae as j_vector_gae
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.models.networks import TrainState as JTrainState

torch.set_num_threads(1)
SMALL = dict(num_envs=4, steps_per_iteration=32, update_epochs=2, num_minibatches=2, hidden=(32, 32))
W = np.array([0.7, 0.3], np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_trees(port, flax, atol):
    flax = _np(flax)
    assert jax.tree.structure(port) == jax.tree.structure(flax)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(port)[0], jax.tree.leaves(flax)):
        np.testing.assert_allclose(a.reshape(b.shape), b, atol=atol, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_update_obs_norm_parity():
    rng = np.random.default_rng(0)
    obs_dim = 17
    s = ObsNormState.create(obs_dim, "cpu")
    js = JObsNormState.create(obs_dim)
    for _ in range(5):
        obs = (rng.normal(size=(64, obs_dim)) * 3 + 1).astype(np.float32)
        s, js = update_obs_norm(s, _t(obs)), j_update_obs_norm(js, jnp.asarray(obs))
    for a, b in zip(s, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_update_obs_norm_member_axis():
    """Stacked statistics (P, obs_dim) equal each member's own."""
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(4, 3, 16, 5)).astype(np.float32)  # (steps, P, N, obs_dim)
    s = ObsNormState.create(5, "cpu", (3,))
    for t in range(4):
        s = update_obs_norm(s, _t(obs[t]))
    for p in range(3):
        one = ObsNormState.create(5, "cpu")
        for t in range(4):
            one = update_obs_norm(one, _t(obs[t, p]))
        for a, b in zip(s, one):
            np.testing.assert_allclose(a[p].numpy(), b.numpy(), rtol=1e-6)


def test_vector_gae_parity():
    rng = np.random.default_rng(2)
    T, N, d = 9, 5, 2
    v, r = rng.normal(size=(T, N, d)).astype(np.float32), rng.normal(size=(T, N, d)).astype(np.float32)
    done = (rng.uniform(size=(T, N)) < 0.3).astype(np.float32)
    last_v = rng.normal(size=(N, d)).astype(np.float32)
    got = vector_gae(_t(v), _t(r), _t(done), _t(last_v), 0.9, 0.8).numpy()
    want = np.asarray(j_vector_gae(*(jnp.asarray(x) for x in (v, r, done, last_v)), 0.9, 0.8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_vector_gae_episode_boundaries():
    """Mirror of tests/test_extras.py::test_vector_gae_episode_boundaries: the
    bootstrap and the advantage chain cut at each transition's OWN done."""
    rng = np.random.default_rng(0)
    T, N, d, gamma, lam = 7, 3, 2, 0.9, 0.8
    v = rng.normal(size=(T, N, d)).astype(np.float32)
    r = rng.normal(size=(T, N, d)).astype(np.float32)
    done = (rng.uniform(size=(T, N)) < 0.3).astype(np.float32)
    last_v = rng.normal(size=(N, d)).astype(np.float32)
    got = vector_gae(_t(v), _t(r), _t(done), _t(last_v), gamma, lam).numpy()
    want = np.zeros_like(v)
    for n in range(N):
        adv_next, v_next = np.zeros(d), last_v[n]
        for t in reversed(range(T)):
            nonterm = 1.0 - done[t, n]
            want[t, n] = r[t, n] + gamma * v_next * nonterm - v[t, n] + gamma * lam * nonterm * adv_next
            adv_next, v_next = want[t, n], v[t, n]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    t_idx = int(np.argwhere(done[:, 0] == 1.0)[0][0])
    np.testing.assert_allclose(got[t_idx, 0], r[t_idx, 0] - v[t_idx, 0], rtol=1e-5)


def _agents(env_id="mo-halfcheetah-jx-v5", **cfg):
    kw = {**SMALL, **cfg}
    env = make(env_id, device="cpu") if "-jx-" in env_id else make(env_id)
    return MOPPO(env, W, MOPPOConfig(**kw), device="cpu"), JMOPPO(jmake(env_id), W, JMOPPOConfig(**kw))


def _flax_params(jagent, seed=0):
    """Flax init, with a random log-std so its terms are not trivial."""
    params = jagent.net.init(jax.random.key(seed), jnp.zeros((1, jagent.obs_dim)))
    if jagent.continuous:
        rng = np.random.default_rng(seed)
        params["params"]["log_std"] = jnp.asarray(rng.uniform(-1.0, 0.5, size=jagent.action_dim), jnp.float32)
    return params


@pytest.mark.parametrize("env_id", ["mo-halfcheetah-jx-v5", "deep-sea-treasure-v0"])
def test_moppo_net_forward_logp_entropy_parity(env_id):
    agent, jagent = _agents(env_id)
    params = _flax_params(jagent)
    net = load_flax_params(agent.make_net(), _np(params))
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(40, jagent.obs_dim)).astype(np.float32)
    pi, log_std, v = jagent.net.apply(params, jnp.asarray(obs))
    tpi, tlog_std, tv = net(_t(obs)[None])
    np.testing.assert_allclose(tpi[0].detach().numpy(), np.asarray(pi), atol=1e-6)
    np.testing.assert_allclose(tv[0].detach().numpy(), np.asarray(v), atol=1e-6)
    key = jax.random.key(7)
    a, logp, _ = jagent._dist(params, jnp.asarray(obs), key)
    if jagent.continuous:
        np.testing.assert_allclose(tlog_std[0].detach().numpy(), np.asarray(log_std), atol=1e-6)
        noise = np.asarray(jax.random.normal(key, pi.shape))
        ta, tlogp, _ = agent._dist(net, _t(obs)[None], _t(noise)[None])
        np.testing.assert_allclose(ta[0].detach().numpy(), np.asarray(a), atol=1e-6)
        np.testing.assert_allclose(tlogp[0].detach().numpy(), np.asarray(logp), atol=1e-5, rtol=1e-6)
        act = rng.normal(size=(40, jagent.action_dim)).astype(np.float32)
    else:
        assert log_std is None and tlog_std is None
        act = rng.integers(0, jagent.action_dim, size=40)
    logp, ent, _ = jagent._logp_entropy(params, jnp.asarray(obs), jnp.asarray(act))
    tlogp, tent, _ = agent._logp_entropy(net, _t(obs)[None], _t(act)[None])
    np.testing.assert_allclose(tlogp[0].detach().numpy(), np.asarray(logp), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tent[0].detach().numpy(), np.asarray(ent), atol=1e-6, rtol=1e-6)
    # the carried tree goes back out unchanged
    _assert_trees(to_flax_params(net), params["params"], atol=0)


def _batch(rng, B, obs_dim, action_dim, d, lead=()):
    f = lambda *s: rng.normal(size=(*lead, *s)).astype(np.float32)  # noqa: E731
    return Rollout(
        obs=f(B, obs_dim), act=f(B, action_dim), logp=f(B) - 5.0, adv=f(B) * 2.0, ret=f(B, d) * 5.0, val=f(B, d)
    )


def _j_step(jagent, ts, batch, idx):
    """The JAX package's minibatch update (moppo.py:268-290), on one fixed index set."""
    cfg = jagent.cfg

    @jax.jit
    def step(ts, obs, act, old_logp, adv, ret, val):
        mb_adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)

        def loss_fn(params):
            logp, ent, v = jagent._logp_entropy(params, obs, act)
            ratio = jnp.exp(logp - old_logp)
            pg_loss = jnp.mean(jnp.maximum(-mb_adv * ratio, -mb_adv * jnp.clip(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)))
            v_clip = val + jnp.clip(v - val, -cfg.clip_coef, cfg.clip_coef)
            v_loss = 0.5 * jnp.mean(jnp.maximum((v - ret) ** 2, (v_clip - ret) ** 2))
            return pg_loss - cfg.ent_coef * jnp.mean(ent) + cfg.vf_coef * v_loss

        loss, grads = jax.value_and_grad(loss_fn)(ts.params)
        return ts.apply_gradients(grads=grads), loss, optax_global_norm(grads)

    ts, loss, gnorm = step(ts, *(jnp.asarray(x)[idx] for x in batch))
    return ts, float(loss), float(gnorm)


def optax_global_norm(tree):
    return jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree.leaves(tree)))


def test_moppo_minibatch_loss_and_adam_parity():
    """One minibatch loss, then two clipped Adam steps (eps 1e-5), on a fixed
    batch and permutation; the clip is active in both."""
    agent, jagent = _agents(ent_coef=0.01)
    params = _flax_params(jagent, seed=1)
    ts = JTrainState.create(apply_fn=jagent.net.apply, params=params, tx=jagent.tx)
    state = agent.init_state(0)
    load_flax_params(state.net, _np(params))
    rng = np.random.default_rng(4)
    B, mb = 64, 32
    batch = _batch(rng, B, jagent.obs_dim, jagent.action_dim, 2)
    perm = rng.permutation(B)
    tbatch = Rollout(*(_t(x)[None] for x in batch))
    for i in range(2):
        idx = perm[i * mb : (i + 1) * mb]
        ts, jloss, gnorm = _j_step(jagent, ts, batch, idx)
        assert gnorm > 2 * agent.cfg.max_grad_norm
        loss = agent.minibatch_step(state, tbatch, _t(idx)[None])
        np.testing.assert_allclose(float(loss[0]), jloss, atol=1e-5, rtol=1e-6)
        _assert_trees(to_flax_params(state.net), ts.params["params"], atol=1e-5)
    assert int(state.optimizer.step_count[0]) == 2


def test_member_update_equals_single_member_update():
    """Member p of a 3-member update (2 epochs x 2 minibatches, given
    permutations) equals a one-member update of the same state and batch."""
    agent, _ = _agents()
    seeds = [5, 6, 7]
    pop = agent.init_state(seeds)
    rng = np.random.default_rng(5)
    B = 64
    batch = Rollout(*(_t(x) for x in _batch(rng, B, agent.obs_dim, agent.action_dim, 2, lead=(3,))))
    perms = torch.stack([torch.stack([torch.randperm(B, generator=torch.Generator().manual_seed(10 * e + p)) for p in range(3)]) for e in range(2)])
    pop_loss = agent.update(pop, batch, perms)
    for p, seed in enumerate(seeds):
        one = agent.init_state(seed)
        for a, b in zip(one.net.parameters(), pop.net.parameters()):
            assert a.shape[1:] == b.shape[1:]
        loss = agent.update(one, Rollout(*(x[p : p + 1] for x in batch)), perms[:, p : p + 1])
        np.testing.assert_allclose(float(loss[0]), float(pop_loss[p]), atol=1e-6)
        for a, b in zip(one.net.parameters(), pop.net.parameters()):
            np.testing.assert_allclose(a[0].detach().numpy(), b[p].detach().numpy(), atol=1e-6, rtol=0)


def test_member_clip_leaves_other_members_alone():
    net = MOPPONet(5, 2, 2, True, (8, 8), members=3)
    rng = np.random.default_rng(6)
    for p in net.parameters():
        p.grad = _t(rng.normal(size=p.shape).astype(np.float32)) * 0.01
    for p in net.parameters():
        p.grad[0] *= 1e4  # member 0 far above the clip
    before = [p.grad.clone() for p in net.parameters()]
    clip_grad_global_norm_members_(list(net.parameters()), 0.5)
    norm0 = torch.sqrt(sum(torch.sum(p.grad[0] ** 2) for p in net.parameters()))
    np.testing.assert_allclose(float(norm0), 0.5, rtol=1e-5)
    for p, g in zip(net.parameters(), before):
        assert torch.equal(p.grad[1:], g[1:])


def test_moppo_train_iteration_population_smoke():
    """A 2-member iteration on the halfcheetah: member-major P·N envs, finite
    params and statistics, each member's own obs statistics, steps counted per member."""
    agent, _ = _agents()
    state = agent.init_state([0, 1])
    w = torch.tensor([[0.9, 0.1], [0.1, 0.9]])
    loss = agent.train_iteration(state, w)
    assert loss.shape == (2,) and bool(torch.isfinite(loss).all())
    assert state.global_step == SMALL["steps_per_iteration"] and state.obs.shape == (2, 4, 17)
    assert all(bool(torch.isfinite(p).all()) for p in state.net.parameters())
    assert int(state.optimizer.step_count[0]) == SMALL["update_epochs"] * SMALL["num_minibatches"]
    assert not torch.equal(state.obs_norm.mean[0], state.obs_norm.mean[1])
    ret, disc = agent.policy_eval(state, torch.Generator().manual_seed(0), 2, w, max_steps=20)
    assert ret.shape == (2, 2) and bool(torch.isfinite(disc).all())


def test_moppo_discrete_iteration_smoke():
    """The categorical actor through a whole iteration on deep-sea-treasure:
    Gumbel-max actions in range, finite losses, an evaluation."""
    agent, _ = _agents("deep-sea-treasure-v0")
    state = agent.init_state([0, 1])
    loss = agent.train_iteration(state, agent.w)
    assert loss.shape == (2,) and bool(torch.isfinite(loss).all())
    a, _, _ = agent._dist(state.net, state.obs.float(), agent._noise(state))
    assert a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < agent.action_dim
    ret, _ = agent.policy_eval(state, torch.Generator().manual_seed(0), 2, max_steps=30)
    assert ret.shape == (2, 2) and bool(torch.isfinite(ret).all())


def test_stacked_moppo_tree_loads():
    """A population tree with a leading member axis (PGMORL's stacked states)
    fills a members net; member p's forward is the flax net's under ``jax.vmap``."""
    agent, jagent = _agents()
    P = 3
    params = jax.vmap(lambda k: jagent.net.init(k, jnp.zeros((1, 17))))(jax.random.split(jax.random.key(11), P))
    net = load_flax_params(agent.make_net(P), _np(params))
    obs = np.random.default_rng(7).normal(size=(P, 30, 17)).astype(np.float32)
    pi, _, v = jax.vmap(jagent.net.apply)(params, jnp.asarray(obs))
    tpi, _, tv = net(_t(obs))
    np.testing.assert_allclose(tpi.detach().numpy(), np.asarray(pi), atol=1e-6)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(v), atol=1e-6)


def test_moppo_train_iteration_parity():
    """A whole iteration (8 rollout steps of 4 envs, obs and reward
    normalization, GAE, 2 epochs of 2 minibatches) on mo-mountaincarcontinuous
    from the same params and env states, with the JAX key chain's action
    normals and permutations handed to the port: params atol 1e-5, the
    statistics rtol 1e-5 (float32 sums in another order, carried through 4
    Adam steps)."""
    agent, jagent = _agents("mo-mountaincarcontinuous-v0")
    js = jagent.init_state(jax.random.key(3))
    params = _flax_params(jagent, seed=2)
    js = js._replace(ts=js.ts.replace(params=params, opt_state=jagent.tx.init(params)))
    js2, _ = jagent.train_iteration(js, jnp.asarray(W))

    cfg = agent.cfg
    T, N = cfg.steps_per_iteration // cfg.num_envs, cfg.num_envs
    key, noises = js.key, []
    for _ in range(T):
        key, ka, _ = jax.random.split(key, 3)
        noises.append(_t(jax.random.normal(ka, (N, 1)))[None])
    perms = torch.stack([_t(jax.random.permutation(k, T * N))[None] for k in jax.random.split(key, cfg.update_epochs)])

    state = agent.init_state(0)
    load_flax_params(state.net, _np(params))
    state.env_state = type(state.env_state)(*(_t(x) for x in js.env_state))
    state.obs = _t(js.obs)[None]
    agent._noise = lambda s: noises.pop(0)
    agent.update(state, agent.rollout(state, _t(W)[None]), perms)
    assert not noises

    _assert_trees(to_flax_params(state.net), js2.ts.params["params"], atol=1e-5)
    for a, b in ((state.obs_norm, js2.obs_norm), (state.rew_norm, js2.rew_norm)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x[0].numpy(), np.asarray(y), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(state.obs[0].numpy(), np.asarray(js2.obs), rtol=1e-6)
