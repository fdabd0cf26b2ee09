"""Parity of the torch port's continuous GPI-LS with the JAX package's, and its smoke checks.

Actor and critic params and batch statistics come from the flax init (the
statistics set to random values with ``steps`` past ``warmup_steps``, the
targets from another init) and are carried across with
``load_flax_variables``; batches and weights are made with numpy from a
seed, and the target-smoothing noise is read off the JAX key and handed to
the port.  Dropout is 0 so that both draw no masks.  Tolerance: atol 1e-5
on the target, the loss, the grads, the params and statistics after Adam
and after Polyak, and the PER priorities (float32 sums in another order);
step counters exactly.  One exception, after Adam: a parameter whose
gradient vanishes (|g| < 1e-6; e.g. the bias of a unit that stays on one
side of the leaky-relu for the whole batch, ahead of a train-mode
BatchRenorm that removes constant shifts) moves by lr * g / (|g| + 1e-8),
which turns float32 noise of 1e-9 in g into a step anywhere in [-lr, lr];
such elements are held to within 2 * lr.  Both packages are resynced from
the JAX state after each update.  The whole slice: GPI-evaluated fronts on
the hopper (deterministic resets) rtol 1e-4 and atol 1e-4, their metrics
rtol 1e-4 (whole episodes of float32 dynamics, GPI argmaxes on the way).
The learning threshold is the JAX test's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import GPILSContinuous, GPILSContinuousConfig
from morl_baselines_torch.core.weights import equally_spaced_weights
from morl_baselines_torch.envs import make
from morl_baselines_torch.evaluation import multi_policy_metrics
from morl_baselines_torch.models import load_flax_variables, to_flax_params, to_flax_variables
from morl_baselines_torch.replay import Transition
from morl_baselines_tpu.agents import GPILSContinuous as JGPILSContinuous
from morl_baselines_tpu.agents import GPILSContinuousConfig as JGPILSContinuousConfig
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.evaluation import multi_policy_metrics as j_metrics
from morl_baselines_tpu.replay import Transition as JTransition

torch.set_num_threads(1)
ATOL = 1e-5
SMALL = dict(num_envs=4, buffer_size=256, batch_size=32, hidden=(32, 32), max_support=4, dropout_rate=0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees(port, flax, atol=ATOL):
    flax = _np(flax)
    assert jax.tree.structure(port) == jax.tree.structure(flax)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(port)[0], jax.tree.leaves(flax)):
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=jax.tree_util.keystr(path))


def _assert_after_adam(port, want, grads, lr):
    """Params after an Adam step: atol 1e-5 where |grad| >= 1e-6, within 2 * lr elsewhere."""
    want, grads = _np(want), _np(grads)
    for (path, a), b, g in zip(jax.tree_util.tree_flatten_with_path(port)[0], jax.tree.leaves(want), jax.tree.leaves(grads)):
        live = np.abs(g) >= 1e-6
        np.testing.assert_allclose(a[live], b[live], atol=ATOL, err_msg=jax.tree_util.keystr(path))
        assert np.all(np.abs(a[~live] - b[~live]) <= 2 * lr), jax.tree_util.keystr(path)


def _random_stats(stats, rng):
    def leaf(path, x):
        name = path[-1].key
        if name == "steps":
            return np.full(x.shape, 100_001, np.int32)
        if name == "mean":
            return rng.normal(scale=0.3, size=x.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _np(stats))


def _agents(**kw):
    cfg = dict(SMALL, **kw)
    jagent = JGPILSContinuous(jmake("mo-hopper-jx-v5"), JGPILSContinuousConfig(**cfg))
    tagent = GPILSContinuous(make("mo-hopper-jx-v5", device="cpu"), GPILSContinuousConfig(**cfg), device="cpu")
    return jagent, tagent


def _carried_states(jagent, tagent, seed=0):
    """A JAX state with random batch statistics and separate targets, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    jstate = jagent.init_state(jax.random.key(seed))
    other = jagent.init_state(jax.random.key(seed + 100))
    tstate = tagent.init_state()
    ts = {}
    for name, t in (("actor_ts", tstate.actor), ("critic_ts", tstate.critic)):
        jts, jother = getattr(jstate, name), getattr(other, name)
        bs = _random_stats(jts.batch_stats, rng)
        tbs = _random_stats(jts.batch_stats, rng)
        ts[name] = jts.replace(batch_stats=bs, target_params=jother.params, target_batch_stats=tbs)
        load_flax_variables(t.net, {"params": _np(jts.params), "batch_stats": bs})
        load_flax_variables(t.target_net, {"params": _np(jother.params), "batch_stats": tbs})
    return jstate._replace(**ts), tstate


def _batch(rng, b, obs_dim=11, a=3, d=3):
    return dict(
        obs=rng.normal(size=(b, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, size=(b, a)).astype(np.float32),
        reward=rng.normal(size=(b, d)).astype(np.float32),
        next_obs=rng.normal(size=(b, obs_dim)).astype(np.float32),
        terminated=(rng.uniform(size=b) < 0.3).astype(np.float32),
    )


def test_update_parity():
    """Two consecutive updates, the first on a ``policy_freq`` iteration: the
    target, the critic loss and grads, the params and batch statistics after
    Adam, the actor's grads and update, the targets after Polyak and the PER
    priorities; the second leaves the actor alone."""
    jagent, tagent = _agents(batch_size=24)
    jstate, tstate = _carried_states(jagent, tagent)
    cfg = jagent.cfg
    rng = np.random.default_rng(1)
    for it in (2, 3):  # policy_freq 2: the actor updates on the first only
        b = _batch(rng, 24)
        w = rng.dirichlet(np.ones(3), size=24).astype(np.float32)
        jb = JTransition(**{k: jnp.asarray(v) for k, v in b.items()})
        jw = jnp.asarray(w)
        key = jax.random.key(10 + it)
        noise = np.array(jax.random.normal(jax.random.split(key, 3)[0], (24, 3)))

        # the JAX package's target, critic loss and grads, recomputed outside its jit
        ats, cts = jstate.actor_ts, jstate.critic_ts
        n = jnp.clip(jnp.asarray(noise) * cfg.policy_noise, -cfg.noise_clip, cfg.noise_clip)
        next_a = jnp.clip(jagent._actor_fwd(ats, jb.next_obs, jw, target=True) + n, -1.0, 1.0)
        q_next = jagent._critic_fwd(cts, jb.next_obs, next_a, jw, target=True)
        min_q = jnp.take_along_axis(q_next, jnp.argmin(jnp.einsum("cbd,bd->cb", q_next, jw), 0)[None, :, None], 0)[0]
        jtarget = jb.reward + (1.0 - jb.terminated[:, None]) * cfg.gamma * min_q

        def closs(p):
            q, _ = jagent.critic.apply({"params": p, "batch_stats": cts.batch_stats}, jb.obs, jb.action, jw, True, False,
                                       mutable=["batch_stats"])
            return jnp.mean((q - jtarget[None]) ** 2)

        jloss, jcgrads = jax.value_and_grad(closs)(cts.params)
        jstate2, jtd = jagent._update(jstate._replace(iter_count=jnp.int32(it)), jb, jw, key)

        tb = Transition(**{k: torch.as_tensor(v) for k, v in b.items()})
        tstate.iter_count = it
        np.testing.assert_allclose(tagent.td_target(tstate, tb, torch.as_tensor(w), torch.as_tensor(noise)).numpy(),
                                   np.asarray(jtarget), atol=ATOL)
        actor_before = to_flax_variables(tstate.actor.net)
        ttd = tagent._update(tstate, tb, torch.as_tensor(w), torch.as_tensor(noise))
        np.testing.assert_allclose(float(tstate.loss), float(jloss), rtol=ATOL, atol=ATOL)
        _assert_trees(to_flax_params(tstate.critic.net, grads=True), jcgrads)
        np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), atol=ATOL)
        grads = {"critic_ts": jcgrads}
        if it % cfg.policy_freq == 0:

            def aloss(p):
                a, _ = jagent.actor.apply({"params": p, "batch_stats": ats.batch_stats}, jb.obs, jw, True, mutable=["batch_stats"])
                q = jagent._critic_fwd(jstate2.critic_ts, jb.obs, a, jw)
                return -jnp.mean(jnp.einsum("bd,bd->b", q.mean(axis=0), jw))

            grads["actor_ts"] = jax.grad(aloss)(ats.params)
            _assert_trees(to_flax_params(tstate.actor.net, grads=True), grads["actor_ts"])
        else:
            _assert_trees(to_flax_variables(tstate.actor.net), actor_before, atol=0.0)
        for name, t in (("actor_ts", tstate.actor), ("critic_ts", tstate.critic)):
            jts = getattr(jstate2, name)
            got = to_flax_variables(t.net)
            if name in grads:
                _assert_after_adam(got["params"], jts.params, grads[name], cfg.learning_rate)
            else:
                _assert_trees(got["params"], jts.params)
            _assert_trees(got["batch_stats"], jts.batch_stats)
            tgt = to_flax_variables(t.target_net)
            _assert_trees(tgt["params"], jts.target_params, atol=ATOL + 2 * cfg.tau * cfg.learning_rate)
            _assert_trees(tgt["batch_stats"], jts.target_batch_stats)
            load_flax_variables(t.net, {"params": _np(jts.params), "batch_stats": _np(jts.batch_stats)})
            load_flax_variables(t.target_net, {"params": _np(jts.target_params), "batch_stats": _np(jts.target_batch_stats)})
        jstate = jstate2


def test_gpi_actions_parity():
    """The GPI evaluation action over a 3-row support, against ``act_eval``
    (which masks the padded support rows)."""
    jagent, tagent = _agents()
    jstate, tstate = _carried_states(jagent, tagent, seed=3)
    support = np.zeros((4, 3), np.float32)
    support[:3] = equally_spaced_weights(3, 3)
    jstate = jstate._replace(support=jnp.asarray(support), support_size=jnp.int32(3))
    tagent.set_weight_support(tstate, list(support[:3]))
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(32, 11)).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=32).astype(np.float32)
    want = np.asarray(jax.vmap(lambda o, ww: jagent.act_eval(jstate, o, ww))(jnp.asarray(obs), jnp.asarray(w)))
    got = tagent.act_eval(tstate, torch.as_tensor(obs), torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_slice_front_and_metrics_parity():
    """The whole slice on the hopper with its reset noise off: a JAX-initialised
    actor and critic, trained a little by the port (so that the policies
    differ per weight) and carried back, give the same GPI-evaluated front
    (8 weights, a 3-weight support, up to 200 steps, every episode ending
    before) and the same multi-policy metrics as ``eval_weights_values``."""
    jagent, tagent = _agents(num_envs=8, buffer_size=1024, learning_starts=64, dropout_rate=0.01)
    jagent.env.reset_noise = tagent.env.reset_noise = 0.0
    jstate = jagent.init_state(jax.random.key(0))
    tstate = tagent.init_state()
    for name, t in (("actor_ts", tstate.actor), ("critic_ts", tstate.critic)):
        jts = getattr(jstate, name)
        load_flax_variables(t.net, {"params": _np(jts.params), "batch_stats": _np(jts.batch_stats)})
    support = list(equally_spaced_weights(3, 3))
    tagent.set_weight_support(tstate, support)
    tagent.train_segment(tstate, 40)
    carried = {}
    for name, t in (("actor_ts", tstate.actor), ("critic_ts", tstate.critic)):
        v = jax.tree.map(jnp.asarray, to_flax_variables(t.net))
        carried[name] = getattr(jstate, name).replace(params=v["params"], batch_stats=v["batch_stats"])
    jstate = jagent.set_weight_support(jstate._replace(**carried), support)

    weights = equally_spaced_weights(3, 8).astype(np.float32)
    jfront = np.asarray(jagent.eval_weights_values(jstate, jnp.asarray(weights), 1, 200))
    tfront = tagent.eval_weights_values(tstate, weights, 1, 200).numpy()
    assert tfront.shape == (8, 3) and len(np.unique(tfront.round(3), axis=0)) >= 4
    np.testing.assert_allclose(tfront, jfront, rtol=1e-4, atol=1e-4)
    ref = np.array([-100.0, -100.0, -100.0])
    want, got = j_metrics(jfront, ref, weights), multi_policy_metrics(tfront, ref, weights)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)

def test_train_segment_bookkeeping():
    """Random actions before ``learning_starts``, then the actor; counters,
    buffer, per-episode weight resampling and finite params; the plain ReLU nets too."""
    for use_brn in (True, False):
        _, tagent = _agents(learning_starts=32, use_batch_renorm=use_brn)
        state = tagent.init_state()
        tagent.set_weight_support(state, list(equally_spaced_weights(3, 4)))
        tagent.train_segment(state, 12)
        assert state.global_step == 48 and state.iter_count == 12 and state.buffer.size == 48
        assert np.isfinite(float(state.loss))
        assert all(bool(torch.isfinite(p).all()) for p in state.critic.net.parameters())
        if use_brn:
            assert int(state.critic.net.norms[0].steps[0]) == 5  # 5 updates at global_step 32..48
            assert int(state.actor.net.norms[0].steps) == 3  # iter_count 8, 10 and 12 (policy_freq 2)


def test_gpils_continuous():
    """Mirror of tests/test_agents_multi.py::test_gpils_continuous on the port."""
    envc = make("mo-mountaincarcontinuous-v0")
    gc = GPILSContinuous(envc, GPILSContinuousConfig(
        num_envs=4, buffer_size=1024, batch_size=16, learning_starts=32, hidden=(16, 16), max_support=4), device="cpu")
    gc.train(total_timesteps=400, ref_point=np.array([-1100.0, -110.0]), timesteps_per_iter=200,
             num_eval_weights_for_front=2, eval_max_steps=30)
    assert len(gc._linear_support.ccs) >= 1


def test_gpils_continuous_learns():
    """Mirror of tests/test_agents_multi.py::test_gpils_continuous_learns: on
    water-reservoir the BatchRenorm/WeightNorm TD3 recipe beats the random
    policy's scalarized utility (about -430 at w = (.5, .5)).

    The port draws other random numbers than the JAX package, so a seed is
    not the JAX seed.  Over seeds 0-7 of the port, six reach -265 to -284
    (the JAX package: -317 at its seed 0); seeds 0 and 2 fall into the
    release-nothing policy at every weight (about -1400 on the demand
    objective), a collapse the JAX package shows too (seed 3, one weight).
    The test runs seed 1."""
    env = make("water-reservoir-v0")
    cfg = GPILSContinuousConfig(num_envs=8, buffer_size=8192, batch_size=64, hidden=(64, 64),
                                learning_starts=500, gradient_updates=1, max_support=8, seed=1)
    agent = GPILSContinuous(env, cfg, device="cpu")
    agent.train(total_timesteps=6000, ref_point=np.array([-5.0, -5.0]),
                timesteps_per_iter=2000, num_eval_weights_for_front=4, eval_max_steps=100)
    front = agent._last_front
    w = np.array([0.5, 0.5])
    assert max(float(w @ v) for v in front) > -380.0
    assert max(float(v[0]) for v in front) >= -1.0
