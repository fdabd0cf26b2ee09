"""Parity of the torch port's dynamics ensemble and GPI-PD with the JAX package's.

Ensemble and critic params come from the flax init and are carried across
with ``load_flax_params``; inputs, batches, the elite choice and the sample
noise are made with numpy (or read off the JAX key) and handed to both.
Tolerances: float32 forwards, predictions, the envelope target, GTD errors,
priorities, losses and params after an Adam step atol 1e-5 (rtol 1e-5 where
the values are large: a Gaussian NLL with log-variance down to -10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morl_baselines_torch.agents import GPIPD, GPIPDConfig
from morl_baselines_torch.core.weights import equally_spaced_weights
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import dynamics as tdyn
from morl_baselines_torch.models import load_flax_params, to_flax_params
from morl_baselines_torch.replay import Transition
from morl_baselines_tpu.agents import GPIPD as JGPIPD
from morl_baselines_tpu.agents import GPIPDConfig as JGPIPDConfig
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.models import dynamics as jdyn
from morl_baselines_tpu.replay import Transition as JTransition

torch.set_num_threads(1)
ATOL = 1e-5


def _ensembles(members=3, elites=2, in_dim=9, out_dim=10, hidden=(32, 32)):
    jcfg = jdyn.EnsembleConfig(num_members=members, num_elites=elites, hidden=hidden, batch_size=16)
    tcfg = tdyn.EnsembleConfig(num_members=members, num_elites=elites, hidden=hidden, batch_size=16)
    return jdyn.ProbabilisticEnsemble(in_dim, out_dim, jcfg), tdyn.ProbabilisticEnsemble(in_dim, out_dim, tcfg, device="cpu")


def _carry(jens, tens, seed=0):
    jst = jens.init_state(jax.random.key(seed))
    tst = tens.init_state()
    load_flax_params(tst.net, jax.tree.map(np.asarray, jst.ts.params))
    return jst, tst


def _assert_trees_close(port_tree, flax_tree, atol=ATOL, rtol=0.0):
    flax_tree = flax_tree.get("params", flax_tree)
    assert jax.tree.structure(port_tree) == jax.tree.structure(jax.tree.map(np.asarray, flax_tree))
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(flax_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def test_gaussian_ensemble_forward_and_predict_parity():
    """The E-member forward (means and bounded log-variances), and ``predict``
    with the same elite choice and noise: the sample and the uncertainty."""
    jens, tens = _ensembles()
    jst, tst = _carry(jens, tens)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 9)).astype(np.float32)
    jm, jlv = jens._apply_shared(jst.ts.params, jnp.asarray(x))
    tm, tlv = tst.net(torch.as_tensor(x))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), atol=ATOL)
    np.testing.assert_allclose(tlv.detach().numpy(), np.asarray(jlv), atol=ATOL)
    _assert_trees_close(to_flax_params(tst.net), jst.ts.params, atol=0.0)

    in_mean, in_std = rng.normal(size=9).astype(np.float32), rng.uniform(0.5, 2, size=9).astype(np.float32)
    elites = np.array([2, 0])
    jst = jst._replace(in_mean=jnp.asarray(in_mean), in_std=jnp.asarray(in_std), elite_idx=jnp.asarray(elites))
    tst.in_mean, tst.in_std, tst.elite_idx = torch.as_tensor(in_mean), torch.as_tensor(in_std), torch.as_tensor(elites)
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    choice = np.asarray(jst.elite_idx[jax.random.randint(k1, (40,), 0, 2)])
    noise = np.asarray(jax.random.normal(k2, (40, 10)))
    jsample, junc = jens.predict(jst, jnp.asarray(x), key)
    tsample, tunc = tens.predict(tst, torch.as_tensor(x), choice=torch.as_tensor(choice), noise=torch.as_tensor(noise))
    np.testing.assert_allclose(tsample.numpy(), np.asarray(jsample), atol=ATOL)
    np.testing.assert_allclose(tunc.numpy(), np.asarray(junc), atol=ATOL)


@pytest.mark.parametrize("row_weighted", [False, True])
def test_fit_step_parity(row_weighted):
    """Two steps of ``fit_converged``'s batch update on a fixed (E, B) batch:
    the Gaussian NLL summed over members, optax ``add_decayed_weights`` on the
    kernels only, then Adam — loss and params."""
    jens, tens = _ensembles()
    jst, tst = _carry(jens, tens, seed=1)
    rng = np.random.default_rng(1)
    wd = 1e-2  # large, so that a decay on the wrong leaves would show
    tx = optax.chain(optax.add_decayed_weights(wd, mask=jens._decay_mask), optax.adam(jens.cfg.learning_rate))
    params = jst.ts.params
    opt_state = tx.init(params)
    topt = tens.make_optimizer(tst.net, wd)
    for _ in range(2):
        xb = rng.normal(size=(3, 16, 9)).astype(np.float32)
        yb = rng.normal(size=(3, 16, 10)).astype(np.float32)
        rw = rng.uniform(0.5, 2.0, size=(3, 16)).astype(np.float32) if row_weighted else None

        def loss_fn(p):
            mean, logvar = jens._apply_per_member(p, jnp.asarray(xb))
            nll = 0.5 * (((mean - yb) ** 2) * jnp.exp(-logvar) + logvar)
            if rw is not None:
                nll = nll * rw[..., None]
            return jnp.sum(jnp.mean(nll, axis=(1, 2)))

        jloss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tloss = tens.fit_step(tst.net, topt, torch.as_tensor(xb), torch.as_tensor(yb), None if rw is None else torch.as_tensor(rw))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL)
        _assert_trees_close(to_flax_params(tst.net), params)


def test_termination_fns_parity():
    rng = np.random.default_rng(2)
    obs = rng.uniform(-0.3, 0.3, size=(512, 7)).astype(np.float32)
    obs[:, 5:7] *= rng.uniform(size=(512, 1)) < 0.5
    nxt = rng.uniform(-0.3, 0.3, size=(512, 7)).astype(np.float32)
    nxt[:, 0] = rng.uniform(0.4, 1.0, size=512)  # the hopper's height around its threshold
    rew = rng.uniform(-0.5, 0.5, size=(512, 3)).astype(np.float32)
    for name in ("false", "dst", "hopper", "mountaincar", "minecart"):
        jfn, tfn = getattr(jdyn, f"termination_fn_{name}"), getattr(tdyn, f"termination_fn_{name}")
        for r in (rew, None) if name == "minecart" else (rew,):
            want = np.asarray(jfn(jnp.asarray(obs), None, jnp.asarray(nxt), None if r is None else jnp.asarray(r)))
            got = tfn(torch.as_tensor(obs), None, torch.as_tensor(nxt), None if r is None else torch.as_tensor(r)).numpy()
            np.testing.assert_array_equal(got, want)
    for env_id in ("minecart-v0", "deep-sea-treasure-v0", "mo-hopper-v4", "mo-mountaincarcontinuous-v0", "fishwood-v0"):
        assert tdyn.get_termination_fn(env_id).__name__ == jdyn.get_termination_fn(env_id).__name__


def test_ensemble_fit_best_on_holdout():
    """Mirror of tests/test_extras.py::test_ensemble_fit_best_on_holdout on the port."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(2048, 3)).astype(np.float32)
    Y = np.stack([X[:, 0] + X[:, 1], X[:, 2] * 2.0], axis=-1).astype(np.float32)
    ens = tdyn.ProbabilisticEnsemble(
        3, 2, tdyn.EnsembleConfig(num_members=3, num_elites=2, hidden=(64, 64), epochs=15, batch_size=128), device="cpu"
    )
    gen = torch.Generator().manual_seed(1)
    st, loss = ens.fit(ens.init_state(0), torch.as_tensor(X), torch.as_tensor(Y), gen)
    sample, unc = ens.predict(st, torch.as_tensor(X[:64]), gen)
    err = float(np.mean(np.abs(sample.numpy() - Y[:64])))
    assert err < 0.25, err
    assert tuple(unc.shape) == (64,)
    assert int(st.elite_idx.shape[0]) == 2 and np.isfinite(float(loss))


def test_ensemble_fit_converged():
    """Mirror of tests/test_extras.py::test_ensemble_fit_converged on the port:
    stops before max_epochs on an easy map, masks padded rows, learns the map."""
    rng = np.random.default_rng(1)
    cap, n = 4096, 3000
    X = np.zeros((cap, 3), dtype=np.float32)
    X[:n] = rng.uniform(-1, 1, size=(n, 3))
    X[n:] = 1e6  # padding rows carry garbage that must not leak into the fit
    Y = np.zeros((cap, 2), dtype=np.float32)
    Y[:n] = np.stack([X[:n, 0] + X[:n, 1], X[:n, 2] * 2.0], axis=-1) + 0.1 * rng.standard_normal((n, 2)).astype(np.float32)
    Y[n:] = -1e6
    ens = tdyn.ProbabilisticEnsemble(
        3, 2, tdyn.EnsembleConfig(num_members=3, num_elites=2, hidden=(64, 64), batch_size=128, max_epochs=60, patience=3),
        device="cpu",
    )
    gen = torch.Generator().manual_seed(1)
    st, mse, epochs = ens.fit_converged(ens.init_state(0), torch.as_tensor(X), torch.as_tensor(Y), n, gen)
    assert 0 < epochs < 60, epochs
    sample, _ = ens.predict(st, torch.as_tensor(X[:64]), gen)
    err = float(np.mean(np.abs(sample.numpy() - Y[:64])))
    assert err < 0.4, err
    assert float(mse) < 0.1, float(mse)
    assert bool(torch.isfinite(sample).all())


def test_minecart_model_termination():
    """Mirror of tests/test_extras.py::test_minecart_model_termination on the port."""
    fn = tdyn.get_termination_fn("minecart-v0")
    out_with_cargo = [0.5, 0.5, 0.1, 0.0, 1.0, 0.4, 0.3]
    out_no_cargo = [0.5, 0.5, 0.1, 0.0, 1.0, 0.0, 0.0]
    in_base = [0.05, 0.05, 0.1, 0.0, 1.0, 0.4, 0.3]
    out_ore0_only = [0.5, 0.5, 0.1, 0.0, 1.0, 0.8, 0.0]
    obs = torch.tensor([out_with_cargo, out_no_cargo, in_base, out_ore0_only])
    nxt = torch.tensor([in_base] * 4)
    assert fn(obs, None, nxt).tolist() == [True, False, False, True]
    far = torch.tensor([out_with_cargo] * 2)
    rew = torch.tensor([[0.6, 0.2, -1.0], [0.0, 0.0, -1.0]])
    assert fn(far, None, far, rew).tolist() == [True, False]


# ------------------------------------------------------------------ GPI-PD

SMALL = dict(
    num_envs=8, buffer_size=64, batch_size=16, hidden=(32, 32), max_support=8, dropout_rate=0.0, dyna_buffer_size=64,
)


def _agents(**kw):
    cfg = dict(SMALL, **kw)
    jens = jdyn.EnsembleConfig(num_members=2, num_elites=1, hidden=(16, 16))
    tens = tdyn.EnsembleConfig(num_members=2, num_elites=1, hidden=(16, 16))
    jagent = JGPIPD(jmake("minecart-v0"), JGPIPDConfig(ensemble=jens, **cfg))
    tagent = GPIPD(make("minecart-v0"), GPIPDConfig(ensemble=tens, **cfg), device="cpu")
    return jagent, tagent


def _q_params(jagent, seed):
    dummy = jnp.zeros((1, jagent.obs_dim)), jnp.zeros((1, jagent.reward_dim))
    return jagent.q_net.init(jax.random.key(seed), *dummy, True)


def _support(rng, size=5):
    support = np.zeros((8, 3), np.float32)
    support[:size] = rng.dirichlet(np.ones(3), size=size)
    return support


def _batch(rng, b):
    return dict(
        obs=rng.uniform(0, 1, size=(b, 7)).astype(np.float32),
        action=rng.integers(0, 6, size=b),
        reward=rng.normal(size=(b, 3)).astype(np.float32),
        next_obs=rng.uniform(0, 1, size=(b, 7)).astype(np.float32),
        terminated=(rng.uniform(size=b) < 0.3).astype(np.float32),
    )


def test_envelope_target_parity():
    jagent, tagent = _agents(n_critics=3)
    params = _q_params(jagent, 1)
    net = load_flax_params(tagent.make_q_net(), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(4)
    next_obs = rng.uniform(size=(48, 7)).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=48).astype(np.float32)
    support = _support(rng)
    want = np.asarray(jagent._envelope_target(params, jnp.asarray(next_obs), jnp.asarray(w), jnp.asarray(support), 5))
    got = tagent._envelope_target(net, torch.as_tensor(next_obs), torch.as_tensor(w), torch.as_tensor(support[:5]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("gpi_pd", [True, False])
def test_update_pd_parity(gpi_pd):
    """``_update_pd``: loss, the TD priority base and the envelope-target GTD
    priority base, and the params after the step."""
    jagent, tagent = _agents(gpi_pd=gpi_pd)
    params, tparams = _q_params(jagent, 2), _q_params(jagent, 3)
    jts = jagent.init_state(jax.random.key(0)).base.ts.replace(params=params, target_params=tparams)
    tts = tagent.make_train_state(load_flax_params(tagent.make_q_net(), jax.tree.map(np.asarray, params)))
    load_flax_params(tts.target_net, jax.tree.map(np.asarray, tparams))
    rng = np.random.default_rng(5)
    b = _batch(rng, 16)
    w = rng.dirichlet(np.ones(3), size=16).astype(np.float32)
    support = _support(rng, 4)
    jts, jloss, jtd_w, jgtd_w = jagent._update_pd(
        jts, JTransition(**{k: jnp.asarray(v) for k, v in b.items()}), jnp.asarray(w), jnp.asarray(support), 4,
        jax.random.key(9),
    )
    tloss, ttd_w, tgtd_w = tagent._update_pd(
        tts, Transition(**{k: torch.as_tensor(v) for k, v in b.items()}), torch.as_tensor(w),
        torch.as_tensor(support[:4]), torch.Generator().manual_seed(0),
    )
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(ttd_w.numpy(), np.asarray(jtd_w), atol=ATOL)
    np.testing.assert_allclose(tgtd_w.numpy(), np.asarray(jgtd_w), atol=ATOL)
    _assert_trees_close(to_flax_params(tts.net), jts.params)


@pytest.mark.parametrize("gpi_pd", [True, False])
def test_recompute_priorities_parity(gpi_pd):
    """The priorities of a partly filled PER buffer recomputed against a new
    task weight: chunked (the port in chunks of 16 rows), the first critic,
    0 beyond ``size``, the running max floored at min_priority ** alpha."""
    jagent, tagent = _agents(gpi_pd=gpi_pd)
    params, tparams = _q_params(jagent, 6), _q_params(jagent, 7)
    rng = np.random.default_rng(6)
    data, size = _batch(rng, 64), 50
    support = list(equally_spaced_weights(3, 4))
    w = rng.dirichlet(np.ones(3)).astype(np.float32)

    jstate = jagent.init_state(jax.random.key(0))
    base = jagent.set_weight_support(jstate.base, support)
    jbuf = base.buffer._replace(
        data=JTransition(**{k: jnp.asarray(v) for k, v in data.items()}), size=jnp.int32(size), ptr=jnp.int32(size)
    )
    base = base._replace(ts=base.ts.replace(params=params, target_params=tparams), buffer=jbuf)
    jstate = jagent.recompute_priorities(jstate._replace(base=base), jnp.asarray(w))

    tstate = tagent.init_state()
    tagent.set_weight_support(tstate.base, support)
    load_flax_params(tstate.base.ts.net, jax.tree.map(np.asarray, params))
    load_flax_params(tstate.base.ts.target_net, jax.tree.map(np.asarray, tparams))
    buf = tstate.base.buffer
    buf.data = Transition(**{k: torch.as_tensor(v, dtype=x.dtype) for (k, v), x in zip(data.items(), buf.data)})
    buf.size = buf.ptr = size
    tagent.recompute_chunk = 16
    tagent.recompute_priorities(tstate, torch.as_tensor(w))
    np.testing.assert_allclose(buf.priorities.numpy(), np.asarray(jstate.base.buffer.priorities), atol=ATOL)
    assert float(buf.priorities[size:].abs().max()) == 0.0
    np.testing.assert_allclose(float(buf.max_priority), float(jstate.base.buffer.max_priority), atol=ATOL)


def test_rollout_keep_filter():
    """Imagined rows above the uncertainty threshold are written as copies of
    the first kept row, terminated rows are not stepped again, and nothing is
    written when no row is kept (the JAX package's static-shape filter)."""
    _, tagent = _agents(dynamics_rollout_starts=6, dynamics_rollout_len=2, dynamics_uncertainty_threshold=0.5)
    state = tagent.init_state()
    tagent.train_segment_pd(state, 4)  # 32 real rows to start from
    steps = iter([
        (torch.tensor([0.9, 0.1, 0.2, 0.9, 0.3, 0.1]), torch.tensor([False, False, True, False, False, False])),
        (torch.tensor([0.1, 0.1, 0.1, 0.1, 0.1, 0.9]), torch.zeros(6, dtype=torch.bool)),
        (torch.ones(6), torch.zeros(6, dtype=torch.bool)),
        (torch.ones(6), torch.zeros(6, dtype=torch.bool)),
    ])

    def fake_step(ens, obs, actions, gen):
        unc, term = next(steps)
        return obs + 1.0, torch.full((obs.shape[0], 3), 7.0) + unc[:, None], term, unc

    tagent.model_env.step = fake_step
    tagent.rollout_dynamics(state)
    dyna = state.dyna_buffer
    assert dyna.size == 12 and dyna.ptr == 12
    rew = dyna.data.reward[:, 0]
    # step 1 keeps rows 1, 2, 4, 5; rows 0 and 3 copy row 1
    np.testing.assert_allclose(rew[:6].numpy(), 7.0 + np.array([0.1, 0.1, 0.2, 0.1, 0.3, 0.1]), rtol=1e-6)
    assert dyna.data.terminated[:6].tolist() == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    # step 2: row 2 has terminated and row 5 is too uncertain; both copy row 0
    np.testing.assert_allclose(rew[6:12].numpy(), np.full(6, 7.1), rtol=1e-6)
    tagent.rollout_dynamics(state)
    assert dyna.size == 12 and dyna.ptr == 12


def test_gpipd_model_based():
    """Mirror of tests/test_agents_multi.py::test_gpipd_model_based on the port,
    and the diagnostic metric keys of the JAX package."""
    env = make("deep-sea-treasure-v0")
    cfg = GPIPDConfig(
        num_envs=8, buffer_size=2048, batch_size=32, hidden=(32, 32),
        learning_starts=100, gradient_updates=1, epsilon_decay_steps=500,
        target_net_update_freq=50, max_support=8, per=True, dyna=True,
        dynamics_train_freq=40, dynamics_fit_samples=256, dynamics_rollout_starts=32,
        dyna_buffer_size=1024,
        ensemble=tdyn.EnsembleConfig(num_members=2, num_elites=1, epochs=2, hidden=(32, 32), batch_size=32),
    )
    agent = GPIPD(env, cfg, device="cpu")
    state = agent.train(total_timesteps=1000, ref_point=np.array([0.0, -50.0]), timesteps_per_iter=500,
                        num_eval_weights_for_front=4, eval_max_steps=40)
    assert int(state.dyna_buffer.size) > 0
    assert len(agent._linear_support.ccs) >= 1
    assert set(agent._diagnostics(state)) >= {
        "diag/buffer_positive_reward_rows", "diag/buffer_size", "diag/mean_priority_all",
        "diag/dyna_size", "diag/dyna_positive_reward_rows", "diag/dyna_terminated_rows",
    }


def test_gpipd_fixed_budget_warmup_and_plain_priorities():
    """The fixed-budget fit, the single-update warm-up and TD priorities
    (gpi_pd=False) keep the bookkeeping right."""
    _, tagent = _agents(
        buffer_size=256, learning_starts=32, gradient_updates=3, gpi_pd=False, full_updates_after=120,
        dynamics_fit_to_convergence=False, dynamics_fit_samples=64, dynamics_rollout_starts=16,
    )
    state = tagent.init_state()
    tagent.set_weight_support(state.base, list(equally_spaced_weights(3, 4)))
    calls = []
    update_pd = tagent._update_pd
    tagent._update_pd = lambda *a, **k: calls.append(state.base.global_step) or update_pd(*a, **k)
    tagent.train_segment_pd(state, 20)
    # 1 update per learning iteration below 120 env steps, 3 from there on
    assert calls.count(32) == 1 and calls.count(112) == 1 and calls.count(120) == 3 and calls.count(160) == 3
    state, loss = tagent.fit_dynamics(state)
    assert np.isfinite(float(loss)) and int(state.ens.elite_idx.shape[0]) == 1
    state, unc = tagent.rollout_dynamics(state)
    assert np.isfinite(float(unc))
    assert float(state.base.buffer.priorities[:160].min()) >= 0.01**0.6 - 1e-7
