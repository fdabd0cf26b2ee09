"""Parity of the torch port's GPI-LS with the JAX package's, and its smoke checks.

Critic params come from the flax init and are carried across with
``load_flax_params``; batches, weights and observations are made with numpy
from a seed and handed to both.  Tolerances: the float32 ensemble forward,
DroQ target, TD errors, loss, grads and params after one Adam step atol 1e-5
(float32 matmuls sum in another order); the bfloat16 forward atol 3e-2 x
max|Q| (each bf16 GEMM rounds its output to 8 bits of mantissa); evaluated
fronts atol 1e-4 and their metrics rtol 1e-4 (200 steps of float32 dynamics
and greedy argmaxes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morl_baselines_torch.agents import GPILS, GPILSConfig
from morl_baselines_torch.core.weights import equally_spaced_weights
from morl_baselines_torch.envs import make
from morl_baselines_torch.evaluation import multi_policy_metrics
from morl_baselines_torch.models import load_flax_params, to_flax_params
from morl_baselines_torch.replay import Transition
from morl_baselines_tpu.agents import GPILS as JGPILS
from morl_baselines_tpu.agents import GPILSConfig as JGPILSConfig
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.evaluation import multi_policy_metrics as j_metrics
from morl_baselines_tpu.models.networks import WeightConditionedQNet as JWCQNet
from morl_baselines_tpu.models.networks import ensemble as j_ensemble
from morl_baselines_tpu.replay import Transition as JTransition

torch.set_num_threads(1)
ATOL = 1e-5

SMALL = dict(num_envs=8, buffer_size=512, batch_size=16, hidden=(32, 32), max_support=8)


def _agents(env_id="minecart-v0", **kw):
    cfg = dict(SMALL, **kw)
    return JGPILS(jmake(env_id), JGPILSConfig(**cfg)), GPILS(make(env_id), GPILSConfig(**cfg), device="cpu")


def _flax_params(jagent, seed):
    dummy = jnp.zeros((1, jagent.obs_dim)), jnp.zeros((1, jagent.reward_dim))
    return jagent.q_net.init(jax.random.key(seed), *dummy, True)


def _to_torch(tagent, params):
    return load_flax_params(tagent.make_q_net(), jax.tree.map(np.asarray, params))


def _assert_trees_close(port_tree, flax_tree, atol=ATOL):
    flax_tree = flax_tree.get("params", flax_tree)
    assert jax.tree.structure(port_tree) == jax.tree.structure(jax.tree.map(np.asarray, flax_tree))
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(flax_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def _obs_w(rng, n, obs_dim=7, d=3):
    return rng.uniform(size=(n, obs_dim)).astype(np.float32), rng.dirichlet(np.ones(d), size=n).astype(np.float32)


@pytest.mark.parametrize("n_critics", [2, 3])
def test_ensemble_forward_parity(n_critics):
    """The critic ensemble (LayerNorm on, dropout off) equals nn.vmap of the flax net."""
    jagent, tagent = _agents(n_critics=n_critics, hidden=(32, 32, 16))
    params = _flax_params(jagent, n_critics)
    net = _to_torch(tagent, params)
    obs, w = _obs_w(np.random.default_rng(n_critics), 64)
    want = np.asarray(jagent.q_net.apply(params, jnp.asarray(obs), jnp.asarray(w), True))
    got = net(torch.as_tensor(obs), torch.as_tensor(w)).detach().numpy()
    assert got.shape == (n_critics, 64, 6, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    _assert_trees_close(to_flax_params(net), params, atol=0.0)


def test_ensemble_init_distribution():
    """Every critic draws flax's distribution on its own: truncated lecun
    normal kernels, zero biases, LayerNorm scale 1 and bias 0."""
    tagent = GPILS(make("minecart-v0"), GPILSConfig(hidden=(512, 512), n_critics=3), device="cpu")
    net = tagent.make_q_net(torch.Generator().manual_seed(0))
    head0 = net.head.layers[0].weight.detach()  # (3, 512, 512)
    assert head0.shape == (3, 512, 512)
    for c in range(3):
        np.testing.assert_allclose(float(head0[c].std()), np.sqrt(1 / 512), rtol=0.02)
        assert float(head0[c].abs().max()) <= 2 * np.sqrt(1 / 512) / 0.87962566 + 1e-6
    assert not torch.equal(head0[0], head0[1])
    obs0 = net.obs_embed.layers[0].weight.detach()
    np.testing.assert_allclose(float(obs0.std()), np.sqrt(1 / 7), rtol=0.05)
    with torch.no_grad():
        assert all(float(layer.bias.abs().max()) == 0.0 for layer in net.head.layers)
        assert float((net.head.norms[0].scale - 1).abs().max()) == 0.0 and float(net.head.norms[0].bias.abs().max()) == 0.0


def test_bf16_forward_and_action_agreement():
    """The bf16 forward against the JAX package's bf16 apply (atol 3e-2 x
    max|Q|), and the share of envs on which the port's bf16 and float32 GPI
    actions agree."""
    jagent, tagent = _agents(hidden=(64, 64, 64))
    params = _flax_params(jagent, 7)
    net = _to_torch(tagent, params)
    j_bf16 = j_ensemble(
        JWCQNet, 2, num_actions=6, reward_dim=3, hidden=(64, 64, 64), dropout_rate=0.01, use_layernorm=True,
        dtype=jnp.bfloat16,
    )
    obs, w = _obs_w(np.random.default_rng(7), 256)
    want = np.asarray(j_bf16.apply(params, jnp.asarray(obs), jnp.asarray(w), True))
    got = net(torch.as_tensor(obs), torch.as_tensor(w), dtype=torch.bfloat16).detach()
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2 * scale)
    f32 = net(torch.as_tensor(obs), torch.as_tensor(w)).detach().numpy()
    assert np.abs(got.numpy() - f32).max() > 0, "the bf16 path must really compute in bf16"

    support = torch.as_tensor(equally_spaced_weights(3, 8), dtype=torch.float32)
    o, ww = torch.as_tensor(obs), torch.as_tensor(w)
    a32 = tagent._gpi_actions(net, o, ww, support)
    tagent.act_dtype = torch.bfloat16
    a16 = tagent._gpi_actions(net, o, ww, support)
    agree = float((a32 == a16).float().mean())
    assert agree >= 0.9, agree


def test_gpi_ugpi_max_actions_parity():
    """Equal actions on the same params, obs, w and a partly filled support
    (the JAX package masks rows >= support_size; the port forwards the valid rows)."""
    jagent, tagent = _agents(n_critics=3)
    params = _flax_params(jagent, 11)
    net = _to_torch(tagent, params)
    rng = np.random.default_rng(11)
    obs, w = _obs_w(rng, 128)
    support = np.zeros((8, 3), np.float32)
    support[:5] = rng.dirichlet(np.ones(3), size=5)
    jo, jw, js = jnp.asarray(obs), jnp.asarray(w), jnp.asarray(support)
    to, tw, ts_ = torch.as_tensor(obs), torch.as_tensor(w), torch.as_tensor(support[:5])
    np.testing.assert_array_equal(
        tagent._gpi_actions(net, to, tw, ts_).numpy(), np.asarray(jagent._gpi_actions(params, jo, jw, js, 5))
    )
    for pess in (0.95, 1.0):
        np.testing.assert_array_equal(
            tagent._ugpi_actions(net, to, tw, ts_, pess).numpy(),
            np.asarray(jagent._ugpi_actions(params, jo, jw, js, 5, pess)),
        )
    np.testing.assert_array_equal(tagent._max_actions(net, to, tw).numpy(), np.asarray(jagent._max_actions(params, jo, jw)))


def _batch(rng, b, obs_dim=7, d=3, a=6):
    return dict(
        obs=rng.uniform(0, 1, size=(b, obs_dim)).astype(np.float32),
        action=rng.integers(0, a, size=b),
        reward=rng.normal(size=(b, d)).astype(np.float32),
        next_obs=rng.uniform(0, 1, size=(b, obs_dim)).astype(np.float32),
        terminated=(rng.uniform(size=b) < 0.3).astype(np.float32),
    )


@pytest.mark.parametrize("n_critics,max_grad_norm", [(2, None), (3, 0.05)])
def test_update_parity(n_critics, max_grad_norm):
    """DroQ target psi, TD errors, loss, (clipped) gradients and the params
    after Adam agree over two consecutive updates (dropout_rate=0; with 3
    critics both draw the same 2 target critics)."""
    jagent, tagent = _agents(n_critics=n_critics, dropout_rate=0.0, max_grad_norm=max_grad_norm, batch_size=24)
    params = _flax_params(jagent, 20 + n_critics)
    jts = jagent.init_state(jax.random.key(0)).ts.replace(params=params, target_params=_flax_params(jagent, 30))
    tts = tagent.make_train_state(_to_torch(tagent, params))
    load_flax_params(tts.target_net, jax.tree.map(np.asarray, jts.target_params))
    rng = np.random.default_rng(n_critics)
    cfg = jagent.cfg
    for step in range(2):
        b = _batch(rng, 24)
        w = rng.dirichlet(np.ones(3), size=24).astype(np.float32)
        jbatch = JTransition(**{k: jnp.asarray(v) for k, v in b.items()})
        key = jax.random.key(100 + step)
        k_inds = jax.random.split(key, 4)[0]
        inds = np.asarray(jax.random.randint(k_inds, (2,), 0, n_critics))

        def loss_fn(p, target_psi):
            psi = jagent.q_net.apply(p, jbatch.obs, jnp.asarray(w), False, rngs={"dropout": key})
            psi_sa = jnp.take_along_axis(psi, jbatch.action[None, :, None, None], axis=2).squeeze(2)
            tds = psi_sa - target_psi[None]
            a = jnp.abs(tds)
            return jnp.where(a < cfg.min_priority, 0.5 * tds**2, a * cfg.min_priority).mean()

        params_before = jts.params
        jts, jloss, jtds, jtarget = jagent._update_with_aux(jts, jbatch, jnp.asarray(w), key)
        jgrads = jax.grad(loss_fn)(params_before, jtarget)
        if max_grad_norm is not None:
            jgrads, _ = optax.clip_by_global_norm(max_grad_norm).update(jgrads, optax.EmptyState())
        tbatch = Transition(**{k: torch.as_tensor(v) for k, v in b.items()})
        gen = torch.Generator().manual_seed(step)
        tloss, ttds, ttarget = tagent._update_with_aux(tts, tbatch, torch.as_tensor(w), gen, torch.as_tensor(inds))
        np.testing.assert_allclose(ttarget.numpy(), np.asarray(jtarget), atol=ATOL)
        np.testing.assert_allclose(ttds.numpy(), np.asarray(jtds), atol=ATOL)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL, atol=ATOL)
        _assert_trees_close(to_flax_params(tts.net, grads=True), jgrads)
        _assert_trees_close(to_flax_params(tts.net), jts.params)


def test_dropout_in_update_not_in_acting():
    """Dropout is on in the target and the online forward of the update (each
    critic its own mask) and off when acting."""
    _, tagent = _agents(dropout_rate=0.5)
    net = tagent.make_q_net(torch.Generator().manual_seed(0))
    with torch.no_grad():  # two identical critics: only their dropout masks can tell them apart
        for p in net.parameters():
            p[1] = p[0]
    obs, w = (torch.as_tensor(x) for x in _obs_w(np.random.default_rng(0), 32))
    gen = torch.Generator().manual_seed(0)
    train = net(obs, w, gen)
    assert not torch.allclose(train[0], train[1])
    eval_ = tagent._q_values(net, obs, w)
    assert torch.equal(eval_[0], eval_[1]) and torch.equal(eval_, tagent._q_values(net, obs, w))

    seen = []  # the dropout generator each forward of the critics was given

    def record(module, args, kwargs):
        seen.append(args[2] if len(args) > 2 else kwargs.get("dropout_gen"))

    ts = tagent.make_train_state(net)
    for m in (ts.net, ts.target_net):
        m.register_forward_pre_hook(record, with_kwargs=True)
    batch = Transition(**{k: torch.as_tensor(v) for k, v in _batch(np.random.default_rng(1), 8).items()})
    tagent._update_with_aux(ts, batch, w[:8], gen)
    assert len(seen) == 2 and all(g is gen for g in seen)
    seen.clear()
    tagent._gpi_actions(ts.net, obs, w, w[:3])
    assert seen == [None]


@pytest.mark.parametrize(
    "env_id,max_steps,iters,lr",
    [("minecart-deterministic-v0", 200, 40, 1e-3), ("deep-sea-treasure-v0", 60, 300, 3e-3)],
)
def test_slice_front_and_metrics_parity(env_id, max_steps, iters, lr):
    """The whole slice on a deterministic env: a JAX-initialised ensemble,
    trained a little by the port (so that the policy differs per weight) and
    carried back, gives the same GPI-evaluated front (8 equally spaced
    weights, a 3-weight support) and the same multi-policy metrics as the
    JAX package's ``eval_weights_values``."""
    jagent, tagent = _agents(
        env_id, num_envs=16, buffer_size=8192, batch_size=32, learning_starts=200, gradient_updates=2,
        epsilon_decay_steps=2000, target_net_update_freq=20, learning_rate=lr, max_support=4,
    )
    d = tagent.reward_dim
    state = tagent.init_state()
    load_flax_params(state.ts.net, jax.tree.map(np.asarray, _flax_params(jagent, 5)))
    support = list(equally_spaced_weights(d, 3))
    tagent.set_weight_support(state, support)
    tagent.train_segment(state, iters)
    params = {"params": jax.tree.map(jnp.asarray, to_flax_params(state.ts.net))}

    jstate = jagent.set_weight_support(jagent.init_state(jax.random.key(0)), support)
    jstate = jstate._replace(ts=jstate.ts.replace(params=params))
    weights = equally_spaced_weights(d, 8).astype(np.float32)
    jfront = np.asarray(jagent.eval_weights_values(jstate, jnp.asarray(weights), 1, max_steps))
    tfront = tagent.eval_weights_values(state, weights, 1, max_steps).numpy()
    assert tfront.shape == (8, d)
    assert len(np.unique(tfront.round(4), axis=0)) >= 2, "the policy must differ across weights"
    np.testing.assert_allclose(tfront, jfront, atol=1e-4)
    ref_point = np.array([0.0, 0.0, -200.0]) if d == 3 else np.array([0.0, -50.0])
    pf = make(env_id).pareto_front(0.98)
    want = j_metrics(jfront, ref_point, weights, pf)
    got = multi_policy_metrics(tfront, ref_point, weights, pf)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_gpils_outer_loop():
    """Mirror of tests/test_agents_multi.py::test_gpils_outer_loop on the port."""
    env = make("deep-sea-treasure-v0")
    cfg = GPILSConfig(num_envs=8, buffer_size=2048, batch_size=32, hidden=(32, 32),
                      learning_starts=100, gradient_updates=1, epsilon_decay_steps=1000,
                      target_net_update_freq=50, max_support=8)
    agent = GPILS(env, cfg, device="cpu")
    agent.train(total_timesteps=1000, ref_point=np.array([0.0, -50.0]), timesteps_per_iter=500,
                num_eval_weights_for_front=4, eval_max_steps=40)
    assert len(agent._linear_support.ccs) >= 1
    assert agent._last_front.shape == (4, 2)
    assert agent.get_config()["algo"] == "GPILS"


@pytest.mark.parametrize(
    "opts",
    [dict(per=True, n_critics=3, gpi_type="ugpi"), dict(tau=0.5, use_gpi=False, max_grad_norm=1.0, train_freq=2)],
)
def test_train_segment_options(opts):
    """PER priorities, 3 critics, soft target updates, train_freq > 1 and the
    max-action path keep the bookkeeping right."""
    _, tagent = _agents(num_envs=4, buffer_size=256, batch_size=16, learning_starts=32, gradient_updates=2, **opts)
    state = tagent.init_state()
    tagent.set_weight_support(state, list(equally_spaced_weights(3, 4)))
    before = [p.detach().clone() for p in state.ts.target_net.parameters()]
    tagent.train_segment(state, 20)
    assert state.global_step == 80 and state.iter_count == 20 and state.buffer.size == 80
    assert np.isfinite(float(state.loss))
    assert all(bool(torch.isfinite(p).all()) for p in state.ts.net.parameters())
    if opts.get("per"):
        assert not torch.all(state.buffer.priorities[:80] == 1.0)
        assert float(state.buffer.priorities[:80].min()) >= 0.01**0.6 - 1e-7
    if opts.get("tau"):
        assert all(not torch.equal(a, b) for a, b in zip(before, state.ts.target_net.parameters()))
