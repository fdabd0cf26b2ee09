"""Parity of the torch port's Envelope with the JAX package's, and learning checks.

Q-net params come from the flax init and are carried across with
``load_flax_params``; batches, sampled weights and observations are made
with numpy from a seed and handed to both.  Tolerances: Q-net forward,
envelope target, loss, grads and params after clip+Adam atol 1e-5 (float32
matmuls sum in another order); evaluated fronts atol 1e-4 and their metrics
rtol 1e-4 (200 steps of float32 dynamics and greedy argmaxes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morl_baselines_tpu.agents import Envelope as JEnvelope
from morl_baselines_tpu.agents import EnvelopeConfig as JEnvelopeConfig
from morl_baselines_tpu.core.weights import random_weights as j_random_weights
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.evaluation import multi_policy_metrics as j_metrics
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.evaluation import multi_policy_metrics
from morl_baselines_torch.models import EnvelopeQNet, load_flax_params, to_flax_params
from morl_baselines_torch.replay import Transition

torch.set_num_threads(1)
ATOL = 1e-5

SMALL = dict(num_envs=8, buffer_size=512, batch_size=16, hidden=(32, 32), num_sample_w=3, max_grad_norm=0.05)


def _agents(env_id, **kw):
    cfg = dict(SMALL, **kw)
    jagent = JEnvelope(jmake(env_id), JEnvelopeConfig(**cfg))
    tagent = Envelope(make(env_id), EnvelopeConfig(**cfg), device="cpu")
    return jagent, tagent


def _flax_params(jagent, seed):
    dummy = jnp.zeros((1, jagent.obs_dim)), jnp.zeros((1, jagent.reward_dim))
    return jagent.q_net.init(jax.random.key(seed), *dummy)


def _to_torch(tagent, params) -> EnvelopeQNet:
    return load_flax_params(tagent.make_q_net(), jax.tree.map(np.asarray, params))


def _flat_torch(net):
    """Torch params in the flax tree's leaf order: per Dense, bias then kernel (in, out)."""
    out = []
    for layer in net.mlp.layers:
        out += [layer.bias.detach().numpy(), layer.weight.detach().numpy().T]
    return out


def _flat_flax(params):
    tree = params["params"]["MLP_0"]
    return [np.asarray(tree[f"Dense_{i}"][k]) for i in range(len(tree)) for k in ("bias", "kernel")]


def _batch(rng, tagent, b):
    d, o, a = tagent.reward_dim, tagent.obs_dim, tagent.env.num_actions
    return dict(
        obs=rng.uniform(0, 1, size=(b, o)).astype(np.float32),
        action=rng.integers(0, a, size=b),
        reward=rng.normal(size=(b, d)).astype(np.float32),
        next_obs=rng.uniform(0, 1, size=(b, o)).astype(np.float32),
        terminated=(rng.uniform(size=b) < 0.3).astype(np.float32),
    )


def test_q_net_forward_and_init_parity():
    jagent, tagent = _agents("minecart-v0")
    params = _flax_params(jagent, 0)
    net = _to_torch(tagent, params)
    rng = np.random.default_rng(0)
    obs = rng.uniform(size=(64, 7)).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=64).astype(np.float32)
    want = np.asarray(jagent.q_net.apply(params, jnp.asarray(obs), jnp.asarray(w)))
    got = net(torch.as_tensor(obs), torch.as_tensor(w)).detach().numpy()
    assert got.shape == (64, 6, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the port's own init draws from flax's distribution: truncated lecun normal, zero bias
    big = Envelope(make("minecart-v0"), EnvelopeConfig(hidden=(512,)), device="cpu").make_q_net(
        torch.Generator().manual_seed(0)
    )
    wt, bias = big.mlp.layers[0].weight.detach(), big.mlp.layers[0].bias.detach()
    assert float(wt.abs().max()) <= 2 * np.sqrt(1 / 10) / 0.87962566 + 1e-6
    np.testing.assert_allclose(float(wt.std()), np.sqrt(1 / 10), rtol=0.05)
    assert float(bias.abs().max()) == 0.0


def test_envelope_target_parity():
    jagent, tagent = _agents("minecart-v0")
    p_online, p_target = _flax_params(jagent, 1), _flax_params(jagent, 2)
    jts = jagent.init_state(jax.random.key(0)).ts.replace(params=p_online, target_params=p_target)
    tts = tagent.make_train_state(_to_torch(tagent, p_online))
    load_flax_params(tts.target_net, jax.tree.map(np.asarray, p_target))
    rng = np.random.default_rng(1)
    b, n_w = 48, 3
    next_obs = rng.uniform(size=(b, 7)).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=b).astype(np.float32)
    sw = rng.dirichlet(np.ones(3), size=n_w).astype(np.float32)
    want = np.asarray(jagent._envelope_target(jts, jnp.asarray(next_obs), jnp.asarray(w), jnp.asarray(sw)))
    got = tagent._envelope_target(tts, torch.as_tensor(next_obs), torch.as_tensor(w), torch.as_tensor(sw))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_pixel_envelope_target_and_update_parity():
    """The NatureCNN Q-net: the port's target from the batch's B distinct next
    frames (each net's trunk once a frame, the head on the tiled rows) against
    the JAX package's on the W-times tiled frames; then one update (loss, TD
    errors, params after clip+Adam) against the JAX package's ``_update``."""
    jagent, tagent = _agents("deep-sea-treasure-pixel-stack-v0", num_envs=2, buffer_size=8, batch_size=4,
                             num_sample_w=2, image_shape=(4, 84, 84))
    p_online, p_target = _flax_params(jagent, 5), _flax_params(jagent, 6)
    jts = jagent.init_state(jax.random.key(0)).ts.replace(params=p_online, target_params=p_target)
    tts = tagent.make_train_state(_to_torch(tagent, p_online))
    load_flax_params(tts.target_net, jax.tree.map(np.asarray, p_target))
    rng = np.random.default_rng(7)
    b = _batch(rng, tagent, 4)
    b["obs"], b["next_obs"] = (rng.integers(0, 256, size=(4, tagent.obs_dim)).astype(np.float32) for _ in range(2))
    jbatch = JTransition(**{k: jnp.asarray(v) for k, v in b.items()})
    key, lam = jax.random.key(11), 0.4
    sw = np.array(j_random_weights(jax.random.split(key)[0], jagent.reward_dim, n=2, dist="gaussian"))
    w = np.repeat(sw, 4, axis=0)
    want = np.asarray(jagent._envelope_target(jts, jnp.tile(jbatch.next_obs, (2, 1)), jnp.asarray(w), jnp.asarray(sw)))
    got = tagent._envelope_target(tts, torch.as_tensor(b["next_obs"]), torch.as_tensor(w), torch.as_tensor(sw))
    assert got.shape == (8, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    jts, jloss, jtd = jax.jit(jagent._update)(jts, jbatch, key, lam)
    tloss, ttd = tagent._update(tts, Transition(**{k: torch.as_tensor(v) for k, v in b.items()}), torch.as_tensor(sw), lam)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), atol=ATOL)
    mine, theirs = jax.tree.leaves(to_flax_params(tts.net)), jax.tree.leaves(jts.params["params"])
    assert len(mine) == len(theirs) == 14  # three Conv, the trunk's Dense, three head Dense: kernel and bias each
    for p_t, p_j in zip(mine, theirs):
        np.testing.assert_allclose(p_t, np.asarray(p_j), atol=ATOL)


def _jax_clipped_grads(jagent, ts, batch, key, lam):
    """The grads of the JAX package's Envelope loss (envelope.py:152-182), clipped by global norm."""
    cfg = jagent.cfg
    k_w, _ = jax.random.split(key)
    sw = j_random_weights(k_w, jagent.reward_dim, n=cfg.num_sample_w, dist="gaussian")
    tile = lambda x: jnp.tile(x, (cfg.num_sample_w,) + (1,) * (x.ndim - 1))
    w = jnp.repeat(sw, batch.obs.shape[0], axis=0)
    obs, actions, rewards, next_obs, dones = map(tile, batch)
    y = rewards + (1.0 - dones[:, None]) * cfg.gamma * jagent._envelope_target(ts, next_obs, w, sw)

    def loss_fn(params):
        q = ts.apply_fn(params, obs, w)
        q_sa = jnp.take_along_axis(q, actions[:, None, None].astype(jnp.int32), axis=1).squeeze(1)
        wq, wy = jnp.sum(q_sa * w, -1), jnp.sum(y * w, -1)
        return (1.0 - lam) * jnp.mean((q_sa - y) ** 2) + lam * jnp.mean((wq - wy) ** 2)

    grads = jax.grad(loss_fn)(ts.params)
    clipped, _ = optax.clip_by_global_norm(cfg.max_grad_norm).update(grads, optax.EmptyState())
    return sw, clipped


def test_update_parity():
    """Loss, td, clipped grads and params after clip+Adam agree over three
    consecutive updates (the clip is active: max_grad_norm=0.05)."""
    jagent, tagent = _agents("minecart-v0")
    params = _flax_params(jagent, 3)
    jts = jagent.init_state(jax.random.key(0)).ts.replace(params=params, target_params=_flax_params(jagent, 4))
    tts = tagent.make_train_state(_to_torch(tagent, params))
    load_flax_params(tts.target_net, jax.tree.map(np.asarray, jts.target_params))
    jupdate = jax.jit(jagent._update)
    rng = np.random.default_rng(3)
    lam = 0.3
    for step in range(3):
        b = _batch(rng, tagent, 16)
        jbatch = JTransition(**{k: jnp.asarray(v) for k, v in b.items()})
        key = jax.random.key(10 + step)
        sw, jgrads = _jax_clipped_grads(jagent, jts, jbatch, key, lam)
        jts, jloss, jtd = jupdate(jts, jbatch, key, lam)
        tloss, ttd = tagent._update(tts, Transition(**{k: torch.as_tensor(v) for k, v in b.items()}), torch.as_tensor(np.array(sw)), lam)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), atol=ATOL)
        tgrads = []
        for layer in tts.net.mlp.layers:
            tgrads += [layer.bias.grad.numpy(), layer.weight.grad.numpy().T]
        for g_t, g_j in zip(tgrads, _flat_flax({"params": jgrads["params"]})):
            np.testing.assert_allclose(g_t, g_j, atol=ATOL)
        for p_t, p_j in zip(_flat_torch(tts.net), _flat_flax(jts.params)):
            np.testing.assert_allclose(p_t, p_j, atol=ATOL)


def _to_flax(net):
    """The port net's params as a flax tree (the inverse of ``load_flax_params``)."""
    layers = {
        f"Dense_{i}": {"kernel": jnp.asarray(l.weight.detach().numpy().T), "bias": jnp.asarray(l.bias.detach().numpy())}
        for i, l in enumerate(net.mlp.layers)
    }
    return {"params": {"MLP_0": layers}}


@pytest.mark.parametrize(
    "env_id,max_steps,train_steps",
    [("minecart-deterministic-v0", 200, 4000), ("deep-sea-treasure-v0", 60, 12000)],
)
def test_slice_front_and_metrics_parity(env_id, max_steps, train_steps):
    """The whole slice: a JAX-initialised Q-net, carried across and trained by
    the port (so that the greedy policy differs per weight), gives the same
    evaluated front (8 equally spaced weights) and the same multi-policy
    metrics in the port's ``_eval_front`` as in the JAX package's."""
    jagent, tagent = _agents(
        env_id, num_envs=16, buffer_size=8192, batch_size=64, hidden=(64, 64), learning_starts=500,
        epsilon_decay_steps=8000, homotopy_decay_steps=8000, target_net_update_freq=100, learning_rate=1e-3,
        num_sample_w=2, max_grad_norm=1.0,
    )
    state = tagent.init_state()
    load_flax_params(state.ts.net, jax.tree.map(np.asarray, _flax_params(jagent, 5)))
    state = tagent.train_segment(state, train_steps // 16)
    params = _to_flax(state.ts.net)
    net = _to_torch(tagent, params)
    from morl_baselines_torch.core.weights import equally_spaced_weights

    weights = equally_spaced_weights(tagent.reward_dim, 8).astype(np.float32)
    jfront = np.asarray(jagent._eval_front(params, jnp.asarray(weights), 1, max_steps))
    tfront = tagent._eval_front(net, torch.as_tensor(weights), 1, max_steps).numpy()
    assert tfront.shape == (8, tagent.reward_dim)
    assert len(np.unique(tfront.round(4), axis=0)) >= 2, "the policy must differ across weights"
    np.testing.assert_allclose(tfront, jfront, atol=1e-4)
    env = make(env_id)
    ref_point = np.array([0.0, 0.0, -200.0]) if tagent.reward_dim == 3 else np.array([0.0, -50.0])
    pf = env.pareto_front(0.98)
    want = j_metrics(jfront, ref_point, weights, pf)
    got = multi_policy_metrics(tfront, ref_point, weights, pf)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_envelope_dst_learns():
    """Mirror of tests/test_agents.py::test_envelope_dst_smoke: HV > 150 at 12k steps."""
    env = make("deep-sea-treasure-v0")
    cfg = EnvelopeConfig(
        num_envs=16,
        buffer_size=8192,
        batch_size=64,
        hidden=(64, 64),
        learning_starts=500,
        epsilon_decay_steps=8000,
        homotopy_decay_steps=8000,
        target_net_update_freq=100,
        learning_rate=1e-3,
        num_sample_w=2,
        seed=0,
    )
    agent = Envelope(env, cfg, device="cpu")
    state = agent.train(
        total_timesteps=12000,
        ref_point=np.array([0.0, -50.0]),
        eval_freq=4000,
        num_eval_weights_for_front=8,
        eval_max_steps=60,
    )
    assert state.global_step >= 12000
    m = agent._last_metrics
    assert m["eval/hypervolume"] > 150.0 and np.isfinite(m["eval/eum"])
    assert agent._last_front.shape == (8, 2)
    assert np.isfinite(float(state.loss))
    assert agent.get_config()["env_id"] == "deep-sea-treasure-v0"


def test_envelope_per_smoke():
    """Mirror of tests/test_agents.py::test_envelope_per_smoke."""
    env = make("deep-sea-treasure-v0")
    cfg = EnvelopeConfig(
        num_envs=4, buffer_size=1024, batch_size=16, hidden=(32, 32), learning_starts=64, num_sample_w=2, per=True
    )
    agent = Envelope(env, cfg, device="cpu")
    state = agent.train_segment(agent.init_state(), 40)
    assert state.global_step == 160 and state.buffer.size == 160
    assert float(state.buffer.max_priority) > 0
    # updates rewrote priorities away from the insert value of the rows they sampled
    assert not torch.all(state.buffer.priorities[:160] == 1.0)


def test_train_segment_bookkeeping():
    """Soft target updates (tau < 1), gradient_updates > 1 and train_freq > 1."""
    env = make("minecart-v0")
    cfg = EnvelopeConfig(
        num_envs=8, buffer_size=64, batch_size=8, hidden=(16,), learning_starts=16, gradient_updates=2,
        train_freq=2, tau=0.5,
    )
    agent = Envelope(env, cfg, device="cpu")
    state = agent.init_state()
    before = [p.detach().clone() for p in state.ts.target_net.parameters()]
    state = agent.train_segment(state, 12)
    assert state.global_step == 96 and state.iter_count == 12 and state.buffer.size == 64
    assert all(not torch.equal(a, b) for a, b in zip(before, state.ts.target_net.parameters()))
    assert np.isfinite(float(state.loss))
    assert state.weights.shape == (8, 3) and torch.allclose(state.weights.sum(-1), torch.ones(8))


BF16_RTOL, BF16_ATOL = 2e-2, 1e-2  # bf16 keeps 8 mantissa bits; XLA and torch may round the dots' sums differently


def test_bf16_q_net_forward_parity():
    """``EnvelopeConfig(bf16=True)``: the JAX Q-net is built with
    ``dtype=bfloat16``, and the port's forward given ``torch.bfloat16`` computes
    every Dense in bf16 from float32 params; both return float32."""
    jagent, tagent = _agents("minecart-v0", bf16=True)
    assert tagent.dtype == torch.bfloat16
    params = _flax_params(jagent, 0)
    net = _to_torch(tagent, params)
    rng = np.random.default_rng(0)
    obs = rng.uniform(size=(64, 7)).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=64).astype(np.float32)
    want = np.asarray(jagent.q_net.apply(params, jnp.asarray(obs), jnp.asarray(w)))
    got = net(torch.as_tensor(obs), torch.as_tensor(w), torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL)
    # bf16 is not float32: the rounding shows
    f32 = net(torch.as_tensor(obs), torch.as_tensor(w)).detach().numpy()
    assert not np.array_equal(f32, got.detach().numpy())
    actions = tagent._greedy_actions(net, torch.as_tensor(obs), torch.as_tensor(w))
    jactions = np.asarray(jagent._greedy_actions(params, jnp.asarray(obs), jnp.asarray(w)))
    assert (actions.numpy() == jactions).mean() >= 0.9


def test_bf16_update_parity():
    """One update of the bf16 agent against the JAX bf16 agent with carried
    params and the JAX key's sampled weights: the envelope target, the loss and
    the TD errors agree at the bf16 tolerance; params stay float32."""
    jagent, tagent = _agents("minecart-v0", bf16=True)
    params = _flax_params(jagent, 3)
    jts = jagent.init_state(jax.random.key(0)).ts.replace(params=params, target_params=_flax_params(jagent, 4))
    tts = tagent.make_train_state(_to_torch(tagent, params))
    load_flax_params(tts.target_net, jax.tree.map(np.asarray, jts.target_params))
    b = _batch(np.random.default_rng(3), tagent, 16)
    jbatch = JTransition(**{k: jnp.asarray(v) for k, v in b.items()})
    key, lam = jax.random.key(10), 0.3
    sw = np.array(j_random_weights(jax.random.split(key)[0], jagent.reward_dim, n=jagent.cfg.num_sample_w, dist="gaussian"))
    w = np.repeat(sw, 16, axis=0)
    want_t = np.asarray(jagent._envelope_target(jts, jnp.tile(jbatch.next_obs, (3, 1)), jnp.asarray(w), jnp.asarray(sw)))
    got_t = tagent._envelope_target(tts, torch.as_tensor(b["next_obs"]).repeat(3, 1), torch.as_tensor(w), torch.as_tensor(sw))
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=BF16_RTOL, atol=BF16_ATOL)
    _, jloss, jtd = jax.jit(jagent._update)(jts, jbatch, key, lam)
    before = [p.detach().clone() for p in tts.net.parameters()]
    tloss, ttd = tagent._update(tts, Transition(**{k: torch.as_tensor(v) for k, v in b.items()}), torch.as_tensor(sw), lam)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=BF16_RTOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(p.dtype == torch.float32 and not torch.equal(p, q) for p, q in zip(tts.net.parameters(), before))


def test_bf16_train_segment_and_eval():
    """The whole bf16 loop runs: act, store, learn, target sync, evaluation."""
    env = make("deep-sea-treasure-v0")
    cfg = EnvelopeConfig(num_envs=4, buffer_size=256, batch_size=8, hidden=(16, 16), learning_starts=16,
                         num_sample_w=2, bf16=True, target_net_update_freq=5)
    agent = Envelope(env, cfg, device="cpu")
    state = agent.train(total_timesteps=400, ref_point=np.array([0.0, -50.0]), eval_freq=200,
                        num_eval_weights_for_front=4, eval_max_steps=40)
    assert state.global_step == 400 and np.isfinite(float(state.loss))
    assert agent._last_front.shape == (4, 2) and np.isfinite(agent._last_metrics["eval/hypervolume"])
