"""Envelope with a seed axis (``init_state_seeds``) against the JAX package
under ``jax.vmap`` and against S one-seed port agents.

Q-net params come from the flax inits, stacked on a leading axis and
carried across with ``load_flax_params``; batches and sampled weights are
made with numpy from a seed and handed to both.  Tolerances: the envelope
target, losses, TD errors and params after clip+Adam atol 1e-5 (float32
matmuls sum in another order; ``MemberAdam`` rounds its update as optax
does, ``torch.optim.Adam`` in another order); the bf16 forward at the bf16
tests' 2e-2 / 1e-2; a one-member stack against the one-seed loop over 8
iterations atol 1e-5 on params and losses, the stored transitions exactly;
evaluated fronts atol 1e-5.  The stacked NatureCNN trunk (pixel obs at a
small image, (2, 36, 36)): the forward against ``jax.vmap`` of the JAX
pixel Q-net on carried params at atol 1e-5 / rtol 1e-5 (float32
convolutions summed in another order), against S one-seed port forwards at
atol 1e-6; two stacked pixel updates against S one-seed ones atol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_tpu.agents import Envelope as JEnvelope
from morl_baselines_tpu.agents import EnvelopeConfig as JEnvelopeConfig
from morl_baselines_tpu.core.weights import random_weights as j_random_weights
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.models.networks import EnvelopeQNet as JEnvelopeQNet
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.agents.envelope import EnvelopeSeedsState
from morl_baselines_torch.core.weights import equally_spaced_weights
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import EnvelopeQNet, MemberAdam, TrainState, load_flax_params, stack_members, to_flax_params
from morl_baselines_torch.replay import MemberPrioritizedReplayBuffer, PrioritizedReplayBuffer, Transition

torch.set_num_threads(1)
ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2e-2, 1e-2
S = 3
SMALL = dict(num_envs=8, buffer_size=512, batch_size=16, hidden=(32, 32), num_sample_w=3, max_grad_norm=0.05)


def _agents(env_id, **kw):
    cfg = dict(SMALL, **kw)
    return JEnvelope(jmake(env_id), JEnvelopeConfig(**cfg)), Envelope(make(env_id), EnvelopeConfig(**cfg), device="cpu")


def _flax_params(jagent, seed):
    return jagent.q_net.init(jax.random.key(seed), jnp.zeros((1, jagent.obs_dim)), jnp.zeros((1, jagent.reward_dim)))


def _stack(trees):
    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


def _member_net(tagent, stacked, s):
    """A one-seed port Q-net holding member s of a stacked one."""
    net = tagent.make_q_net()
    with torch.no_grad():
        for lin, ens in zip(net.mlp.layers, stacked.mlp.layers):
            lin.weight.copy_(ens.weight[s].T)
            lin.bias.copy_(ens.bias[s])
    return net


def _flat(net, s):
    """Member s's params, per Dense bias then kernel (in, out)."""
    return [x.detach().numpy() for layer in net.mlp.layers for x in (layer.bias[s], layer.weight[s])]


def _flat_flax(params, s):
    tree = params["params"]["MLP_0"]
    return [np.asarray(tree[f"Dense_{i}"][k][s]) for i in range(len(tree)) for k in ("bias", "kernel")]


def _batches(rng, tagent, b):
    d, o, a = tagent.reward_dim, tagent.obs_dim, tagent.env.num_actions
    return dict(
        obs=rng.uniform(0, 1, size=(S, b, o)).astype(np.float32),
        action=rng.integers(0, a, size=(S, b)),
        reward=rng.normal(size=(S, b, d)).astype(np.float32),
        next_obs=rng.uniform(0, 1, size=(S, b, o)).astype(np.float32),
        terminated=(rng.uniform(size=(S, b)) < 0.3).astype(np.float32),
    )


def _stacked_pair(jagent, tagent, seeds_online, seeds_target):
    """The JAX TrainStates stacked on a seed axis, and a port seed state holding the same params."""
    base = jagent.init_state(jax.random.key(0)).ts  # one apply_fn and tx: the stacked trees' static fields
    jts = _stack([base.replace(params=_flax_params(jagent, a), target_params=_flax_params(jagent, b))
                  for a, b in zip(seeds_online, seeds_target)])
    state = tagent.init_state_seeds(range(S))
    load_flax_params(state.ts.net, jax.tree.map(np.asarray, jts.params))
    load_flax_params(state.ts.target_net, jax.tree.map(np.asarray, jts.target_params))
    return jts, state


def test_member_init_equals_one_seed():
    """Member s of ``init_state_seeds(seeds)`` holds ``init_state(seeds[s])``'s
    Q-net bitwise (and so does the target), on a 7-input and a 2-input net."""
    for env_id in ("minecart-v0", "deep-sea-treasure-v0"):
        agent = Envelope(make(env_id), EnvelopeConfig(**SMALL), device="cpu")
        seeds = [3, 0, 7]
        state = agent.init_state_seeds(seeds)
        assert isinstance(state, EnvelopeSeedsState) and state.members == 3
        assert state.obs.shape == (3, 8, agent.obs_dim) and state.weights.shape == (3, 8, agent.reward_dim)
        for s, seed in enumerate(seeds):
            one = agent.init_state(seed).ts.net
            for lin, ens, tgt in zip(one.mlp.layers, state.ts.net.mlp.layers, state.ts.target_net.mlp.layers):
                assert torch.equal(ens.weight[s], lin.weight.T) and torch.equal(ens.bias[s], lin.bias)
                assert torch.equal(tgt.weight[s], lin.weight.T)
    # the pixel net: the NatureCNN trunk's stacked convolutions and Dense too
    pixel = Envelope(make("deep-sea-treasure-pixel-stack-v0"), EnvelopeConfig(**SMALL, image_shape=(4, 84, 84)), device="cpu")
    state = pixel.init_state_seeds([0, 1])
    for s, seed in enumerate([0, 1]):
        one = pixel.init_state(seed).ts.net
        for conv, member in zip(one.cnn.convs, state.ts.net.cnn.convs):
            assert torch.equal(member.weight[s], conv.weight) and torch.equal(member.bias[s], conv.bias)
        assert torch.equal(state.ts.net.cnn.out.weight[s], one.cnn.out.weight.T)
        for lin, ens in zip(one.mlp.layers, state.ts.net.mlp.layers):
            assert torch.equal(ens.weight[s], lin.weight.T) and torch.equal(ens.bias[s], lin.bias)


@pytest.mark.parametrize("bf16", [False, True])
def test_envelope_target_seeds_parity(bf16):
    """The stacked target equals the JAX target under ``jax.vmap`` and S one-seed port targets."""
    jagent, tagent = _agents("minecart-v0", bf16=bf16)
    jts, state = _stacked_pair(jagent, tagent, [1, 2, 3], [4, 5, 6])
    rng = np.random.default_rng(1)
    b, n_w = 48, 3
    next_obs = rng.uniform(size=(S, b, 7)).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=(S, b)).astype(np.float32)
    sw = rng.dirichlet(np.ones(3), size=(S, n_w)).astype(np.float32)
    want = np.asarray(jax.vmap(jagent._envelope_target)(jts, jnp.asarray(next_obs), jnp.asarray(w), jnp.asarray(sw)))
    got = tagent._envelope_target(state.ts, *map(torch.as_tensor, (next_obs, w, sw))).numpy()
    assert got.shape == (S, b, 3)
    rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (0.0, ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    for s in range(S):
        one = tagent.make_train_state(_member_net(tagent, state.ts.net, s))
        one.target_net.load_state_dict(_member_net(tagent, state.ts.target_net, s).state_dict())
        alone = tagent._envelope_target(one, *(torch.as_tensor(x[s]) for x in (next_obs, w, sw)))
        np.testing.assert_allclose(got[s], alone.numpy(), rtol=rtol, atol=atol)


def _jax_sampled_weights(jagent, key):
    return np.array(j_random_weights(jax.random.split(key)[0], jagent.reward_dim, n=jagent.cfg.num_sample_w, dist="gaussian"))


@pytest.mark.parametrize("bf16", [False, True])
def test_update_seeds_parity(bf16):
    """Two consecutive stacked updates (the clip active: max_grad_norm 0.05)
    against the JAX ``_update`` under ``jax.vmap`` with per-seed batches and
    keys, and against S one-seed port updates: losses, TD errors and params;
    in bf16 the losses and TD errors at the bf16 tolerance."""
    jagent, tagent = _agents("minecart-v0", bf16=bf16)
    jts, state = _stacked_pair(jagent, tagent, [7, 8, 9], [10, 11, 12])
    ones = []
    for s in range(S):
        one = tagent.make_train_state(_member_net(tagent, state.ts.net, s))
        one.target_net.load_state_dict(_member_net(tagent, state.ts.target_net, s).state_dict())
        ones.append(one)
    jupdate = jax.jit(jax.vmap(jagent._update, in_axes=(0, 0, 0, None)))
    rng = np.random.default_rng(3)
    lam = 0.3
    for step in range(2):
        b = _batches(rng, tagent, 16)
        keys = jax.random.split(jax.random.key(20 + step), S)
        sw = np.stack([_jax_sampled_weights(jagent, k) for k in keys])
        jts, jloss, jtd = jupdate(jts, JTransition(**{k: jnp.asarray(v) for k, v in b.items()}), keys, lam)
        loss, td = tagent._update(state.ts, Transition(**{k: torch.as_tensor(v) for k, v in b.items()}),
                                  torch.as_tensor(sw), lam)
        assert loss.shape == (S,) and td.shape == (S, 16)
        rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (ATOL, ATOL)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=rtol, atol=atol)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=rtol, atol=atol)
        for s in range(S):
            lone, tdone = tagent._update(ones[s], Transition(**{k: torch.as_tensor(v[s]) for k, v in b.items()}),
                                         torch.as_tensor(sw[s]), lam)
            np.testing.assert_allclose(float(loss[s]), float(lone), rtol=ATOL, atol=ATOL)
            np.testing.assert_allclose(td[s].numpy(), tdone.numpy(), atol=ATOL)
            mine = _flat(state.ts.net, s)
            alone = [x.detach().numpy() for layer in ones[s].net.mlp.layers for x in (layer.bias, layer.weight.T)]
            for p, q in zip(mine, alone):
                np.testing.assert_allclose(p, q, atol=ATOL)
            if not bf16:
                for p, q in zip(mine, _flat_flax(jts.params, s)):
                    np.testing.assert_allclose(p, q, atol=ATOL)
    assert state.ts.optimizer.step_count.tolist() == [2] * S
    assert all(p.dtype == torch.float32 for p in state.ts.net.parameters())


def test_huge_gradient_rescales_no_other_seed():
    """Seed 0's batch has rewards of 1e6: its update is clipped to norm
    ``max_grad_norm``, and the other seeds' params come out as they do when
    seed 0's batch is ordinary."""
    _, tagent = _agents("minecart-v0", max_grad_norm=1.0)
    rng = np.random.default_rng(5)
    b = _batches(rng, tagent, 16)
    sw = torch.as_tensor(rng.dirichlet(np.ones(3), size=(S, 3)).astype(np.float32))
    results = []
    for scale in (1.0, 1e6):
        state = tagent.init_state_seeds(range(S))
        before = [p.detach().clone() for p in state.ts.net.parameters()]
        bb = dict(b, reward=b["reward"] * np.array([scale, 1.0, 1.0], dtype=np.float32)[:, None, None])
        tagent._update(state.ts, Transition(**{k: torch.as_tensor(v) for k, v in bb.items()}), sw, 0.5)
        results.append((before, [p.detach().clone() for p in state.ts.net.parameters()]))
    (_, ordinary), (before, huge) = results
    for p, q in zip(ordinary, huge):
        assert torch.equal(p[1:], q[1:])
    # Adam's first step moves each element by at most lr, whatever the gradient's scale
    step0 = max(float((q[0] - p[0]).abs().max()) for p, q in zip(before, huge))
    assert 0.0 < step0 <= 1.0001 * tagent.cfg.learning_rate


def test_member_per_equals_per_seed():
    """Member PER: inserts at each member's max priority, priority updates and
    sampling at given uniforms equal S separate ``PrioritizedReplayBuffer``s."""
    rng = np.random.default_rng(0)
    cap, n, d = 16, 6, 3
    mem = MemberPrioritizedReplayBuffer.create(S, cap, obs_dim=2, reward_dim=d, device="cpu")
    sep = [PrioritizedReplayBuffer.create(cap, obs_dim=2, reward_dim=d, device="cpu") for _ in range(S)]
    for step in range(4):
        rows = dict(
            obs=rng.normal(size=(S, n, 2)).astype(np.float32), action=rng.integers(0, 4, size=(S, n)),
            reward=rng.normal(size=(S, n, d)).astype(np.float32), next_obs=rng.normal(size=(S, n, 2)).astype(np.float32),
            terminated=(rng.uniform(size=(S, n)) < 0.5).astype(np.float32),
        )
        mem.add_batch(Transition(**{k: torch.as_tensor(v) for k, v in rows.items()}))
        for s in range(S):
            sep[s].add_batch(Transition(**{k: torch.as_tensor(v[s]) for k, v in rows.items()}))
        idx = np.stack([rng.choice(min(cap, (step + 1) * n), size=5, replace=False) for _ in range(S)])
        prio = rng.uniform(0.1, 3.0, size=(S, 5)).astype(np.float32)
        mem.update_priorities(torch.as_tensor(idx), torch.as_tensor(prio))
        for s in range(S):
            sep[s].update_priorities(torch.as_tensor(idx[s]), torch.as_tensor(prio[s]))
    u = torch.as_tensor(rng.uniform(size=(S, 32)).astype(np.float32))
    batch, idx, probs = mem.sample_at(u)
    for s in range(S):
        assert torch.equal(mem.priorities[s], sep[s].priorities)
        assert torch.equal(mem.max_priority[s], sep[s].max_priority)
        b1, i1, p1 = sep[s].sample_at(u[s])
        assert torch.equal(idx[s], i1) and torch.equal(probs[s], p1)
        for x, y in zip(batch, b1):
            assert torch.equal(x[s], y)
    g = torch.Generator().manual_seed(0)
    assert mem.sample(g, 8)[1].shape == (S, 8)


@pytest.mark.parametrize("per", [False, True])
def test_one_member_train_segment_equals_one_seed(per):
    """A one-member stack draws what the one-seed loop draws, in the same
    order: over 8 iterations on stochastic minecart (12 updates, 2 hard target
    syncs) the transitions are equal and the params, losses and weights agree."""
    cfg = EnvelopeConfig(**dict(SMALL, max_grad_norm=1.0), learning_starts=32, gradient_updates=3,
                         target_net_update_freq=3, per=per)
    agent = Envelope(make("minecart-v0"), cfg, device="cpu")
    one = agent.init_state(4)
    stack = agent.init_state_seeds([4])
    one = agent.train_segment(one, 8)
    stack = agent.train_segment(stack, 8)
    assert stack.global_step == one.global_step == 64 and stack.buffer.size == one.buffer.size == 64
    for x, y in zip(stack.buffer.data, one.buffer.data):
        assert torch.equal(x[0], y)
    if per:
        np.testing.assert_allclose(stack.buffer.priorities[0].numpy(), one.buffer.priorities.numpy(), atol=ATOL)
    np.testing.assert_allclose(stack.weights[0].numpy(), one.weights.numpy(), atol=0)
    np.testing.assert_allclose(float(stack.loss[0]), float(one.loss), rtol=ATOL, atol=ATOL)
    for net_s, net_1 in ((stack.ts.net, one.ts.net), (stack.ts.target_net, one.ts.target_net)):
        for ens, lin in zip(net_s.mlp.layers, net_1.mlp.layers):
            np.testing.assert_allclose(ens.weight[0].detach().numpy(), lin.weight.T.detach().numpy(), atol=ATOL)
            np.testing.assert_allclose(ens.bias[0].detach().numpy(), lin.bias.detach().numpy(), atol=ATOL)


def test_eval_front_seeds_equals_one_seed():
    """The stacked ``_eval_front`` runs the S fronts as one batch and returns
    (S, K, d); member s's front equals the one-seed ``_eval_front`` of its params."""
    cfg = EnvelopeConfig(num_envs=16, buffer_size=4096, batch_size=32, hidden=(32, 32), learning_starts=256,
                         epsilon_decay_steps=2000, homotopy_decay_steps=2000, target_net_update_freq=50,
                         learning_rate=1e-3, num_sample_w=2)
    agent = Envelope(make("deep-sea-treasure-v0"), cfg, device="cpu")
    state = agent.train_segment(agent.init_state_seeds(range(S)), 150)
    weights = torch.as_tensor(equally_spaced_weights(2, 8), dtype=torch.float32)
    fronts = agent._eval_front(state.ts.net, weights, 1, 60)
    assert fronts.shape == (S, 8, 2)
    for s in range(S):
        alone = agent._eval_front(_member_net(agent, state.ts.net, s), weights, 1, 60)
        np.testing.assert_allclose(fronts[s].numpy(), alone.numpy(), atol=ATOL)
    assert len({tuple(f.round(4).ravel()) for f in fronts.numpy()}) > 1, "the seeds must learn different fronts"


# ---------------------------------------------------------------- the stacked NatureCNN trunk

IMAGE = (2, 36, 36)
IMAGE_OBS = int(np.prod(IMAGE))


def _pixel_inputs(seed, members, rows):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, size=(members, rows, IMAGE_OBS)).astype(np.float32)
    w = rng.dirichlet([1.0, 1.0], size=(members, rows)).astype(np.float32)
    return obs, w


def test_stacked_pixel_forward_matches_jax_vmap():
    """``jax.vmap`` of the JAX pixel ``EnvelopeQNet`` over 2 keys, its params
    carried into ``EnvelopeQNet(image_shape=..., members=2)`` (stacked Conv
    kernels (S, kh, kw, in, out)), gives the port's stacked forward; the
    params carry back bitwise through ``to_flax_params``."""
    jnet = JEnvelopeQNet(num_actions=4, reward_dim=2, hidden=(32, 32), image_shape=IMAGE, cnn_features=64)
    keys = jax.random.split(jax.random.key(5), 2)
    params = jax.vmap(lambda k: jnet.init(k, jnp.zeros((1, IMAGE_OBS)), jnp.zeros((1, 2))))(keys)
    obs, w = _pixel_inputs(6, 2, 5)
    want = np.asarray(jax.vmap(jnet.apply)(params, jnp.asarray(obs), jnp.asarray(w)))
    net = load_flax_params(EnvelopeQNet(IMAGE_OBS, 4, 2, (32, 32), image_shape=IMAGE, cnn_features=64, members=2),
                           jax.tree.map(np.asarray, params))
    assert tuple(net.cnn.convs[0].weight.shape) == (2, 32, 2, 8, 8)
    got = net(torch.as_tensor(obs), torch.as_tensor(w)).detach().numpy()
    assert got.shape == (2, 5, 4, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    back = to_flax_params(net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_stacked_pixel_forward_equals_one_seed_forwards():
    """Member s of a stack built by ``stack_members`` from seeds computes what
    a one-seed pixel Q-net of seed s computes, on its own rows."""
    seeds = [2, 9, 4]
    make_net = lambda members, gen: EnvelopeQNet(IMAGE_OBS, 4, 2, (32, 32), gen, IMAGE, 64, members)  # noqa: E731
    stacked = stack_members(make_net, seeds)
    obs, w = _pixel_inputs(7, len(seeds), 6)
    got = stacked(torch.as_tensor(obs), torch.as_tensor(w)).detach()
    for s, seed in enumerate(seeds):
        one = make_net(None, torch.Generator().manual_seed(seed))
        want = one(torch.as_tensor(obs[s]), torch.as_tensor(w[s])).detach()
        np.testing.assert_allclose(got[s].numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_stacked_pixel_update_equals_one_seed_updates():
    """Two updates of a stacked pixel net (S = 3) equal S one-seed pixel
    updates on loss, TD errors and params; each seed's target runs each trunk
    once on its B distinct next frames, as the one-seed target does."""
    _, agent = _agents("deep-sea-treasure-v0", num_sample_w=2)  # 4 actions x 2 objectives, as the nets below
    make_net = lambda members, gen: EnvelopeQNet(IMAGE_OBS, 4, 2, (32, 32), gen, IMAGE, 64, members)  # noqa: E731
    net, target = stack_members(make_net, [1, 2, 3]), stack_members(make_net, [4, 5, 6]).requires_grad_(False)
    stacked = TrainState(net=net, target_net=target, optimizer=MemberAdam(net.parameters(), lr=agent.cfg.learning_rate))
    ones = []
    for s in range(S):
        one, one_target = make_net(None, torch.Generator().manual_seed(1 + s)), make_net(None, torch.Generator().manual_seed(4 + s))
        opt = torch.optim.Adam(one.parameters(), lr=agent.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        ones.append(TrainState(net=one, target_net=copy.deepcopy(one_target).requires_grad_(False), optimizer=opt))
    trunk_rows = []
    for cnn in (net.cnn, target.cnn):
        cnn.register_forward_hook(lambda m, args, out: trunk_rows.append(tuple(args[0].shape[:2])))
    rng = np.random.default_rng(8)
    b, lam = 8, 0.3
    for step in range(2):
        obs, _ = _pixel_inputs(10 + step, S, 2 * b)
        batch = dict(obs=obs[:, :b], next_obs=obs[:, b:], action=rng.integers(0, 4, size=(S, b)),
                     reward=rng.normal(size=(S, b, 2)).astype(np.float32),
                     terminated=(rng.uniform(size=(S, b)) < 0.3).astype(np.float32))
        sw = rng.dirichlet(np.ones(2), size=(S, 2)).astype(np.float32)
        trunk_rows.clear()
        loss, td = agent._update(stacked, Transition(**{k: torch.as_tensor(v) for k, v in batch.items()}), torch.as_tensor(sw), lam)
        assert loss.shape == (S,) and td.shape == (S, b)
        assert trunk_rows == [(S, b), (S, b), (S, 2 * b)]  # target side: B frames a net; the loss's W·B tiled rows
        for s in range(S):
            lone, tdone = agent._update(ones[s], Transition(**{k: torch.as_tensor(v[s]) for k, v in batch.items()}),
                                        torch.as_tensor(sw[s]), lam)
            np.testing.assert_allclose(float(loss[s]), float(lone), rtol=ATOL, atol=ATOL)
            np.testing.assert_allclose(td[s].numpy(), tdone.numpy(), atol=ATOL)
            for p, q in zip(jax.tree.leaves(to_flax_params(net)), jax.tree.leaves(to_flax_params(ones[s].net))):
                np.testing.assert_allclose(p[s], q, atol=ATOL)
    assert stacked.optimizer.step_count.tolist() == [2] * S


def test_stacked_pixel_train_segment_runs():
    """A tiny stacked pixel-DST ``train_segment`` (2 seeds x 4 envs under the
    mario wrapper stack, past ``learning_starts``) and its stacked evaluation."""
    cfg = EnvelopeConfig(num_envs=4, buffer_size=64, batch_size=8, hidden=(32, 32), learning_starts=8,
                         image_shape=(4, 84, 84), num_sample_w=2)
    agent = Envelope(make("deep-sea-treasure-pixel-stack-v0"), cfg, device="cpu")
    state = agent.train_segment(agent.init_state_seeds([0, 1]), 5)
    assert state.global_step == 20 and state.buffer.size == 20 and state.obs.shape == (2, 4, 4 * 84 * 84)
    assert bool(torch.isfinite(state.loss).all())
    assert not torch.equal(state.buffer.data.obs[0, :20], state.buffer.data.obs[1, :20])
    fronts = agent._eval_front(state.ts.net, torch.tensor([[0.5, 0.5], [1.0, 0.0]]), 1, 30)
    assert fronts.shape == (2, 2, 2) and bool(torch.isfinite(fronts).all())
