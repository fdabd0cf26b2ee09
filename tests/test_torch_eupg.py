"""Parity of the port's fishwood env and EUPG with the JAX package.

The same inputs, made from a numpy seed, go through both packages on the CPU:
the fishwood step given the same uniforms, its utility, ``PolicyNet`` from
carried flax params, the reward-to-go, completed mask, loss, gradients and
one Adam step on a fixed chunk, a whole ``train_segment`` and ``_eval_esr``
with the JAX key chain's Gumbel noise and catch uniforms handed to the port.
Then the learning mirror of tests/test_agents.py::test_eupg_fishwood_smoke.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morl_baselines_torch.agents import EUPG, EUPGConfig, PolicyNet
from morl_baselines_torch.agents.eupg import Chunk, completed_mask, reward_to_go
from morl_baselines_torch.envs import Fishwood, fishwood_utility, make
from morl_baselines_torch.models import load_flax_params, to_flax_params
from morl_baselines_tpu.agents import EUPG as JEUPG
from morl_baselines_tpu.agents import EUPGConfig as JEUPGConfig
from morl_baselines_tpu.envs import Fishwood as JFishwood
from morl_baselines_tpu.envs import fishwood_utility as jfishwood_utility

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_fishwood_step_and_utility():
    """State index, and a step of 64 envs given the JAX step's own uniforms:
    exact.  Then tests/test_envs.py::test_fishwood on a batch."""
    env, jenv = make("fishwood-v0"), JFishwood()
    assert env.num_states == jenv.num_states == 2
    obs = np.array([[0.0], [1.0], [1.0]], dtype=np.float32)
    np.testing.assert_array_equal(env.state_index(_t(obs)).numpy(), np.asarray(jenv.state_index(jnp.asarray(obs))))
    n = 64
    rng = np.random.default_rng(0)
    loc = rng.integers(0, 2, size=n).astype(np.int32)
    t = rng.integers(190, 200, size=n).astype(np.int32)
    actions = rng.integers(0, 2, size=n).astype(np.int32)
    keys = jax.random.split(jax.random.key(1), n)
    jstate = type(jenv.reset(keys[0])[0])(jnp.asarray(loc), jnp.asarray(t))
    want = jax.vmap(jenv.step)(jstate, jnp.asarray(actions), keys)
    u = _t(jax.vmap(jax.random.uniform)(keys))
    got = env.step(type(env.reset(1, torch.Generator())[0])(_t(loc), _t(t)), _t(actions), u)
    for g, w in zip((got.obs, got.reward, got.terminated, got.truncated, *got.state), (want.obs, want.reward, want.terminated, want.truncated, *want.state)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # random rollout: one-hot or zero rewards, truncation at 200
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(8, gen)
    rewards, dones = [], []
    for _ in range(400):
        out = env.step(state, env.action_space.sample(gen, 8), env.sample_noise(8, gen))
        rewards.append(out.reward)
        dones.append(out.truncated)
        state = out.state
    assert set(torch.unique(torch.stack(rewards)).tolist()) <= {0.0, 1.0}
    assert bool(torch.stack(dones).any())
    assert float(fishwood_utility(torch.tensor([3.0, 7.0]))) == 3.0
    assert float(fishwood_utility(torch.tensor([5.0, 4.0]))) == 2.0
    r = np.round(rng.uniform(-10, 60, size=(50, 2)), 1).astype(np.float32)
    np.testing.assert_array_equal(fishwood_utility(_t(r)).numpy(), np.asarray(jfishwood_utility(jnp.asarray(r))))


def test_policy_net_from_flax_params():
    jagent = JEUPG(JFishwood(), jfishwood_utility, config=JEUPGConfig(hidden=(32, 16)))
    params = jagent.net.init(jax.random.key(0), jnp.zeros((1, 1)), jnp.zeros((1, 2)))
    net = PolicyNet(1, 2, 2, (32, 16))
    load_flax_params(net, _np(params))
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 2, size=(20, 1)).astype(np.float32)
    acc = rng.integers(0, 50, size=(20, 2)).astype(np.float32)
    with torch.no_grad():
        got = net(_t(obs), _t(acc)).numpy()
    np.testing.assert_allclose(got, np.asarray(jagent.net.apply(params, obs, acc)), atol=1e-6)
    back = to_flax_params(net)
    jax.tree.map(np.testing.assert_array_equal, back, _np(params["params"]))


def _jax_update(jagent, params, chunk, gamma, lr):
    """The JAX package's update on a fixed chunk, its expressions as in
    ``EUPG.train_segment`` after the scan: reward-to-go, completed mask,
    loss and gradients, one optax Adam step."""
    obs_t, acc_t, act_t, rew_t, done_t = (jnp.asarray(x) for x in chunk)
    n, d = rew_t.shape[1], rew_t.shape[2]

    def rev(rtg, xs):
        r, dn = xs
        rtg = r + gamma * rtg * (1.0 - dn[:, None])
        return rtg, rtg

    _, rtg_t = jax.lax.scan(rev, jnp.zeros((n, d)), (rew_t, done_t.astype(jnp.float32)), reverse=True)
    completed = jax.lax.cummax(done_t.astype(jnp.float32), axis=0, reverse=True)
    utilities = jagent.u(rtg_t)

    def loss_fn(p):
        logp = jax.nn.log_softmax(jagent.net.apply(p, obs_t, acc_t))
        lp_a = jnp.take_along_axis(logp, act_t[..., None], axis=-1).squeeze(-1)
        return -jnp.sum(lp_a * utilities * completed) / jnp.maximum(jnp.sum(completed), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(lr)
    updates, _ = tx.update(grads, tx.init(params), params)
    return rtg_t, completed, loss, grads, optax.apply_updates(params, updates)


def test_update_on_fixed_chunk():
    """Reward-to-go and completed mask (rtol 1e-5), the loss and every
    gradient (rtol 1e-5), and the params after one Adam step (atol 1e-6)."""
    T, n, gamma, lr = 40, 6, 0.99, 1e-3
    rng = np.random.default_rng(2)
    done = rng.uniform(size=(T, n)) < 0.08
    done[-1, 0], done[:, 1] = True, False  # an episode ending on the last step; an env that never ends
    chunk = (
        rng.integers(0, 2, size=(T, n, 1)).astype(np.float32),
        rng.integers(0, 30, size=(T, n, 2)).astype(np.float32),
        rng.integers(0, 2, size=(T, n)).astype(np.int32),
        np.eye(3, 2, dtype=np.float32)[rng.integers(0, 3, size=(T, n))],  # (1, 0), (0, 1) or (0, 0)
        done,
    )
    jagent = JEUPG(JFishwood(), jfishwood_utility, config=JEUPGConfig(hidden=(16, 16), gamma=gamma, learning_rate=lr))
    params = jagent.net.init(jax.random.key(3), jnp.zeros((1, 1)), jnp.zeros((1, 2)))
    rtg, completed, loss, grads, new_params = _jax_update(jagent, params, chunk, gamma, lr)

    agent = EUPG(make("fishwood-v0"), fishwood_utility, config=EUPGConfig(num_envs=n, hidden=(16, 16), gamma=gamma, learning_rate=lr), device="cpu")
    st = agent.init_state()
    load_flax_params(st.net, _np(params))
    tchunk = Chunk(_t(chunk[0]), _t(chunk[1]), _t(chunk[2]).long(), _t(chunk[3]), _t(chunk[4]))
    np.testing.assert_allclose(reward_to_go(tchunk.reward, tchunk.done, gamma).numpy(), np.asarray(rtg), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(completed_mask(tchunk.done).numpy(), np.asarray(completed))
    assert 0 < float(completed.sum()) < T * n
    got = agent.loss(st.net, tchunk)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7), to_flax_params(st.net, grads=True), _np(grads["params"]))
    st.optimizer.step()
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-6), to_flax_params(st.net), _np(new_params["params"]))


@jax.jit
def _segment_draws(key, n: int = 4, steps: int = 50):
    """Per step of the JAX ``train_segment``: the categorical's Gumbel noise
    (n, 2) and each env's catch uniform (the first n of the vector step's keys)."""

    def body(k, _):
        k, ka, ks = jax.random.split(k, 3)
        g = jax.random.gumbel(ka, (n, 2))
        u = jax.vmap(jax.random.uniform)(jax.random.split(ks, 2 * n)[:n])
        return k, (g, u)

    return jax.lax.scan(body, key, None, length=steps)[1]


def test_train_segment_parity():
    """One chunk of 4 envs x 50 steps on a 20-step fishwood and its update,
    from the same params, given the JAX key chain's noise: the chunk's end
    state exactly, the loss rel 1e-5 and the params after the Adam step
    atol 1e-6."""
    n, T = 4, 50
    cfg = dict(num_envs=n, chunk_len=T, hidden=(16, 16))
    jagent = JEUPG(JFishwood(max_episode_steps=20), jfishwood_utility, config=JEUPGConfig(**cfg))
    js = jagent.init_state(jax.random.key(4))
    gumbel, uniforms = (list(_t(x)) for x in _segment_draws(js.key))
    js2, jloss = jagent.train_segment(js)

    agent = EUPG(Fishwood(max_episode_steps=20), fishwood_utility, config=EUPGConfig(**cfg), device="cpu")
    st = agent.init_state()
    load_flax_params(st.net, _np(js.ts.params))
    agent._gumbel = lambda state: gumbel.pop(0)
    agent.env.sample_noise = lambda k, gen: uniforms.pop(0)
    loss = agent.train_segment(st)
    assert st.global_step == int(js2.global_step) == n * T
    np.testing.assert_array_equal(st.accrued.numpy(), np.asarray(js2.accrued))
    np.testing.assert_array_equal(st.obs.numpy(), np.asarray(js2.obs))
    for g, w in zip(st.env_state, js2.env_state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5) and float(jloss) != 0.0
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-6), to_flax_params(st.net), _np(js2.ts.params["params"]))


def test_eval_esr_parity():
    """Greedy ESR evaluation, 5 episodes of 200 steps as the rows of one
    batch, given each episode's JAX catch uniforms: the summed returns
    exactly (their means to one float32 rounding), discounted returns rel 1e-6."""
    jagent = JEUPG(JFishwood(), jfishwood_utility, config=JEUPGConfig(hidden=(16, 16)))
    params = jagent.net.init(jax.random.key(5), jnp.zeros((1, 1)), jnp.zeros((1, 2)))
    # bias the policy so that it switches between river and woods on the accrued reward
    params = jax.tree.map(lambda x: x * 3.0, params)
    key, rep = jax.random.key(6), 5
    jret, jdisc = jagent._eval_esr(params, key, rep)

    def uniforms(k):
        def body(kk, _):
            kk, _ka, ks = jax.random.split(kk, 3)
            return kk, jax.random.uniform(ks)

        return jax.lax.scan(body, jax.random.split(k)[1], None, length=200)[1]

    u = list(_t(jax.vmap(uniforms)(jax.random.split(key, rep)).T))  # (200, rep)
    agent = EUPG(make("fishwood-v0"), fishwood_utility, config=EUPGConfig(hidden=(16, 16)), device="cpu")
    net = agent.make_net()
    load_flax_params(net, _np(params))
    agent.env.sample_noise = lambda k, gen: u.pop(0)
    ret, disc = agent._eval_esr(net, torch.Generator(), rep)
    assert not u
    np.testing.assert_array_equal(np.round(ret.numpy() * rep), np.round(np.asarray(jret) * rep))
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-6)
    np.testing.assert_allclose(disc.numpy(), np.asarray(jdisc), rtol=1e-6)
    assert float(jret.sum()) > 0


def test_eupg_fishwood_smoke():
    """tests/test_agents.py::test_eupg_fishwood_smoke."""
    agent = EUPG(make("fishwood-v0"), scalarization=fishwood_utility,
                 config=EUPGConfig(num_envs=8, chunk_len=200, hidden=(32, 32)), device="cpu")
    agent.train(total_timesteps=4800, eval_freq=1600)
    ret, disc = agent.last_eval
    assert ret.shape == (2,)
    assert (ret >= 0).all()
