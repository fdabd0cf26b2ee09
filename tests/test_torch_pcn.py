"""Parity of the port's PCN and LCN (with episodic replay, fruit-tree and the
Lorenz helpers) with the JAX package.

The same inputs, made from a numpy seed, go through both packages on the CPU.
Tolerances: ``lorenz_vector``, the dominance predicates, the fruit-tree leaf
table, front and steps exact; ``crowding_distance`` (tied objectives included),
``_pcn_keep_score`` and the kept rows of ``add_episodes`` 1e-6 (relative on
the scores, which reach 1e6); ``sample_steps`` given the JAX draw's (e, t)
1e-5; ``PCNModel`` from one flax tree 1e-5; one ``update_model`` step on the
JAX sample 1e-5 on the loss and gradients, 1e-6 on the params after Adam; a
greedy ``collect_episodes`` on deep-sea-treasure exact on the lengths, 1e-5
on the returns; ``choose_commands`` for PCN and LCN given the same integer
seed 1e-6.  Then the smoke mirror of tests/test_agents_multi.py::test_pcn_and_lcn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import LCN, PCN, LCNConfig, PCNConfig, PCNModel
from morl_baselines_torch.core import (
    batched_pareto_dominates,
    lorenz_dominates,
    lorenz_vector,
    pareto_dominates,
    strict_pareto_dominates,
)
from morl_baselines_torch.envs import FruitTree, make
from morl_baselines_torch.envs.fruit_tree import _make_fruits
from morl_baselines_torch.models import load_flax_params, to_flax_params
from morl_baselines_torch.replay import EpisodeBatch, EpisodicBuffer, crowding_distance
from morl_baselines_torch.replay.episodic import _pcn_keep_score
from morl_baselines_tpu.agents import LCN as JLCN
from morl_baselines_tpu.agents import PCN as JPCN
from morl_baselines_tpu.agents import LCNConfig as JLCNConfig
from morl_baselines_tpu.agents import PCNConfig as JPCNConfig
from morl_baselines_tpu.core import pareto as jpareto
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.envs.fruit_tree import FruitTree as JFruitTree
from morl_baselines_tpu.envs.fruit_tree import _make_fruits as j_make_fruits
from morl_baselines_tpu.replay.episodic import EpisodeBatch as JEpisodeBatch
from morl_baselines_tpu.replay.episodic import EpisodicBuffer as JEpisodicBuffer
from morl_baselines_tpu.replay.episodic import _pcn_keep_score as j_pcn_keep_score
from morl_baselines_tpu.replay.episodic import crowding_distance as jcrowding_distance

torch.set_num_threads(1)
REF2 = np.array([0.0, -50.0])
DST_CFG = dict(num_envs=4, max_buffer_episodes=16, max_episode_len=32, scaling_factor=(0.1, 0.1, 0.01))
_jadd = jax.jit(JEpisodicBuffer.add_episodes, static_argnums=2)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_lorenz_vector_and_dominance():
    """Exact, on points with tied objectives and on lambda 1, 0.5 and 0: the
    Lorenz vector and every dominance predicate."""
    rng = np.random.default_rng(0)
    pts = np.round(rng.normal(size=(64, 6)) * 4).astype(np.float32) / 4
    for lam in (1.0, 0.5, 0.0):
        np.testing.assert_array_equal(lorenz_vector(_t(pts), lam).numpy(), np.asarray(jpareto.lorenz_vector(jnp.asarray(pts), lam)))
    a, b = pts[:32], pts[32:]
    b[:4] = a[:4] - 0.25  # strictly dominated rows
    b[4:8] = a[4:8]  # equal rows: not strict
    b[8:12] = a[8:12]
    b[8:12, 0] -= 0.25  # weakly dominated rows
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got = strict_pareto_dominates(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpareto.strict_pareto_dominates(ja, jb)))
    assert got[:4].all() and not got[4:12].any()
    got = pareto_dominates(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpareto.pareto_dominates(ja, jb)))
    assert got[:4].all() and not got[4:8].any() and got[8:12].all()
    np.testing.assert_array_equal(batched_pareto_dominates(_t(a[0]), _t(b)).numpy(), np.asarray(jpareto.batched_pareto_dominates(ja[0], jb)))
    for lam in (1.0, 0.5):
        np.testing.assert_array_equal(lorenz_dominates(_t(a), _t(b), lam).numpy(), np.asarray(jpareto.lorenz_dominates(ja, jb, lam)))


def test_fruit_tree_table_front_and_steps():
    """The leaf table and the front bitwise for every depth; a batch of
    random action sequences exact against the vmapped JAX step."""
    for depth in (5, 6, 7):
        np.testing.assert_array_equal(_make_fruits(depth), j_make_fruits(depth))
        env, jenv = FruitTree(depth), JFruitTree(depth)
        np.testing.assert_array_equal(env.pareto_front(0.99), jenv.pareto_front(0.99))
        assert env.num_states == jenv.num_states
    env, jenv = make("fruit-tree-v0"), jmake("fruit-tree-v0")
    n = 32
    rng = np.random.default_rng(1)
    state, obs = env.reset(n, torch.Generator())
    jstate, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), n))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(8):  # two steps past the leaf: the done envs keep stepping, as PCN's collection does
        a = rng.integers(0, 2, size=n).astype(np.int32)
        out = env.step(state, _t(a))
        jout = jstep(jstate, jnp.asarray(a), jax.random.split(jax.random.key(1), n))
        for g, w in zip((out.obs, out.reward, out.terminated, out.truncated), (jout.obs, jout.reward, jout.terminated, jout.truncated)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(env.state_index(out.obs).numpy(), np.asarray(jenv.state_index(jout.obs)))
        state, jstate = out.state, jout.state


def _returns(rng, n, d, ties: bool):
    r = rng.uniform(0, 10, size=(n, d)).astype(np.float32)
    if ties:
        r[: n // 2, 0] = np.round(r[: n // 2, 0])  # many tied values in the first objective
        r[n // 2 : n // 2 + 3] = r[n // 2 + 3]  # an exact duplicate group
    return r


@pytest.mark.parametrize("d", [2, 3, 6])
def test_crowding_distance_and_keep_score(d):
    rng = np.random.default_rng(d)
    pts = _returns(rng, 40, d, ties=True)
    valid = rng.uniform(size=40) > 0.2
    np.testing.assert_allclose(
        crowding_distance(_t(pts), _t(valid)).numpy(),
        np.asarray(jcrowding_distance(jnp.asarray(pts), jnp.asarray(valid))),
        rtol=1e-6,
    )
    pts = np.where(valid[:, None], pts, -np.inf).astype(np.float32)
    np.testing.assert_allclose(
        _pcn_keep_score(_t(pts), _t(valid)).numpy(),
        np.asarray(j_pcn_keep_score(jnp.asarray(pts), jnp.asarray(valid))),
        rtol=1e-6,
    )


def _episodes(rng, n, T, d, obs_dim=2, n_actions=4):
    """Random padded episodes with distinct returns (no tied keep scores)."""
    length = rng.integers(1, T + 1, size=n).astype(np.int32)
    mask = np.arange(T)[None, :] < length[:, None]
    reward = (rng.uniform(-1, 5, size=(n, T, d)) * mask[..., None]).astype(np.float32)
    return dict(
        obs=rng.normal(size=(n, T, obs_dim)).astype(np.float32),
        action=rng.integers(0, n_actions, size=(n, T)).astype(np.int32),
        reward=reward,
        length=length,
        vec_return=reward.sum(axis=1),
        horizon=length.astype(np.float32),
    )


def _both_buffers(rng, cap, T, d, batches, lorenz):
    port = EpisodicBuffer.create(cap, T, 2, d, device="cpu")
    jbuf = JEpisodicBuffer.create(cap, T, 2, d)
    for n in batches:
        eps = _episodes(rng, n, T, d)
        port.add_episodes(EpisodeBatch(**{k: _t(v) for k, v in eps.items()}), lorenz_lambda=lorenz)
        jbuf = _jadd(jbuf, JEpisodeBatch(**{k: jnp.asarray(v) for k, v in eps.items()}), lorenz)
    return port, jbuf


@pytest.mark.parametrize("lorenz", [None, 1.0, 0.5])
def test_add_episodes_kept_rows(lorenz):
    """Two adds that fill the buffer, a third that evicts: the size, and every
    kept episode row in order, 1e-6."""
    rng = np.random.default_rng(3)
    port, jbuf = _both_buffers(rng, cap=16, T=6, d=3, batches=(7, 6, 12), lorenz=lorenz)
    assert port.size == int(jbuf.size) == 16
    for name, a, b in zip(EpisodeBatch._fields, port.data, _np(jbuf.data)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=name)
    # top_returns: 4 of the 7 best scores tie at 1e6 in float32 (non-dominated, a crowding term
    # below an ulp); the stable sort orders them as lax.top_k does, lower row first
    vals, hors, valid = port.top_returns(7)
    jvals, jhors, jvalid = jbuf.top_returns(7)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6)
    np.testing.assert_allclose(hors.numpy(), np.asarray(jhors), rtol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_sample_steps_given_the_draw():
    """The JAX draw's (episode, t) handed to ``steps_at``: obs, action,
    discounted reward-to-go and horizon at 1e-5, gamma 0.9."""
    rng = np.random.default_rng(4)
    port, jbuf = _both_buffers(rng, cap=12, T=8, d=2, batches=(9,), lorenz=None)
    key, B, gamma = jax.random.key(5), 64, 0.9
    k1, k2 = jax.random.split(key)
    e = jax.random.randint(k1, (B,), 0, jnp.maximum(jbuf.size, 1))
    t = jnp.clip((jax.random.uniform(k2, (B,)) * jbuf.data.length[e]).astype(jnp.int32), 0, jbuf.max_len - 1)
    want = jbuf.sample_steps(key, B, gamma)
    got = port.steps_at(_t(np.asarray(e)).long(), _t(np.asarray(t)).long(), gamma)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # the port's own draw stays inside the valid steps
    e2, t2 = port.draw_steps(torch.Generator().manual_seed(0), 256)
    assert int(e2.max()) < port.size and bool((t2 < port.data.length[e2]).all())


def _jpcn_params(jagent, seed):
    return jagent.init_state(jax.random.key(seed)).ts.params


def test_pcn_model_from_flax():
    env = make("minecart-deterministic-v0")
    cfg = dict(scaling_factor=(1.0, 1.0, 0.1, 0.1), hidden_dim=64)
    jagent = JPCN(jmake("minecart-deterministic-v0"), JPCNConfig(**cfg))
    params = _jpcn_params(jagent, 0)
    model = PCNModel(env.obs_dim, 3, 6, cfg["scaling_factor"], 64)
    load_flax_params(model, _np(params))
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(40, env.obs_dim)).astype(np.float32)
    dr = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    dh = rng.uniform(1, 400, size=(40,)).astype(np.float32)
    with torch.no_grad():
        got = model(_t(obs), _t(dr), _t(dh)).numpy()
    np.testing.assert_allclose(got, np.asarray(jagent.model.apply(params, obs, dr, dh)), atol=1e-5)
    jax.tree.map(np.testing.assert_array_equal, to_flax_params(model), _np(params["params"]))


def test_update_model_step():
    """One step of the JAX ``update_model`` (num_model_updates=1) and the
    port's ``update_step`` on the batch the JAX key drew."""
    rng = np.random.default_rng(7)
    cfg = dict(DST_CFG, num_model_updates=1, batch_size=64, gamma=0.95)
    jagent = JPCN(jmake("deep-sea-treasure-v0"), JPCNConfig(**cfg))
    jstate = jagent.init_state(jax.random.key(1))
    agent = PCN(make("deep-sea-treasure-v0"), PCNConfig(**cfg), device="cpu")
    state = agent.init_state()
    load_flax_params(state.model, _np(jstate.ts.params))
    eps = _episodes(rng, 10, 32, 2)
    eps["obs"] = rng.integers(0, 10, size=(10, 32, 2)).astype(np.float32)
    jbuf = _jadd(jstate.buffer, JEpisodeBatch(**{k: jnp.asarray(v) for k, v in eps.items()}), None)
    key = jax.random.key(8)
    batch = jbuf.sample_steps(jax.random.split(key, 1)[0], cfg["batch_size"], cfg["gamma"])
    ts, jloss = jagent.update_model(jstate.ts, jbuf, key)
    loss = agent.update_step(state, tuple(_t(x) for x in batch[:1]) + (_t(batch[1]).long(),) + tuple(_t(x) for x in batch[2:]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jgrads = jax.jit(jax.grad(
        lambda p: -jnp.mean(
            jnp.take_along_axis(jax.nn.log_softmax(jagent.model.apply(p, batch[0], batch[2], batch[3])), batch[1][:, None], axis=1)
        )
    ))(jstate.ts.params)
    port_grads = to_flax_params(state.model, grads=True)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7), port_grads, _np(jgrads["params"]))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6), to_flax_params(state.model), _np(ts.params["params"]))


def test_greedy_collect_on_dst():
    """Greedy episodes under the same commands: lengths exact, returns and
    every record 1e-5 (a command reached in fewer steps freezes)."""
    cfg = dict(DST_CFG, gamma=0.99)
    jagent = JPCN(jmake("deep-sea-treasure-v0"), JPCNConfig(**cfg))
    jstate = jagent.init_state(jax.random.key(2))
    agent = PCN(make("deep-sea-treasure-v0"), PCNConfig(**cfg), device="cpu")
    model = agent.make_model()
    load_flax_params(model, _np(jstate.ts.params))
    rng = np.random.default_rng(9)
    cmds = np.concatenate([rng.uniform(0, 24, size=(12, 1)), rng.uniform(-20, -1, size=(12, 1)), rng.integers(1, 30, size=(12, 1))], axis=1)
    cmds = cmds.astype(np.float32)
    want = jagent.collect_episodes(jstate.ts, jnp.asarray(cmds), jax.random.key(3), True)
    got = agent.collect_episodes(model, _t(cmds), torch.Generator(), greedy=True)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(want.action))
    for name in ("obs", "reward", "vec_return", "horizon"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        agent.eval_commands(model, _t(cmds), torch.Generator()).numpy(),
        np.asarray(jagent.eval_commands(jstate.ts, jnp.asarray(cmds), jax.random.key(4))),
        atol=1e-5,
    )


@pytest.mark.parametrize("algo", ["pcn", "lcn"])
def test_choose_commands_given_the_seed(algo):
    """The same buffer and the integer the JAX key draws: the commands at 1e-6."""
    rng = np.random.default_rng(10)
    env_id, d, cfg = ("deep-sea-treasure-v0", 2, DST_CFG) if algo == "pcn" else (
        "fruit-tree-v0", 6, dict(num_envs=16, max_buffer_episodes=32, max_episode_len=8, scaling_factor=(0.1,) * 7)
    )
    port_cls, jcls = (PCN, PCNConfig), (JPCN, JPCNConfig)
    if algo == "lcn":
        port_cls, jcls = (LCN, LCNConfig), (JLCN, JLCNConfig)
        cfg = dict(cfg, lorenz_lambda=0.7)
    agent = port_cls[0](make(env_id), port_cls[1](**cfg), device="cpu")
    jagent = jcls[0](jmake(env_id), jcls[1](**cfg))
    lorenz = cfg.get("lorenz_lambda")
    port, jbuf = _both_buffers(rng, cap=cfg["max_buffer_episodes"], T=cfg["max_episode_len"], d=d, batches=(20, 30), lorenz=lorenz)
    for k in range(2):
        key = jax.random.key(11 + k)
        seed = int(jax.random.randint(key, (), 0, 2**30))
        want = np.asarray(jagent.choose_commands(jbuf, key, 16))
        np.testing.assert_allclose(agent.choose_commands(port, 16, seed).numpy(), want, rtol=1e-6)


def test_pcn_and_lcn_smoke():
    """Mirror of tests/test_agents_multi.py::test_pcn_and_lcn at its sizes and seed 0."""
    env = make("deep-sea-treasure-v0")
    pcn = PCN(env, PCNConfig(num_model_updates=3, **DST_CFG), device="cpu")
    pcn.train(total_timesteps=700, ref_point=REF2, num_er_episodes=4)
    assert pcn._last_metrics["eval/hypervolume"] >= 0
    lcn = LCN(env, LCNConfig(num_model_updates=3, **DST_CFG), device="cpu")
    ls = lcn.train(total_timesteps=500, ref_point=REF2, num_er_episodes=4)
    assert ls.global_step >= 500
