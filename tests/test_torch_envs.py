"""Parity of the torch port's envs with the JAX package's, on identical inputs.

Batched random states and actions are made with numpy from a seed and handed
to both steps.  The JAX minecart step draws its ore noise from a key, so the
test draws those same normals from the same keys and hands them to the port.
Tolerance of a step: atol 1e-6 (float32 sin/cos and sums may round
differently in the two libraries).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_tpu.envs import EpisodeStats as JEpisodeStats
from morl_baselines_tpu.envs import VectorMOEnv as JVectorMOEnv
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.envs.dst import DSTState as JDSTState
from morl_baselines_tpu.envs.minecart import MinecartState as JMinecartState
from morl_baselines_torch.envs import EpisodeStats, VectorMOEnv, make
from morl_baselines_torch.envs.dst import DSTState
from morl_baselines_torch.envs.minecart import _MINE_POS, MinecartState

torch.set_num_threads(1)
ATOL = 1e-6
FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _assert_step_equal(jout, tout):
    for a, b in zip(jout.state, tout.state):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(jout.obs), tout.obs.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(jout.reward), tout.reward.numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jout.terminated), tout.terminated.numpy())
    np.testing.assert_array_equal(np.asarray(jout.truncated), tout.truncated.numpy())


def _minecart_states(rng, n):
    """Random states: a third near a mine, a third near home with cargo, a third anywhere."""
    k = n // 3
    pos = rng.uniform(0, 1, size=(n, 2))
    pos[:k] = _MINE_POS[rng.integers(0, 5, size=k)] + rng.normal(scale=0.08, size=(k, 2))
    pos[k : 2 * k] = rng.uniform(0, 0.2, size=(k, 2))
    return dict(
        pos=np.clip(pos, 0, 1).astype(np.float32),
        speed=rng.uniform(0, 0.02, size=n).astype(np.float32),
        angle=rng.uniform(-np.pi, 2 * np.pi, size=n).astype(np.float32),
        cargo=rng.uniform(0, 0.75, size=(n, 2)).astype(np.float32),
        departed=rng.uniform(size=n) < 0.7,
        t=rng.integers(990, 1001, size=n).astype(np.int32),
    )


@pytest.mark.parametrize("env_id", ["minecart-v0", "minecart-deterministic-v0"])
def test_minecart_step_parity(env_id):
    rng = np.random.default_rng(0)
    n = 600
    st = _minecart_states(rng, n)
    actions = rng.integers(0, 6, size=n)
    keys = jax.random.split(jax.random.key(int(rng.integers(1 << 30))), n)
    jenv, tenv = jmake(env_id), make(env_id)

    jout = jax.vmap(jenv.step)(
        JMinecartState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(actions, jnp.int32), keys
    )
    noise = None
    if not tenv.deterministic:
        noise = torch.as_tensor(np.array(jax.vmap(lambda k: jax.random.normal(k, (2,)))(keys)))
    tout = tenv.step(MinecartState(**{k: torch.as_tensor(v) for k, v in st.items()}), torch.as_tensor(actions), noise)
    _assert_step_equal(jout, tout)
    # the batch exercises mining, selling and truncation
    assert (tout.state.cargo.sum(-1) > torch.as_tensor(st["cargo"]).sum(-1)).any()
    assert tout.terminated.any() and tout.truncated.any()


def test_dst_step_parity():
    rng = np.random.default_rng(1)
    n = 500
    depths = np.array([1, 2, 3, 4, 4, 4, 7, 7, 9, 10])
    col = rng.integers(0, 10, size=n)
    row = np.minimum(rng.integers(0, 11, size=n), depths[col])
    st = dict(row=row.astype(np.int32), col=col.astype(np.int32), t=rng.integers(490, 501, size=n).astype(np.int32))
    actions = rng.integers(0, 4, size=n)
    jenv, tenv = jmake("deep-sea-treasure-v0"), make("deep-sea-treasure-v0")
    jout = jax.vmap(jenv.step)(
        JDSTState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(actions, jnp.int32),
        jax.random.split(jax.random.key(0), n),
    )
    tout = tenv.step(DSTState(**{k: torch.as_tensor(v) for k, v in st.items()}), torch.as_tensor(actions))
    _assert_step_equal(jout, tout)
    assert tout.terminated.any() and tout.truncated.any()


@pytest.mark.parametrize("env_id", ["minecart-v0", "deep-sea-treasure-v0"])
def test_pareto_front_parity(env_id):
    """The simulated minecart front (60 scripted policies, 1000 steps) and the
    closed-form DST front agree with the JAX package's and its fixture."""
    got = make(env_id).pareto_front(0.98)
    ref = np.asarray(jmake(env_id).pareto_front(0.98))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.load(FIXTURES / f"front_{env_id}.npy"), rtol=1e-5, atol=1e-6)


def test_minecart_deterministic_front_equals_stochastic_front():
    np.testing.assert_array_equal(
        make("minecart-deterministic-v0").pareto_front(0.98), make("minecart-v0").pareto_front(0.98)
    )


@pytest.mark.parametrize("env_id", ["deep-sea-treasure-v0", "minecart-deterministic-v0"])
def test_vector_autoreset_and_stats_parity(env_id):
    """Same-step autoreset, final_obs and EpisodeStats over 300 steps of
    identical random actions (deterministic envs: no noise to share)."""
    n, steps, gamma = 32, 300, 0.99
    kw = {"max_episode_steps": 60}
    jvenv, tvenv = JVectorMOEnv(jmake(env_id, **kw), n), VectorMOEnv(make(env_id, **kw), n)
    gen = torch.Generator().manual_seed(0)
    jstate, jobs = jvenv.reset(jax.random.key(0))
    tstate, tobs = tvenv.reset(gen)
    d = tvenv.reward_dim
    jstats, tstats = JEpisodeStats.create(n, d), EpisodeStats.create(n, d, "cpu")
    jstep = jax.jit(lambda s, a, st: _jax_vec_step(jvenv, s, a, st, gamma))
    actions = np.random.default_rng(2).integers(0, tvenv.env.num_actions, size=(steps, n))
    n_done = 0
    for a in actions:
        jout, jstats, jfin = jstep(jstate, jnp.asarray(a, jnp.int32), jstats)
        tout = tvenv.step(tstate, torch.as_tensor(a), gen)
        tstats, tfin = tstats.update(tout.reward, tout.terminated | tout.truncated, gamma)
        for name in ("obs", "final_obs", "reward", "terminated", "truncated"):
            np.testing.assert_allclose(np.asarray(getattr(jout, name)), getattr(tout, name).numpy(), atol=ATOL)
        for a_, b_ in zip(jfin, tfin):
            np.testing.assert_allclose(np.asarray(a_), b_.numpy(), atol=1e-5)
        jstate, tstate = jout.state, tout.state
        done = tout.terminated | tout.truncated
        n_done += int(done.sum())
        # final_obs is the pre-reset obs; obs is the reset obs where done
        assert torch.equal(tout.obs[~done], tout.final_obs[~done])
    assert n_done > 0
    for a_, b_ in zip(jstats, tstats):
        np.testing.assert_allclose(np.asarray(a_), b_.numpy(), atol=1e-5)


def _jax_vec_step(jvenv, state, actions, stats, gamma):
    out = jvenv.step(state, actions, jax.random.key(0))
    stats, fin = stats.update(out.reward, out.terminated | out.truncated, gamma)
    return out, stats, fin


def test_registry_and_sell_cycle():
    with pytest.raises(KeyError):
        make("bogus-v0")  # an id neither package has
    env = make("minecart-deterministic-v0")
    assert env.name == "minecart-deterministic-v0" and env.obs_dim == 7 and env.num_actions == 6
    # mirror tests/test_envs.py::test_minecart_sell_cycle on a batch of one
    state, obs = env.reset(1, torch.Generator())
    assert obs.shape == (1, 7)
    plan = [3] * 35 + [4] * 5 + [0] * 3 + [1] * 12
    for a in plan:
        out = env.step(state, torch.tensor([a]))
        state = out.state
    assert float(state.cargo.sum()) > 0
    for _ in range(120):
        out = env.step(state, torch.tensor([3]))
        state = out.state
        if bool(out.terminated):
            break
    assert bool(out.terminated)
    r = out.reward[0]
    assert r[0] > 0 and r[1] > 0 and r[2] < 0


@pytest.mark.parametrize("env_id", ["water-reservoir-v0", "mo-mountaincar-v0", "mo-mountaincarcontinuous-v0"])
def test_continuous_slice_env_step_parity(env_id):
    """Water reservoir (its inflow normals read off the JAX keys) and both
    mountain cars on random states and actions, truncation included."""
    from morl_baselines_tpu.envs.mountaincar import MCState as JMCState
    from morl_baselines_tpu.envs.water_reservoir import DamState as JDamState
    from morl_baselines_torch.envs.mountaincar import MCState
    from morl_baselines_torch.envs.water_reservoir import DamState

    rng = np.random.default_rng(3)
    n = 400
    jenv, tenv = jmake(env_id), make(env_id)
    t = rng.integers(tenv.max_episode_steps - 5, tenv.max_episode_steps, size=n).astype(np.int32)
    if env_id == "water-reservoir-v0":
        st = dict(storage=rng.uniform(0, 300, size=n).astype(np.float32), t=t)
        jcls, tcls = JDamState, DamState
    else:
        pos = rng.uniform(-1.2, 0.6, size=n).astype(np.float32)
        pos[: n // 4] = rng.uniform(0.4, 0.6, size=n // 4)  # near the goal
        pos[n // 4 : n // 2] = rng.uniform(-1.2, -1.15, size=n // 4)  # at the left wall
        st = dict(position=pos, velocity=rng.uniform(-0.07, 0.07, size=n).astype(np.float32), t=t)
        jcls, tcls = JMCState, MCState
    if env_id == "mo-mountaincar-v0":
        actions = rng.integers(0, 3, size=n)
        jactions = jnp.asarray(actions, jnp.int32)
    else:
        actions = rng.uniform(-1.5, 1.5, size=(n, 1)).astype(np.float32)
        jactions = jnp.asarray(actions)
    keys = jax.random.split(jax.random.key(5), n)
    jout = jax.vmap(jenv.step)(jcls(**{k: jnp.asarray(v) for k, v in st.items()}), jactions, keys)
    noise = None
    if env_id == "water-reservoir-v0":
        noise = torch.as_tensor(np.array(jax.vmap(lambda k: jax.random.normal(k, ()))(keys)))
    tout = tenv.step(tcls(**{k: torch.as_tensor(v) for k, v in st.items()}), torch.as_tensor(actions), noise)
    _assert_step_equal(jout, tout)
    assert tout.truncated.any() and not tout.truncated.all()
    if "mountaincar" in env_id:
        assert tout.terminated.any() and not tout.terminated.all()


def test_normalize_reward_parity():
    """``normalize_reward`` against the JAX package's over a run of steps with
    episode ends (the accumulator reset by each step's own done), clip 10;
    rtol 1e-6 on the statistics and the normalized rewards."""
    from morl_baselines_torch.envs import RewardNormState, normalize_reward
    from morl_baselines_tpu.envs.vector import RewardNormState as JRewardNormState
    from morl_baselines_tpu.envs.vector import normalize_reward as j_normalize_reward

    rng = np.random.default_rng(0)
    n, d = 16, 2
    s, js = RewardNormState.create(n, d, "cpu"), JRewardNormState.create(n, d)
    for step in range(12):
        r = (rng.normal(size=(n, d)) * [5.0, 0.1] + [1.0, -2.0]).astype(np.float32)
        done = rng.uniform(size=n) < 0.2
        s, out = normalize_reward(s, torch.as_tensor(r), torch.as_tensor(done), 0.99, clip=10.0)
        js, jout = j_normalize_reward(js, jnp.asarray(r), jnp.asarray(done), 0.99, clip=10.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7, err_msg=f"step {step}")
    for a, b in zip(s, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_normalize_reward_member_axis():
    """Mirror of tests/test_envs.py::test_reward_normalizer, then a stacked
    member axis: statistics (P, d) equal each member's own."""
    from morl_baselines_torch.envs import RewardNormState, normalize_reward

    rng = np.random.default_rng(1)
    r = torch.as_tensor(rng.normal(size=(8, 2)).astype(np.float32) * 5.0)
    norm, done = RewardNormState.create(8, 2, "cpu"), torch.zeros(8, dtype=torch.bool)
    for _ in range(20):
        norm, out = normalize_reward(norm, r, done, 0.99, clip=10.0)
    assert bool(torch.isfinite(out).all()) and norm.var.shape == (2,)

    rew = rng.normal(size=(6, 3, 8, 2)).astype(np.float32)
    dones = rng.uniform(size=(6, 3, 8)) < 0.25
    pop = RewardNormState.create(8, 2, "cpu", (3,))
    outs = []
    for t in range(6):
        pop, o = normalize_reward(pop, torch.as_tensor(rew[t]), torch.as_tensor(dones[t]), 0.99, clip=10.0)
        outs.append(o)
    for p in range(3):
        one = RewardNormState.create(8, 2, "cpu")
        for t in range(6):
            one, o = normalize_reward(one, torch.as_tensor(rew[t, p]), torch.as_tensor(dones[t, p]), 0.99, clip=10.0)
            np.testing.assert_allclose(outs[t][p].numpy(), o.numpy(), rtol=1e-6)
        for a, b in zip(pop, one):
            np.testing.assert_allclose(a[p].numpy(), b.numpy(), rtol=1e-6)


def test_array_box_sample():
    """``ArrayBox.sample`` (JAX ``envs/base.py::ArrayBox.sample``): uniform in
    [low, high) cast to the box's dtype, uint8 by default, one row per draw."""
    from morl_baselines_tpu.envs.base import ArrayBox as JArrayBox
    from morl_baselines_torch.envs.base import ArrayBox

    gen = torch.Generator().manual_seed(0)
    box = ArrayBox(0, 255, (4, 84, 84))
    x = box.sample(gen, 3)
    want = np.asarray(JArrayBox(0, 255, (4, 84, 84)).sample(jax.random.key(0)))
    assert x.shape == (3, *want.shape) and x.dtype == torch.uint8 and want.dtype == np.uint8
    assert int(x.min()) == 0 and int(x.max()) == 254  # floor of [0, 255): both ends reached over 84,672 draws
    assert abs(float(x.float().mean()) - float(want.mean())) < 1.0
    f = ArrayBox(-1.0, 2.0, (5,), torch.float32).sample(gen, 1000)
    assert f.dtype == torch.float32 and float(f.min()) >= -1.0 and float(f.max()) < 2.0
