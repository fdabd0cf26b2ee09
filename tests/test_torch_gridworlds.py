"""Parity of the torch port's four-room, resource-gathering, breakable-bottles
and highway envs with the JAX package's, the registry, and the env mirrors.

Random states and actions are made with numpy from a seed; each step's
uniform draw (the enemy attack, the bottle drop) is read off the JAX key and
handed to the port, and highway's reset draws likewise.  The gridworlds are
integer dynamics and compare exactly, as do ``state_index`` and
``pareto_front``.  Highway's positions and speeds are float32 sums of the
same terms in the same order: atol 1e-5 on its state and obs (positions up
to about 1.3e3 m, where a float32 ulp is 1.2e-4 m, scale to at most 1e-5 in
the obs), the rewards atol 1e-6 (a speed one ulp apart) and the flags
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.envs import ENV_REGISTRY, ENVS_WITH_KNOWN_PARETO_FRONT, make
from morl_baselines_torch.envs.breakable_bottles import BottlesState
from morl_baselines_torch.envs.four_room import FourRoomState
from morl_baselines_torch.envs.highway import HighwayState
from morl_baselines_torch.envs.resource_gathering import RGState
from morl_baselines_tpu.envs import ENV_REGISTRY as JENV_REGISTRY
from morl_baselines_tpu.envs import ENVS_WITH_KNOWN_PARETO_FRONT as JKNOWN
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.envs.breakable_bottles import BottlesState as JBottlesState
from morl_baselines_tpu.envs.four_room import FourRoomState as JFourRoomState
from morl_baselines_tpu.envs.resource_gathering import RGState as JRGState

torch.set_num_threads(1)
HOST_MUJOCO = {"mo-hopper-v5", "mo-halfcheetah-v5", "mo-hopper-v4", "mo-halfcheetah-v4", "mo-reacher-v4", "mo-reacher-v5"}


def _t(x):
    return torch.as_tensor(np.array(x))


def _uniforms(keys):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k))(keys))


def _assert_exact(jout, tout):
    for a, b in zip(jax.tree.leaves(jout.state), jax.tree.leaves(tuple(tout.state))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for name in ("obs", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)


def _four_room_states(rng, n):
    from morl_baselines_tpu.envs.four_room import _WALLS

    cells = np.argwhere(~_WALLS)
    pick = cells[rng.integers(0, len(cells), n)]
    return dict(row=pick[:, 0].astype(np.int32), col=pick[:, 1].astype(np.int32),
                items=rng.uniform(size=(n, 9)) < 0.7, t=rng.integers(190, 201, n).astype(np.int32))


def test_four_room_step_parity():
    """Four-room from every free cell: walls, doorways, pickups of each shape, the goal and truncation."""
    rng = np.random.default_rng(0)
    n = 3000
    st, act = _four_room_states(rng, n), rng.integers(0, 4, n)
    keys = jax.random.split(jax.random.key(0), n)
    jout = jax.vmap(jmake("four-room-v0").step)(JFourRoomState(**{k: jnp.asarray(v) for k, v in st.items()}),
                                                jnp.asarray(act, jnp.int32), keys)
    tout = make("four-room-v0").step(FourRoomState(**{k: _t(v) for k, v in st.items()}), _t(act))
    _assert_exact(jout, tout)
    r = tout.reward.numpy()
    assert all((r[:, i] == 1.0).any() for i in range(3)) and tout.terminated.any() and tout.truncated.any()


def test_resource_gathering_step_parity():
    """Every cell and carry combination, the attack draw handed over; enemy_proba 0.5 so attacks are frequent."""
    rng = np.random.default_rng(1)
    n = 3000
    st = dict(row=rng.integers(0, 5, n).astype(np.int32), col=rng.integers(0, 5, n).astype(np.int32),
              has_gold=rng.uniform(size=n) < 0.5, has_gem=rng.uniform(size=n) < 0.5,
              t=rng.integers(95, 101, n).astype(np.int32))
    act = rng.integers(0, 4, n)
    keys = jax.random.split(jax.random.key(1), n)
    jout = jax.vmap(jmake("resource-gathering-v0", enemy_proba=0.5).step)(
        JRGState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(act, jnp.int32), keys)
    tout = make("resource-gathering-v0", enemy_proba=0.5).step(RGState(**{k: _t(v) for k, v in st.items()}), _t(act),
                                                               _t(_uniforms(keys)))
    _assert_exact(jout, tout)
    r = tout.reward.numpy()
    assert (r[:, 0] == -1).any() and (r[:, 1] == 1).any() and (r[:, 2] == 1).any() and tout.truncated.any()


def test_breakable_bottles_step_parity():
    """Every location, carry and delivery count, the drop draw handed over."""
    rng = np.random.default_rng(2)
    n = 3000
    st = dict(loc=rng.integers(0, 5, n).astype(np.int32), carrying=rng.integers(0, 3, n).astype(np.int32),
              delivered=rng.integers(0, 2, n).astype(np.int32), dropped=rng.integers(0, 2, (n, 5)).astype(np.int32),
              t=rng.integers(95, 101, n).astype(np.int32))
    act = rng.integers(0, 3, n)
    keys = jax.random.split(jax.random.key(2), n)
    jout = jax.vmap(jmake("breakable-bottles-v0").step)(JBottlesState(**{k: jnp.asarray(v) for k, v in st.items()}),
                                                        jnp.asarray(act, jnp.int32), keys)
    tout = make("breakable-bottles-v0").step(BottlesState(**{k: _t(v) for k, v in st.items()}), _t(act), _t(_uniforms(keys)))
    _assert_exact(jout, tout)
    r = tout.reward.numpy()
    assert (r[:, 2] == -1).any() and (r[:, 1] == 25).any() and tout.truncated.any()


@pytest.mark.parametrize("env_id", ["four-room-v0", "resource-gathering-v0", "breakable-bottles-v0"])
def test_state_index_parity(env_id):
    """``state_index`` of every reachable obs kind equals the JAX package's, in range, batched over (..., obs_dim)."""
    rng = np.random.default_rng(3)
    hi = np.asarray(make(env_id).observation_space.high)
    obs = np.floor(rng.uniform(0, hi + 1, size=(20, 50, len(hi)))).astype(np.float32)
    if env_id == "breakable-bottles-v0":
        obs[..., 2] = np.minimum(obs[..., 2], 2)
    got = make(env_id).state_index(_t(obs)).numpy()
    want = np.asarray(jmake(env_id).state_index(jnp.asarray(obs)))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < make(env_id).num_states


@pytest.mark.parametrize("gamma", [1.0, 0.99, 0.9])
def test_resource_gathering_pareto_front_parity(gamma):
    for p in (0.1, 0.3):
        got = make("resource-gathering-v0", enemy_proba=p).pareto_front(gamma)
        np.testing.assert_array_equal(got, np.asarray(jmake("resource-gathering-v0", enemy_proba=p).pareto_front(gamma)))


def test_highway_reset_and_step_parity():
    """Highway resets given the JAX key's four draws, then 40 decisions of
    random actions, each stepped from the JAX state."""
    n = 256
    jenv, tenv = jmake("mo-highway-jx-v0"), make("mo-highway-jx-v0")
    keys = jax.random.split(jax.random.key(4), n)
    jstate, jobs = jax.vmap(jenv.reset)(keys)

    def draws(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return (jax.random.randint(k1, (), 0, 4), jax.random.randint(k2, (10,), 0, 4),
                jax.random.uniform(k3, (10,), minval=-8.0, maxval=8.0), jax.random.uniform(k4, (10,), minval=20.0, maxval=24.0))

    tstate, tobs = tenv.initial_state(*(_t(x) for x in jax.vmap(draws)(keys)))
    for a, b in zip(jstate, tstate):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6)

    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(5)
    crashed = 0
    for i in range(40):
        act = rng.integers(0, 5, n)
        jout = jstep(jstate, jnp.asarray(act, jnp.int32), keys)
        tout = tenv.step(HighwayState(*(_t(x) for x in jstate)), _t(act))
        for a, b in zip(jout.state, tout.state):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), atol=1e-6, err_msg=f"step {i}")
        for name in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
        crashed += int(tout.terminated.sum())
        jstate = jout.state
    assert crashed > 0 and tout.truncated.all()


def test_registry_parity():
    """Mirror of tests/test_envs.py::test_registry: the port has every id of
    the JAX registry; each but the host MuJoCo ones (tests/test_torch_mujoco.py)
    is checked here for spaces, reward width and one batched step."""
    assert set(ENV_REGISTRY) == set(JENV_REGISTRY) and HOST_MUJOCO <= set(ENV_REGISTRY)
    assert ENVS_WITH_KNOWN_PARETO_FRONT == JKNOWN
    gen = torch.Generator().manual_seed(0)
    for name in sorted(set(ENV_REGISTRY) - HOST_MUJOCO):
        kw = {"device": "cpu"} if "-jx-v5" in name else {}
        env, jenv = make(name, **kw), jmake(name)
        assert env.name == name and env.reward_dim == jenv.reward_dim and env.obs_dim == jenv.obs_dim
        assert type(env.action_space).__name__ == type(jenv.action_space).__name__
        state, _ = env.reset(3, gen)
        out = env.step(state, env.action_space.sample(gen, 3), env.sample_noise(3, gen))
        assert out.reward.shape == (3, env.reward_dim) and bool(torch.isfinite(out.reward).all()), name
        assert out.obs.shape[0] == 3 and out.terminated.shape == (3,), name
    with pytest.raises(KeyError):
        make("mo-swimmer-v5")  # an id neither package has


def test_resource_gathering():
    """Mirror of tests/test_envs.py::test_resource_gathering: the gem route with no enemies."""
    env = make("resource-gathering-v0", enemy_proba=0.0)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(1, gen)
    np.testing.assert_array_equal(obs.numpy(), [[4.0, 2.0, 0.0, 0.0]])
    for a in [0, 0, 0, 3, 3, 2, 2, 1, 1, 1]:
        out = env.step(state, torch.tensor([a]), env.sample_noise(1, gen))
        state = out.state
    assert bool(out.terminated[0])
    np.testing.assert_allclose(out.reward.numpy(), [[0.0, 0.0, 1.0]])


def test_four_room():
    """Mirror of tests/test_envs.py::test_four_room."""
    env = make("four-room-v0")
    gen = torch.Generator().manual_seed(0)
    s, obs = env.reset(1, gen)
    assert obs.shape == (1, 11) and env.reward_dim == 3
    for _ in range(6):  # up from (12, 0): blocked at the row-6 wall (col 0 is no doorway)
        s = env.step(s, torch.tensor([0])).state
    assert int(s.row[0]) == 7
    idx = env.state_index(env._obs(s))
    assert 0 <= int(idx[0]) < env.num_states
    s2, _ = env.reset(1, gen)
    s2 = s2._replace(row=torch.tensor([2], dtype=torch.int32), col=torch.tensor([3], dtype=torch.int32))
    out = env.step(s2, torch.tensor([2]))  # left onto the shape-0 item at (2, 2)
    np.testing.assert_allclose(out.reward.numpy(), [[1.0, 0.0, 0.0]])


def test_breakable_bottles():
    """Mirror of tests/test_envs.py::test_breakable_bottles: pick up two,
    walk right, fetch replacements for dropped bottles, deliver."""
    env = make("breakable-bottles-v0")
    gen = torch.Generator().manual_seed(3)
    s, _ = env.reset(1, gen)

    def step(s, a):
        return env.step(s, torch.tensor([a]), env.sample_noise(1, gen))

    for _ in range(2):
        s = step(s, 2).state
    assert int(s.carrying[0]) == 2
    total, done = np.zeros(3), False
    for _ in range(40):
        out = step(s, 1)
        s = out.state
        total += out.reward[0].numpy()
        if bool(out.terminated[0]):
            done = True
            break
        if int(s.carrying[0]) < 2 and int(s.loc[0]) == 0:
            s = step(s, 2).state
        elif int(s.carrying[0]) == 0:
            for _ in range(int(s.loc[0])):
                out = step(s, 0)
                s = out.state
                total += out.reward[0].numpy()
            s = step(step(s, 2).state, 2).state
    assert done and total[1] == 25.0
    assert total[0] <= -4


def test_highway_env():
    """Mirror of tests/test_envs.py::test_highway_env: rewards in range, random
    driving crashes, the keep-right policy survives the 40-decision horizon."""
    from morl_baselines_torch.envs import VectorMOEnv

    env = make("mo-highway-jx-v0")
    assert env.reward_dim == 3 and env.obs_dim == 25
    gen = torch.Generator().manual_seed(1)
    venv = VectorMOEnv(env, 8)
    st, obs = venv.reset(gen)
    assert obs.shape == (8, 25) and bool(torch.isfinite(obs).all())
    rw, term = [], []
    for _ in range(120):
        out = venv.step(st, torch.randint(0, 5, (8,), generator=gen), gen)
        st = out.state
        rw.append(out.reward.numpy())
        term.append(out.terminated.numpy())
    rw = np.stack(rw)
    assert rw[..., 0].min() >= 0.0 and rw[..., 0].max() <= 1.0
    assert rw[..., 1].min() >= 0.0 and rw[..., 1].max() <= 1.0
    assert set(np.unique(rw[..., 2])) <= {-1.0, 0.0}
    assert np.stack(term).any()
    s, _ = env.reset(1, torch.Generator().manual_seed(5))
    tot = np.zeros(3)
    for _ in range(40):
        out = env.step(s, torch.tensor([2]))
        s = out.state
        tot += out.reward[0].numpy()
        if bool(out.terminated[0]):
            break
    assert bool(out.truncated[0]) and not bool(out.terminated[0])
    assert tot[1] > 35.0 and tot[2] == 0.0
