"""The port's host-stepped MuJoCo envs against the JAX package's adapter.

The host functions are held bitwise equal to the JAX adapter's given the
same pool slots, seeds and actions; the batched API, ``VectorMOEnv``'s
hooks (one host call a vector step, autoreset on the host, no new pool
slots) and the mirrors of the JAX tests run on the CPU.  Gated on
gymnasium and mujoco, as tests/test_extras.py gates its MuJoCo test.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("gymnasium")
pytest.importorskip("mujoco")

from morl_baselines_tpu.envs import make as jmake  # noqa: E402
from morl_baselines_torch.envs import VectorMOEnv, make  # noqa: E402

torch.set_num_threads(1)


def test_mujoco_host_adapter():
    """Mirror of tests/test_extras.py::test_mujoco_host_adapter."""
    env = make("mo-halfcheetah-v5")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(1, gen)
    assert obs.shape == (1, env.obs_dim)
    out = env.step(state, torch.zeros((1, env.action_dim)))
    assert out.reward.shape == (1, 2)
    venv = VectorMOEnv(env, 3)
    vs, vobs = venv.reset(gen)
    vout = venv.step(vs, torch.zeros((3, env.action_dim)), gen)
    assert vout.reward.shape == (3, 2)
    assert bool(torch.isfinite(vout.reward).all())


def test_mo_reacher_episode_length():
    """Mirror of tests/test_envs.py::test_mo_reacher_episode_length: the inner
    gymnasium TimeLimit is off, so mo-reacher's own 100 steps end the episode."""
    env = make("mo-reacher-v5")
    assert env.observation_space.shape == (6,)
    assert env.reward_dim == 4 and env.num_actions == 9
    gen = torch.Generator().manual_seed(0)
    s, obs = env.reset(1, gen)
    assert obs.shape == (1, 6)
    steps = 0
    for _ in range(150):
        out = env.step(s, torch.zeros(1, dtype=torch.int64))
        s = out.state
        steps += 1
        assert out.reward.shape == (1, 4)
        if bool(out.terminated[0]) or bool(out.truncated[0]):
            break
    assert steps == 100


def test_mujoco_batched_vector_step():
    """Mirror of tests/test_envs.py::test_mujoco_batched_vector_step: the
    whole batch steps through one host call a vector step, with same-step
    autoreset on the host; the pool allocates no slot after the reset."""
    env = make("mo-hopper-v5", max_episode_steps=3)
    venv = VectorMOEnv(env, 4)
    gen = torch.Generator().manual_seed(0)
    state, obs = venv.reset(gen)
    assert obs.shape == (4, env.obs_dim) and len(env._pool.envs) == 4
    for i in range(8):
        out = venv.step(state, torch.zeros((4, env.action_dim)), gen)
        state = out.state
        assert out.obs.shape == (4, env.obs_dim)
        assert out.reward.shape == (4, env.reward_dim)
        assert out.final_obs.shape == (4, env.obs_dim)
        if i % 3 == 2:  # the third step of each episode truncates and resets on the host
            assert bool(out.truncated.all()) and bool((state.t == 0).all())
            assert not torch.equal(out.obs, out.final_obs)
        else:
            assert bool((state.t == i % 3 + 1).all()) and torch.equal(out.obs, out.final_obs)
    assert len(env._pool.envs) == 4
    env.close()
    assert env._pool.envs == [] and env._executor_cached is None


@pytest.mark.parametrize("env_id", ["mo-hopper-v5", "mo-halfcheetah-v5", "mo-reacher-v5"])
def test_host_functions_equal_jax(env_id):
    """``_host_reset``, ``_host_step`` and ``_host_vector_step`` give the JAX
    adapter's numbers bitwise for the same slots, seeds and actions, over 12
    vector steps of 5-step episodes (so the host autoreset fires)."""
    env, jenv = make(env_id, max_episode_steps=5), jmake(env_id, max_episode_steps=5)
    rng = np.random.default_rng(0)
    n = 4
    seeds = rng.integers(0, 2**31 - 1, size=n)
    got = [env._host_reset(s) for s in seeds]
    want = [jenv._host_reset(s) for s in seeds]
    for (gs, go), (ws, wo) in zip(got, want):
        assert gs == ws and np.array_equal(go, wo)
    slots = np.array([g[0] for g in got], dtype=np.int32)
    t = np.zeros(n, dtype=np.int32)
    discrete = env_id == "mo-reacher-v5"
    resets = 0
    for step in range(12):
        actions = rng.integers(0, 9, size=n) if discrete else rng.uniform(-1, 1, size=(n, env.action_dim)).astype(np.float32)
        seeds = rng.integers(0, 2**31 - 1, size=n)
        out = env._host_vector_step(slots, t, actions, seeds)
        jout = jenv._host_vector_step(slots, t, actions, seeds)
        for a, b in zip(out, jout):
            assert a.dtype == b.dtype and np.array_equal(a, b), step
        t = out[1]
        resets += int(out[5].sum())
    assert t.max() < 5 and resets >= 2 * n
    a = actions[0]
    for x, y in zip(env._host_step(slots[0], a), jenv._host_step(slots[0], a)):
        assert np.array_equal(x, y)


def test_tensor_api_equals_jax_host():
    """The batched ``step`` carries device tensors to and from the host: given
    the JAX adapter's slots and actions it returns the host step's numbers."""
    env, jenv = make("mo-hopper-v5"), jmake("mo-hopper-v5")
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset(2, gen)
    jslots = [jenv._host_reset(s) for s in torch.randint(0, 2**31 - 1, (2,), generator=torch.Generator().manual_seed(3)).numpy()]
    np.testing.assert_array_equal(obs.numpy(), np.stack([o for _, o in jslots]))
    a = np.random.default_rng(1).uniform(-1, 1, size=(2, 3)).astype(np.float32)
    out = env.step(state, torch.as_tensor(a))
    for i, (slot, _) in enumerate(jslots):
        jo, jr, jt, jtr = jenv._host_step(slot, a[i])
        assert np.array_equal(out.obs[i].numpy(), jo) and np.array_equal(out.reward[i].numpy(), jr)
        assert bool(out.terminated[i]) == bool(jt)
    assert out.state.t.tolist() == [1, 1] and out.obs.dtype == torch.float32
