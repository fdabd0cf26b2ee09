"""Parity of the torch port's lunar landers with the JAX package's, and the landing mirrors.

Random states, actions and the JAX key's draws (the reset force, each step's
dispersion) are made from numpy and JAX seeds and handed to both envs.  One
step from the same state and noise: states and obs atol 1e-5 with rtol 1e-6
(eight substeps of float32 sin/cos and sums that round otherwise; the
shaping potential is near -100, where a float32 ulp is 7.6e-6), rewards atol
1e-4 (the shaped reward is a difference of two such potentials), the flags
exactly.  A trajectory could diverge once a contact or a ``where`` branch
flips on a rounding difference; from identical resets under the same
actions and noise, 200 steps (every lander has ended by then) stay within
1.7e-5 of the JAX obs on this test's seeds, so the trajectory holds obs at
1e-4 and the flags exactly.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.envs import lander_heuristic, make
from morl_baselines_torch.envs.lunar_lander import CONTACT_K, HELIPAD_Y, LEG_TIP_Y, MASS, LLState, W
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.envs.lunar_lander import LLState as JLLState

torch.set_num_threads(1)
ENVS = ["mo-lunar-lander-v3", "mo-lunar-lander-continuous-v3"]


def _t(x):
    return torch.as_tensor(np.array(x))


REST = 100  # the first rows rest on both legs, engines off: they land in one step


def _states(rng, n):
    """Landers near the pad (legs touching, bouncing, crashing), tilted and
    spinning, the first ``REST`` at rest on the spring contacts; t near the limit."""
    st = dict(
        x=rng.uniform(W / 2 - 6, W / 2 + 6, n), y=rng.uniform(HELIPAD_Y + 0.3, HELIPAD_Y + 2.0, n),
        vx=rng.normal(0, 1, n), vy=rng.normal(-1, 1, n), angle=rng.normal(0, 0.3, n), omega=rng.normal(0, 0.5, n),
        prev_shaping=rng.normal(-100, 30, n), t=rng.integers(990, 1001, n),
    )
    st["y"][:REST] = HELIPAD_Y - LEG_TIP_Y - MASS * 10.0 / 2 / CONTACT_K  # both springs carry the weight
    for k in ("vx", "vy", "angle", "omega"):
        st[k][:REST] = 0.0
    return {k: v.astype(np.int32 if k == "t" else np.float32) for k, v in st.items()}


def _actions(env_id, rng, n):
    if "continuous" in env_id:
        act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        act[:REST] = (-1.0, 0.0)
        return act
    act = rng.integers(0, 4, n).astype(np.int32)
    act[:REST] = 0
    return act


def _dispersion(keys):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0))(keys))


def _assert_out(jout, tout, atol=1e-5):
    for name, a, b in zip(LLState._fields, jout.state, tout.state):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), atol=atol, rtol=1e-6)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(jout.terminated))
    np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(jout.truncated))


@pytest.mark.parametrize("env_id", ENVS)
def test_reset_parity(env_id):
    """Reset given the JAX key's (2,) initial force."""
    keys = jax.random.split(jax.random.key(2), 500)
    jstate, jobs = jax.vmap(jmake(env_id).reset)(keys)
    force = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1000.0, maxval=1000.0))(keys))
    tstate, tobs = make(env_id).initial_state(_t(force))
    for name, a, b in zip(LLState._fields, jstate, tstate):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6)
    # reset(n, gen) draws the force within the bounds
    st, obs = make(env_id).reset(64, torch.Generator().manual_seed(0))
    assert obs.shape == (64, 8) and float(st.vx.abs().max()) <= 1000.0 * (1 / 50) / 4.96


@pytest.mark.parametrize("env_id", ENVS)
def test_step_parity(env_id):
    """One step of 2000 landers from random states, given the JAX key's dispersion."""
    rng = np.random.default_rng(0)
    n = 2000
    st, act = _states(rng, n), _actions(env_id, rng, n)
    keys = jax.random.split(jax.random.key(1), n)
    jout = jax.vmap(jmake(env_id).step)(JLLState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(act), keys)
    tout = make(env_id).step(LLState(**{k: _t(v) for k, v in st.items()}), _t(act), _t(_dispersion(keys)))
    _assert_out(jout, tout)
    # the batch lands, crashes, flies on and truncates
    rew0 = tout.reward[:, 0].numpy()
    assert (rew0 == 100.0).any() and (rew0 == -100.0).any() and (~tout.terminated).any() and tout.truncated.any()


@pytest.mark.parametrize("env_id", ENVS)
def test_trajectory_parity(env_id):
    """64 landers from identical resets, 200 steps of the same random actions and dispersion, no autoreset."""
    n, steps = 64, 200
    je, te = jmake(env_id), make(env_id)
    keys = jax.random.split(jax.random.key(5), n)
    jstate, _ = jax.vmap(je.reset)(keys)
    force = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,), minval=-1000.0, maxval=1000.0))(keys))
    tstate, _ = te.initial_state(_t(force))
    jstep = jax.jit(jax.vmap(je.step))
    rng = np.random.default_rng(3)
    for i in range(steps):
        act = _actions(env_id, rng, n)
        skeys = jax.random.split(jax.random.fold_in(jax.random.key(6), i), n)
        jout = jstep(jstate, jnp.asarray(act), skeys)
        tout = te.step(tstate, _t(act), _t(_dispersion(skeys)))
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(jout.terminated), err_msg=f"step {i}")
        jstate, tstate = jout.state, tout.state
    assert bool(tout.terminated.all())


def _rollout(env, n, gen, policy):
    """Total reward (n, 4) of one episode per lander (rewards after its end are dropped) and its done flags."""
    state, obs = env.reset(n, gen)
    done = torch.zeros(n, dtype=torch.bool)
    total = torch.zeros(n, 4)
    for _ in range(1000):
        out = env.step(state, policy(obs), env.sample_noise(n, gen))
        total += torch.where(done[:, None], 0.0, out.reward)
        done |= out.terminated | out.truncated
        state, obs = out.state, out.obs
        if bool(done.all()):
            break
    return total.numpy(), done.numpy()


def test_lunar_lander_heuristic_lands():
    """Mirror of tests/test_envs.py::test_lunar_lander_heuristic_lands: the PD
    controller lands (+100 on objective 0) in 90% of 16 episodes and burns
    main-engine fuel; random actions crash in 70%."""
    env = make("mo-lunar-lander-v3")
    total, done = _rollout(env, 16, torch.Generator().manual_seed(3), lander_heuristic)
    assert done.all()
    assert (total[:, 0] == 100.0).mean() >= 0.9
    assert (total[:, 2] < 0.0).all()
    gen = torch.Generator().manual_seed(4)
    total_rnd, _ = _rollout(env, 16, torch.Generator().manual_seed(3), lambda obs: torch.randint(0, 4, (16,), generator=gen))
    assert (total_rnd[:, 0] == -100.0).mean() >= 0.7


def test_lander_heuristic_matches_jax():
    """The port's heuristic equals the JAX test's on random obs (legs touching or not)."""
    spec = importlib.util.spec_from_file_location("_jax_env_tests", pathlib.Path(__file__).with_name("test_envs.py"))
    jax_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tests)
    _lander_heuristic = jax_tests._lander_heuristic
    rng = np.random.default_rng(7)
    obs = rng.normal(0, 0.5, (1000, 8)).astype(np.float32)
    obs[:, 6:] = rng.uniform(size=(1000, 2)) < 0.3
    want = np.asarray(jax.vmap(_lander_heuristic)(jnp.asarray(obs)))
    np.testing.assert_array_equal(lander_heuristic(_t(obs)).numpy(), want)


def test_lunar_lander_continuous_interface():
    """Mirror of tests/test_envs.py::test_lunar_lander_continuous_interface."""
    env = make("mo-lunar-lander-continuous-v3")
    assert env.reward_dim == 4 and env.action_dim == 2
    gen = torch.Generator().manual_seed(0)
    s, _ = env.reset(1, gen)
    out = env.step(s, torch.tensor([[1.0, 0.0]]), env.sample_noise(1, gen))
    assert out.obs.shape == (1, 8) and out.reward.shape == (1, 4)
    np.testing.assert_allclose(float(out.reward[0, 2]), -0.30, atol=1e-6)  # full main throttle costs 0.30 fuel
    assert float(out.reward[0, 3]) == 0.0
