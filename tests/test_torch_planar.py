"""Parity of the torch port's planar hopper/halfcheetah with the JAX package's.

The port writes the equations of motion out in closed form where the JAX
package takes them by autodiff, so the terms are compared one by one on 64
states from a JAX rollout under random actions (they include ground contact
and joint-limit violations), then one whole step.  The in-air trajectories
are also held against MuJoCo, as tests/test_planar.py does.

Tolerances (float32):
- the constants: exactly equal;
- the mass matrix, the right-hand side and the limit torques: atol 1e-5 x
  max|value| (sums of float32 products taken in another order);
- the contact torques: atol 1e-4 x max|value|, because the port folds
  kp = 2e4 into the constant matrix, so kp * pen is a sum of terms of size
  kp * 1.25 whose float32 rounding (about 1e-3 N) stands beside forces of up
  to 2e3 N;
- one step (4 substeps for the hopper, 20 for the halfcheetah): rtol 1e-4
  and atol 1e-4; the absolute part covers velocities that pass near zero,
  where the contact-force rounding above is all that is left;
- against MuJoCo: the JAX test's bounds (0.02 and 0.05 on qpos).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.envs import VectorMOEnv, make
from morl_baselines_torch.envs.planar import MOHalfCheetahJX, MOHopperJX, PlanarState
from morl_baselines_torch.envs.planar_models import HALF_CHEETAH, HOPPER
from morl_baselines_tpu.envs import planar as jplanar

torch.set_num_threads(1)

ENVS = {"hopper": (jplanar.MOHopperJX, MOHopperJX), "halfcheetah": (jplanar.MOHalfCheetahJX, MOHalfCheetahJX)}


@pytest.mark.parametrize("xml,model", [("hopper.xml", HOPPER), ("half_cheetah.xml", HALF_CHEETAH)])
def test_constants_equal_the_mujoco_projection(xml, model):
    jm, dt, nq, nu = jplanar._build_planar_model(xml)
    assert (model.timestep, model.nq, model.nu) == (dt, nq, nu)
    for name, want in jm._asdict().items():
        got = getattr(model, name)
        if isinstance(want, tuple):
            assert got == want, name
        else:
            assert got.dtype == np.float32, name
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def _rollout_states(jenv, n_states=64, seed=0):
    """States of a JAX rollout of 16 envs under random actions."""
    rng = np.random.default_rng(seed)
    n = 16
    keys = jax.random.split(jax.random.key(seed), n)
    st, _ = jax.vmap(jenv.reset)(keys)
    step = jax.jit(jax.vmap(jenv.step))
    qs, qds = [], []
    for _ in range(40):
        out = step(st, jnp.asarray(rng.uniform(-1, 1, (n, jenv.nu)), jnp.float32), keys)
        st = out.state
        qs.append(np.asarray(st.q))
        qds.append(np.asarray(st.qd))
    return np.concatenate(qs)[::10][:n_states], np.concatenate(qds)[::10][:n_states], rng


def _jax_terms(jenv):
    m = jenv.model

    def terms(q, qd, tau):
        T = lambda q_, qd_: jplanar._kinetic(m, q_, qd_)  # noqa: E731
        p_fn = jax.grad(T, argnums=1)
        M = jax.jacfwd(p_fn, argnums=1)(q, qd)
        coriolis = jax.jvp(lambda q_: p_fn(q_, qd), (q,), (qd,))[1]
        rhs = tau + jax.grad(T, 0)(q, qd) - jax.grad(lambda q_: jplanar._potential(m, q_))(q) - coriolis
        contact = jplanar._contact_tau(m, q, qd, jenv.kp, jenv.kd, jenv.v_slip)
        return M, rhs, contact, jplanar._limit_tau(m, q, qd, jenv.k_lim, jenv.d_lim)

    return jax.jit(jax.vmap(terms))


def _close_to_scale(got, want, frac):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("env", ["hopper", "halfcheetah"])
def test_dynamics_terms_and_step_parity(env):
    """M, the right-hand side, contact and limit torques, and one step."""
    jcls, tcls = ENVS[env]
    jenv, tenv = jcls(), tcls(device="cpu")
    q, qd, rng = _rollout_states(jenv)
    tau = (10 * rng.normal(size=q.shape)).astype(np.float32)
    M, rhs, contact, limit = _jax_terms(jenv)(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau))
    # the states exercise contact and limits
    assert (np.abs(np.asarray(contact)).sum(-1) > 0).sum() >= 8
    assert (np.abs(np.asarray(limit)).sum(-1) > 0).sum() >= 8

    dyn = tenv.dyn
    tq, tqd, ttau = torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(tau)
    out = dyn.features_out(tq, tqd)
    _close_to_scale(dyn.augmented(out, torch.zeros_like(tq))[..., :-1].numpy(), M, 1e-5)
    _close_to_scale(dyn.augmented(out, dyn.spring_tau(tq, ttau))[..., -1].numpy(), rhs, 1e-5)
    _close_to_scale(dyn.contact_tau(out).numpy(), contact, 1e-4)
    _close_to_scale(dyn.limit_tau(tq, tqd).numpy(), limit, 1e-5)
    np.testing.assert_allclose(
        dyn.solve(dyn.augmented(out, dyn.spring_tau(tq, ttau))).numpy(),
        np.asarray(jax.vmap(lambda a, b, c: jplanar._qdd(jenv.model, a, b, c))(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau))),
        rtol=1e-4, atol=1e-4,
    )

    a = rng.uniform(-1.2, 1.2, (q.shape[0], jenv.nu)).astype(np.float32)
    t = rng.integers(995, 1000, size=q.shape[0]).astype(np.int32)
    jout = jax.vmap(jenv.step)(
        jplanar.PlanarState(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(t)), jnp.asarray(a),
        jax.random.split(jax.random.key(1), q.shape[0]),
    )
    tout = tenv.step(PlanarState(tq, tqd, torch.as_tensor(t)), torch.as_tensor(a))
    for x, y in zip(jout.state, tout.state):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(jout.terminated))
    np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(jout.truncated))
    assert tout.truncated.any() and not tout.truncated.all()


# ---------------------------------------------------------------- mirrors of tests/test_planar.py


def _mujoco_env(gid):
    import gymnasium

    kw = {"terminate_when_unhealthy": False} if "Hopper" in gid else {}
    env = gymnasium.make(gid, max_episode_steps=-1, **kw)
    env.reset(seed=0)
    return env


def _state(q, qd):
    return PlanarState(
        torch.as_tensor(np.asarray(q, np.float32))[None], torch.as_tensor(np.asarray(qd, np.float32))[None],
        torch.zeros(1, dtype=torch.int32),
    )


def test_hopper_inair_parity_vs_mujoco():
    env = MOHopperJX(device="cpu")
    genv = _mujoco_env("Hopper-v5")
    q0 = np.array([0, 2.5, 0.1, -0.5, -0.4, 0.2])
    qd0 = 0.3 * np.ones(6)
    genv.unwrapped.set_state(q0.astype(float), qd0)
    s = _state(q0, qd0)
    rng = np.random.default_rng(1)
    for _ in range(10):
        a = rng.uniform(-1, 1, 3)
        genv.step(a)
        s = env.step(s, torch.as_tensor(a, dtype=torch.float32)[None]).state
        assert np.max(np.abs(s.q[0].numpy() - genv.unwrapped.data.qpos)) < 0.02


def test_halfcheetah_inair_parity_vs_mujoco():
    env = MOHalfCheetahJX(device="cpu")
    genv = _mujoco_env("HalfCheetah-v5")
    q0 = np.array([0, 2.0, 0.2, 0.2, -0.2, 0.1, -0.2, 0.2, -0.1])
    qd0 = 0.1 * np.ones(9)
    genv.unwrapped.set_state(q0.astype(float), qd0)
    s = _state(q0, qd0)
    for _ in range(8):
        genv.step(np.zeros(6))
        s = env.step(s, torch.zeros(1, 6)).state
        # stiff leg springs accumulate integrator drift; class-of-motion match
        assert np.max(np.abs(s.q[0].numpy() - genv.unwrapped.data.qpos)) < 0.05


def test_hopper_standing_equilibrium_matches_mujoco():
    env = MOHopperJX(device="cpu")
    s = _state([0, 1.25, 0, 0, 0, 0.0], np.zeros(6))
    for _ in range(30):
        s = env.step(s, torch.zeros(1, 3)).state
    assert abs(float(s.q[0, 1]) - 1.205) < 0.02  # MuJoCo settles at ~1.204-1.208
    assert abs(float(s.q[0, 2])) < 0.05


def test_planar_env_contract():
    """Registry, obs/reward shapes, termination, batched stepping; passive hoppers settle on the foot."""
    for name, obs_dim, act_dim, d in [("mo-hopper-jx-v5", 11, 3, 3), ("mo-halfcheetah-jx-v5", 17, 6, 2)]:
        env = make(name, device="cpu", max_episode_steps=7)
        assert env.name == name and env.max_episode_steps == 7 and env.obs_dim == obs_dim
        s, obs = env.reset(2, torch.Generator())
        assert obs.shape == (2, obs_dim)
        out = env.step(s, torch.zeros(2, act_dim))
        assert out.reward.shape == (2, d) and env.sample_noise(2, torch.Generator()) is None

    env = make("mo-hopper-jx-v5", device="cpu")
    n = 16
    venv = VectorMOEnv(env, n)
    gen = torch.Generator().manual_seed(0)
    st, _ = venv.reset(gen)
    terms = torch.zeros(n, dtype=torch.bool)
    for _ in range(80):
        out = venv.step(st, torch.zeros(n, 3), gen)
        st = out.state
        terms |= out.terminated
        assert not torch.isnan(out.reward).any()
    assert not bool(terms.any())
    assert np.all(np.abs(st.q[:, 1].numpy() - 1.205) < 0.05)


def test_hopper_hops_under_thrust():
    """A periodic ankle thrust gives forward motion and airborne phases."""
    env = MOHopperJX(device="cpu")
    s, _ = env.reset(1, torch.Generator().manual_seed(0))
    xs, zs = [], []
    for t in range(100):
        a = torch.tensor([[0.0, 0.0, 1.0 if (t // 10) % 2 == 0 else -1.0]])
        out = env.step(s, a)
        s = out.state
        xs.append(float(s.q[0, 0]))
        zs.append(float(s.q[0, 1]))
        if bool(out.terminated):
            break
    assert max(zs) > 1.28
    assert xs[-1] > 0.1
