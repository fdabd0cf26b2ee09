"""Parity of the torch port's continuous GPI-PD with the JAX package's, and its smoke checks.

The imagined rollout is compared on the same actor (params and batch
statistics from the flax init), the same ensemble (params, normalizer and
elites), the same start rows and the same noise: the start indices, the
exploration noise, the elite choice and the sample noise are all read off
the JAX key and handed to the port.  Tolerance: atol 1e-5 on the stored
rows and the mean uncertainty (float32 forwards summed in another order);
the buffer's size and pointer and the terminated flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from morl_baselines_torch.agents import GPIPDContinuous, GPIPDContinuousConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import load_flax_params, load_flax_variables
from morl_baselines_torch.models.dynamics import EnsembleConfig
from morl_baselines_torch.replay import PrioritizedReplayBuffer, Transition
from morl_baselines_tpu.agents import GPIPDContinuous as JGPIPDContinuous
from morl_baselines_tpu.agents import GPIPDContinuousConfig as JGPIPDContinuousConfig
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.models.dynamics import EnsembleConfig as JEnsembleConfig
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_tpu.replay.prioritized import PrioritizedReplayBuffer as JPrioritizedReplayBuffer

torch.set_num_threads(1)
ATOL = 1e-5
STARTS, LEN = 48, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _agents(threshold):
    common = dict(num_envs=4, buffer_size=256, batch_size=32, hidden=(32, 32), max_support=4,
                  dynamics_rollout_starts=STARTS, dynamics_rollout_len=LEN, dyna_buffer_size=512,
                  dynamics_uncertainty_threshold=threshold)
    ens = dict(num_members=3, num_elites=2, hidden=(32, 32), batch_size=32)
    jagent = JGPIPDContinuous(jmake("mo-hopper-jx-v5"), JGPIPDContinuousConfig(**common, ensemble=JEnsembleConfig(**ens)))
    tagent = GPIPDContinuous(make("mo-hopper-jx-v5", device="cpu"),
                             GPIPDContinuousConfig(**common, ensemble=EnsembleConfig(**ens)), device="cpu")
    return jagent, tagent


def _hopper_rows(rng, n):
    """Hopper-like observations near the healthy boundary (z ~ 0.72-1.3, small angles)."""
    obs = rng.normal(scale=0.1, size=(n, 11)).astype(np.float32)
    obs[:, 0] = rng.uniform(0.72, 1.3, size=n)
    return dict(
        obs=obs, action=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        reward=rng.normal(size=(n, 3)).astype(np.float32), next_obs=obs.copy(),
        terminated=np.zeros(n, np.float32),
    )


def test_rollout_keep_filter_and_alive_mask_parity():
    """``rollout_dynamics`` with the same actor, ensemble, start rows and noise:
    the kept rows (dropped rows written as copies of the first kept one),
    the terminal transitions kept and their rows frozen afterwards."""
    rng = np.random.default_rng(0)
    jagent, tagent = _agents(threshold=np.inf)
    jstate = jagent.init_state(jax.random.key(0))
    tstate = tagent.init_state()
    data = _hopper_rows(rng, 100)
    w = np.array([[0.6, 0.3, 0.1]], np.float32)
    jbase = jagent.set_weight_support(jstate.base, list(w))
    jbase = jbase._replace(buffer=jbase.buffer.add_batch(JTransition(**{k: jnp.asarray(v) for k, v in data.items()})))
    # a model of small, confident steps, so that rows survive a step and are stepped again
    params = _np(jstate.ens.ts.params)
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * 0.02
    params["params"]["max_logvar"] = np.full_like(params["params"]["max_logvar"], -8.0)
    jens = jstate.ens._replace(
        ts=jstate.ens.ts.replace(params=jax.tree.map(jnp.asarray, params)),
        in_mean=jnp.asarray(rng.normal(scale=0.2, size=14), jnp.float32),
        in_std=jnp.asarray(rng.uniform(0.5, 1.5, size=14), jnp.float32),
        elite_idx=jnp.asarray([2, 0]),
    )
    jstate = jstate._replace(base=jbase, ens=jens)

    tagent.set_weight_support(tstate.base, list(w))
    tstate.base.buffer.add_batch(Transition(**{k: torch.as_tensor(v) for k, v in data.items()}))
    load_flax_variables(tstate.base.actor.net, {"params": _np(jbase.actor_ts.params), "batch_stats": _np(jbase.actor_ts.batch_stats)})
    load_flax_params(tstate.ens.net, _np(jens.ts.params))
    tstate.ens.in_mean, tstate.ens.in_std = torch.as_tensor(np.asarray(jens.in_mean)), torch.as_tensor(np.asarray(jens.in_std))
    tstate.ens.elite_idx = torch.as_tensor(np.asarray(jens.elite_idx))

    # every draw of the JAX rollout, from its key
    key = jax.random.key(7)
    k_obs, _k_w, k_steps = jax.random.split(key, 3)
    start = np.asarray(jax.random.randint(k_obs, (STARTS,), 0, 100))
    act_noise, choice, model_noise = [], [], []
    for k in jax.random.split(k_steps, LEN):
        ka, km = jax.random.split(k)
        k1, k2 = jax.random.split(km)
        act_noise.append(np.asarray(jax.random.normal(ka, (STARTS, 3))))
        choice.append(np.asarray(jens.elite_idx[jax.random.randint(k1, (STARTS,), 0, 2)]))
        model_noise.append(np.asarray(jax.random.normal(k2, (STARTS, 14))))

    # a threshold that drops about a third of the rows at the first step
    obs0 = jnp.asarray(data["obs"][start])
    a0 = jnp.clip(jagent._actor_fwd(jbase.actor_ts, obs0, jnp.tile(jnp.asarray(w), (STARTS, 1))) + 0.1 * act_noise[0], -1, 1)
    _, unc0 = jagent.dynamics.predict(jens, jnp.concatenate([obs0, a0], -1), jax.random.key(0))
    threshold = float(np.quantile(np.asarray(unc0), 0.66))
    jagent.cfg = jagent.cfg.__class__(**{**jagent.cfg.__dict__, "dynamics_uncertainty_threshold": threshold})
    tagent.cfg = tagent.cfg.__class__(**{**tagent.cfg.__dict__, "dynamics_uncertainty_threshold": threshold})
    jstate2, jmean_unc = jagent.rollout_dynamics(jstate, key)

    step = iter(range(LEN))
    draws = {}
    tstate.base.buffer.sample_obs = lambda gen, n: tstate.base.buffer.data.obs[torch.as_tensor(start)]
    tagent._explore = lambda a, gen: torch.clamp(a + 0.1 * torch.as_tensor(act_noise[draws.setdefault("i", next(step))]), -1.0, 1.0)
    predict = tagent.dynamics.predict

    def fixed_predict(state, x, gen=None, choice_=None, noise=None):
        i = draws.pop("i")
        return predict(state, x, choice=torch.as_tensor(choice[i]), noise=torch.as_tensor(model_noise[i]))

    tagent.dynamics.predict = fixed_predict
    tstate, tmean_unc = tagent.rollout_dynamics(tstate)

    jd, td = jstate2.dyna_buffer, tstate.dyna_buffer
    assert td.size == int(jd.size) and td.ptr == int(jd.ptr)
    n = td.size
    for name in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_allclose(getattr(td.data, name)[:n].numpy(), np.asarray(getattr(jd.data, name))[:n], atol=ATOL)
    np.testing.assert_array_equal(td.data.terminated[:n].numpy(), np.asarray(jd.data.terminated)[:n])
    np.testing.assert_allclose(float(tmean_unc), float(jmean_unc), atol=ATOL)
    # the run covers dropped rows, terminations and rows stepped again after surviving
    term = td.data.terminated[:n].numpy()
    assert n == LEN * STARTS and 0 < term.sum() < STARTS
    assert not torch.equal(td.data.obs[STARTS : 2 * STARTS], td.data.obs[:STARTS])
    assert len(np.unique(td.data.obs[:STARTS].numpy(), axis=0)) < STARTS  # dropped rows hold copies


def test_reset_priorities_parity():
    """Uniform priorities on the valid rows, 0 beyond ``size``, the running max reset."""
    rng = np.random.default_rng(1)
    data = _hopper_rows(rng, 40)
    jbuf = JPrioritizedReplayBuffer.create(64, 11, (3,), 3, jnp.float32).add_batch(
        JTransition(**{k: jnp.asarray(v) for k, v in data.items()})
    )
    tbuf = PrioritizedReplayBuffer.create(64, 11, (3,), 3, torch.float32, device="cpu")
    tbuf.add_batch(Transition(**{k: torch.as_tensor(v) for k, v in data.items()}))
    idx = rng.integers(0, 40, size=16)
    pr = rng.uniform(0.1, 3.0, size=16).astype(np.float32)
    jbuf = jbuf.update_priorities(jnp.asarray(idx), jnp.asarray(pr)).reset_priorities()
    tbuf.update_priorities(torch.as_tensor(idx), torch.as_tensor(pr)).reset_priorities()
    np.testing.assert_array_equal(tbuf.priorities.numpy(), np.asarray(jbuf.priorities))
    assert float(tbuf.max_priority) == float(jbuf.max_priority) == 1.0
    assert tbuf.priorities[:40].eq(1.0).all() and tbuf.priorities[40:].eq(0.0).all()


def test_gpipd_continuous_model_based():
    """Mirror of tests/test_agents_multi.py::test_gpipd_continuous_model_based
    on the port: dynamics fit, imagined actor rollouts and PER end to end; the
    second outer iteration resets the priorities."""
    env = make("mo-mountaincarcontinuous-v0")
    cfg = GPIPDContinuousConfig(
        num_envs=4, buffer_size=2048, batch_size=32, hidden=(32, 32),
        learning_starts=64, gradient_updates=1, max_support=4,
        per=True, dyna=True,
        dynamics_train_freq=40, dynamics_fit_samples=128, dynamics_rollout_starts=16,
        dynamics_rollout_len=2, dyna_buffer_size=512,
        ensemble=EnsembleConfig(num_members=2, num_elites=1, epochs=2, hidden=(32, 32), batch_size=32),
    )
    agent = GPIPDContinuous(env, cfg, device="cpu")
    resets = []
    agent._on_new_task = lambda state, w, f=agent._on_new_task: resets.append(state.base.buffer.size) or f(state, w)
    state = agent.train(total_timesteps=600, ref_point=np.array([-1100.0, -110.0]),
                        timesteps_per_iter=300, num_eval_weights_for_front=2, eval_max_steps=30)
    assert isinstance(state.base.buffer, PrioritizedReplayBuffer)
    assert int(state.dyna_buffer.size) > 0
    assert len(agent._linear_support.ccs) >= 1
    assert resets == [0, 300]
    prios = state.base.buffer.priorities[: state.base.buffer.size]
    assert bool(torch.isfinite(prios).all()) and float(prios.min()) >= 0.1**0.6 - 1e-6
