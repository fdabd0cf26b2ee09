"""Parity of the port's NL-MOPPO and IPRO with the JAX package's.

Params come from the flax init and are carried across with
``load_flax_params``; the rollout's Gumbel noise and the epochs'
permutations are read off the JAX key chain and handed to the port.
Tolerances: ``NLAgentNet`` 1e-5; the AASF and its loss weights at a tie
exact (``torch.amin`` splits the subgradient of the min as ``jnp.min``
does); a whole ``train_iteration`` on deep-sea-treasure with ``lr_frac`` < 1
exact on the rollout's actions, obs and accrued rewards, 1e-5 on the params;
``policy_evaluate`` 1e-5; the n-D IPRO point-set machinery and the IPRO-2D
box split exact; the float64 volumes of the n-D loop exact (both packages'
host HV run the native WFG), 1e-12 where the JAX package's library is not built; the n-D loop's
stopping rule on a stubbed oracle exact.  Then the smoke mirrors of
tests/test_agents_multi.py::test_nlmoppo_and_ipro2d and ::test_ipro_nd_end_to_end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import IPRO, IPRO2D, NLMOPPO, IPROConfig, NLAgentNet, NLMOPPOConfig
from morl_baselines_torch.agents.ipro import Box, make_aasf, make_linear_u
from morl_baselines_torch.agents.nlmoppo import loss_weights
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import load_flax_params, to_flax_params
from morl_baselines_tpu.agents.ipro import IPRO as JIPRO
from morl_baselines_tpu.agents.ipro import IPRO2D as JIPRO2D
from morl_baselines_tpu.agents.ipro import Box as JBox
from morl_baselines_tpu.agents.ipro import IPROConfig as JIPROConfig
from morl_baselines_tpu.agents.ipro import make_aasf as jmake_aasf
from morl_baselines_tpu.agents.nlmoppo import NLMOPPO as JNLMOPPO
from morl_baselines_tpu.agents.nlmoppo import NLMOPPOConfig as JNLMOPPOConfig
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.utils import native as jnative

torch.set_num_threads(1)
TINY = dict(num_envs=4, num_steps=32, num_minibatches=2, update_epochs=1, hidden=(16, 16))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_nl_agent_net_from_flax():
    jagent = JNLMOPPO(jmake("deep-sea-treasure-v0"), JNLMOPPOConfig(hidden=(32, 16)))
    params = jagent.net.init(jax.random.key(0), jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    net = load_flax_params(NLAgentNet(2, 2, 4, (32, 16)), _np(params))
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 10, size=(30, 2)).astype(np.float32)
    acc = rng.uniform(-20, 20, size=(30, 2)).astype(np.float32)
    logits, v = jax.jit(jagent.net.apply)(params, obs, acc)
    with torch.no_grad():
        tlogits, tv = net(_t(obs), _t(acc))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-5)
    jax.tree.map(np.testing.assert_array_equal, to_flax_params(net), _np(params["params"]))


def test_aasf_and_loss_weights_at_a_tie():
    """At v with tied fractions the gradient of the min splits evenly (0.55,
    0.55 for min + 0.1 mean): the AASF values and loss weights exact, at a
    tie and off it, in 2-D and 3-D."""
    cases = [
        ((0.0, 0.0), (0.0, 0.0), (2.0, 2.0), [(1.0, 1.0), (1.5, 0.5)]),
        ((1.0, -3.0, 0.5), (0.0, -5.0, 0.0), (4.0, 1.0, 2.0), [(2.5, -1.5, 1.25), (2.0, -1.0, 1.0), (3.0, 0.0, 1.0)]),
    ]
    for referent, nadir, ideal, points in cases:
        u, ju = make_aasf(referent, nadir, ideal, device="cpu"), jmake_aasf(referent, nadir, ideal)
        for v in points:
            v = np.asarray(v, np.float32)
            assert float(u(_t(v))) == float(ju(jnp.asarray(v)))
            np.testing.assert_array_equal(loss_weights(u, _t(v)).numpy(), np.asarray(jax.grad(ju)(jnp.asarray(v))))
    tie = loss_weights(make_aasf((0, 0), (0, 0), (1, 1), scale=1.0, device="cpu"), _t(np.ones(2, np.float32))).numpy()
    np.testing.assert_allclose(tie, [0.55, 0.55], rtol=1e-7)  # min's 1 split in halves, plus 0.1 mean's 0.05
    np.testing.assert_array_equal(loss_weights(make_linear_u([0.3, 0.7], device="cpu"), _t(np.ones(2, np.float32))).numpy(), np.float32([0.3, 0.7]))


def _jax_noise(js, jagent, cfg):
    """The rollout's Gumbel noise (T, N, A) and the epochs' permutations, off the JAX key chain."""
    key, gumbels = js.key, []
    for _ in range(cfg["num_steps"]):
        key, ka, _ = jax.random.split(key, 3)
        gumbels.append(np.asarray(jax.random.gumbel(ka, (cfg["num_envs"], 4))))
    B = cfg["num_envs"] * cfg["num_steps"]
    perms = np.stack([np.asarray(jax.random.permutation(k, B)) for k in jax.random.split(key, cfg["update_epochs"])])
    return gumbels, perms


def test_train_iteration_parity():
    """A whole iteration on deep-sea-treasure (a rollout that crosses episode
    ends, GAE, the AASF loss weights, 2 epochs of 2 clipped Adam steps scaled
    by lr_frac = 0.6, entropy coefficient 0.1) given the JAX key chain's noise."""
    cfg = dict(num_envs=4, num_steps=24, num_minibatches=2, update_epochs=2, hidden=(16, 16), gamma=0.95, mc_k=4)
    jagent = JNLMOPPO(jmake("deep-sea-treasure-v0"), JNLMOPPOConfig(**cfg))
    js = jagent.init_state(jax.random.key(1))
    agent = NLMOPPO(make("deep-sea-treasure-v0"), NLMOPPOConfig(**cfg), device="cpu")
    st = agent.init_state()
    load_flax_params(st.net, _np(js.ts.params))
    args = ((6.0, -9.0), (0.0, -20.0), (24.0, -1.0))
    gumbels, perms = _jax_noise(js, jagent, cfg)
    js2, jloss = jagent.train_iteration(js, jmake_aasf(*args), jnp.float32(0.1), jnp.float32(0.6))
    noise = iter(gumbels)
    agent._gumbel = lambda state: _t(next(noise))
    batch = agent.rollout(st, make_aasf(*args, device="cpu"))
    loss = agent.update(st, batch, 0.1, 0.6, _t(perms))
    assert st.global_step == int(js2.global_step) == 96
    np.testing.assert_array_equal(st.obs.numpy(), np.asarray(js2.obs))
    np.testing.assert_allclose(st.acc.numpy(), np.asarray(js2.acc), atol=1e-5)
    np.testing.assert_allclose(st.gamma_pow.numpy(), np.asarray(js2.gamma_pow), rtol=1e-6)
    assert int(batch.act.ne(0).sum()) > 0 and bool((batch.loss_w != 0).all())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5), to_flax_params(st.net), _np(js2.ts.params["params"]))


def test_policy_evaluate():
    cfg = dict(TINY, gamma=0.9)
    jagent = JNLMOPPO(jmake("deep-sea-treasure-v0"), JNLMOPPOConfig(**cfg))
    js = jagent.init_state(jax.random.key(2))
    agent = NLMOPPO(make("deep-sea-treasure-v0"), NLMOPPOConfig(**cfg), device="cpu")
    st = agent.init_state()
    rng = np.random.default_rng(3)
    # the init's params with noise, so the greedy episodes differ from a fresh net's
    params = jax.tree.map(lambda x: x + 0.3 * rng.normal(size=x.shape).astype(np.float32), _np(js.ts.params))
    load_flax_params(st.net, params)
    want = jagent.policy_evaluate(js._replace(ts=js.ts.replace(params=params)), jax.random.key(0), 3, 60)
    got = agent.policy_evaluate(st, torch.Generator(), 3, 60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _nd_pair():
    ppo = dict(num_envs=2, num_steps=8, hidden=(8, 8))
    ipro = IPRO(make("deep-sea-treasure-v0"), IPROConfig(ppo=NLMOPPOConfig(**ppo)), device="cpu")
    jipro = JIPRO(jmake("deep-sea-treasure-v0"), JIPROConfig(ppo=JNLMOPPOConfig(**ppo)))
    return ipro, jipro


def test_ipro_nd_referent_machinery():
    """Mirror of tests/test_agents_multi.py::test_ipro_nd_referent_machinery,
    each call also made on the JAX package's IPRO and every set held equal
    to its own: exact."""
    ipro, jipro = _nd_pair()
    for obj in (ipro, jipro):
        obj.nadir = np.array([0.0, 0.0])
        obj.ideal = np.array([4.0, 4.0])
        obj.total_hv = 16.0
        obj.pf = []
        obj.lower_points = obj.nadir[None].copy()
        obj.upper_points = obj.ideal[None].copy()

    # found (2,3) against referent (0,0): staircase splits both sets
    for obj in (ipro, jipro):
        obj.update_found(np.array([0.0, 0.0]), np.array([2.0, 3.0]))
    _same_sets(ipro, jipro)
    assert sorted(map(tuple, ipro.lower_points)) == [(0.0, 3.0), (2.0, 0.0)]
    assert sorted(map(tuple, ipro.upper_points)) == [(2.0, 4.0), (4.0, 3.0)]

    # HVI order: vol-to-ideal of pf∪{(2,0)} = 8 > pf∪{(0,3)} = 4
    for obj in (ipro, jipro):
        obj.compute_hvis()
    _same_sets(ipro, jipro)
    assert tuple(ipro.select_referent()) == tuple(jipro.select_referent()) == (2.0, 0.0)

    # failed referent (2,0) with a robust point (1,1)
    for obj in (ipro, jipro):
        obj.update_not_found(np.array([2.0, 0.0]), np.array([1.0, 1.0]))
    _same_sets(ipro, jipro)
    assert sorted(map(tuple, ipro.lower_points)) == [(0.0, 3.0)]
    assert tuple(map(tuple, ipro.completed)) == ((2.0, 0.0),)
    assert tuple(map(tuple, ipro.robust_points)) == ((1.0, 1.0),)
    assert sorted(map(tuple, ipro.upper_points)) == [(2.0, 4.0)]

    # excluded volume: dominated HV(pf vs nadir)=6, discarded vol-to-ideal=8
    for obj in (ipro, jipro):
        obj.update_excluded_volume()
        obj.estimate_error()
    _same_sets(ipro, jipro)
    assert abs(ipro.dominated_hv - 6.0) < 1e-9
    assert abs(ipro.discarded_hv - 8.0) < 1e-9
    assert np.isfinite(ipro.error)


def _same_sets(a, b):
    for name in ("lower_points", "upper_points", "completed", "robust_points"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(a.pf), np.asarray(b.pf))
    assert (a.error, a.replay_triggered) == (b.error, b.replay_triggered)
    # float64 volumes: both packages' host HV run the same native WFG, so they are equal where the JAX
    # package's library is built; without it the JAX package sums in Python, in another order
    for name in ("dominated_hv", "discarded_hv"):
        if jnative.available():
            assert getattr(a, name) == getattr(b, name), name
        else:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=1e-12, err_msg=name)


def test_ipro_nd_sequence_and_replay_equal():
    """A 3-D sequence of found and failed referents chosen by HVI, then a
    replay: the staircases, front, completed and robust sets, the error and
    the referent order equal the JAX package's exactly, the volumes too (1e-12 without the JAX library)."""
    ppo = dict(num_envs=2, num_steps=8, hidden=(8, 8))
    env, jenv = make("deep-sea-treasure-v0"), jmake("deep-sea-treasure-v0")
    env.reward_dim = jenv.reward_dim = 3  # the point-set machinery only reads reward_dim
    ipro = IPRO(env, IPROConfig(ppo=NLMOPPOConfig(**ppo), hvi_samples=3), device="cpu")
    jipro = JIPRO(jenv, JIPROConfig(ppo=JNLMOPPOConfig(**ppo), hvi_samples=3))
    rng = np.random.default_rng(4)
    for obj in (ipro, jipro):
        obj.nadir, obj.ideal = np.zeros(3), np.full(3, 10.0)
        obj.total_hv = 1000.0
        obj.pf = [np.array([9.0, 1.0, 1.0]), np.array([1.0, 9.0, 1.0]), np.array([1.0, 1.0, 9.0])]
        obj._init_pf = list(obj.pf)
        obj.lower_points = obj.nadir[None].copy()
        for p in obj.pf:
            obj.update_lower_points(p)
        obj.upper_points = obj.ideal[None].copy()
    subs, jsubs = [], []
    for step in range(6):
        ipro.compute_hvis()
        jipro.compute_hvis()
        ref, jref = ipro.select_referent(), jipro.select_referent()
        np.testing.assert_array_equal(ref, jref)
        point = ref + rng.uniform(0.2, 2.0, size=3) if step % 3 != 2 else ref - 0.5
        for obj, sub in ((ipro, subs), (jipro, jsubs)):
            if np.all(point > ref):
                obj.update_found(ref, point)
            else:
                obj.update_not_found(ref, point)
            sub.append((ref, point))
            obj.update_excluded_volume()
            obj.estimate_error()
        _same_sets(ipro, jipro)
    vec = subs[0][1] + 0.5
    subs = ipro.replay(vec, subs)
    jsubs = jipro.replay(vec, jsubs)
    _same_sets(ipro, jipro)
    assert len(subs) == len(jsubs) and all(np.array_equal(a[1], b[1]) for a, b in zip(subs, jsubs))


INIT_POINTS = np.float32([[0.7, -1.0], [23.7, -19.0]])  # the init phase's two extrema on deep-sea-treasure


def _scripted_ipro(oracle, **cfg):
    """Both packages' n-D IPRO on deep-sea-treasure with the NL-MOPPO agent
    stubbed: ``train`` returns INIT_POINTS for the init phase, then
    ``oracle(ipro, referent, call)``.  Each log records the referents and the
    coverage before each oracle call."""
    ppo = dict(num_envs=2, num_steps=8, hidden=(8, 8))
    pair = []
    for cls, conf, ppo_conf, jax_side in ((IPRO, IPROConfig, NLMOPPOConfig, False), (JIPRO, JIPROConfig, JNLMOPPOConfig, True)):
        kw = {} if jax_side else dict(device="cpu")
        obj = cls((jmake if jax_side else make)("deep-sea-treasure-v0"), conf(ppo=ppo_conf(**ppo), **cfg), **kw)
        log = dict(referents=[], coverage=[], calls=0)

        def train(total, u, state=None, obj=obj, log=log):
            log["calls"] += 1
            if log["calls"] <= len(INIT_POINTS):
                return state, INIT_POINTS[log["calls"] - 1]
            log["coverage"].append(obj.coverage)
            return state, oracle(obj, log["referents"][-1], log["calls"] - len(INIT_POINTS) - 1)

        def referent(log=log, f=obj.select_referent):
            log["referents"].append(f())
            return log["referents"][-1]

        obj.agent.train, obj.agent.init_state, obj.select_referent = train, lambda seed=None: "state", referent
        pair.append((obj, log))
    return pair


def _toward_ideal(fracs):
    """An oracle that answers referent r with r + f·(ideal - r), f cycling through ``fracs``."""
    return lambda obj, r, call: np.float32(r + fracs[call % len(fracs)] * (obj.ideal - r))


@pytest.mark.parametrize("tolerance,iterations", [(0.05, 5), (0.02, 9)])
def test_ipro_stops_at_first_coverage_within_tolerance(tolerance, iterations):
    """``ipro_dst`` (tolerance 0.05) and ``ipro_dst_fine`` (0.02) stop alike:
    the n-D loop ends after the first iteration whose coverage reaches
    1 - tolerance, in both packages, on the same stubbed oracle (coverage
    0.952 after 5 iterations, 0.984 after 9): the referents equal exactly, the
    coverage too (1e-12 without the JAX library)."""
    (ipro, log), (jipro, jlog) = _scripted_ipro(_toward_ideal((0.5, 0.5, 0.9)), tolerance=tolerance)
    ipro.train()
    jipro.train()
    np.testing.assert_array_equal(np.asarray(log["referents"]), np.asarray(jlog["referents"]))
    exact = jnative.available()  # else float64 volumes summed in another order
    np.testing.assert_allclose(log["coverage"], jlog["coverage"], rtol=0 if exact else 1e-12, atol=0 if exact else 1e-15)
    after = log["coverage"][1:] + [ipro.coverage]  # the coverage after each iteration
    assert len(after) == iterations < IPROConfig.max_iterations and len(ipro.lower_points) > 0
    assert all(1.0 - c > tolerance for c in after[:-1]) and 1.0 - after[-1] <= tolerance
    assert ipro.coverage == jipro.coverage or not exact


def test_ipro2d_box_split():
    """``_split_box`` at interior and clipped points, and the queue order: exact."""
    cfg = dict(ppo=dict(num_envs=2, num_steps=8, hidden=(8, 8)), tolerance=0.05)
    ipro = IPRO2D(make("deep-sea-treasure-v0"), IPROConfig(tolerance=0.05, ppo=NLMOPPOConfig(**cfg["ppo"])), device="cpu")
    jipro = JIPRO2D(jmake("deep-sea-treasure-v0"), JIPROConfig(tolerance=0.05, ppo=JNLMOPPOConfig(**cfg["ppo"])))
    box, jbox = Box(np.array([0.0, -20.0]), np.array([24.0, -1.0])), JBox(np.array([0.0, -20.0]), np.array([24.0, -1.0]))
    assert box.volume == jbox.volume and box.max_dist == jbox.max_dist
    for point in (np.float32([8.2, -3.0]), np.float32([30.0, -5.0]), np.float32([0.02, -1.01])):
        got, want = ipro._split_box(box, point), jipro._split_box(jbox, point)
        assert [(b.nadir.tolist(), b.ideal.tolist()) for b in got] == [(b.nadir.tolist(), b.ideal.tolist()) for b in want]
        ipro._push_boxes(got)
        jipro._push_boxes(want)
    assert (ipro.dominated_hv, ipro.discarded_hv) == (jipro.dominated_hv, jipro.discarded_hv)
    assert [b.volume for b in ipro.box_queue] == [b.volume for b in jipro.box_queue]


def test_nlmoppo_and_ipro2d_smoke():
    """Mirror of tests/test_agents_multi.py::test_nlmoppo_and_ipro2d at its sizes and seed 0."""
    env = make("deep-sea-treasure-v0")
    nl = NLMOPPO(env, NLMOPPOConfig(**TINY), device="cpu")
    st, point = nl.train(256, lambda v: torch.amin(v, dim=-1))
    assert point.shape == (2,)
    ipro = IPRO2D(env, IPROConfig(max_iterations=1, iter_total_timesteps=256, ppo=NLMOPPOConfig(**TINY)), device="cpu")
    pf = ipro.train()
    assert len(pf) >= 2


def test_ipro_nd_end_to_end():
    """Mirror of tests/test_agents_multi.py::test_ipro_nd_end_to_end at its sizes and seed 0."""
    env = make("deep-sea-treasure-v0")
    ipro = IPRO(env, IPROConfig(max_iterations=2, iter_total_timesteps=256, ppo=NLMOPPOConfig(**TINY)), device="cpu")
    pf = ipro.train()
    assert len(pf) >= 2
    assert 0.0 <= ipro.coverage <= 1.0
