"""A whole vectorized MORL/D round with discrete SAC members against the JAX package's.

The discrete counterpart of tests/test_torch_morld_round.py, kept in a file
of its own because compiling the JAX package's ``_pop_step`` takes most of
a minute's budget on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from morl_baselines_torch.agents import MORLD, MORLDConfig, MOSACConfig, MOSACDiscrete
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import load_flax_params, to_flax_params
from morl_baselines_torch.replay import Transition
from morl_baselines_tpu.agents.morld import MORLD as JMORLD
from morl_baselines_tpu.agents.morld import MORLDConfig as JMORLDConfig
from morl_baselines_tpu.agents.mosac import MOSACConfig as JMOSACConfig
from morl_baselines_tpu.envs import make as jmake

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_discrete_pop_step_parity():
    """One vectorized round (``_pop_step``: 4 iterations of 2 ``MOSACDiscrete``
    members x 4 envs on deep-sea-treasure, each with an update, 2 of them
    with the actor and alpha step, then 2 cooperation passes on rolled
    batches with int64 actions) against the JAX package's, from the same
    params and env states, with every member's key chain read off (the
    Gumbel noise of ``jax.random.categorical``, batch indices) and handed to
    the port.  Params, log_alpha and the buffers atol 1e-5 (float32 sums in
    another order through 6 Adam steps)."""
    P, N, B, iters, passes = 2, 4, 8, 4, 2
    sac = dict(num_envs=N, learning_starts=0, batch_size=B, buffer_size=64, hidden=(16, 16))
    cfg = dict(pop_size=P, vectorized=True, update_passes=passes)
    algo = MORLD(make("deep-sea-treasure-v0"), MORLDConfig(**cfg, sac=MOSACConfig(**sac)), device="cpu")
    jalgo = JMORLD(jmake("deep-sea-treasure-v0"), JMORLDConfig(**cfg, sac=JMOSACConfig(**sac)))
    agent, jagent = algo.population[0], jalgo.population[0]
    assert isinstance(agent, MOSACDiscrete)
    A = agent.num_actions
    js = jax.vmap(jagent.init_state)(jax.random.split(jax.random.key(0), P))
    jbuf = jax.tree.map(lambda x: jnp.repeat(jnp.asarray(x)[None], P, axis=0), jagent.make_buffer())
    ws = jnp.stack([jnp.asarray(w) for w in jalgo.weights])
    key = jax.random.key(1)
    js2, jbuf2 = jalgo._pop_step(js, jbuf, ws, iters, passes, key)

    # the random numbers of the JAX round, in the order the port asks for them
    gumbels, indices = [], []
    stack = lambda f, ks: torch.stack([torch.as_tensor(np.array(f(k))) for k in ks])  # noqa: E731
    mkeys = [js.key[j] for j in range(P)]
    for it in range(iters):
        splits = [jax.random.split(k, 4) for k in mkeys]
        mkeys = [s[0] for s in splits]
        gumbels.append(stack(lambda k: jax.random.gumbel(k, (N, A)), [s[1] for s in splits]))
        size = min((it + 1) * N, 64)
        indices.append(stack(lambda k: jax.random.randint(k, (B,), 0, size), [s[3] for s in splits]))
    for r in range(passes):
        key, k = jax.random.split(key)
        indices.append(stack(lambda kk: jax.random.randint(kk, (B,), 0, iters * N), jax.random.split(k, P)))

    st, buf = agent.init_state([0, 1]), agent.make_buffer(P)
    load_flax_params(st.actor, _np(js.actor_ts.params))
    load_flax_params(st.critic.net, _np(js.critic_ts.params))
    load_flax_params(st.critic.target_net, _np(js.critic_ts.target_params))
    st.env_state = type(st.env_state)(*(torch.as_tensor(np.array(x)).reshape(P * N) for x in js.env_state))
    st.obs = torch.as_tensor(np.array(js.obs))
    rows = torch.arange(P)[:, None]
    agent._gumbel = lambda state, like: gumbels.pop(0)

    def sample(gen, batch_size):
        idx = indices.pop(0)
        return Transition(*(x[rows, idx] for x in buf.data))

    buf.sample = sample
    algo._pop_step(st, buf, torch.as_tensor(np.array(ws)), iters, passes)
    assert not gumbels and not indices and st.iter_count == iters
    assert buf.data.action.dtype == torch.int64

    def assert_tree(port, want):
        for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(a.reshape(b.shape), b, atol=1e-5, rtol=0)

    assert_tree(to_flax_params(st.actor), js2.actor_ts.params["params"])
    assert_tree(to_flax_params(st.critic.net), js2.critic_ts.params["params"])
    assert_tree(to_flax_params(st.critic.target_net), js2.critic_ts.target_params["params"])
    np.testing.assert_allclose(st.log_alpha.detach().numpy(), np.asarray(js2.log_alpha), atol=1e-5)
    for a, b in zip(buf.data, jbuf2.data):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), atol=1e-5)
