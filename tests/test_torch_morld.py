"""The torch port's MORL/D: its population mechanics against the JAX package's, and both modes.

The cooperation roll, the one-shot neighbour gather and the PSA weight
update are index and host arithmetic, so they must agree exactly with the
JAX package's on the same inputs (made with numpy from a seed; the gather
on population trees laid out as the JAX package's, gathered by ``jnp`` indexing).  The
population runs mirror tests/test_parallel.py at the JAX tests' sizes on
mo-mountaincarcontinuous (without the device mesh); discrete MORL/D runs in
both modes on deep-sea-treasure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import MORLD, MORLDConfig, MOSACConfig
from morl_baselines_torch.agents.morld import cooperation_shift, neighbor_sources
from morl_baselines_torch.core.indicators import hypervolume
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import DiscreteSACActor, gather_members_, to_flax_params
from morl_baselines_tpu.agents.morld import MORLD as JMORLD
from morl_baselines_tpu.agents.morld import MORLDConfig as JMORLDConfig
from morl_baselines_tpu.agents.mosac import MOSACConfig as JMOSACConfig
from morl_baselines_tpu.envs import make as jmake

torch.set_num_threads(1)
REF = np.array([-120.0, -120.0])
SAC = dict(num_envs=4, learning_starts=32, batch_size=32, buffer_size=2048, hidden=(32, 32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(pop=4, **kw):
    cfg = dict(pop_size=pop, exchange_every=64, update_passes=2, weight_adaptation_method="PSA", **kw)
    port = MORLD(make("mo-mountaincarcontinuous-v0"), MORLDConfig(**cfg, sac=MOSACConfig(**SAC)), device="cpu")
    jax_ = JMORLD(jmake("mo-mountaincarcontinuous-v0"), JMORLDConfig(**cfg, sac=JMOSACConfig(**SAC)))
    return port, jax_


@pytest.mark.parametrize("pop", [1, 2, 3, 6])
def test_cooperation_roll_matches_jnp_roll(pop):
    """Pass r rolls the sampled batches by (r % max(pop - 1, 1)) + 1 along the
    member axis (morld.py:206-207): member j gets member (j - shift) mod P's batch."""
    x = np.arange(pop * 3, dtype=np.float32).reshape(pop, 3)
    for r in range(8):
        shift = cooperation_shift(r, pop)
        assert shift == (r % max(pop - 1, 1)) + 1
        assert np.array_equal(torch.roll(torch.as_tensor(x), shift, dims=0).numpy(), np.asarray(jnp.roll(x, shift, axis=0)))


@pytest.mark.parametrize("pop, k", [(4, 1), (6, 1), (6, 2), (5, 3)])
def test_neighbor_gather_matches_jax(pop, k):
    """The neighbourhoods, the transfer sources (morld.py:237-240) and the
    gather of actor, critic and target params along the member axis (:250-258)."""
    port, jx = _pair(pop, neighborhood_size=k)
    assert np.array_equal(port.neighborhoods, jx.neighborhoods)
    assert all(np.array_equal(a, b) for a, b in zip(port.weights, jx.weights))
    src_j = np.arange(pop)
    for j in range(1, pop):
        if (j - 1) in jx.neighborhoods[j]:
            src_j[j] = j - 1
    src = neighbor_sources(port.neighborhoods, pop)
    assert np.array_equal(src, src_j)
    agent = port.population[0]
    for make_net, per in ((agent.make_actor, 1), (agent.make_critic, 2)):
        net = make_net(pop * per, torch.Generator().manual_seed(pop))
        # the JAX package's population tree: (P, ...) for the actor, (P, 2, ...) for the twin critics
        tree = jax.tree.map(lambda x: np.copy(x).reshape(pop, *x.shape[1:]) if per == 1 else np.copy(x).reshape(pop, per, *x.shape[1:]), to_flax_params(net))
        want = jax.tree.map(lambda x: np.asarray(jnp.asarray(x)[src_j]), tree)
        gather_members_(net, src, per)
        for a, b in zip(jax.tree.leaves(to_flax_params(net)), jax.tree.leaves(want)):
            assert np.array_equal(a.reshape(b.shape), b)


def test_psa_weight_matches_jax():
    port, jx = _pair(pop=4)
    rng = np.random.default_rng(0)
    for _ in range(12):
        ev = rng.normal(size=2) * [20.0, 1.0] + [-80.0, -2.0]
        port.archive.add(0, ev)
        jx.archive.add(0, ev)
    assert len(port.archive) == len(jx.archive) > 1
    for ev in [*port.archive.evaluations, *(rng.normal(size=(6, 2)) * [20.0, 1.0] + [-80.0, -2.0])]:
        for w in port.weights:
            got, want = port._psa_weight(ev, w), jx._psa_weight(ev, w)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("vectorized", [False, True], ids=["looped", "vectorized"])
def test_discrete_morld_dst(vectorized):
    """MORL/D with ``MOSACDiscrete`` members on deep-sea-treasure, as the JAX
    package builds it for a discrete action space: categorical actors, PSA,
    an archive with a positive hypervolume at (0, -50)."""
    ref = np.array([0.0, -50.0])
    cfg = MORLDConfig(pop_size=3, exchange_every=64, update_passes=2, vectorized=vectorized,
                      weight_adaptation_method="PSA", sac=MOSACConfig(**SAC))
    algo = MORLD(make("deep-sea-treasure-v0"), cfg, device="cpu")
    jalgo = JMORLD(jmake("deep-sea-treasure-v0"), JMORLDConfig(pop_size=3, sac=JMOSACConfig(**SAC)))
    assert all(type(a).__name__ == type(j).__name__ == "MOSACDiscrete" for a, j in zip(algo.population, jalgo.population))
    out = algo.train(total_timesteps=768, ref_point=ref, eval_max_steps=60)
    states = [out] if vectorized else out
    assert all(isinstance(s.actor, DiscreteSACActor) for s in states)
    assert all(bool(torch.isfinite(p).all()) for s in states for p in s.actor.parameters())
    assert len(algo.archive) >= 1 and algo._last_metrics["eval/hypervolume"] > 0.0
    assert algo.archive.front.shape[1] == 2


def test_looped_neighbor_transfer_copies():
    """In the first round the candidate's nets go to its higher neighbours as
    copies: equal values, separate storage."""
    port, _ = _pair(pop=3, neighborhood_size=1)
    states = port.train(total_timesteps=64)
    src = states[0]
    for n in port.neighborhoods[0]:
        if n > 0:
            for a, b in zip(src.actor.parameters(), states[n].actor.parameters()):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert len(port.archive) >= 1


def test_vectorized_morld_population():
    """Mirror of tests/test_parallel.py::test_vectorized_morld_population_mesh, without the mesh."""
    port, _ = _pair(pop=4, vectorized=True)
    state = port.train(total_timesteps=512, ref_point=REF)
    assert len(port.archive) >= 1
    assert port._last_metrics["eval/hypervolume"] >= 0.0
    leaf = next(state.actor.parameters())
    assert leaf.shape[0] == 4 and bool(torch.isfinite(leaf).all())
    assert len(port.weights) == 4 and state.global_step == 512 // 4


def _morld_final_hv(vectorized: bool) -> float:
    cfg = MORLDConfig(pop_size=3, exchange_every=64, update_passes=2, vectorized=vectorized, sac=MOSACConfig(**SAC))
    agent = MORLD(make("mo-mountaincarcontinuous-v0"), cfg, device="cpu")
    agent.train(total_timesteps=768, ref_point=REF)
    return float(hypervolume(agent.archive.front, REF))


def test_morld_vectorized_matches_sequential_front_quality():
    """Mirror of tests/test_parallel.py::test_morld_vectorized_matches_sequential_front_quality."""
    hv_seq = _morld_final_hv(vectorized=False)
    hv_vec = _morld_final_hv(vectorized=True)
    assert hv_seq > 0.0 and hv_vec > 0.0
    assert hv_vec >= 0.5 * hv_seq, (hv_vec, hv_seq)

