"""The accrued-reward buffer and DiverseMemory of the port against the JAX package's.

The same transitions go into both packages' buffers; every field must then be
equal exactly.  Sampling is compared at the JAX package's own draws (its
indices and uniforms, handed to the port): indices and rows exactly,
probabilities at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from morl_baselines_tpu.replay import AccruedRewardReplayBuffer as JAccrued
from morl_baselines_tpu.replay import AccruedTransition as JAccruedTransition
from morl_baselines_tpu.replay import DiverseMemory as JDiverse
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_torch.replay import AccruedRewardReplayBuffer, AccruedTransition, DiverseMemory, Transition

torch.set_num_threads(1)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _accrued_batch(rng, n):
    return dict(
        obs=rng.normal(size=(n, 2)).astype(np.float32),
        accrued_reward=rng.normal(size=(n, 2)).astype(np.float32),
        action=rng.integers(0, 3, size=n).astype(np.int32),
        reward=rng.normal(size=(n, 2)).astype(np.float32),
        next_obs=rng.normal(size=(n, 2)).astype(np.float32),
        terminated=(rng.uniform(size=n) < 0.3).astype(np.float32),
        timestep=np.arange(n, dtype=np.int32),
    )


def test_accrued_buffer_mirror():
    """Mirror of tests/test_replay.py::test_accrued_buffer."""
    buf = AccruedRewardReplayBuffer.create(32, obs_dim=1, reward_dim=2, device="cpu")
    buf.add_batch(AccruedTransition(torch.ones((5, 1)), torch.ones((5, 2)) * 3, torch.zeros(5, dtype=torch.int64),
                                    torch.ones((5, 2)), torch.ones((5, 1)), torch.zeros(5), torch.arange(5, dtype=torch.int32)))
    assert buf.size == 5
    data, valid = buf.get_all()
    assert int(valid.sum()) == 5 and data.timestep.dtype == torch.int32 and data.timestep[:5].tolist() == [0, 1, 2, 3, 4]
    buf.reset()
    assert buf.size == 0 and buf.ptr == 0


def test_accrued_buffer_matches_jax():
    rng = np.random.default_rng(0)
    jbuf = JAccrued.create(12, obs_dim=2, reward_dim=2)
    tbuf = AccruedRewardReplayBuffer.create(12, obs_dim=2, reward_dim=2, device="cpu")
    for n in (5, 4, 6):  # the third batch wraps the ring
        b = _accrued_batch(rng, n)
        jbuf = jbuf.add_batch(JAccruedTransition(**{k: jnp.asarray(v) for k, v in b.items()}))
        tbuf.add_batch(AccruedTransition(**{k: torch.as_tensor(v) for k, v in b.items()}))
    assert tbuf.ptr == int(jbuf.ptr) and tbuf.size == int(jbuf.size) == 12
    for t, j in zip(tbuf.data, jbuf.data):
        _eq(t, j)
    (tdata, tvalid), (_, jvalid) = tbuf.get_all(), jbuf.get_all()
    _eq(tvalid, jvalid)
    # a sample at the JAX key's indices
    key = jax.random.key(3)
    idx = jax.random.randint(key, (7,), 0, jnp.maximum(jbuf.size, 1))
    for t, j in zip(tbuf.gather(torch.as_tensor(np.array(idx))), jbuf.sample(key, 7)):
        _eq(t, j)
    assert tbuf.sample(torch.Generator().manual_seed(0), 7).timestep.shape == (7,)
    jbuf, _ = jbuf.reset(), tbuf.reset()
    assert tbuf.size == int(jbuf.size) == 0 and tbuf.ptr == int(jbuf.ptr) == 0


def _tr_jax(v):
    return JTransition(obs=jnp.full((1, 2), v), action=jnp.zeros(1, dtype=jnp.int32), reward=jnp.full((1, 2), v),
                       next_obs=jnp.zeros((1, 2)), terminated=jnp.zeros(1))


def _tr_torch(v):
    return Transition(obs=torch.full((1, 2), v), action=torch.zeros(1, dtype=torch.int64), reward=torch.full((1, 2), v),
                      next_obs=torch.zeros((1, 2)), terminated=torch.zeros(1))


def test_diverse_memory_mirror():
    """Mirror of tests/test_extras.py::test_diverse_memory."""
    mem = DiverseMemory.create(capacity=8, sec_capacity=4, obs_dim=2, reward_dim=2, num_trees=2, device="cpu")
    for i in range(12):  # overflow the ring -> promotions considered
        mem.add_batch(_tr_torch(float(i)), torch.full((1, 2), float(i)))
    assert mem.size == 8
    batch, idx, probs = mem.sample(torch.Generator().manual_seed(0), 16, tree=0)
    assert batch.obs.shape == (16, 2) and probs.shape == (16,)
    mem.update_priorities(idx[:4], torch.ones(4) * 5.0, tree=1)
    assert float(mem.max_priority) == 5.0
    sec, _ = mem.sample_secondary(torch.Generator().manual_seed(1), 4)
    assert sec.obs.shape == (4, 2)


def _diverse_fields(mem):
    return [*mem.data, mem.priorities, mem.trace_value, *mem.sec_data, mem.sec_value, mem.sec_valid, mem.max_priority]


def test_diverse_memory_matches_jax():
    """Promotions into a partly filled secondary store (an empty store never
    promotes, in either package: the evicted row is then the only valid one and
    so the least diverse), proportional samples at the JAX uniforms, priority
    updates, and secondary samples at the JAX indices."""
    rng = np.random.default_rng(5)
    jmem = JDiverse.create(capacity=6, sec_capacity=4, obs_dim=2, reward_dim=2, num_trees=2)
    tmem = DiverseMemory.create(capacity=6, sec_capacity=4, obs_dim=2, reward_dim=2, num_trees=2, device="cpu")
    seed_vals = rng.normal(size=(4, 2)).astype(np.float32)
    jmem = jmem._replace(sec_value=jnp.asarray(seed_vals), sec_valid=jnp.asarray([True, True, False, False]))
    tmem.sec_value.copy_(torch.as_tensor(seed_vals))
    tmem.sec_valid.copy_(torch.tensor([True, True, False, False]))
    for i in range(14):
        v, tv = float(i), rng.normal(size=(1, 2)).astype(np.float32) * 3.0
        jmem = jmem.add_batch(_tr_jax(v), jnp.asarray(tv))
        tmem.add_batch(_tr_torch(v), torch.as_tensor(tv))
        for t, j in zip(_diverse_fields(tmem), _diverse_fields(jmem)):
            _eq(t, j)
        assert tmem.ptr == int(jmem.ptr) and tmem.size == int(jmem.size)
    # promotions replaced valid members (the least diverse); an invalid slot is never filled, in either package
    assert not np.array_equal(tmem.sec_value[:2].numpy(), seed_vals[:2]) and tmem.sec_valid.tolist() == [True, True, False, False]
    jmem = jmem.update_priorities(jnp.asarray([0, 2, 3]), jnp.asarray([0.5, 4.0, 1e-20]), tree=1)
    tmem.update_priorities(torch.tensor([0, 2, 3]), torch.tensor([0.5, 4.0, 1e-20]), tree=1)
    for t, j in zip(_diverse_fields(tmem), _diverse_fields(jmem)):
        _eq(t, j)
    for tree in (0, 1):
        key = jax.random.key(10 + tree)
        jbatch, jidx, jprobs = jmem.sample(key, 32, tree=tree)
        tbatch, tidx, tprobs = tmem.sample_at(torch.as_tensor(np.array(jax.random.uniform(key, (32,)))), tree=tree)
        _eq(tidx, jidx)
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6)
        for t, j in zip(tbatch, jbatch):
            _eq(t, j)
    jsec, jidx = jmem.sample_secondary(jax.random.key(2), 8)
    for t, j in zip(Transition(*(x[torch.as_tensor(np.array(jidx))] for x in tmem.sec_data)), jsec):
        _eq(t, j)
    tsec, tidx = tmem.sample_secondary(torch.Generator().manual_seed(2), 64)
    assert bool(tmem.sec_valid[tidx].all())
