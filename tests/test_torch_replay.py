"""Parity of the torch port's replay buffers with the JAX package's.

Transitions, indices and uniforms are made with numpy from a seed and handed
to both; gathers and priorities must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

from morl_baselines_tpu.replay import PrioritizedReplayBuffer as JPrioritizedReplayBuffer
from morl_baselines_tpu.replay import ReplayBuffer as JReplayBuffer
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_torch.replay import PrioritizedReplayBuffer, ReplayBuffer, Transition

torch.set_num_threads(1)


def _batch(rng, n, obs_dim=3, d=2):
    return dict(
        obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
        action=rng.integers(0, 4, size=n),
        reward=rng.normal(size=(n, d)).astype(np.float32),
        next_obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
        terminated=(rng.uniform(size=n) < 0.2).astype(np.float32),
    )


def _jt(b):
    return JTransition(**{k: jnp.asarray(v, jnp.int32 if k == "action" else None) for k, v in b.items()})


def _tt(b):
    return Transition(**{k: torch.as_tensor(v) for k, v in b.items()})


def _assert_data_equal(jdata, tdata):
    for a, b in zip(jdata, tdata):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_ring_wraparound_parity():
    rng = np.random.default_rng(0)
    jbuf = JReplayBuffer.create(8, obs_dim=3, reward_dim=2)
    tbuf = ReplayBuffer.create(8, obs_dim=3, reward_dim=2, device="cpu")
    for n in (6, 6, 3, 8):
        b = _batch(rng, n)
        jbuf = jbuf.add_batch(_jt(b))
        tbuf.add_batch(_tt(b))
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        _assert_data_equal(jbuf.data, tbuf.data)
    assert (tbuf.ptr, tbuf.size) == (7, 8)


def test_gather_and_sample():
    rng = np.random.default_rng(1)
    jbuf = JReplayBuffer.create(64, obs_dim=3, reward_dim=2)
    tbuf = ReplayBuffer.create(64, obs_dim=3, reward_dim=2, device="cpu")
    b = _batch(rng, 10)
    jbuf, _ = jbuf.add_batch(_jt(b)), tbuf.add_batch(_tt(b))
    idx = rng.integers(0, 10, size=32)
    _assert_data_equal([x[jnp.asarray(idx)] for x in jbuf.data], tbuf.gather(torch.as_tensor(idx)))
    gen = torch.Generator().manual_seed(0)
    batch = tbuf.sample(gen, 16, use_cer=True)
    # CER: first sample is the latest transition (row 9); all rows are valid rows
    assert torch.equal(batch.obs[0], tbuf.data.obs[9])
    valid_rows = {tuple(r) for r in b["obs"].tolist()}
    assert all(tuple(r) in valid_rows for r in batch.obs.tolist())
    assert tbuf.sample_obs(gen, 5).shape == (5, 3)


def test_prioritized_sampling_parity():
    """Same priorities and the same uniforms pick the same rows (the JAX
    sample is reproduced at the given uniforms with its own cumsum and
    searchsorted code path)."""
    rng = np.random.default_rng(2)
    cap = 64
    jbuf = JPrioritizedReplayBuffer.create(cap, obs_dim=3, reward_dim=2)
    tbuf = PrioritizedReplayBuffer.create(cap, obs_dim=3, reward_dim=2, device="cpu")
    b = _batch(rng, 40)
    jbuf = jbuf.add_batch(_jt(b))
    tbuf.add_batch(_tt(b))
    idx = rng.integers(0, 40, size=25)  # repeated indices: last write wins on both sides
    idx = np.unique(idx)
    prio = rng.uniform(0.01, 2.0, size=len(idx)).astype(np.float32)
    jbuf = jbuf.update_priorities(jnp.asarray(idx), jnp.asarray(prio))
    tbuf.update_priorities(torch.as_tensor(idx), torch.as_tensor(prio))
    np.testing.assert_array_equal(np.asarray(jbuf.priorities), tbuf.priorities.numpy())
    assert float(jbuf.max_priority) == float(tbuf.max_priority)

    u = rng.uniform(size=512).astype(np.float32)
    cdf = jnp.cumsum(jbuf.priorities)
    total = jnp.maximum(cdf[-1], 1e-12)
    jidx = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u) * total, side="right"), 0, cap - 1)
    batch, tidx, probs = tbuf.sample_at(torch.as_tensor(u))
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_allclose(probs.numpy(), np.asarray(jbuf.priorities[jidx] / total), rtol=1e-6)
    _assert_data_equal([x[jidx] for x in jbuf.data], batch)
    # new rows enter at the running max priority
    b2 = _batch(rng, 4)
    jbuf = jbuf.add_batch(_jt(b2))
    tbuf.add_batch(_tt(b2))
    np.testing.assert_array_equal(np.asarray(jbuf.priorities), tbuf.priorities.numpy())


def test_prioritized_proportional():
    """Mirror of tests/test_replay.py::test_prioritized_proportional."""
    buf = PrioritizedReplayBuffer.create(16, obs_dim=1, reward_dim=2, device="cpu")
    buf.add_batch(
        Transition(
            obs=torch.arange(4, dtype=torch.float32)[:, None],
            action=torch.zeros(4, dtype=torch.int64),
            reward=torch.zeros((4, 2)),
            next_obs=torch.zeros((4, 1)),
            terminated=torch.zeros(4),
        )
    )
    buf.update_priorities(torch.tensor([0, 1, 2, 3]), torch.tensor([1e-6, 1e-6, 1.0, 1e-6]))
    _, idx, _ = buf.sample(torch.Generator().manual_seed(0), 256)
    assert float((idx == 2).float().mean()) > 0.98
    assert float(buf.max_priority) == 1.0
