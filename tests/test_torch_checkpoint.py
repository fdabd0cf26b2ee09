"""Checkpoints of the port's agent states: save, load into a fresh template, continue.

``MOAgentBase.save`` / ``load`` replace the JAX package's orbax checkpoint
(``morl_baselines_tpu/agents/base.py:60-98``).  On the CPU a restored state
must continue bitwise equal to the state it was saved from, which holds the
generator states, the Adam moments and step counts, the buffers' pointers and
the env states; the comparisons below are exact (``torch.equal`` on every
tensor of the two states' trees).
"""

import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import (
    MORLD,
    PCN,
    Envelope,
    EnvelopeConfig,
    MOQLearning,
    MOQLearningConfig,
    MORLDConfig,
    MOSACConfig,
    PCNConfig,
)
from morl_baselines_torch.agents.base import state_tree
from morl_baselines_torch.envs import make

torch.set_num_threads(1)


def assert_trees_equal(a, b, where="state"):
    """Bitwise equality of two ``state_tree``s."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, where


def test_moql_roundtrip(tmp_path):
    """Mirror of tests/test_extras.py::test_checkpoint_roundtrip, and the
    continued runs equal bitwise."""
    agent = MOQLearning(make("deep-sea-treasure-v0"), weights=np.array([0.5, 0.5]),
                        config=MOQLearningConfig(num_envs=4), device="cpu")
    state = agent.train_segment(agent.init_state(), 10)
    agent.save(state, tmp_path / "ckpt")
    restored = agent.load(agent.init_state(seed=3), tmp_path / "ckpt")
    assert torch.equal(restored.q_table, state.q_table)
    assert restored.global_step == state.global_step == 40
    agent.train_segment(restored, 5)
    agent.train_segment(state, 5)
    assert restored.global_step == 60
    assert_trees_equal(state_tree(state), state_tree(restored))


def test_envelope_per_continues_bitwise(tmp_path):
    """Envelope with PER: the run saved after 20 iterations and restored into a
    state from another seed continues exactly as the uninterrupted run."""
    cfg = EnvelopeConfig(num_envs=4, buffer_size=256, batch_size=8, hidden=(16, 16), learning_starts=16,
                         num_sample_w=2, per=True, target_net_update_freq=7)
    agent = Envelope(make("deep-sea-treasure-v0"), cfg, device="cpu")
    state = agent.train_segment(agent.init_state(), 20)
    agent.save(state, tmp_path / "deep" / "envelope.pt")  # parent directories are created
    restored = agent.load(agent.init_state(seed=5), tmp_path / "deep" / "envelope.pt")
    assert_trees_equal(state_tree(state), state_tree(restored))
    # the optimizer still steps the restored net's own parameters
    assert restored.ts.optimizer.param_groups[0]["params"][0] is next(restored.ts.net.parameters())
    agent.train_segment(state, 15)
    agent.train_segment(restored, 15)
    assert restored.global_step == 140 and restored.buffer.ptr == 140
    assert_trees_equal(state_tree(state), state_tree(restored))
    assert float(restored.loss) == float(state.loss)


def test_morld_vectorized_population_continues_bitwise(tmp_path):
    """The vectorized MORL/D population (one MOSAC state of 3 members, its
    member buffers, per-member Adam state and alpha) saved as a pair."""
    sac = MOSACConfig(num_envs=4, learning_starts=32, batch_size=32, buffer_size=512, hidden=(32, 32))
    algo = MORLD(make("mo-mountaincarcontinuous-v0"), MORLDConfig(pop_size=3, exchange_every=64, update_passes=2,
                                                                  vectorized=True, sac=sac), device="cpu")
    member = algo.population[0]
    weights = torch.as_tensor(np.stack(algo.weights))
    state, buffer = member.init_state([0, 1, 2]), member.make_buffer(3)
    algo._pop_step(state, buffer, weights, 16, 2)
    member.save((state, buffer), tmp_path / "morld.pt")
    rstate, rbuffer = member.load((member.init_state([7, 8, 9]), member.make_buffer(3)), tmp_path / "morld.pt")
    assert rstate.log_alpha.requires_grad and rstate.alpha_optimizer.param_groups[0]["params"][0] is rstate.log_alpha
    assert rbuffer.ptr == buffer.ptr == 64
    for s, b in ((state, buffer), (rstate, rbuffer)):
        algo._pop_step(s, b, weights, 16, 2)
    assert rstate.global_step == 128
    assert_trees_equal(state_tree((state, buffer)), state_tree((rstate, rbuffer)))


def test_pcn_with_episodic_buffer_continues_bitwise(tmp_path):
    cfg = PCNConfig(num_envs=4, max_buffer_episodes=16, max_episode_len=32, scaling_factor=(0.1, 0.1, 0.01),
                    num_model_updates=3, batch_size=32, hidden_dim=16)
    agent = PCN(make("deep-sea-treasure-v0"), cfg, device="cpu")
    state = agent.train(total_timesteps=300, num_er_episodes=4)
    agent.save(state, tmp_path / "pcn.pt")
    restored = agent.load(agent.init_state(seed=4), tmp_path / "pcn.pt")
    assert restored.buffer.size == state.buffer.size > 0
    for s in (state, restored):
        agent.train_round(s)
    assert_trees_equal(state_tree(state), state_tree(restored))


def test_weights_only_file_and_template_dtypes(tmp_path):
    """The file is plain tensors and containers (``weights_only=True`` reads
    it); numpy arrays keep their dtype, frozen dataclasses and NamedTuples are
    rebuilt, and tensors land on the template's dtype."""
    from dataclasses import dataclass
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: torch.Tensor
        b: np.ndarray

    @dataclass(frozen=True)
    class Frozen:
        pair: Pair
        step: int
        scale: np.float32
        gen: torch.Generator

    agent = MOQLearning(make("deep-sea-treasure-v0"), weights=np.array([0.5, 0.5]), device="cpu")
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    saved = Frozen(Pair(torch.arange(4, dtype=torch.int32), np.array([1.5, 2.5], dtype=np.float16)), 9, np.float32(0.25), gen)
    agent.save(saved, tmp_path / "x.pt")
    raw = torch.load(tmp_path / "x.pt", weights_only=True)
    assert raw["step"] == 9 and raw["pair"][1].dtype == torch.float16
    template = Frozen(Pair(torch.zeros(4, dtype=torch.float64), np.zeros(2, dtype=np.float16)), 0, np.float32(0), torch.Generator())
    out = agent.load(template, tmp_path / "x.pt")
    assert out is not template and isinstance(out.pair, Pair) and template.step == 0
    assert out.pair.a.dtype == torch.float64 and out.pair.a.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert out.pair.b.dtype == np.float16 and out.pair.b.tolist() == [1.5, 2.5]
    assert out.step == 9 and isinstance(out.scale, np.float32) and out.scale == 0.25
    assert torch.equal(torch.rand(3, generator=out.gen), torch.rand(3, generator=gen))
    # a template of another layout is refused
    agent.save([torch.zeros(2), torch.ones(2)], tmp_path / "two.pt")
    with pytest.raises(ValueError, match="2"):
        agent.load([torch.zeros(2)], tmp_path / "two.pt")
