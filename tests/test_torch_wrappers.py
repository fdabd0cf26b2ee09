"""Parity of the torch port's pixel DST, wrapper stack and NatureCNN trunk with
the JAX package's, and mirrors of tests/test_wrappers.py.

Frames are integers, so the rendered ``PixelDST`` frames and every wrapper's
output are held bitwise: over all 110 agent positions, through the resize
(``interpolate(antialias=True)``, as ``jax.image.resize`` antialiases where
it shrinks) and the grayscale, MaxAndSkip's freeze after done, the frame
stack's reset padding, and the whole stack under the vector env's autoreset.
The CNN forwards (``NatureCNN`` and ``EnvelopeQNet(image_shape=...)``) run
on flax-initialized params carried across with ``load_flax_params``, at
atol 1e-5 (float32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.envs import (
    FlattenObservation,
    FrameStackObservation,
    GrayscaleObservation,
    MOMaxAndSkipObservation,
    PixelDST,
    ResizeObservation,
    TimeLimit,
    VectorMOEnv,
    make,
)
from morl_baselines_torch.envs.dst import DSTState
from morl_baselines_torch.models import EnvelopeQNet, NatureCNN, load_flax_params, to_flax_params
from morl_baselines_tpu.envs import FrameStackObservation as JFrameStack
from morl_baselines_tpu.envs import GrayscaleObservation as JGray
from morl_baselines_tpu.envs import MOMaxAndSkipObservation as JMaxAndSkip
from morl_baselines_tpu.envs import PixelDST as JPixelDST
from morl_baselines_tpu.envs import ResizeObservation as JResize
from morl_baselines_tpu.envs import VectorMOEnv as JVectorMOEnv
from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.envs.dst import DSTState as JDSTState
from morl_baselines_tpu.models.networks import EnvelopeQNet as JEnvelopeQNet
from morl_baselines_tpu.models.networks import NatureCNN as JNatureCNN

torch.set_num_threads(1)
DEPTHS = np.array([1, 2, 3, 4, 4, 4, 7, 7, 9, 10])


def _t(x):
    return torch.as_tensor(np.array(x))


def _all_positions():
    """Every cell of the 11x10 grid (those below the sea floor included), as DST states of both packages."""
    rows, cols = (a.ravel().astype(np.int32) for a in np.meshgrid(np.arange(11), np.arange(10), indexing="ij"))
    t = np.zeros(110, np.int32)
    return DSTState(_t(rows), _t(cols), _t(t)), JDSTState(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(t))


def test_pixel_frames_and_wrappers_bitwise():
    """The 110 rendered frames, their resize, grayscale and resize-then-grayscale, bitwise."""
    tstate, jstate = _all_positions()
    tenv, jenv = PixelDST(), JPixelDST()
    frames, jframes = tenv._render(tstate), jax.vmap(jenv._render)(jstate)
    assert frames.dtype == torch.uint8 and frames.shape == (110, 88, 80, 3)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    resize, jresize = ResizeObservation(tenv, (84, 84)), JResize(jenv, (84, 84))
    gray, jgray = GrayscaleObservation(resize), JGray(jresize)
    small, jsmall = resize._map(frames), jax.vmap(jresize._map)(jframes)
    np.testing.assert_array_equal(small.numpy(), np.asarray(jsmall))
    np.testing.assert_array_equal(gray._map(small).numpy(), np.asarray(jax.vmap(jgray._map)(jsmall)))
    np.testing.assert_array_equal(
        GrayscaleObservation(tenv)._map(frames).numpy(), np.asarray(jax.vmap(JGray(jenv)._map)(jframes))
    )
    # a grayscale (H, W) frame resizes as a one-channel image; in this order (not the stack's) the
    # blends of grey levels land near .5 and 4 of 776,160 pixels round to the other level
    g = GrayscaleObservation(tenv)._map(frames)
    got = ResizeObservation(GrayscaleObservation(tenv))._map(g).numpy().astype(int)
    want = np.asarray(jax.vmap(JResize(JGray(jenv))._map)(jnp.asarray(g.numpy()))).astype(int)
    assert got.shape == want.shape == (110, 84, 84)
    assert np.abs(got - want).max() <= 1 and (got != want).sum() <= 8


def test_max_and_skip_freezes_after_done_parity():
    """MaxAndSkip over DST from every position and action: the summed reward,
    the max of the last two frames, and the state frozen once an episode ends mid-skip."""
    tstate, jstate = _all_positions()
    rows = np.minimum(tstate.row.numpy(), DEPTHS[tstate.col.numpy()])  # cells above or on the sea floor
    tstate = tstate._replace(row=_t(rows))
    jstate = jstate._replace(row=jnp.asarray(rows))
    tenv, jenv = MOMaxAndSkipObservation(PixelDST(), 4), JMaxAndSkip(JPixelDST(), 4)
    for a in range(4):
        act = np.full(110, a, np.int32)
        jout = jax.vmap(jenv.step)(jstate, jnp.asarray(act), jax.random.split(jax.random.key(a), 110))
        tout = tenv.step(tstate, _t(act))
        for x, y in zip(jout.state, tout.state):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        for name in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
        if a == 1:  # down: an episode that ends before the last sub-step keeps its step count there
            assert tout.terminated.any() and (tout.state.t[tout.terminated] < 4).any()


def test_frame_stack_padding_and_step_parity():
    tenv, jenv = FrameStackObservation(GrayscaleObservation(PixelDST()), 4), JFrameStack(JGray(JPixelDST()), 4)
    tstate, tobs = tenv.reset(2, torch.Generator().manual_seed(0))
    jstate, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), 2))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    for a in (3, 1, 3, 3, 1):
        act = np.full(2, a, np.int32)
        jout = jax.vmap(jenv.step)(jstate, jnp.asarray(act), jax.random.split(jax.random.key(1), 2))
        tout = tenv.step(tstate, _t(act))
        np.testing.assert_array_equal(tout.obs.numpy(), np.asarray(jout.obs))
        np.testing.assert_array_equal(tout.state.frames.numpy(), np.asarray(jout.state.frames))
        jstate, tstate = jout.state, tout.state


def test_full_stack_vector_autoreset_parity():
    """The registry's pixel stack under each package's vector env: 30 steps of
    the same random actions over 6 envs, with same-step autoreset of the nested
    wrapper states; obs and final_obs bitwise, rewards and flags equal."""
    n = 6
    jvenv = JVectorMOEnv(jmake("deep-sea-treasure-pixel-stack-v0"), n)
    tvenv = VectorMOEnv(make("deep-sea-treasure-pixel-stack-v0"), n)
    jstate, jobs = jvenv.reset(jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tstate, tobs = tvenv.reset(gen)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jvenv.step)
    rng = np.random.default_rng(1)
    ended = 0
    for i in range(30):
        act = rng.integers(0, 4, n).astype(np.int32)
        jout = jstep(jstate, jnp.asarray(act), jax.random.key(i))
        tout = tvenv.step(tstate, _t(act), gen)
        for name in ("obs", "final_obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=f"{name} {i}")
        ended += int((tout.terminated | tout.truncated).sum())
        jstate, tstate = jout.state, tout.state
    assert ended > 0 and tout.obs.shape == (n, 4 * 84 * 84) and tout.obs.dtype == torch.float32


def test_nature_cnn_forward_parity():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, size=(8, 4, 84, 84)).astype(np.uint8)
    jnet = JNatureCNN()
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 84, 84, 4)))
    want = np.asarray(jnet.apply(params, jnp.asarray(np.moveaxis(frames, 1, -1))))
    net = load_flax_params(NatureCNN((4, 84, 84)), jax.tree.map(np.asarray, params))
    assert net.out.in_features == 3136
    np.testing.assert_allclose(net(_t(frames)).detach().numpy(), want, atol=1e-5, rtol=1e-5)
    back = to_flax_params(net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_envelope_cnn_qnet_forward_parity():
    """``EnvelopeQNet(image_shape=(4, 84, 84))`` on flat stacked frames with leading batch axes."""
    rng = np.random.default_rng(3)
    obs = rng.integers(0, 256, size=(3, 5, 4 * 84 * 84)).astype(np.float32)
    w = rng.dirichlet([1.0, 1.0], size=(3, 5)).astype(np.float32)
    jnet = JEnvelopeQNet(num_actions=4, reward_dim=2, hidden=(32, 32), image_shape=(4, 84, 84))
    params = jnet.init(jax.random.key(1), jnp.zeros((1, 4 * 84 * 84)), jnp.zeros((1, 2)))
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), jnp.asarray(w)))
    net = load_flax_params(EnvelopeQNet(4 * 84 * 84, 4, 2, (32, 32), image_shape=(4, 84, 84)), jax.tree.map(np.asarray, params))
    got = net(_t(obs), _t(w)).detach().numpy()
    assert got.shape == (3, 5, 4, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="image_shape"):
        EnvelopeQNet(100, 4, 2, (32, 32), image_shape=(4, 84, 84))


# ---------------------------------------------------------------- mirrors of tests/test_wrappers.py


def test_pixel_dst_renders_and_matches_dynamics():
    env = make("deep-sea-treasure-pixel-v0")
    state, obs = env.reset(1, torch.Generator().manual_seed(0))
    assert obs.shape == (1, 88, 80, 3) and obs.dtype == torch.uint8
    np.testing.assert_array_equal(obs[0, 0, 0].numpy(), [220, 50, 50])  # the agent at the top-left start
    out = env.step(state, torch.tensor([1]))  # down -> treasure 0.7
    np.testing.assert_allclose(out.reward.numpy(), [[0.7, -1.0]], rtol=1e-6)
    assert bool(out.terminated[0])
    np.testing.assert_array_equal(out.obs[0, 8, 0].numpy(), [220, 50, 50])
    np.testing.assert_array_equal(env.pareto_front(0.98), make("deep-sea-treasure-v0").pareto_front(0.98))


def test_grayscale_resize_flatten_shapes():
    gen = torch.Generator().manual_seed(0)
    env = GrayscaleObservation(PixelDST())
    _, obs = env.reset(1, gen)
    assert obs.shape == (1, 88, 80) and obs.dtype == torch.uint8
    _, obs = ResizeObservation(GrayscaleObservation(PixelDST()), (84, 84)).reset(1, gen)
    assert obs.shape == (1, 84, 84)
    env = FlattenObservation(PixelDST())
    _, obs = env.reset(1, gen)
    assert obs.shape == (1, 88 * 80 * 3) and env.obs_dim == 88 * 80 * 3


def test_frame_stack_rolls():
    env = FrameStackObservation(GrayscaleObservation(PixelDST()), 4)
    state, obs = env.reset(1, torch.Generator().manual_seed(0))
    assert obs.shape == (1, 4, 88, 80)
    assert torch.equal(obs[0, 0], obs[0, 3])  # a reset pads with the reset frame
    out = env.step(state, torch.tensor([3]))  # right
    assert torch.equal(out.obs[0, :3], obs[0, 1:])
    assert not torch.equal(out.obs[0, 3], out.obs[0, 0])


def test_max_and_skip_accumulates_vector_reward_and_freezes_after_done():
    env = MOMaxAndSkipObservation(make("deep-sea-treasure-v0"), skip=4)
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(1, gen)
    out = env.step(state, torch.tensor([3]))  # 4x right
    np.testing.assert_allclose(out.reward.numpy(), [[0.0, -4.0]])
    state, _ = env.reset(1, gen)
    out = env.step(state, torch.tensor([1]))  # down -> the first treasure; no reward accrues after it
    assert bool(out.terminated[0])
    np.testing.assert_allclose(out.reward.numpy(), [[0.7, -1.0]], rtol=1e-6)


def test_time_limit_truncates():
    env = TimeLimit(make("deep-sea-treasure-pixel-v0"), max_episode_steps=3)
    state, _ = env.reset(1, torch.Generator().manual_seed(0))
    for _ in range(3):
        out = env.step(state, torch.tensor([0]))  # up: a no-op that never terminates
        state = out.state
    assert bool(out.truncated[0])


def test_full_stack_vector_steps():
    env = make("deep-sea-treasure-pixel-stack-v0")
    venv = VectorMOEnv(env, 4)
    gen = torch.Generator().manual_seed(0)
    state, obs = venv.reset(gen)
    assert obs.shape == (4, 4 * 84 * 84)
    rewards = []
    for _ in range(10):
        out = venv.step(state, torch.randint(0, 4, (4,), generator=gen), gen)
        state = out.state
        rewards.append(out.reward)
    rewards = torch.stack(rewards)
    assert rewards.shape == (10, 4, 2) and bool(torch.isfinite(rewards).all())


def test_envelope_cnn_trunk_trains():
    env = make("deep-sea-treasure-pixel-stack-v0")
    cfg = EnvelopeConfig(num_envs=4, buffer_size=128, batch_size=8, learning_starts=8, hidden=(32, 32),
                         image_shape=(4, 84, 84), num_sample_w=2)
    agent = Envelope(env, cfg, device="cpu")
    state = agent.train_segment(agent.init_state(0), 6)
    assert state.global_step == 24
    assert all(bool(torch.isfinite(p).all()) for p in state.ts.net.parameters())
    assert np.isfinite(float(state.loss))
