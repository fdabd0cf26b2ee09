"""Envelope's target side on a Q-net with a NatureCNN trunk: each net's trunk
runs once a distinct next frame, and its features go to the head's B·W² rows
by broadcast, where the tiled computation ran the trunk on every tiled row.

The tiled computation (``_loss`` tiling the batch over the W sampled weights,
``_envelope_target`` tiling the next frames W times more, both nets'
whole forward on the B·W² rows) is kept here as the reference.  On the CPU:
the new target and one eager update against it (float32 convolutions sum in
another order at another batch size: atol 1e-6); the MLP net's target and
update bitwise the tiled ones; the ``qnet.trunk`` spans of one traced eager
update and the rows each sees.  On an NVIDIA card (``cuda`` marker; skipped here):
the target at the pixel cell's shapes against the tiled one, and the pixel
update under ``GraphedUpdate``, one capture and a replay an update.  Imports
no JAX, so the card runs it with ``--noconftest``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import graphed
from morl_baselines_torch.models.graphed import GraphedUpdate
from morl_baselines_torch.models.networks import clip_grad_global_norm_
from morl_baselines_torch.replay.buffer import Transition

torch.set_num_threads(1)

ATOL = 1e-6
PIXEL = dict(num_envs=4, buffer_size=64, batch_size=8, hidden=(32, 32), num_sample_w=3, image_shape=(4, 84, 84),
             max_grad_norm=0.05)
MLP = dict(num_envs=4, buffer_size=64, batch_size=16, hidden=(32, 32), num_sample_w=3, max_grad_norm=0.05)


def _agent(pixel: bool, device: str = "cpu", **kw) -> Envelope:
    env = make("deep-sea-treasure-pixel-stack-v0" if pixel else "minecart-v0")
    return Envelope(env, EnvelopeConfig(**{**(PIXEL if pixel else MLP), **kw}), device=device)


def _train_state(agent: Envelope):
    """Online and target nets from two seeds, so the two sides' trunks differ."""
    ts = agent.make_train_state(agent.make_q_net(torch.Generator().manual_seed(3)))
    ts.target_net.load_state_dict(agent.make_q_net(torch.Generator().manual_seed(4)).state_dict())
    return ts


def _batch(agent: Envelope, seed: int, b: int) -> Transition:
    """Frames of grey levels 0..255 for the pixel net, uniform vectors for the MLP."""
    g, dev = torch.Generator().manual_seed(seed), agent.device
    obs = lambda: (  # noqa: E731
        torch.randint(0, 256, (b, agent.obs_dim), generator=g).float()
        if agent.cfg.image_shape else torch.rand((b, agent.obs_dim), generator=g)
    )
    return Transition(obs().to(dev), torch.randint(0, agent.env.num_actions, (b,), generator=g).to(dev),
                      torch.randn((b, agent.reward_dim), generator=g).to(dev), obs().to(dev),
                      (torch.rand(b, generator=g) < 0.3).float().to(dev))


def _sampled_w(agent: Envelope, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((agent.cfg.num_sample_w, agent.reward_dim), generator=g).to(agent.device)


@torch.no_grad()
def _tiled_target(agent: Envelope, ts, next_obs, w, sampled_w):
    """The tiled target: both nets' whole forward on every one of the B*W rows."""
    b, n_w, d = next_obs.shape[0], sampled_w.shape[0], agent.reward_dim
    no = next_obs.repeat_interleave(n_w, dim=0)
    ws = sampled_w.repeat(b, 1)
    q_online = ts.net(no, ws, agent.dtype).reshape(b, n_w, -1, d)
    scal = torch.einsum("bd,bwad->bwa", w, q_online)
    best_a = torch.argmax(scal, dim=2)
    best_w = torch.argmax(torch.max(scal, dim=2).values, dim=1)
    q_target = ts.target_net(no, ws, agent.dtype).reshape(b, n_w, -1, d)
    q_at_a = torch.gather(q_target, 2, best_a[:, :, None, None].expand(b, n_w, 1, d)).squeeze(2)
    return torch.gather(q_at_a, 1, best_w[:, None, None].expand(b, 1, d)).squeeze(1)


def _tiled_update(agent: Envelope, ts, batch: Transition, sampled_w, lam: float):
    """The tiled update: the loss on the batch tiled over the sampled weights,
    its target from ``_tiled_target`` on the tiled next frames; clip and Adam."""
    cfg = agent.cfg
    n_w, b = sampled_w.shape[0], batch.obs.shape[0]
    w = sampled_w.repeat_interleave(b, dim=0)
    target_next = _tiled_target(agent, ts, batch.next_obs.repeat(n_w, 1), w, sampled_w)
    y = batch.reward.repeat(n_w, 1) + (1.0 - batch.terminated.repeat(n_w)[:, None]) * cfg.gamma * target_next
    q = ts.net(batch.obs.repeat(n_w, 1), w, agent.dtype)
    q_sa = torch.gather(q, 1, batch.action.repeat(n_w).long()[:, None, None].expand(-1, 1, agent.reward_dim)).squeeze(1)
    wq, wy = torch.sum(q_sa * w, dim=-1), torch.sum(y * w, dim=-1)
    lam64 = torch.as_tensor(lam, dtype=torch.float64)
    loss = (1.0 - lam64).float() * torch.mean((q_sa - y) ** 2) + lam64.float() * torch.mean((wq - wy) ** 2)
    ts.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    clip_grad_global_norm_(list(ts.net.parameters()), cfg.max_grad_norm)
    ts.optimizer.step()
    return loss.detach(), (wq - wy)[:b].detach()


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("seed", [0, 1])
def test_pixel_target_equals_the_tiled_target(seed):
    """From the batch's B distinct frames (the loss's call) and from the W-times
    tiled frames (the layout the JAX parity tests pass), the target equals the
    tiled one."""
    agent = _agent(True)
    ts = _train_state(agent)
    batch, sw = _batch(agent, seed, 8), _sampled_w(agent, 10 + seed)
    w = sw.repeat_interleave(8, dim=0)
    tiled = batch.next_obs.repeat(3, 1)
    want = _tiled_target(agent, ts, tiled, w, sw)
    for next_obs in (batch.next_obs, tiled):
        got = agent._envelope_target(ts, next_obs, w, sw)
        assert got.shape == want.shape == (24, 2)
        torch.testing.assert_close(got, want, rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("lam", [0.0, 0.7])
def test_pixel_update_equals_the_tiled_update(lam):
    """One eager update against the tiled update: the loss, the TD errors,
    the clipped gradients and the parameters after Adam's step."""
    agent = _agent(True)
    sides = [_train_state(agent) for _ in range(2)]
    batch, sw = _batch(agent, 2, 8), _sampled_w(agent, 12)
    loss, td = agent._update(sides[0], batch, sw, lam)
    want_loss, want_td = _tiled_update(agent, sides[1], batch, sw, lam)
    torch.testing.assert_close(loss, want_loss, rtol=ATOL, atol=0.0)
    torch.testing.assert_close(td, want_td, rtol=0.0, atol=ATOL)
    for p, q in zip(sides[0].net.parameters(), sides[1].net.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=0.0, atol=ATOL)
        torch.testing.assert_close(p, q, rtol=0.0, atol=ATOL)


def test_mlp_target_and_update_are_bitwise_the_tiled_ones():
    """Without a trunk the head sees the tiled rows' values in their order: the
    target on the tiled next obs and two updates (the loss, the TD errors,
    every parameter and Adam moment) equal the tiled computation bit for bit."""
    agent = _agent(False)
    ts, twin = _train_state(agent), _train_state(agent)
    batch, sw = _batch(agent, 5, 16), _sampled_w(agent, 15)
    w = sw.repeat_interleave(16, dim=0)
    tiled = batch.next_obs.repeat(3, 1)
    assert torch.equal(agent._envelope_target(ts, tiled, w, sw), _tiled_target(agent, ts, tiled, w, sw))
    for step, lam in enumerate((0.2, 0.9)):
        batch, sw = _batch(agent, 6 + step, 16), _sampled_w(agent, 16 + step)
        loss, td = agent._update(ts, batch, sw, lam)
        want_loss, want_td = _tiled_update(agent, twin, batch, sw, lam)
        assert torch.equal(loss, want_loss) and torch.equal(td, want_td)
    for p, q in zip(ts.net.parameters(), twin.net.parameters()):
        assert torch.equal(p, q)
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ts.optimizer.state[p][k], twin.optimizer.state[q][k])


def _trunk_rows(agent: Envelope, ts, batch, sw) -> list[int]:
    """The rows each ``qnet.trunk`` span of one traced eager update convolves,
    in the order the spans open: the batch size of its first convolution."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        agent._update(ts, batch, sw, 0.5)
    events = prof.events()
    trunks = sorted((e.time_range.start, e.time_range.end) for e in events if e.name == "qnet.trunk")
    rows = []
    for start, end in trunks:
        convs = sorted((e.time_range.start, e.input_shapes[0][0]) for e in events
                       if e.name == "aten::convolution" and start <= e.time_range.start and e.time_range.end <= end)
        rows.append(convs[0][1])
    return rows


def test_trunk_spans_see_the_distinct_frames():
    """The engagement reading: in one traced eager update the target side's two
    trunks (online, target) convolve the B distinct next frames and the loss's
    trunk the B·W tiled rows; the MLP net opens no trunk span."""
    agent = _agent(True)
    assert _trunk_rows(agent, _train_state(agent), _batch(agent, 3, 8), _sampled_w(agent, 13)) == [8, 8, 24]
    mlp = _agent(False)
    assert _trunk_rows(mlp, _train_state(mlp), _batch(mlp, 3, 16), _sampled_w(mlp, 13)) == []


# ------------------------------------------------------------------ the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's shapes and the CUDA graph run only on the card")


@pytest.mark.cuda
def test_cuda_pixel_target_at_the_cell_shapes():
    """B 256, W 4, 4x84x84 frames (``envelope-pixel.wide``'s update): the target
    from the 256 distinct frames against the tiled one on 4096 rows; prints
    whether each net's trunk features and the target are bitwise equal, and
    the largest gaps."""
    _needs_card()
    agent = _agent(True, "cuda", batch_size=256, num_sample_w=4, hidden=(256, 256, 256, 256))
    ts = _train_state(agent)
    batch, sw = _batch(agent, 7, 256), _sampled_w(agent, 17)
    w = sw.repeat_interleave(256, dim=0)
    want = _tiled_target(agent, ts, batch.next_obs.repeat(4, 1), w, sw)
    got = agent._envelope_target(ts, batch.next_obs, w, sw)
    with torch.no_grad():
        tiled_frames = batch.next_obs.repeat(16, 1)
        nets = (ts.net, ts.target_net)
        feats = [(net.features(batch.next_obs).repeat(16, 1), net.features(tiled_frames)) for net in nets]
    report = [f"features {name}: bitwise {torch.equal(a, b)}, largest gap {float((a - b).abs().max())!r}"
              for name, (a, b) in zip(("online", "target"), feats)]
    report.append(f"target: bitwise {torch.equal(got, want)}, largest gap {float((got - want).abs().max())!r}")
    print("[cell shapes] " + "; ".join(report))
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_pixel_update_is_one_capture_and_a_replay_an_update():
    """The pixel update under ``GraphedUpdate``: the eager warm-ups, one
    capture, then every update a replay; losses, TD errors and parameters
    bitwise those of the same updates run eagerly on a twin state with Adam
    as the graph has it (cuDNN's deterministic algorithms on both sides: a
    kernel gradient summed with atomics is not repeatable bit for bit)."""
    _needs_card()
    agent = _agent(True, "cuda", batch_size=32)
    helper, n = GraphedUpdate(), 8
    graphed_ts, eager_ts = _train_state(agent), _train_state(agent)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(n):
                batch, sw = _batch(agent, 20 + i, 32), _sampled_w(agent, 30 + i)
                got = helper(agent._update, graphed_ts, batch, sw, 0.5)
                graphed._make_capturable(eager_ts.optimizer)
                want = agent._update(eager_ts, batch, sw, 0.5)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), i
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert helper.captures == 1
    assert [e.name for e in prof.events()].count("learner.graph_replay") == n - graphed.WARMUP
    for p, q in zip(graphed_ts.net.parameters(), eager_ts.net.parameters()):
        assert torch.equal(p, q)
