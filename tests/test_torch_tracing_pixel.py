"""The pixel path's spans: ``qnet.trunk`` (``NatureCNN.forward``) and
``env.frames`` (the pixel DST's renders and the mario stack's image work),
beside ``tests/test_torch_tracing.py``'s spans of the loop.  How many an
iteration of Envelope on the pixel stack records under a profiler and where
they lie, that they change no result, and that without a profiler they are
the shared no-op and open no range.  CPU, a small Q-net head; imports no JAX.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from morl_baselines_torch.agents import Envelope, EnvelopeConfig
from morl_baselines_torch.envs import VectorMOEnv, make
from morl_baselines_torch.utils import profiling, span

torch.set_num_threads(1)

UPDATES = 2
# 4 envs learning from 8 rows: the second iteration is the first that learns
SMALL = dict(num_envs=4, buffer_size=64, batch_size=4, hidden=(16, 16), learning_starts=8, gradient_updates=UPDATES,
             num_sample_w=2, image_shape=(4, 84, 84), seed=5)
# a vector step's image work: MaxAndSkip's 4 renders, 3 frame selects and the max; the resize, the grayscale and
# the stack shift of the stepped frame; the autoreset's render, resize, grayscale and stack fill
FRAMES_PER_STEP = 4 + 3 + 1 + 3 + 4


def _learning(per: bool):
    agent = Envelope(make("deep-sea-treasure-pixel-stack-v0"), EnvelopeConfig(**SMALL, per=per), device="cpu")
    state = agent.init_state()
    agent.train_segment(state, 1)
    return agent, state


def _spans(agent, state, iters=1) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        agent.train_segment(state, iters)
    names = ("qnet.trunk", "env.frames", "actor.act", "env.step", "learner.update")
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name in names),
                  key=lambda x: x[1])


@pytest.mark.parametrize("per", [False, True])
def test_spans_an_iteration_and_where_they_lie(per):
    """One trunk in the act and three in each eager update (the target side's
    online and target nets, the loss), every one inside its half; the frame
    spans inside the env step, none nested in another."""
    agent, state = _learning(per)
    spans = _spans(agent, state)
    names = [n for n, _, _ in spans]
    assert names.count("qnet.trunk") == 1 + 3 * UPDATES
    assert names.count("env.frames") == FRAMES_PER_STEP and names.count("env.step") == 1
    inside = lambda s, e, outer: any(a <= s and e <= b for n, a, b in spans if n == outer)  # noqa: E731
    trunks = [(s, e) for n, s, e in spans if n == "qnet.trunk"]
    assert sum(inside(s, e, "actor.act") for s, e in trunks) == 1
    assert sum(inside(s, e, "learner.update") for s, e in trunks) == 3 * UPDATES
    frames = [(s, e) for n, s, e in spans if n == "env.frames"]
    assert all(inside(s, e, "env.step") for s, e in frames)
    assert all(e1 <= s2 for (_, e1), (s2, _) in zip(frames, frames[1:]))


def test_frame_spans_of_the_bare_stack():
    """The registered stack alone, stepped by ``VectorMOEnv``: the same count a step."""
    venv = VectorMOEnv(make("deep-sea-treasure-pixel-stack-v0"), 3)
    gen = torch.Generator().manual_seed(0)
    state, _ = venv.reset(gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state = venv.step(state, torch.tensor([0, 1, 3]), gen).state
    assert [e.name for e in prof.events()].count("env.frames") == 2 * FRAMES_PER_STEP


def test_new_spans_off_are_the_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    assert span("qnet.trunk") is span("env.frames") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("qnet.trunk") is not profiling._OFF and span("env.frames") is not profiling._OFF


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} was opened with no profiler recording")

    for owner in (profiling, torch.profiler):
        monkeypatch.setattr(owner, "record_function", refuse)
    agent, state = _learning(True)
    agent.train_segment(state, 2)
    assert state.iter_count == 3


def test_spans_change_no_result():
    """From one seed, three iterations with a profiler recording and without
    one leave the nets, the optimizer, the replay and the obs bitwise equal."""
    (agent, plain), (_, traced) = _learning(True), _learning(True)
    agent.train_segment(plain, 3)
    _spans(agent, traced, 3)

    def leaves(state):
        out = [p for p in state.ts.net.parameters()] + [p for p in state.ts.target_net.parameters()]
        out += list(state.buffer.data) + [state.buffer.priorities, state.loss, state.obs]
        return out + [v for s in state.ts.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]

    a, b = leaves(plain), leaves(traced)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
