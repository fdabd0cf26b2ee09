"""The loop's spans (``utils.profiling.span``) in Envelope's (one seed and
seeds stacked) and GPI-LS's ``train_segment``: how many of each an iteration records under a profiler,
where each lies, that they change no result, that they cost nothing without a
profiler, and that ``trace`` exports them.  CPU, tiny widths; imports no JAX.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from morl_baselines_torch.agents import GPILS, Envelope, EnvelopeConfig, GPILSConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import MemberAdam
from morl_baselines_torch.utils import profiling, span, trace

torch.set_num_threads(1)

SPANS = ("actor", "actor.act", "env.step", "replay.add", "learner", "replay.sample", "learner.update",
         "replay.update_priorities", "learner.target_copy")
UPDATES, COPY_EVERY, ITERS = 2, 3, 6
# 16 envs and learning from 32 rows: the second iteration is the first that learns
SMALL = dict(num_envs=16, buffer_size=256, batch_size=8, hidden=(16, 16), learning_starts=32,
             gradient_updates=UPDATES, target_net_update_freq=COPY_EVERY, seed=3)
CASES = [("envelope", False), ("envelope", True), ("envelope-seeds", False), ("envelope-seeds", True),
         ("gpils", False), ("gpils", True)]


def _build(algo: str, per: bool):
    env = make("minecart-v0")
    if algo.startswith("envelope"):
        agent = Envelope(env, EnvelopeConfig(**SMALL, per=per, num_sample_w=3), device="cpu")
        return agent, (agent.init_state_seeds([3, 5]) if algo == "envelope-seeds" else agent.init_state())
    agent = GPILS(env, GPILSConfig(**SMALL, per=per, max_support=4), device="cpu")
    support = [np.eye(3, dtype=np.float32)[i] for i in range(3)] + [np.full(3, 1 / 3, np.float32)]
    return agent, agent.set_weight_support(agent.init_state(), support)


def _learning(agent, state):
    """The agent, and its state past the first iteration: the next one learns."""
    agent.train_segment(state, 1)
    assert state.global_step + agent.cfg.num_envs >= agent.cfg.learning_starts
    return agent, state


def _profiled_iteration(agent, state) -> list:
    """(name, start, end) of every span one iteration records, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        agent.train_segment(state, 1)
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name in SPANS]
    return sorted(out, key=lambda x: x[1])


@pytest.mark.parametrize("algo,per", CASES)
def test_spans_an_iteration(algo, per):
    agent, state = _learning(*_build(algo, per))
    copies = 0
    for _ in range(ITERS):
        names = [n for n, _, _ in _profiled_iteration(agent, state)]
        copied = state.iter_count % COPY_EVERY == 0
        copies += copied
        want = {"actor": 1, "actor.act": 1, "env.step": 1, "replay.add": 1, "learner": 1,
                "replay.sample": UPDATES, "learner.update": UPDATES,
                "replay.update_priorities": UPDATES if per else 0, "learner.target_copy": int(copied)}
        assert {k: names.count(k) for k in SPANS} == want
    assert copies == ITERS // COPY_EVERY


@pytest.mark.parametrize("algo,per", CASES)
def test_spans_nest_in_their_half_of_the_iteration(algo, per):
    agent, state = _learning(*_build(algo, per))
    inner = {"actor.act": "actor", "env.step": "actor", "replay.add": "actor", "replay.sample": "learner",
             "learner.update": "learner", "replay.update_priorities": "learner"}
    seen = set()
    for _ in range(COPY_EVERY):  # each profile has a clock of its own
        spans = _profiled_iteration(agent, state)
        outer = {k: [(s, e) for n, s, e in spans if n == k] for k in ("actor", "learner")}
        for name, s, e in spans:
            if name in inner:
                assert any(a <= s and e <= b for a, b in outer[inner[name]]), (name, s, e)
                seen.add(name)
            elif name == "learner.target_copy":
                assert not any(a <= s <= b for a, b in outer["actor"] + outer["learner"])
                seen.add(name)
    assert seen == set(inner) - (set() if per else {"replay.update_priorities"}) | {"learner.target_copy"}


def _snapshot(state) -> list:
    out = [p.detach().clone() for p in state.ts.net.parameters()]
    out += [p.detach().clone() for p in state.ts.target_net.parameters()]
    out += [x.clone() for x in state.buffer.data] + [state.loss.clone(), state.obs.clone()]
    opt = state.ts.optimizer
    if isinstance(opt, MemberAdam):
        out += [v.clone() for v in (*opt.exp_avg, *opt.exp_avg_sq, opt.step_count)]
    else:
        out += [v.clone() for s in opt.state.values() for v in s.values() if torch.is_tensor(v)]
    if hasattr(state.buffer, "priorities"):
        out += [state.buffer.priorities.clone(), state.buffer.max_priority.clone()]
    return out


@pytest.mark.parametrize("algo,per", CASES)
def test_spans_change_no_result(algo, per):
    """From one seed, the state after k iterations is bitwise the same with a
    profiler recording and without one."""
    agent, plain = _build(algo, per)
    _, traced = _build(algo, per)
    agent.train_segment(plain, ITERS)
    with profile(activities=[ProfilerActivity.CPU]):
        agent.train_segment(traced, ITERS)
    a, b = _snapshot(plain), _snapshot(traced)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert (plain.global_step, plain.iter_count) == (traced.global_step, traced.iter_count)


def test_span_off_is_one_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    assert span("actor") is span("learner.update") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("actor") is not profiling._OFF


@pytest.mark.parametrize("algo,per", CASES)
def test_no_range_is_opened_without_a_profiler(algo, per, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} was opened with no profiler recording")

    for owner in (profiling, torch.profiler):
        monkeypatch.setattr(owner, "record_function", refuse)
    agent, state = _build(algo, per)
    agent.train_segment(state, ITERS)
    assert state.iter_count == ITERS


@pytest.mark.parametrize("algo,per", CASES)
def test_trace_exports_every_span(algo, per, tmp_path):
    agent, state = _learning(*_build(algo, per))
    with trace(tmp_path):
        agent.train_segment(state, COPY_EVERY)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert set(SPANS) - ({"replay.update_priorities"} if not per else set()) <= names
    assert per or "replay.update_priorities" not in names
