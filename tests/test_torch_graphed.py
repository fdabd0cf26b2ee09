"""The learner's update as a CUDA graph (``models.graphed.GraphedUpdate``) in
Envelope's and GPI-LS's ``train_segment``.

On the CPU every path is the eager update: no graph, no ``learner.graph_*``
span, Adam as made, and the loop's results those of the plain ``_update``;
Envelope's loss reads a 0-d float64 λ (a graph's input) bitwise as the float.
On an NVIDIA card (``cuda`` marker; skipped here): 20 replayed updates
against 20 eager ones on two states built from one seed, bitwise where both
Adams are capturable and within a stated bound of the library's default
Adam; the generator's state after them; a recapture for a new state and for
replaced leaves; whole ``train_segment`` runs against the eager loop.
Imports no JAX, so the card runs it with ``--noconftest``.
"""

import copy
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from morl_baselines_torch.agents import GPILS, Envelope, EnvelopeConfig, GPILSConfig
from morl_baselines_torch.agents.base import state_tree
from morl_baselines_torch.core.weights import random_weights
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import graphed
from morl_baselines_torch.models.graphed import GraphedUpdate
from morl_baselines_torch.models.networks import MemberAdam, TrainState, polyak_update
from morl_baselines_torch.replay.buffer import Transition

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
UPDATES = 20
SMALL = dict(num_envs=16, buffer_size=256, batch_size=8, hidden=(16, 16), learning_starts=32,
             gradient_updates=2, target_net_update_freq=3, seed=3)
CASES = [("envelope", False), ("envelope", True), ("gpils", False), ("gpils", True)]
GRAPH_SPANS = ("learner.graph_replay", "learner.graph_capture")


def _agent(algo: str, per: bool, device: str, **kw):
    env = make("minecart-v0")
    if algo == "envelope":
        cfg = {**SMALL, "num_sample_w": 3, "homotopy_decay_steps": 40, **kw}
        return Envelope(env, EnvelopeConfig(**cfg, per=per), device=device)
    return GPILS(env, GPILSConfig(**{**SMALL, "max_support": 4, **kw}, per=per), device=device)


def _state(agent):
    if isinstance(agent, Envelope):
        return agent.init_state()
    support = [np.eye(3, dtype=np.float32)[i] for i in range(3)] + [np.full(3, 1 / 3, np.float32)]
    return agent.set_weight_support(agent.init_state(), support)


def _eager(agent):
    """The agent with its graphed update replaced by the plain ``_update``."""
    agent._graphed = lambda update, ts, *args: update(ts, *args)
    return agent


def _twin(update, ts, *args):
    """The plain update with Adam as the graph has it: as made until its
    first step, then capturable with float64 step counts."""
    graphed._make_capturable(ts.optimizer)
    return update(ts, *args)


def _assert_same(a, b, path="state"):
    """Two state trees (``state_tree``) equal bitwise, leaf by leaf."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a.nan_to_num(), b.nan_to_num())), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("algo,per", CASES)
def test_cpu_train_segment_opens_no_graph_span_and_builds_no_graph(algo, per):
    agent = _agent(algo, per, "cpu")
    state = _state(agent)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        agent.train_segment(state, 4)
    names = [e.name for e in prof.events()]
    assert names.count("learner.update") == 3 * SMALL["gradient_updates"]  # the last three iterations learn
    assert not [n for n in names if n in GRAPH_SPANS]
    assert agent._graphed.graph is None and agent._graphed.captures == 0 and agent._graphed.warm == 0
    assert not any(g["capturable"] for g in state.ts.optimizer.param_groups)


@pytest.mark.parametrize("algo,per", CASES)
def test_cpu_train_segment_gives_the_eager_update_results(algo, per):
    """The loop's state after 6 iterations (target copies and, with PER,
    priorities among them) equals, bitwise, that of the loop calling the plain
    ``_update``."""
    runs = []
    for agent in (_agent(algo, per, "cpu"), _eager(_agent(algo, per, "cpu"))):
        state = _state(agent)
        agent.train_segment(state, 6)
        runs.append(state_tree(state))
    _assert_same(*runs)
    assert np.isfinite(float(runs[0]["loss"]))


@pytest.mark.parametrize("lam", [0.0, 0.1, 1 / 3, 0.7, 0.9999999, 1.0])
def test_loss_reads_a_tensor_lambda_bitwise_as_the_float(lam):
    """Envelope's homotopy loss and its gradient with λ a 0-d float64 tensor
    (a graph's input) equal those with λ the float, 1/3 and 0.9999999 among
    them, whose (1 - λ) rounds in float32 to another value than 1 - float32(λ)."""
    agent = _agent("envelope", False, "cpu")
    g = torch.Generator().manual_seed(11)
    batch = Transition(torch.randn(8, agent.obs_dim, generator=g), torch.randint(0, 6, (8,), generator=g),
                       torch.randn(8, 3, generator=g), torch.randn(8, agent.obs_dim, generator=g),
                       (torch.rand(8, generator=g) < 0.2).float())
    sampled_w = random_weights(torch.Generator().manual_seed(5), 3, n=3, dist="gaussian")
    out = []
    for lam_in in (lam, torch.tensor(lam, dtype=torch.float64)):
        ts = agent.make_train_state(agent.make_q_net(torch.Generator().manual_seed(2)))
        loss, td, l_mo = agent._loss(ts, batch, sampled_w, lam_in)
        loss.backward()
        out.append([loss.detach(), td.detach(), l_mo.detach()] + [p.grad for p in ts.net.parameters()])
    for a, b in zip(*out):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_engages_only_on_a_cuda_adam():
    agent = _agent("envelope", False, "cpu")
    ts = agent.make_train_state(agent.make_q_net(torch.Generator().manual_seed(0)))
    assert not graphed.engages(ts)  # a CPU Adam
    stacked = TrainState(net=ts.net, target_net=ts.target_net, optimizer=MemberAdam(ts.net.parameters(), lr=1e-3))
    assert not graphed.engages(stacked)
    assert not graphed.engages(SimpleNamespace(optimizer=torch.optim.SGD(ts.net.parameters(), lr=1e-3)))
    with pytest.raises(TypeError):
        graphed._signature(("a string",))
    sig = graphed._signature((torch.zeros(2, 3), 0.5, 1))
    assert sig == (((2, 3), torch.float32), float, float)


def test_a_graphed_adams_checkpoint_steps_on_the_cpu(tmp_path):
    """A checkpoint of the optimizer as a graphed run leaves it (capturable,
    float64 step counts) restores into a CPU template as a plain Adam, which
    steps; a capturable Adam on the CPU would raise."""
    agent = _agent("envelope", False, "cpu")
    state = _state(agent)
    agent.train_segment(state, 3)
    for group in state.ts.optimizer.param_groups:
        group["capturable"] = True
    for st in state.ts.optimizer.state.values():
        st["step"] = st["step"].to(torch.float64)
    agent.save(state, tmp_path / "graphed.pt")
    restored = agent.load(_state(agent), tmp_path / "graphed.pt")
    assert not any(g["capturable"] for g in restored.ts.optimizer.param_groups)
    assert all(st["step"].dtype == torch.float64 for st in restored.ts.optimizer.state.values())
    steps = lambda: {float(st["step"]) for st in restored.ts.optimizer.state.values()}  # noqa: E731
    assert steps() == {4.0}  # two learning iterations of two updates
    agent.train_segment(restored, 2)
    assert steps() == {8.0}


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("replays,want", [(16, 100.0), (12, 75.0), (0, None)])
def test_graph_replay_share_reader(replays, want):
    """``learner.graph_replay_share``: replays over updates in the profiled
    stretch, in %; nothing where the program opens no replay span."""
    host = [("learner.update", 0.01 * i, 0.01 * i + 0.005) for i in range(16)]
    host += [("learner.graph_replay", 0.01 * i + 0.001, 0.01 * i + 0.004) for i in range(replays)]
    host += [("learner.graph_capture", 0.5, 0.6)]
    stretch = SimpleNamespace(iters=1, window_s=1.0, device_ops=[("k", 0.0, 1e-5)], host_ops=sorted(host, key=lambda x: x[1]))
    assert _reader("learner.graph_replay_share")(SimpleNamespace(stretch=stretch)) == want
    assert _reader("learner.graph_replay_share")(SimpleNamespace(stretch=None)) is None


# ------------------------------------------------------------------ the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph runs only on the card")


def _batch(agent, g: torch.Generator, b: int) -> Transition:
    dev = agent.device
    return Transition(torch.randn(b, agent.obs_dim, generator=g).to(dev),
                      torch.randint(0, agent.env.num_actions, (b,), generator=g).to(dev),
                      torch.randn(b, agent.reward_dim, generator=g).to(dev),
                      torch.randn(b, agent.obs_dim, generator=g).to(dev),
                      (torch.rand(b, generator=g) < 0.2).float().to(dev))


def _train_state(agent) -> TrainState:
    return agent.make_train_state(agent.make_q_net(torch.Generator().manual_seed(7)))


def _leaves(ts) -> list:
    opt = ts.optimizer
    return [t for p in ts.net.parameters() for t in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])]


def _updates(algo: str, n: int, hook=None):
    """(losses, tds, leaves, generator states) of ``n`` updates on three states
    from one seed: through ``GraphedUpdate``, eager with Adam as the graph has
    it (``_twin``), and eager with the library's default Adam; Envelope's λ changes every update,
    GPI-LS draws its dropout masks from each state's generator.  ``hook(i,
    states)`` runs before update i (replacing leaves, copying the target)."""
    agent = _agent(algo, False, "cuda", hidden=(64, 64))
    helper = GraphedUpdate()
    states = [_train_state(agent) for _ in range(3)]
    gens = [torch.Generator(agent.device).manual_seed(4) for _ in states]
    data = torch.Generator().manual_seed(9)
    out = [([], []) for _ in states]
    for i in range(n):
        if hook is not None:
            hook(i, states, helper)
        batch = _batch(agent, data, 32)
        for k, (ts, gen) in enumerate(zip(states, gens)):
            if algo == "envelope":
                w = random_weights(gen, 3, n=3, dist="gaussian")
                args = (batch, w, 0.05 + 0.9 * i / (n - 1))
            else:
                w = random_weights(gen, 3, n=32)
                args = (batch, w, gen)
            step = (helper, _twin, lambda update, ts, *a: update(ts, *a))[k]
            loss, td = step(agent._update, ts, *args)
            out[k][0].append(loss.clone())
            out[k][1].append(td.clone())
    return helper, out, [_leaves(ts) for ts in states], [g.get_state() for g in gens]


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["envelope", "gpils"])
def test_graphed_updates_match_eager(algo):
    """Bitwise against eager updates with Adam as the graph has it: losses,
    TD errors, parameters, exp_avg, exp_avg_sq and the generator's state.
    Against the library's default Adam, within 1e-5 of each tensor's largest
    magnitude (the two Adams round their last step differently)."""
    _needs_card()
    helper, out, leaves, gen_states = _updates(algo, UPDATES)
    assert helper.captures == 1 and helper.graph is not None
    graph_side, same_adam, default_adam = zip(out, leaves)
    for a, b in zip(graph_side[0][0] + graph_side[0][1], same_adam[0][0] + same_adam[0][1]):
        assert torch.equal(a, b)
    for a, b in zip(graph_side[1], same_adam[1]):
        assert torch.equal(a, b)
    assert torch.equal(gen_states[0], gen_states[1]) and torch.equal(gen_states[0], gen_states[2])
    for a, b in zip(graph_side[1], default_adam[1]):
        tol = 1e-5 * float(b.detach().abs().max())
        torch.testing.assert_close(a, b, rtol=0.0, atol=tol)
    torch.testing.assert_close(torch.stack(graph_side[0][0]), torch.stack(default_adam[0][0]), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["envelope", "gpils"])
def test_graph_recaptures_on_replaced_leaves_and_survives_the_target_copy(algo):
    """A parameter whose storage is replaced (update 8) and Adam's state
    loaded from a copy (update 14) each drop the graph and capture it again after
    a new warm-up; the hard target copy (every 5 updates, in place) does not.
    Every side stays bitwise equal to the eager one."""
    _needs_card()

    def hook(i, states, helper):
        if i and i % 5 == 0:
            for ts in states:
                polyak_update(ts.net, ts.target_net, 1.0)
        if i == 8:
            for ts in states:
                p = next(ts.net.parameters())
                p.data = p.data.clone()
        if i == 14:  # new tensors, as a restored checkpoint brings
            for ts in states:
                ts.optimizer.load_state_dict(copy.deepcopy(ts.optimizer.state_dict()))

    helper, out, leaves, gen_states = _updates(algo, UPDATES, hook)
    # captures at update 3, after 8's replacement at 11, after 14's at 17
    assert helper.captures == 3
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        assert torch.equal(a, b)
    for a, b in zip(leaves[0], leaves[1]):
        assert torch.equal(a, b)
    assert torch.equal(gen_states[0], gen_states[1])


@pytest.mark.cuda
def test_graph_recaptures_for_a_new_state():
    _needs_card()
    agent = _agent("gpils", False, "cuda")
    helper, data = GraphedUpdate(), torch.Generator().manual_seed(1)
    for _ in range(2):
        ts = _train_state(agent)
        gen = torch.Generator(agent.device).manual_seed(0)
        for _ in range(graphed.WARMUP + 2):
            helper(agent._update, ts, _batch(agent, data, 16), random_weights(gen, 3, n=16), gen)
        assert helper.warm == graphed.WARMUP and helper.graph is not None
        assert all(g["capturable"] for g in ts.optimizer.param_groups)
    assert helper.captures == 2


@pytest.mark.cuda
@pytest.mark.parametrize("algo,per", CASES)
def test_cuda_train_segment_matches_the_eager_loop(algo, per):
    """The loop with the graph against the loop calling the plain ``_update``
    (with Adam as the graph has it): the whole state bitwise after 12
    iterations (target copies, PER priorities, the generator); every update
    after the capture a replay."""
    _needs_card()
    runs, spans = [], None
    twin = _agent(algo, per, "cuda")
    twin._graphed = _twin
    for agent in (_agent(algo, per, "cuda"), twin):
        state = _state(agent)
        agent.train_segment(state, 4)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            agent.train_segment(state, 8)
        torch.cuda.synchronize()
        spans = spans or [e.name for e in prof.events()]
        runs.append(state_tree(state))
    _assert_same(*runs)
    assert spans.count("learner.graph_replay") == spans.count("learner.update") == 8 * SMALL["gradient_updates"]
    assert "learner.graph_capture" not in spans


@pytest.mark.cuda
def test_capturable_adam_with_float64_steps_is_the_default_adam():
    """Adam made capturable after its first step, its step counts float64 on
    the device (``_make_capturable``), against the default Adam over 20 steps
    from zero parameters: within 1e-6 of each tensor's largest magnitude, where
    float32 step counts put every early update off by about 6e-6."""
    _needs_card()
    shapes, g = [(64, 64), (64,), (6, 3)], torch.Generator().manual_seed(1)
    sides = [[torch.zeros(s, device="cuda", requires_grad=True) for s in shapes] for _ in range(2)]
    opts = [torch.optim.Adam(ps, lr=3e-4, betas=(0.9, 0.999), eps=1e-8) for ps in sides]
    for _ in range(20):
        grads = [torch.randn(s, generator=g).cuda() for s in shapes]
        graphed._make_capturable(opts[0])
        for ps, opt in zip(sides, opts):
            for p, gr in zip(ps, grads):
                p.grad = gr.clone()
            opt.step()
    assert all(st["step"].dtype == torch.float64 and st["step"].is_cuda for st in opts[0].state.values())
    assert opts[0].param_groups[0]["capturable"] and not opts[1].param_groups[0]["capturable"]
    for a, b in zip(*sides):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6 * float(b.detach().abs().max()))
    for p, q in zip(*sides):
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opts[0].state[p][k], opts[1].state[q][k], rtol=0.0, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,per", CASES)
def test_cuda_checkpoint_loads_bitwise_as_saved(algo, per, tmp_path):
    """A state saved after its capture loads into a fresh template as it was
    saved, compared straight away: Adam capturable, its step counts float64 on
    the device (``load_state_dict`` alone would make them float32)."""
    _needs_card()
    agent = _agent(algo, per, "cuda")
    live = _state(agent)
    agent.train_segment(live, 6)
    assert agent._graphed.captures == 1
    agent.save(live, tmp_path / "state.pt")
    restored = agent.load(_state(agent), tmp_path / "state.pt")
    _assert_same(state_tree(live), state_tree(restored))
    opt = restored.ts.optimizer
    assert all(g["capturable"] for g in opt.param_groups)
    assert all(st["step"].dtype == torch.float64 and st["step"].is_cuda for st in opt.state.values())


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["envelope", "gpils"])
def test_cuda_checkpoint_resumes_through_a_new_capture(algo, tmp_path):
    """A state saved mid-run on the card and restored into a fresh template
    continues bitwise as the live state does: the restored state is new, so
    its updates warm up and capture again, and its Adam becomes capturable
    with float64 step counts as the live one is."""
    _needs_card()
    agent = _agent(algo, False, "cuda")
    live = _state(agent)
    agent.train_segment(live, 6)
    agent.save(live, tmp_path / "mid.pt")
    restored = agent.load(_state(agent), tmp_path / "mid.pt")
    _assert_same(state_tree(live), state_tree(restored))
    captures = agent._graphed.captures
    trees = []
    for state in (restored, live):
        agent.train_segment(state, 6)
        trees.append(state_tree(state))
    _assert_same(*trees)
    assert agent._graphed.captures == captures + 2  # the restored state's, then the live one's again
