"""The learner's clip and Adam step (``ops.adam_step.clip_adam_step_``).

On the CPU: the wrapper is bitwise ``clip_grad_global_norm_`` then
``torch.optim.Adam.step`` over several steps, with and without a clip; it
refuses an Adam the kernels do not compute before it looks at the device; the
launch plan adapts its grid to the parameter count; the state the kernels
take is made where Adam holds none, and a count torch made is turned to
float64; Envelope's and GPI-LS's one-seed updates step through it.

On an NVIDIA card (``cuda`` marker; skipped here), over 20 steps from a new
Adam at Envelope's and the pixel Q-net's shapes against the plain path (the
clip, then torch's capturable Adam with float64 step counts from its first
step): parameters, moments and step counts bitwise with no clip, where the
clip does not scale, and where it scales on gradients whose norm every
summation order computes exactly; within 4 float32 ulps of each tensor's
largest magnitude where it scales on Gaussian gradients (the norm's sum runs
in another order); two runs bitwise each other; the same inside a captured
and replayed CUDA graph; 2 launches a step, the first included; a state made
by a default Adam's first step taken over bitwise.  Imports no JAX, so the
card runs it with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from morl_baselines_torch.agents import GPILS, Envelope, EnvelopeConfig, GPILSConfig
from morl_baselines_torch.envs import make
from morl_baselines_torch.models import graphed
from morl_baselines_torch.models.networks import EnvelopeQNet, MemberAdam, clip_grad_global_norm_
from morl_baselines_torch.ops import adam_step
from morl_baselines_torch.ops.adam_step import adam_launch_plan, adam_step_plain, clip_adam_step_
from morl_baselines_torch.replay.buffer import Transition

torch.set_num_threads(1)

STEPS = 20
LR, BETAS, EPS = 3e-4, (0.9, 0.999), 1e-8


def _shapes(net: str) -> list:
    """The parameter shapes of the cells' Q-nets: Envelope's on minecart (10
    tensors, 204,818 parameters), the pixel Q-net (18 tensors, 2,015,400)."""
    if net == "envelope":
        q = EnvelopeQNet(7, 6, 3)
    elif net == "pixel":
        q = EnvelopeQNet(4 * 84 * 84, 4, 2, image_shape=(4, 84, 84))
    else:
        q = EnvelopeQNet(5, 3, 2, hidden=(16, 16))
    return [tuple(p.shape) for p in q.parameters()]


def _params(shapes, device, seed: int = 0) -> list:
    g = torch.Generator().manual_seed(seed)
    return [(0.1 * torch.randn(s, generator=g)).to(device).requires_grad_() for s in shapes]


def _grads(shapes, g: torch.Generator, kind: str) -> list:
    """Gaussian gradients, or ``dyadic`` ones (k / 32, k in -2..2), whose
    squares and their sum over 2M elements are exact in float32 in any order."""
    if kind == "dyadic":
        return [torch.randint(-2, 3, s, generator=g).float() / 32 for s in shapes]
    return [torch.randn(s, generator=g) for s in shapes]


def _run(shapes, device, max_norm, kind: str, step, steps: int = STEPS, grad_seed: int = 1):
    """``steps`` steps of ``step(opt, max_norm)`` from one seed's parameters
    and gradients; returns (params, optimizer)."""
    params = _params(shapes, device)
    opt = torch.optim.Adam(params, lr=LR, betas=BETAS, eps=EPS)
    g = torch.Generator().manual_seed(grad_seed)
    for _ in range(steps):
        for p, gr in zip(params, _grads(shapes, g, kind)):
            p.grad = gr.to(device)
        step(opt, max_norm)
    return params, opt


def _leaves(params, opt) -> list:
    out = []
    for p in params:
        st = opt.state[p]
        out += [p.detach(), st["exp_avg"], st["exp_avg_sq"], st["step"]]
    return out


def _assert_bitwise(a: list, b: list) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y), f"leaf {i}: largest gap {float((x.double() - y.double()).abs().max())!r}"


# ------------------------------------------------------------------ the CPU


def _plain(opt, max_norm):
    """Today's code: the clip where set, then Adam's step."""
    if max_norm is not None:
        clip_grad_global_norm_(opt.param_groups[0]["params"], max_norm)
    opt.step()


@pytest.mark.parametrize("max_norm,kind", [(None, "gauss"), (1.0, "gauss"), (1e6, "gauss"), (0.5, "dyadic")])
def test_cpu_path_is_the_clip_then_adams_step(max_norm, kind):
    """Bitwise over 6 steps: parameters, moments and step counts; no launch."""
    shapes = _shapes("small")
    before = clip_adam_step_.launches
    _assert_bitwise(_leaves(*_run(shapes, "cpu", max_norm, kind, clip_adam_step_, steps=6)),
                    _leaves(*_run(shapes, "cpu", max_norm, kind, _plain, steps=6)))
    assert clip_adam_step_.launches == before


@pytest.mark.parametrize("make_opt", [
    lambda ps: torch.optim.Adam(ps, lr=LR, amsgrad=True),
    lambda ps: torch.optim.Adam(ps, lr=LR, maximize=True),
    lambda ps: torch.optim.Adam(ps, lr=LR, weight_decay=1e-4),
    lambda ps: torch.optim.Adam([{"params": ps[:1]}, {"params": ps[1:]}], lr=LR),
    lambda ps: torch.optim.AdamW(ps, lr=LR),
    lambda ps: MemberAdam(ps, lr=LR),
], ids=["amsgrad", "maximize", "weight_decay", "two_groups", "adamw", "member_adam"])
def test_refuses_what_the_kernels_do_not_compute(make_opt):
    """Raises before the device dispatch and before any step: nothing moves."""
    params = _params(_shapes("small"), "cpu")
    for p in params:
        p.grad = torch.ones_like(p)
    kept = [p.detach().clone() for p in params]
    with pytest.raises((ValueError, TypeError)):
        clip_adam_step_(make_opt(params), 1.0)
    _assert_bitwise([p.detach() for p in params], kept)


@pytest.mark.parametrize("made_by", ["none", "torch"])
def test_device_state_holds_float64_counts(made_by):
    """Where Adam holds no state: zero moments and a float64 count 0 on the
    parameter's device; where torch's default step made it: the same moments,
    the count turned to float64."""
    params = _params(_shapes("small"), "cpu")
    opt = torch.optim.Adam(params, lr=LR)
    if made_by == "torch":
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
    kept = {id(p): {k: v.clone() for k, v in opt.state[p].items()} for p in params}
    for p in params:
        st = adam_step._device_state(opt, p)
        assert st is opt.state[p]
        assert st["step"].dtype == torch.float64 and st["step"].device == p.device and st["step"].dim() == 0
        want = kept[id(p)] or {k: torch.zeros((), dtype=torch.float64) if k == "step" else torch.zeros_like(p)
                               for k in ("step", "exp_avg", "exp_avg_sq")}
        assert float(st["step"]) == float(want["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].dtype == torch.float32 and torch.equal(st[k], want[k])


@pytest.mark.parametrize("total,sms,want", [
    (204_818, 132, (201, 401)),  # Envelope's minecart Q-net
    (2_015_400, 132, (264, 1056)),  # the pixel Q-net: both launches capped at a few waves
    (413_220, 132, (264, 808)),  # GPI-LS's two DroQ critics
    (1, 132, (1, 1)),
])
def test_launch_plan_adapts_to_the_parameter_count(total, sms, want):
    plan = adam_launch_plan(total, sms)
    assert tuple(plan) == want
    assert plan.norm_blocks <= adam_step.NORM_BLOCKS_PER_SM * sms
    assert plan.update_blocks <= adam_step.UPDATE_BLOCKS_PER_SM * sms


def _small_agent(algo: str):
    kw = dict(num_envs=4, buffer_size=64, batch_size=8, hidden=(16, 16), learning_starts=8, seed=0)
    env = make("minecart-v0")
    if algo == "envelope":
        return Envelope(env, EnvelopeConfig(**kw, num_sample_w=2), device="cpu")
    return GPILS(env, GPILSConfig(**kw, max_support=4), device="cpu")


@pytest.mark.parametrize("algo", ["envelope", "gpils"])
def test_one_seed_updates_step_through_the_wrapper(algo, monkeypatch):
    """Envelope's and GPI-LS's ``_update`` call ``clip_adam_step_`` once, with
    the config's clip (GPI-LS: none), on the state's optimizer."""
    agent = _small_agent(algo)
    module = __import__(f"morl_baselines_torch.agents.{algo}", fromlist=["clip_adam_step_"])
    calls = []

    def spy(opt, max_norm):
        calls.append((opt, max_norm))
        adam_step_plain(opt, max_norm)

    monkeypatch.setattr(module, "clip_adam_step_", spy)
    ts = agent.make_train_state(agent.make_q_net(torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(2)
    batch = Transition(torch.randn(8, agent.obs_dim, generator=g), torch.randint(0, 6, (8,), generator=g),
                       torch.randn(8, 3, generator=g), torch.randn(8, agent.obs_dim, generator=g),
                       torch.zeros(8))
    w = torch.full((2 if algo == "envelope" else 8, 3), 1 / 3)
    args = (w, 0.5) if algo == "envelope" else (w[:8], torch.Generator().manual_seed(3))
    agent._update(ts, batch, *args)
    assert calls == [(ts.optimizer, agent.cfg.max_grad_norm)]


# ------------------------------------------------------------------ the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _kernel(opt, max_norm):
    """The step as the loops take it on the card, from a new Adam on."""
    clip_adam_step_(opt, max_norm)


def _reference(opt, max_norm):
    """The clip, then torch's capturable Adam with float64 counts, its state
    made by hand where it holds none (as torch makes it, but the counts float64)."""
    for p in opt.param_groups[0]["params"]:
        if not opt.state[p]:
            opt.state[p].update(step=torch.zeros((), dtype=torch.float64, device=p.device),
                                exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
    opt.param_groups[0]["capturable"] = True
    adam_step_plain(opt, max_norm)


def _ulps_at_scale(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in float32 ulps of b's largest magnitude."""
    if a.dtype != torch.float32:
        return 0.0 if torch.equal(a, b) else float("inf")
    top = float(b.abs().max())
    ulp = float(np.spacing(np.float32(top))) if top > 0 else float(np.finfo(np.float32).tiny)
    return float((a.double() - b.double()).abs().max()) / ulp


CASES = [(None, "gauss"), (1e6, "gauss"), (1.0, "dyadic")]  # no clip; a clip that never scales; one that always does


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["envelope", "pixel"])
@pytest.mark.parametrize("max_norm,kind", CASES, ids=["noclip", "unscaled", "scaled_exact_norm"])
def test_kernel_is_bitwise_the_capturable_adam(net, max_norm, kind):
    """20 steps from a new Adam: parameters, moments and float64 step counts
    bitwise the plain path's; 2 launches a step, the first (which makes Adam's
    state) included; the group left capturable."""
    _needs_card()
    shapes = _shapes(net)
    before = clip_adam_step_.launches
    params, opt = _run(shapes, "cuda", max_norm, kind, _kernel)
    got = _leaves(params, opt)
    assert clip_adam_step_.launches - before == 2 * STEPS
    assert opt.param_groups[0]["capturable"]
    want = _leaves(*_run(shapes, "cuda", max_norm, kind, _reference))
    torch.cuda.synchronize()
    _assert_bitwise(got, want)
    assert all(x.dtype == torch.float64 and float(x) == STEPS for x in got[3::4])


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["envelope", "pixel"])
def test_kernel_where_the_clip_scales(net):
    """Gaussian gradients, max_norm 1 (every step scales): within 4 float32
    ulps of each tensor's largest magnitude of the plain path, the step counts
    equal; two runs bitwise each other."""
    _needs_card()
    shapes = _shapes(net)
    runs = [_leaves(*_run(shapes, "cuda", 1.0, "gauss", _kernel)) for _ in range(2)]
    want = _leaves(*_run(shapes, "cuda", 1.0, "gauss", _reference))
    torch.cuda.synchronize()
    _assert_bitwise(runs[0], runs[1])
    gaps = [_ulps_at_scale(a, b) for a, b in zip(runs[0], want)]
    print(f"[{net}] largest gap where the clip scales: {max(gaps):.3f} ulps at scale")
    assert max(gaps) <= 4.0, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("max_norm,kind", [(1.0, "gauss"), (1e6, "gauss"), (None, "gauss")],
                         ids=["scaled", "unscaled", "noclip"])
def test_kernel_inside_a_replayed_graph(max_norm, kind):
    """Envelope's shapes: 3 eager steps, a capture of the step, 17 replays
    with new gradients copied into the static ones; bitwise the eager kernel
    steps (and, where the clip does not scale, the plain path); the capture
    counts 2 launches, a replay none."""
    _needs_card()
    shapes = _shapes("envelope")
    eager = _leaves(*_run(shapes, "cuda", max_norm, kind, _kernel))
    params = _params(shapes, "cuda")
    opt = torch.optim.Adam(params, lr=LR, betas=BETAS, eps=EPS)
    g = torch.Generator().manual_seed(1)
    static = None
    for i in range(STEPS):
        grads = [gr.cuda() for gr in _grads(shapes, g, kind)]
        if i < 3:
            for p, gr in zip(params, grads):
                p.grad = gr
            _kernel(opt, max_norm)
            continue
        if static is None:
            static = [gr.clone() for gr in grads]
            for p, s in zip(params, static):
                p.grad = s
            graph = torch.cuda.CUDAGraph()
            before = clip_adam_step_.launches
            with torch.cuda.graph(graph):
                clip_adam_step_(opt, max_norm)
            assert clip_adam_step_.launches - before == 2
            before = clip_adam_step_.launches
        for s, gr in zip(static, grads):
            s.copy_(gr)
        graph.replay()
    torch.cuda.synchronize()
    assert clip_adam_step_.launches == before
    _assert_bitwise(_leaves(params, opt), eager)
    if max_norm != 1.0:
        _assert_bitwise(_leaves(params, opt), _leaves(*_run(shapes, "cuda", max_norm, kind, _reference)))


@pytest.mark.cuda
def test_kernel_refuses_tensors_it_does_not_take():
    """More tensors than the table holds, float64 parameters and a missing
    gradient raise on a new Adam, before any state is made or launch made."""
    _needs_card()
    for shapes, dtype, grad, match in (([(3,)] * (adam_step.MAX_TENSORS + 1), torch.float32, True, "at most"),
                                       (_shapes("small"), torch.float64, True, "float32"),
                                       (_shapes("small"), torch.float32, False, "float32")):
        params = [p.to(dtype).detach().requires_grad_() for p in _params(shapes, "cuda")]
        opt = torch.optim.Adam(params, lr=LR)
        for p in params:
            p.grad = torch.ones_like(p) if grad else None
        before = clip_adam_step_.launches
        with pytest.raises(ValueError, match=match):
            clip_adam_step_(opt, 1.0)
        assert clip_adam_step_.launches == before and not opt.state


@pytest.mark.cuda
def test_kernel_takes_over_a_state_torch_made():
    """After a default Adam's first step (its counts float32 on the host),
    3 kernel steps are bitwise ``_make_capturable`` then torch's step."""
    _needs_card()
    sides = [_params(_shapes("small"), "cuda") for _ in range(2)]
    opts = [torch.optim.Adam(ps, lr=LR, betas=BETAS, eps=EPS) for ps in sides]
    g = torch.Generator().manual_seed(4)
    for i in range(4):
        grads = [gr.cuda() for gr in _grads(_shapes("small"), g, "gauss")]
        for ps in sides:
            for p, gr in zip(ps, grads):
                p.grad = gr.clone()
        if i == 0:
            for opt in opts:
                opt.step()
            continue
        _kernel(opts[0], None)
        graphed._make_capturable(opts[1])
        adam_step_plain(opts[1], None)
    torch.cuda.synchronize()
    _assert_bitwise(_leaves(sides[0], opts[0]), _leaves(sides[1], opts[1]))
