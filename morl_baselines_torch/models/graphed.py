"""One learner update as a CUDA graph, captured once for a training state and
replayed for every later update.

An update of the Envelope or GPI-LS loop (target, forward, backward, then
the clip and Adam as the two kernels of ``ops/adam_step.py``) is about 140
small kernels, each a few microseconds of device work behind a launch of
20-30 µs made from Python.  ``GraphedUpdate`` wraps an
agent's ``_update(ts, *args)`` so that every kernel of it is launched by one
``CUDAGraph.replay``:

- it engages on a one-seed ``TrainState`` whose optimizer is a
  ``torch.optim.Adam`` over CUDA parameters; every other call (the CPU, the
  seed-stacked ``MemberAdam``) is the plain ``update(ts, *args)``;
- the first ``WARMUP`` updates of a state run eagerly on a side stream: real
  updates on their real batches.  Adam is ``capturable``, with its step
  counts on the device in float64: the agents' step (``ops/adam_step.py``)
  makes a new state so, and ``_make_capturable`` turns a state made as Adam
  is made (a default Adam's first step, a loaded checkpoint) into it;
- the next update is captured (capture runs nothing) and replayed, and every
  later update copies its inputs into the graph's static tensors and replays.
  A tensor argument is copied, a ``Transition``'s five too; a number (the
  homotopy λ) is filled into a 0-d float64 tensor, so the graph reads this
  update's value; a ``torch.Generator`` (GPI-LS's dropout masks) is registered
  with the graph, and each replay advances its offset by what the eager
  update draws, so every later draw sees the stream the eager loop sees;
- the graph is dropped and captured again (after a new warm-up) when the
  state, the inputs' shapes and dtypes, or any tensor the graph reads or
  writes in place changes: a parameter, its ``.grad``, an Adam state tensor,
  a buffer, a target-net leaf replaced rather than written (a loaded optimizer
  state, a restored checkpoint), or Adam's hyperparameters.  The target copy
  (``polyak_update``) writes in place, so the graph stays valid across it.

The outputs of a replay are the graph's static tensors, overwritten by the
next replay; the first (the loss, which the state keeps) is copied.  Warm-ups
and captures run inside a ``learner.graph_capture`` span, replays inside a
``learner.graph_replay`` span.
"""

from __future__ import annotations

import weakref

import torch

from ..replay.buffer import Transition
from ..utils.profiling import span

WARMUP = 3  # eager updates of a state before its capture


def engages(ts) -> bool:
    """True where the update runs as a graph: a ``torch.optim.Adam`` over CUDA parameters."""
    opt = getattr(ts, "optimizer", None)
    return type(opt) is torch.optim.Adam and opt.param_groups[0]["params"][0].is_cuda


def _make_capturable(opt: torch.optim.Adam) -> None:
    """Adam with its step counts on the device, so a graph can advance them,
    in float64.  A capturable Adam computes its bias corrections on the device
    in the counts' dtype, and makes them float32: there float32(0.999) puts
    1 - β2**t off by 1.3e-5 and every early update off by 6e-6, where the host's
    float64 bias corrections of the default Adam are exact.  So an Adam that
    holds no state stays as made until its first step has made the counts."""
    if not opt.state:
        return
    for group in opt.param_groups:
        group["capturable"] = True
    for p, st in opt.state.items():
        step = st.get("step")
        if isinstance(step, torch.Tensor) and (step.device != p.device or step.dtype != torch.float64):
            st["step"] = step.to(device=p.device, dtype=torch.float64)


def _tensors(ts) -> tuple[list, list]:
    """The online net's parameters, and the other tensors a captured update
    reads in place: the online net's buffers, the target net's leaves."""
    fixed = list(ts.net.buffers()) + list(ts.target_net.parameters()) + list(ts.target_net.buffers())
    return list(ts.net.parameters()), fixed


def _signature(args) -> tuple:
    """The shapes and dtypes of the tensor inputs, the generators' identity."""
    out = []
    for a in args:
        if isinstance(a, Transition):
            out.append(tuple((tuple(x.shape), x.dtype) for x in a))
        elif isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), a.dtype))
        elif isinstance(a, torch.Generator):
            out.append(a)
        elif isinstance(a, (int, float)):
            out.append(float)
        else:
            raise TypeError(f"a graphed update takes tensors, Transitions, numbers and generators, not {type(a).__name__}")
    return tuple(out)


def _static(a, device):
    """A static input of the graph shaped as ``a``; ``_fill`` gives it ``a``'s value."""
    if isinstance(a, Transition):
        return Transition(*(torch.empty_like(x) for x in a))
    if isinstance(a, torch.Tensor):
        return torch.empty_like(a)
    if isinstance(a, (int, float)):
        return torch.empty((), dtype=torch.float64, device=device)
    return a  # a generator, registered with the graph


def _fill(static, a) -> None:
    """``a``'s value into its static input."""
    if isinstance(a, Transition):
        for s, x in zip(static, a):
            s.copy_(x)
    elif isinstance(a, torch.Tensor):
        static.copy_(a)
    elif isinstance(a, (int, float)):
        static.fill_(a)


class GraphedUpdate:
    """``update(ts, *args)`` as a replayed CUDA graph where it ``engages``; see the module."""

    def __init__(self):
        self.captures = 0  # graphs captured over this object's life
        self._reset(None, None)

    def _reset(self, ts, signature) -> None:
        self.graph = None
        self._ts = None if ts is None else weakref.ref(ts)
        self._signature = signature
        self._bound = self._params = self._fixed = None
        self._inputs = self._outputs = None
        self.warm = 0

    def _binding(self, ts) -> tuple:
        """The objects of the state and the addresses of every tensor the graph
        reads or writes (parameters, ``.grad``, Adam's state, buffers, the
        target's leaves), and Adam's hyperparameters: equal while the graph is
        valid.  The parameter lists are those of the capture, so a call walks
        no module."""
        opt, ptrs = ts.optimizer, []
        for p in self._params:
            g = p.grad
            ptrs += [p.data_ptr(), 0 if g is None else g.data_ptr()]
            ptrs += [v.data_ptr() for v in opt.state.get(p, {}).values() if isinstance(v, torch.Tensor)]
        ptrs += [t.data_ptr() for t in self._fixed]
        hyper = [(k, v) for g in opt.param_groups for k, v in g.items() if k != "params"]
        return (id(ts.net), id(ts.target_net), id(opt)), ptrs, hyper

    def __call__(self, update, ts, *args):
        if not engages(ts):
            return update(ts, *args)
        sig = _signature(args)
        same = self._ts is not None and self._ts() is ts and sig == self._signature
        if self.graph is not None and same and self._binding(ts) == self._bound:
            with span("learner.graph_replay"):
                return self._replay(args)
        if not same or self.graph is not None:
            self._reset(ts, sig)
        with span("learner.graph_capture"):
            if self.warm < WARMUP:
                self.warm += 1
                return self._warm_up(update, ts, args)
            self._capture(update, ts, args)
        with span("learner.graph_replay"):
            return self._replay(args)

    def _warm_up(self, update, ts, args):
        """One eager update on a side stream, as a capture needs its lazy state made outside it."""
        _make_capturable(ts.optimizer)
        dev = ts.optimizer.param_groups[0]["params"][0].device
        side, main = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = update(ts, *args)
        main.wait_stream(side)
        return out

    def _capture(self, update, ts, args) -> None:
        _make_capturable(ts.optimizer)
        dev = ts.optimizer.param_groups[0]["params"][0].device
        self._inputs = tuple(_static(a, dev) for a in args)
        graph = torch.cuda.CUDAGraph()
        for a in args:
            if isinstance(a, torch.Generator):
                graph.register_generator_state(a)
        ts.optimizer.zero_grad(set_to_none=True)  # the backward makes .grad in the graph's memory
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._outputs = update(ts, *self._inputs)
        self._params, self._fixed = _tensors(ts)
        self.graph, self._bound = graph, self._binding(ts)
        self.captures += 1

    def _replay(self, args):
        for static, a in zip(self._inputs, args):
            _fill(static, a)
        self.graph.replay()
        loss, *rest = self._outputs
        return (loss.clone(), *rest)
