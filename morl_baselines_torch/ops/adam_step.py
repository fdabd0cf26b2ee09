"""The learner's clip and Adam step: hand-written CUDA kernel pair, its plain version, dispatch.

``clip_adam_step_(optimizer, max_norm)`` is the step that ends Envelope's and
GPI-LS's one-seed update: ``clip_grad_global_norm_`` (optax's
``clip_by_global_norm``) when ``max_norm`` is set, then ``optimizer.step()``.
On the card it is two launches of ``csrc/adam_step.cu`` in place of about 80
library launches (10 per-tensor sums of squares and 10 scalings for the clip;
torch's capturable foreach Adam, whose two float32-by-float64 divisions fall to
a per-tensor loop).  The kernel replaces no TPU kernel: the JAX package leaves
the step to XLA.  Its bound is bytes: 32 a parameter (g, p, m, v read, p, m, v
written, g read once more for the norm), 6.6 MB for Envelope's 204,818
parameters, 64 MB for the pixel Q-net's 2,015,400.

It reproduces torch's capturable Adam with float64 step counts
(``models/graphed.py::_make_capturable``) bitwise where the clip does not
scale; where it scales, the factor differs from the plain path's by the order
of the norm's float32 sum alone.  The ``.grad`` tensors are read and left
unscaled; nothing reads them after the step.

A CPU optimizer takes the plain path, bitwise as before.  A CUDA optimizer
takes the kernels from its first step: where Adam holds no state yet, the
wrapper makes it as torch's capturable Adam would, but with float64 counts
(zero moments, a 0-d float64 ``step`` on the parameter's device), turns a
count it finds in another dtype or on another device into that (as
``models/graphed.py::_make_capturable`` does), and marks the group
capturable, so torch's own step would take the same state.  Anything else the
kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.networks import clip_grad_global_norm_
from . import _build

MAX_TENSORS = 32  # csrc/adam_step.cu: MAX_TENSORS
THREADS = 256  # csrc/adam_step.cu: THREADS
NORM_ITEMS = 4  # elements a thread of the norm pass aims for
UPDATE_ITEMS = 2  # elements a thread of the update aims for
NORM_BLOCKS_PER_SM = 2
UPDATE_BLOCKS_PER_SM = 8  # a full SM at 256 threads a block


class _Entry(ctypes.Structure):
    """csrc/adam_step.cu: Entry."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("step", ctypes.c_void_p), ("offset", ctypes.c_longlong), ("n", ctypes.c_longlong)]


class AdamPlan(NamedTuple):
    norm_blocks: int  # blocks of the norm pass, each one float32 partial
    update_blocks: int


@functools.lru_cache(maxsize=64)
def adam_launch_plan(total: int, sm_count: int) -> AdamPlan:
    """Blocks of each launch for ``total`` parameters: enough that each thread
    takes a few elements, at most a couple of waves of the card."""
    norm = min(-(-total // (THREADS * NORM_ITEMS)), NORM_BLOCKS_PER_SM * sm_count)
    update = min(-(-total // (THREADS * UPDATE_ITEMS)), UPDATE_BLOCKS_PER_SM * sm_count)
    return AdamPlan(max(norm, 1), max(update, 1))


def _check(optimizer) -> dict:
    """The group's hyperparameters; raises on what the kernels do not compute."""
    if type(optimizer) is not torch.optim.Adam:
        raise TypeError(f"clip_adam_step_ takes a torch.optim.Adam, got {type(optimizer).__name__}")
    if len(optimizer.param_groups) != 1:
        raise ValueError(f"clip_adam_step_ takes one parameter group, got {len(optimizer.param_groups)}")
    group = optimizer.param_groups[0]
    for key in ("amsgrad", "maximize", "differentiable"):
        if group.get(key):
            raise ValueError(f"clip_adam_step_ does not compute Adam with {key}=True")
    if group["weight_decay"] != 0:
        raise ValueError(f"clip_adam_step_ does not compute Adam with weight_decay={group['weight_decay']}")
    if group.get("fused"):
        raise ValueError("clip_adam_step_ does not take a fused Adam")
    return group


def adam_step_plain(optimizer: torch.optim.Adam, max_norm: float | None) -> None:
    """The kernels' function in plain torch: the clip, then torch's Adam step."""
    if max_norm is not None:
        clip_grad_global_norm_(optimizer.param_groups[0]["params"], max_norm)
    optimizer.step()


@torch.no_grad()
def clip_adam_step_(optimizer: torch.optim.Adam, max_norm: float | None) -> None:
    """``clip_grad_global_norm_`` (when ``max_norm`` is not None), then Adam's
    step, in place.  CPU parameters take the plain path; CUDA parameters the
    two kernels, from the first step.  Each kernel launch adds one to
    ``clip_adam_step_.launches``."""
    group = _check(optimizer)
    if group["params"][0].is_cuda:
        clip_adam_step_cuda(optimizer, max_norm)
    else:
        adam_step_plain(optimizer, max_norm)


def _device_state(optimizer: torch.optim.Adam, p: torch.Tensor) -> dict:
    """Adam's state of ``p`` with its count a float64 tensor on ``p``'s device;
    made (zero moments, count 0) where Adam holds none."""
    st = optimizer.state[p]
    if not st:
        st["step"] = torch.zeros((), dtype=torch.float64, device=p.device)
        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    elif st["step"].dtype != torch.float64 or st["step"].device != p.device:
        st["step"] = st["step"].to(device=p.device, dtype=torch.float64)
    return st


def clip_adam_step_cuda(optimizer: torch.optim.Adam, max_norm: float | None) -> None:
    """Launch the two kernels on the current stream, making Adam's state where
    it holds none; raises on tensors they do not take."""
    group = optimizer.param_groups[0]
    params = group["params"]
    if len(params) > MAX_TENSORS:
        raise ValueError(f"the kernels take at most {MAX_TENSORS} tensors, got {len(params)}")
    if isinstance(group["lr"], torch.Tensor) or any(isinstance(b, torch.Tensor) for b in group["betas"]):
        raise ValueError("the kernels take lr and betas as floats")
    if max_norm is not None and max_norm < 0:
        raise ValueError(f"max_norm must be >= 0, got {max_norm}")
    device = params[0].device
    for p in params:
        for t in (p, p.grad):
            if t is None or t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("the kernels take contiguous float32 parameters and grads on one device")
    group["capturable"] = True  # the counts live on the device: torch's own step would read them there
    entries, offset = (_Entry * len(params))(), 0
    for i, p in enumerate(params):
        st = _device_state(optimizer, p)
        for t in (st["exp_avg"], st["exp_avg_sq"]):
            if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("the kernels take contiguous float32 moments on the parameters' device")
        entries[i] = _Entry(p.data_ptr(), p.grad.data_ptr(), st["exp_avg"].data_ptr(), st["exp_avg_sq"].data_ptr(),
                            st["step"].data_ptr(), offset, p.numel())
        offset += p.numel()
    index = device.index if device.index is not None else torch.cuda.current_device()
    plan = adam_launch_plan(offset, _sm_count(index))
    partials = torch.empty(plan.norm_blocks, dtype=torch.float32, device=device) if max_norm is not None else None
    beta1, beta2 = group["betas"]
    err = _lib().adam_step_launch(
        ctypes.addressof(entries), len(params), offset, None if partials is None else partials.data_ptr(),
        plan.norm_blocks, plan.update_blocks, float(group["lr"]), float(beta1), float(beta2), float(group["eps"]),
        -1.0 if max_norm is None else float(max_norm), index, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"adam_step kernel launch failed: cudaError {err}")
    clip_adam_step_.launches += 2


clip_adam_step_.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("adam_step")
    if lib.adam_step_launch.argtypes is None:
        lib.adam_step_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_double] * 5, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.adam_step_launch.restype = ctypes.c_int
    return lib
