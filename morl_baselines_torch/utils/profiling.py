"""Profiling: ``torch.profiler`` traces, the loop's spans and host-side phase timing.

PyTorch port of ``morl_baselines_tpu/utils/profiling.py``.  ``trace`` wraps
``torch.profiler.profile`` (CPU and CUDA activity) around any training
segment and exports a Chrome trace into ``logdir``; ``span`` names a stretch
of the program as a profiler range (``actor``, ``env.step``, ``replay.add``,
``learner.update``, ...) while a profiler records, and costs one flag read
otherwise; ``PhaseTimer`` sums wall-clock time per named learner phase
(collect / update / eval / outer) between segments, under the same metric
keys as the JAX package's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is recording, else a shared no-op.

    The gate reads the C++ profiler state, which ``torch.profiler.profile``,
    ``torch.autograd.profiler.profile`` and ``emit_nvtx`` all set; a range is
    on the same clock as the device activity of a trace and adds no device
    work and no synchronise."""
    return record_function(name) if torch._C._autograd._profiler_enabled() else _OFF


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator["torch.profiler.profile"]:
    """Profile the block, the card's activity too where CUDA is available,
    and write ``logdir/trace.json`` (chrome://tracing, Perfetto).

    >>> with trace("/tmp/torch-trace"):
    ...     agent.train_segment(state, 100)
    ...     torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


class PhaseTimer:
    """Sum wall-clock time per named phase; report once per log interval.

    A phase must bracket *completed* device work: end it with
    ``torch.cuda.synchronize()`` (or time whole launch-and-wait segments),
    since CUDA calls return before the device has finished.
    """

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def metrics(self, prefix: str = "profile/") -> Dict[str, float]:
        """``{prefix}{name}_s`` totals and ``{prefix}{name}_calls`` counts; resets the timer."""
        out = {}
        for name, total in self._total.items():
            out[f"{prefix}{name}_s"] = total
            out[f"{prefix}{name}_calls"] = self._count[name]
        self._total.clear()
        self._count.clear()
        return out
