"""Profiling: ``torch.profiler`` traces and host-side phase timing.

PyTorch port of ``morl_baselines_tpu/utils/profiling.py``.  ``trace`` wraps
``torch.profiler.profile`` (CPU and CUDA activity) around any training
segment and exports a Chrome trace into ``logdir``; ``PhaseTimer`` sums
wall-clock time per named learner phase (collect / update / eval / outer)
between segments, under the same metric keys as the JAX package's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


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
