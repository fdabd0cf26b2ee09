"""Reduction of a ``torch.profiler`` trace of a stretch of iterations.

The stretch runs inside one ``record_function`` range, which gives the window
in the trace's own clock.  Device operations are every event on the device
timeline that is not a user annotation: kernels, copies and fills."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

RANGE = "benchmark.stretch"


@dataclass
class Stretch:
    iters: int
    window_s: float  # the range's length
    device_ops: list = field(default_factory=list)  # (name, start_s, dur_s), sorted by start
    host_ops: list = field(default_factory=list)  # (name, start_s, end_s), sorted by start

    @property
    def kernel_s(self) -> float:
        """Device time summed over operations."""
        return sum(d for _, _, d in self.device_ops)

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the window."""
        out = []
        for _, s, d in self.device_ops:
            e = min(s + d, self.window_s)
            s = max(s, 0.0)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_device_ops(self, k: int = 10) -> list:
        total = defaultdict(float)
        for name, _, d in self.device_ops:
            total[name[:120]] += d
        return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time, summed by the innermost host operation running at
        each gap's midpoint ("python" where none is)."""
        starts = [s for _, s, _ in self.host_ops]
        total = defaultdict(float)
        edge = 0.0
        for s, e in self.busy_intervals() + [[self.window_s, self.window_s]]:
            if s > edge:
                mid, name = (edge + s) / 2, "python"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 256, -1), -1):
                    if self.host_ops[j][2] >= mid:
                        name = self.host_ops[j][0]
                        break
                total[name[:120]] += s - edge
            edge = max(edge, e)
        return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:k]


def reduce(events, iters: int) -> Stretch | None:
    """A ``Stretch`` from ``prof.events()``; None when the trace holds no range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name == RANGE and e.device_type != cuda]
    if not spans:
        return None
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end  # microseconds
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == RANGE:
            continue
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, (s - t0) / 1e6, (t - s) / 1e6))
        elif t0 <= s <= t1:
            host.append((e.name, (s - t0) / 1e6, (t - t0) / 1e6))
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Stretch(iters=iters, window_s=(t1 - t0) / 1e6, device_ops=dev, host_ops=host)
