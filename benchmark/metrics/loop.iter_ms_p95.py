"""The 95th percentile (nearest rank) of every actor-learner iteration's interval in the window, by CUDA events:
``iter_ms_p95`` read per layer, in the cells whose runs spread too widely to hold it end to end."""

import math


def read(win):
    if not win.intervals_ms:
        return None
    xs = sorted(win.intervals_ms)
    return xs[math.ceil(0.95 * len(xs)) - 1]
