"""Device operations (kernels, copies, fills) launched per iteration over the profiled stretch."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    return len(s.device_ops) / s.iters
