"""The union of the device operations' intervals over the profiled stretch's wall time, in percent."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops or s.window_s <= 0:
        return None
    return 100.0 * s.busy_s / s.window_s
