"""Mean host milliseconds of the program's ``learner.update`` span (weights drawn, target, forward, backward, clip, Adam) over the profiled stretch."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    spans = [e - b for name, b, e in s.host_ops if name == "learner.update"]
    return 1e3 * sum(spans) / len(spans) if spans else None
