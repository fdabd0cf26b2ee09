"""Host milliseconds an iteration inside the program's ``actor`` spans (act, env step, store) over the profiled stretch."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    spans = [e - b for name, b, e in s.host_ops if name == "actor"]
    return 1e3 * sum(spans) / s.iters if spans else None
