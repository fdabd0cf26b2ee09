"""Mean host milliseconds of the program's ``env.step`` span (``VectorMOEnv.step``) over the profiled stretch."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    spans = [e - b for name, b, e in s.host_ops if name == "env.step"]
    return 1e3 * sum(spans) / len(spans) if spans else None
