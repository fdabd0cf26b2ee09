"""Mean host milliseconds of the program's ``qnet.trunk`` span (``NatureCNN.forward``) over the profiled stretch.
A replayed CUDA graph opens no span, so on the card these are the act's trunks."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    spans = [e - b for name, b, e in s.host_ops if name == "qnet.trunk"]
    return 1e3 * sum(spans) / len(spans) if spans else None
