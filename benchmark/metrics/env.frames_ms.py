"""Host milliseconds of the program's ``env.frames`` spans (renders, the max of the last two frames, the resize,
the grayscale, the frame-stack shift) per ``env.step`` span over the profiled stretch."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    steps = sum(1 for name, _, _ in s.host_ops if name == "env.step")
    frames = [e - b for name, b, e in s.host_ops if name == "env.frames"]
    return 1e3 * sum(frames) / steps if steps and frames else None
