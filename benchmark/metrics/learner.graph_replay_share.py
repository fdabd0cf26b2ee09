"""The program's ``learner.graph_replay`` spans (an update run as one CUDA graph replay) over its ``learner.update`` spans in the profiled stretch, in percent."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops:
        return None
    updates = sum(1 for name, _, _ in s.host_ops if name == "learner.update")
    replays = sum(1 for name, _, _ in s.host_ops if name == "learner.graph_replay")
    return 100.0 * replays / updates if replays and updates else None
