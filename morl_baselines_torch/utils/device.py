"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on; raises rather than falling back to the CPU.

    Entry points default to ``"cuda"``; tests pass ``"cpu"`` explicitly.  On a
    CUDA device this also turns TF32 off for matmuls and convolutions, so the
    float32 Q-net runs in full float32, as the reference does.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
