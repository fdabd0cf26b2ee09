"""The least time of the stretch's needed trunk work (the NatureCNN's convolutions and its dense layer, forward
and backward) over all device time in the stretch, in percent.

Each operation's least time is the larger of its operations over the float32 peak and its bytes over the peak
bandwidth (``peaks.json``), with every tensor read or written once at its true size: a convolution of N frames
moves 4·(N·Cin·H·W + Cout·Cin·kh·kw + N·Cout·Ho·Wo) bytes, forward and in each gradient.  The operations and
bytes are the ``trunk`` list that the cell's ``algos/<algorithm>.py::gemms`` returns beside its GEMMs."""


def read(win):
    s = win.stretch
    ops = getattr(win.gemms, "trunk", None)
    if s is None or not s.device_ops or not ops:
        return None
    flops, bw = win.peaks["fp32_flops"], win.peaks["hbm_bytes_per_s"]
    least = sum(max(f / flops, b / bw) for f, b in ops)
    return 100.0 * least * s.iters / s.kernel_s
