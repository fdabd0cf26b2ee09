"""The least time of the stretch's Q-net GEMMs over all device time in the stretch, in percent.

A GEMM (m, k, n) needs 2·m·k·n float32 operations and reads m·k + k·n and writes
m·n floats once; its least time is the larger of the operations over the peak
rate and the bytes over the peak bandwidth (``peaks.json``)."""


def read(win):
    s = win.stretch
    if s is None or not s.device_ops or not win.gemms:
        return None
    flops, bw = win.peaks["fp32_flops"], win.peaks["hbm_bytes_per_s"]
    least = sum(max(2.0 * m * k * n / flops, 4.0 * (m * k + k * n + m * n) / bw) for m, k, n in win.gemms)
    return 100.0 * least * s.iters / s.kernel_s
