"""The Q-net operations the window's iterations need over the window's wall time, as a share of the float32 peak, in percent."""


def read(win):
    if not win.gemms or win.wall_s <= 0:
        return None
    flops = sum(2.0 * m * k * n for m, k, n in win.gemms)
    return 100.0 * flops * win.iters / (win.wall_s * win.peaks["fp32_flops"])
