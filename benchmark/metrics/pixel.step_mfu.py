"""The Q-net operations the window's iterations need (the trunk's convolutions as implicit GEMMs, its dense layer
and the head) over the window's wall time, as a share of the float32 peak, in percent: ``step_mfu``'s reading
for the pixel cell."""


def read(win):
    if not win.gemms or win.wall_s <= 0:
        return None
    flops = sum(2.0 * m * k * n for m, k, n in win.gemms)
    return 100.0 * flops * win.iters / (win.wall_s * win.peaks["fp32_flops"])
