"""Env transitions completed in the window over the window's wall time, opening synchronise to closing synchronise."""


def read(win):
    return win.iters * win.num_envs / win.wall_s
