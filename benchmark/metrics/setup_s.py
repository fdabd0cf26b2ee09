"""Process start to the window's opening: imports, the CUDA context, the state, the warm-up iterations."""


def read(win):
    return win.setup_s
