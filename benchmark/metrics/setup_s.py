"""Process start to the window's start: imports, CUDA, the kernel library,
the scene, the warm launch and its captures."""

UNIT, BETTER = "s", "lower"


def read(window):
    return window.setup_s
