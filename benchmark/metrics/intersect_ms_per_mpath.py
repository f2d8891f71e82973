"""``ops.intersect``: device time of K1, K2, K4 and K5, ms per million
paths."""

from benchmark.metrics import _kernels

UNIT, BETTER, MOVES = "ms/Mpath", "lower", "paths_per_s"


def read(window):
    return _kernels.ms_per_mpath(window, _kernels.INTERSECT)
