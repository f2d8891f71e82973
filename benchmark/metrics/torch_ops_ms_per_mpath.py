"""Shading in ``integrator.regen`` / ``integrator.wavefront``: device time
of every kernel that is not one of the port's K1-K6 (torch's elementwise
kernels inside the graph replays), ms per million paths."""

from benchmark.metrics import _kernels

UNIT, BETTER, MOVES = "ms/Mpath", "lower", "paths_per_s"


def read(window):
    return _kernels.ms_per_mpath(window, _kernels.PORT, invert=True)
