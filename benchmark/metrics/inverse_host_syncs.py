"""diff.inverse and integrator.wavefront: host reads of device values a
step, the count of ``inverse.sync`` and ``wavefront.sync`` spans; averaged
over the chips."""

from benchmark.metrics import _inverse

UNIT, BETTER, MOVES = "calls", "lower", "paths_per_s"


def read(window):
    return _inverse.per_step(window, lambda ts: _inverse.count(ts, _inverse.SYNCS))
