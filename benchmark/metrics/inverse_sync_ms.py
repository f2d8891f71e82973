"""diff.inverse and integrator.wavefront: the host waiting on device values
a step, the ``inverse.sync`` (the loss) and ``wavefront.sync`` (each
render's live mask before a bounce) spans, ms a step; averaged over the
chips."""

from benchmark.metrics import _inverse

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _inverse.per_step(window, lambda ts: _inverse.total_us(ts, _inverse.SYNCS), 1e-3)
