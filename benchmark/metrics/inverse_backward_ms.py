"""diff.inverse: a step's ``inverse.backward`` span (``loss.backward()``
through the two renders), ms a step; averaged over the chips."""

from benchmark.metrics import _inverse

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _inverse.per_step(window, lambda ts: _inverse.total_us(ts, ("inverse.backward",)),
                             1e-3)
