"""diff.inverse: a step's ``inverse.forward`` span (the two renders under
autograd and the loss) less its ``wavefront.sync`` children (the host's
reads of the live mask, which ``inverse_sync_ms`` reads), ms a step;
averaged over the chips."""

from benchmark.metrics import _inverse, _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _inverse.per_step(
        window, lambda ts: _spans.self_us(ts, "inverse.forward", ("wavefront.sync",)), 1e-3)
