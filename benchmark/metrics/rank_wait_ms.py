"""parallel.sharded.make_regen_sharded: a rank's count all_reduce and host
reads a launch, its wait for the slowest rank (parallel.reduce spans);
averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _spans.per_launch(window, lambda ts: _spans.total_us(ts, "parallel.reduce"), 1e-3)
