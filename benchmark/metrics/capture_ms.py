"""integrator.graph.GraphedLoop: captures and instantiations a launch
(graph.capture spans); averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _spans.per_launch(window, lambda ts: _spans.total_us(ts, "graph.capture"), 1e-3)
