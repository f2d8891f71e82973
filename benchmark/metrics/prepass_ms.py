"""integrator.regen.primary_prepass: its own time a launch, its context and
captures left out (regen.prepass spans); averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"

#: Child spans whose time other metrics read.
CHILDREN = ("regen.context", "graph.capture")


def read(window):
    return _spans.per_launch(window,
                             lambda ts: _spans.self_us(ts, "regen.prepass", CHILDREN), 1e-3)
