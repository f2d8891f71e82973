"""integrator.regen.render_regen: the loop's own time a launch, its context and
captures left out (regen.loop spans); averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"

#: Child spans whose time other metrics read.
CHILDREN = ("regen.context", "graph.capture")


def read(window):
    return _spans.per_launch(window,
                             lambda ts: _spans.self_us(ts, "regen.loop", CHILDREN), 1e-3)
