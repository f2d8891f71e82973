"""host reads of device values a launch: loop conditions, prepass predicates,
counts (regen.sync spans); averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "calls", "lower", "paths_per_s"


def read(window):
    return _spans.per_launch(window, lambda ts: _spans.count(ts, "regen.sync"))
