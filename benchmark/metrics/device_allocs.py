"""The caching allocator: cudaMalloc, cuMemAlloc and cuMemCreate calls inside
the regen.prepass and regen.loop spans, a launch; averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "calls", "lower", "paths_per_s"

PARENTS = ("regen.prepass", "regen.loop")


def read(window):
    return _spans.per_launch(window,
                             lambda ts: _spans.calls_inside(ts, _spans.ALLOC, PARENTS))
