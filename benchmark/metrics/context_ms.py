"""integrator.regen: the per-call build of accel, light tables, constants and
state buffers a launch (regen.context spans); averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _spans.per_launch(window, lambda ts: _spans.total_us(ts, "regen.context"), 1e-3)
