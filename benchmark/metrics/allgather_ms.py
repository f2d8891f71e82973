"""parallel.mesh.gather_rows: a launch's all_gather of the ranks'
framebuffer shards (parallel.gather spans), averaged over the chips; None
where the program emits no such span."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"

NAME = "parallel.gather"


def _us(ts):
    return _spans.total_us(ts, NAME) if _spans.count(ts, NAME) else None


def read(window):
    return _spans.per_launch(window, _us, 1e-3)
