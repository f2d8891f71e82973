"""render.renderer.render_image_regen: the framebuffer's copy, the host add and
the mean image a launch (render.accumulate spans); averaged over the chips."""

from benchmark.metrics import _spans

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    return _spans.per_launch(window, lambda ts: _spans.total_us(ts, "render.accumulate"), 1e-3)
