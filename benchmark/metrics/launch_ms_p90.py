"""``render.renderer.render_image_regen``'s launch-latency tail: the 90th
percentile (nearest rank) over all the window's launches, from the previous
launch's framebuffer on the host (or the job's call) to this launch's. A
tenth or so of the launches take two to four times the median, at random
places (``torch.cuda.graph`` empties the allocator's cache at each of a
launch's captures, and that sometimes takes ten times its usual 25-35 ms),
so this tail swings too widely from run to run to hold a bound."""

import math

UNIT, BETTER, MOVES = "ms", "lower", "launch_ms_p50"


def read(window):
    lat = sorted((t1 - t0) * 1e3 for t0, t1, _ in window.launches)
    if not lat:
        return None
    return lat[math.ceil(0.9 * len(lat)) - 1]
