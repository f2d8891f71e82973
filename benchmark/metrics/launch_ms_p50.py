"""The median (the upper one, sorted[n // 2]) over all the window's launches
of one launch's latency: from the previous launch's framebuffer on the host
(or the job's call) to this launch's. The preview's typical wait."""

UNIT, BETTER = "ms", "lower"


def read(window):
    lat = sorted((t1 - t0) * 1e3 for t0, t1, _ in window.launches)
    return lat[len(lat) // 2] if lat else None
