"""Pixels x spp of every whole launch in the window over the time from the
window's start to the end of its last launch: all the work over all the
time."""

UNIT, BETTER = "paths/s", "higher"


def read(window):
    if not window.launches:
        return None
    paths = sum(p for _, _, p in window.launches)
    return paths / (window.launches[-1][1] - window.start)
