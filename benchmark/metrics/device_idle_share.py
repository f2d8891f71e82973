"""The device: 1 minus the union of kernel and copy intervals over the
traced sub-window, averaged over the chips."""

import numpy as np

UNIT, BETTER, MOVES = "share", "lower", "paths_per_s"


def read(window):
    vals = [1.0 - ts.busy_us() / ts.window_us for ts in window.traces
            if ts.window_us > 0 and ts.device.names]
    return float(np.mean(vals)) if vals else None
