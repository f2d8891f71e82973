"""``integrator.graph`` and the caching allocator: device-idle time per
launch while the host is in a graph capture or instantiation, cudaMalloc
or cudaFree (runtime and driver calls), averaged over the chips."""

import re

import numpy as np

from benchmark import trace

UNIT, BETTER, MOVES = "ms", "lower", "launch_ms_p50"

_HOST = re.compile(r"Capture|GraphInstantiate|GraphDestroy|GraphExecDestroy|cudaMalloc|cudaFree"
                   r"|cuMemAlloc|cuMemFree|cuMemCreate|cuMemMap|cuMemUnmap|cuMemRelease")


def read(window):
    vals = []
    for ts in window.traces:
        if ts.launches <= 0 or not ts.device.names:
            continue
        sel = np.array([bool(_HOST.search(n)) for n in ts.host.names], bool)
        hs, he = trace.union(ts.host.start[sel], ts.host.end[sel])
        gs, ge = ts.gaps()
        vals.append(trace.overlap(gs, ge, hs, he) / 1e3 / ts.launches)
    return float(np.mean(vals)) if vals else None
