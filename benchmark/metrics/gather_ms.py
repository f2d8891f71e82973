"""``parallel.mesh``: per launch, from the end of the slowest rank's render
to rank 0's deinterleaved framebuffer on the host (the count all_reduce,
``gather_rows``, the copy), host clock, from the harness's own spans."""

import numpy as np

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s"


def read(window):
    v = window.spans.get("gather_s")
    return float(np.mean(v)) * 1e3 if v else None
