"""``parallel.sharded``: per launch, the slowest rank's render seconds over
the mean of the ranks, averaged over the window's launches."""

import numpy as np

UNIT, BETTER, MOVES = "ratio", "lower", "paths_per_s"


def read(window):
    r = window.spans.get("rank_render_s")        # [launch][rank]
    if not r:
        return None
    r = np.asarray(r, float)
    return float(np.mean(r.max(axis=1) / r.mean(axis=1)))
