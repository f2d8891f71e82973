"""The port's kernels by the names of their ``__global__`` functions in
``monte_carlo_path_tracing_tpu_torch/csrc/``."""

import re

import numpy as np

K1, K2, K3 = "nearest_kernel", "occluded_kernel", "arvo_select_kernel"
K4, K5 = "nearest_culled_kernel", "occluded_culled_kernel"
K6 = ("threefry_fold_kernel", "threefry_bits_kernel")
INTERSECT = (K1, K2, K4, K5)
PORT = (K1, K2, K3, K4, K5) + K6


def matches(names, symbols) -> np.ndarray:
    """[len(names)] bool: the kernel name holds one of ``symbols`` as a word."""
    pat = re.compile(r"\b(?:" + "|".join(map(re.escape, symbols)) + r")\b")
    return np.array([bool(pat.search(n)) for n in names], bool)


def ms_per_mpath(window, symbols, invert=False):
    """Device milliseconds of the kernels named by ``symbols`` (or, with
    ``invert``, of every other kernel) per million paths of the traced
    launches, averaged over the chips; None without a trace."""
    vals = []
    for ts in window.traces:
        if ts.paths <= 0 or not ts.kernels.names:
            continue
        hit = matches(ts.kernels.names, symbols)
        if invert:
            hit = ~hit
        dur = ts.kernels.end - ts.kernels.start
        vals.append(float(dur[hit].sum()) / 1e3 / (ts.paths / 1e6))
    return float(np.mean(vals)) if vals else None
