"""Host-materializing timing helpers.

Counterpart of ``monte_carlo_path_tracing_tpu/utils/timing.py``. A CUDA
call returns once its kernels are queued, not once they have run, so a
host clock stopped there measures the enqueue. Every timed region here
therefore ends at a copy of every output leaf to host numpy: a
device-to-host copy cannot complete before the work that produced it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def _leaves(out):
    """The leaves of ``out`` in order: tuples, lists and NamedTuples by
    position, dicts by sorted key (as ``jax.tree_util`` orders them),
    dataclasses by field; ``None`` holds no leaf."""
    if out is None:
        return
    if isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    elif isinstance(out, dict):
        for k in sorted(out):
            yield from _leaves(out[k])
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _leaves(getattr(out, f.name))
    else:
        yield out


def materialize(out):
    """Copy every leaf of ``out`` to the host; returns the numpy leaves."""
    return [x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
            for x in _leaves(out)]


def timed(fn, *args, n: int = 20):
    """(mean seconds per call over ``n`` calls, last output). A warm-up
    call and its materialization run outside the clock; the timed region
    ends at the materialization of the last call's outputs (a stream runs
    in order, so the last copy retires every call queued before it)."""
    out = fn(*args)
    materialize(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    materialize(out)
    return (time.perf_counter() - t0) / n, out
