"""The port's spans in the traced sub-window: the launch path's named
ranges (``utils.profiling.span``: ``render.launch``, ``regen.prepass``,
``graph.capture``, ...), which a traced run's profiler records as host
intervals on the device events' clock. Each reader takes a chip's
:class:`benchmark.trace.TraceSummary` and gives a number for its traced
launches, or None where the trace holds nothing to read; :func:`per_launch`
divides by the launches and averages over the chips."""

import re

import numpy as np

from benchmark import trace

#: The span every launch of the regeneration path opens: a trace without
#: it comes from a program that emits no spans.
LOOP = "regen.loop"
#: The CUDA API calls (runtime and low-level) that allocate device memory.
ALLOC = re.compile(r"cudaMalloc|cuMemAlloc|cuMemCreate")


def named(ts, name):
    """(starts, ends) of the host intervals named ``name`` exactly."""
    sel = np.array([n == name for n in ts.host.names], bool)
    if not sel.size:
        return np.zeros(0), np.zeros(0)
    return ts.host.start[sel], ts.host.end[sel]


def has_spans(ts) -> bool:
    return named(ts, LOOP)[0].size > 0


def total_us(ts, name):
    """Microseconds covered by the spans named ``name``; 0 where the
    program emits spans but none of these, None where it emits none."""
    if not has_spans(ts):
        return None
    s, e = trace.union(*named(ts, name))
    return float((e - s).sum())


def self_us(ts, name, children):
    """Microseconds of the spans named ``name`` less the part covered by
    the spans named in ``children`` (clipped to the parents: a child that
    sticks out counts only inside); None where there is no such span."""
    ps, pe = trace.union(*named(ts, name))
    if not ps.size:
        return None
    cs = [named(ts, c) for c in children]
    cu = trace.union(np.concatenate([c[0] for c in cs]), np.concatenate([c[1] for c in cs]))
    return float((pe - ps).sum()) - trace.overlap(ps, pe, *cu)


def count(ts, name):
    """The number of spans named ``name``; None where the program emits
    no spans."""
    return int(named(ts, name)[0].size) if has_spans(ts) else None


def calls_inside(ts, pattern, parents):
    """The host calls whose name matches ``pattern`` and that start inside
    a span named in ``parents``; None where the program emits no spans."""
    if not has_spans(ts):
        return None
    ps = [named(ts, p) for p in parents]
    us, ue = trace.union(np.concatenate([p[0] for p in ps]), np.concatenate([p[1] for p in ps]))
    n = 0
    for name, t in zip(ts.host.names, ts.host.start):
        if pattern.search(name):
            i = np.searchsorted(us, t, side="right") - 1
            n += bool(i >= 0 and t < ue[i])
    return n


def per_launch(window, value, scale=1.0):
    """``value(ts)`` over each chip's traced launches, times ``scale``,
    averaged over the chips; None where no chip has a reading."""
    vals = []
    for ts in window.traces:
        if ts.launches <= 0:
            continue
        v = value(ts)
        if v is not None:
            vals.append(v * scale / ts.launches)
    return float(np.mean(vals)) if vals else None
