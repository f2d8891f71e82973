"""The inverse-rendering step's spans (``diff.inverse.recover_materials``:
``inverse.step`` and its children, the wavefront's ``wavefront.sync``) in
the traced sub-window, a step being a launch. A reader gives None for a
chip whose trace holds no ``inverse.step`` span: a program that emits none
(``_spans``' readers gate on the regeneration path's ``regen.loop``, which
a step never opens)."""

import numpy as np

from benchmark import trace
from benchmark.metrics import _spans

STEP = "inverse.step"
#: The spans in which the host waits on a device value.
SYNCS = ("inverse.sync", "wavefront.sync")


def per_step(window, value, scale=1.0):
    """``value(ts)`` a traced step, times ``scale``, averaged over the chips
    whose trace holds ``inverse.step`` spans; None where none does."""
    return _spans.per_launch(
        window, lambda ts: value(ts) if _spans.named(ts, STEP)[0].size else None, scale)


def total_us(ts, names) -> float:
    """Microseconds covered by the spans named in ``names`` (0 where none)."""
    spans = [_spans.named(ts, n) for n in names]
    s, e = trace.union(np.concatenate([x[0] for x in spans]),
                       np.concatenate([x[1] for x in spans]))
    return float((e - s).sum())


def count(ts, names) -> int:
    return int(sum(_spans.named(ts, n)[0].size for n in names))
