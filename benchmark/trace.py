"""The traced sub-window: torch.profiler events reduced to interval arrays.

A profiler (CPU and CUDA activity, CUPTI) runs over whole launches of the
measured window; its events stay in memory and no trace file is written.
:func:`summarize` keeps three kinds of intervals, in microseconds on the
profiler's clock: kernels, all device work (kernels, copies, fills) and
host ops (operators, runtime and driver calls). The busy time is the union
of the device intervals, the window the span from the first event to the
last, and each idle gap is named by the innermost host op open where it
starts. The arithmetic follows ``chip_smoke.py``'s phase "profile".
"""

from __future__ import annotations

import dataclasses

import numpy as np

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: Characters of an op's name kept in the result's breakdown.
_NAME = 160


@dataclasses.dataclass
class Intervals:
    names: list
    start: np.ndarray   # us
    end: np.ndarray     # us

    @classmethod
    def empty(cls):
        return cls([], np.zeros(0), np.zeros(0))


@dataclasses.dataclass
class TraceSummary:
    """One chip's traced sub-window: kernels, device work, host ops, and the
    whole launches it covers."""

    kernels: Intervals
    device: Intervals
    host: Intervals
    w0: float
    w1: float
    launches: int
    paths: int

    @property
    def window_us(self) -> float:
        return self.w1 - self.w0

    def busy(self):
        """(starts, ends) of the union of the device intervals."""
        return union(self.device.start, self.device.end)

    def busy_us(self) -> float:
        s, e = self.busy()
        return float((e - s).sum())

    def gaps(self):
        """(starts, ends) of the device's idle gaps inside the window."""
        s, e = self.busy()
        return np.r_[self.w0, e], np.r_[s, self.w1]


def _kind(ev) -> str:
    try:
        return ev.activity_type()
    except AttributeError:                      # older torch: by device and name
        if str(ev.device_type()).endswith("CUDA"):
            n = ev.name()
            return ("gpu_memcpy" if n.startswith("Memcpy")
                    else "gpu_memset" if n.startswith("Memset") else "kernel")
        return "cpu_op"


def summarize(prof, launches: int, paths: int) -> TraceSummary:
    """The :class:`TraceSummary` of a stopped ``torch.profiler.profile``."""
    rows = {"kernel": [], "device": [], "host": []}
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        rec = (ev.name(), ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3)
        if kind in _DEVICE and rec[0].startswith("nccl:"):
            continue                  # NCCL's annotation of a kernel the trace holds too
        if kind in _DEVICE:
            rows["device"].append(rec)
            if kind == "kernel":
                rows["kernel"].append(rec)
        elif kind in _HOST:
            rows["host"].append(rec)

    def arr(r):
        if not r:
            return Intervals.empty()
        names, s, e = zip(*r)
        return Intervals(list(names), np.asarray(s, float), np.asarray(e, float))

    k, d, h = arr(rows["kernel"]), arr(rows["device"]), arr(rows["host"])
    starts = np.r_[d.start, h.start]
    ends = np.r_[d.end, h.end]
    if starts.size == 0:
        raise RuntimeError("the traced sub-window holds no event")
    return TraceSummary(k, d, h, float(starts.min()), float(ends.max()), launches, paths)


def union(start: np.ndarray, end: np.ndarray):
    """The union of [start, end) intervals as sorted disjoint (starts, ends)."""
    if start.size == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], np.maximum.accumulate(end[order])
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(first)
    return s[idx], e[np.r_[idx[1:] - 1, len(s) - 1]]


def overlap(a_s, a_e, b_s, b_e) -> float:
    """Length of the intersection of two unions of disjoint sorted intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a_s) and j < len(b_s):
        lo, hi = max(a_s[i], b_s[j]), min(a_e[i], b_e[j])
        if hi > lo:
            total += hi - lo
        if a_e[i] < b_e[j]:
            i += 1
        else:
            j += 1
    return total


def host_op_at(host: Intervals, t: float):
    """The innermost host op open at time t (the latest to start among those
    whose interval holds it); None where none is open."""
    open_ = np.flatnonzero((host.start <= t) & (host.end > t))
    if open_.size == 0:
        return None
    return host.names[open_[np.argmax(host.start[open_])]]


def breakdown(summaries, top: int = 10) -> dict:
    """The device ops that took most time and the longest idle gaps (named
    by the host op open at their start), in seconds, over the chips."""
    tot: dict = {}
    gaps = []
    for ts in summaries:
        for n, s, e in zip(ts.device.names, ts.device.start, ts.device.end):
            tot[n] = tot.get(n, 0.0) + (e - s)
        gs, ge = ts.gaps()
        for i in np.argsort(-(ge - gs), kind="stable")[:top]:
            gaps.append([host_op_at(ts.host, gs[i]) or "no host op", float(ge[i] - gs[i]) / 1e6])
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:_NAME], v / 1e6] for n, v in ops],
            "idle_gaps": [[n[:_NAME], v] for n, v in gaps[:top]]}
