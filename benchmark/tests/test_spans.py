"""The readers of the port's spans (metrics/_spans.py and the metrics that
use it) on synthetic traced sub-windows: durations and counts a launch,
self time less the named children (a child that sticks out past its
parent counts only inside it), allocations inside the prepass and the
loop, the mean over the chips, and None where the trace holds no span."""

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.metrics import _spans

#: A launch as the port records it (us): render.launch [0, 100) holds
#: regen.prepass [0, 40) with its context [0, 5) and a capture [10, 20),
#: regen.loop [40, 90) with its context [40, 44), a capture [50, 60) and
#: a context that sticks out past it, [85, 95); syncs at 30, 60, 70;
#: allocations at 2 and 52 (inside), 95 (outside); accumulate [90, 100).
HOST = [("render.launch", 0, 100), ("regen.prepass", 0, 40), ("regen.context", 0, 5),
        ("graph.capture", 10, 20), ("cudaMalloc", 2, 3), ("regen.sync", 30, 31),
        ("regen.loop", 40, 90), ("regen.context", 40, 44), ("graph.capture", 50, 60),
        ("cudaMalloc", 52, 53), ("regen.sync", 60, 61), ("regen.sync", 70, 72),
        ("regen.context", 85, 95), ("cuMemCreate", 95, 96), ("render.accumulate", 90, 100),
        ("parallel.reduce", 96, 99), ("aten::add", 91, 92)]


def _summary(host, launches=1, shift=0.0):
    names, s, e = zip(*host) if host else ((), (), ())
    h = trace.Intervals(list(names), np.asarray(s, float) + shift, np.asarray(e, float) + shift)
    dev = trace.Intervals(["k"], np.array([shift]), np.array([shift + 1.0]))
    return trace.TraceSummary(dev, dev, h, shift, shift + 100.0, launches, 1)


def _window(*summaries):
    return harness.Window(start=0.0, launches=[], setup_s=0.0, traces=list(summaries))


def _read(name, window):
    return harness.metric_module(name).read(window)


def test_self_time_leaves_out_the_named_children():
    ts = _summary(HOST)
    assert _spans.self_us(ts, "regen.prepass", ("regen.context", "graph.capture")) == 25.0
    # the loop: 50 less its context (4), capture (10) and 5 of the context
    # that sticks out past its end
    assert _spans.self_us(ts, "regen.loop", ("regen.context", "graph.capture")) == 31.0
    assert _read("prepass_ms", _window(ts)) == pytest.approx(0.025)
    assert _read("loop_ms.device_bound", _window(ts)) == pytest.approx(0.031)


def test_durations_and_counts_a_launch_averaged_over_the_chips():
    two = _summary(HOST + [(n, s + 100, e + 100) for n, s, e in HOST], launches=2)
    w = _window(_summary(HOST), two)
    assert _read("capture_ms", w) == pytest.approx(0.020)
    assert _read("context_ms", w) == pytest.approx(0.019)
    assert _read("accumulate_ms", w) == pytest.approx(0.010)
    assert _read("rank_wait_ms", w) == pytest.approx(0.003)
    assert _read("host_syncs", w) == 3.0
    assert _read("device_allocs", w) == 2.0
    lone = _window(_summary(HOST, launches=2))
    assert _read("host_syncs", lone) == 1.5


def test_a_program_with_spans_but_none_of_a_kind_reads_zero():
    ts = _summary([("regen.loop", 0, 50), ("cudaMalloc", 60, 61)])
    w = _window(ts)
    assert _read("capture_ms", w) == 0.0
    assert _read("host_syncs", w) == 0.0
    assert _read("device_allocs", w) == 0.0
    assert _read("loop_ms", w) == pytest.approx(0.050)
    assert _read("prepass_ms", w) is None


@pytest.mark.parametrize("name", ["capture_ms", "context_ms", "prepass_ms",
                                  "prepass_ms.device_bound", "loop_ms", "loop_ms.device_bound",
                                  "accumulate_ms", "host_syncs", "device_allocs",
                                  "rank_wait_ms"])
def test_no_span_reads_none(name):
    # The trace of a program without spans: runtime calls and operators only.
    ts = _summary([("cudaMalloc", 2, 3), ("aten::add", 5, 9), ("cudaGraphLaunch", 10, 11)])
    assert _read(name, _window(ts)) is None
    assert _read(name, _window()) is None
    assert _read(name, _window(_summary([]))) is None
