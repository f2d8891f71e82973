"""The window's arithmetic and the result line, on the CPU at a tiny size:
all the work over all the time, the p90 over every launch, whole launches
only, the job ended from its launch callback."""

import itertools
import json
import time
import types

import numpy as np
import pytest

from benchmark import harness
from benchmark.launchers import common, single
from benchmark.metrics import launch_ms_p50, launch_ms_p90, paths_per_s
from benchmark.tests import tiny


def test_paths_per_s_is_all_the_work_over_all_the_time():
    # Three launches with a gap between the second and the third: the gap counts.
    w = harness.Window(start=10.0, launches=[(10.0, 11.0, 100), (11.0, 12.0, 100),
                                             (13.0, 14.0, 100)], setup_s=1.0)
    assert paths_per_s.read(w) == pytest.approx(300 / 4.0)


def test_launch_p90_is_the_nearest_rank_over_every_launch():
    lat = list(range(1, 101))                   # 1 .. 100 ms
    w = harness.Window(start=0.0, launches=[(0.0, v / 1e3, 1) for v in lat], setup_s=0.0)
    assert launch_ms_p90.read(w) == pytest.approx(90.0)
    w.launches = [(0.0, v / 1e3, 1) for v in (5, 1, 3)]
    assert launch_ms_p90.read(w) == pytest.approx(5.0)


def test_result_line_keys_and_checks_last():
    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 1},
                               {"sum_gap": {"value": 0.0, "limit": 1e-3}},
                               {"device_ops": [], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]


def test_the_window_ends_the_job_from_its_launch_callback():
    cell = tiny.cell("veach-1024-mis-preview", spp=6)
    m = single.run(cell, 7, 0.0, False, common.SetupClock(time.perf_counter()), device="cpu")
    # The first launch's callback is past the deadline: one whole launch of 6.
    assert len(m.window.launches) == 1 and m.rounds == [0]
    assert m.window.launches[0][2] == 16 * 16
    assert m.rays > 0 and np.isfinite(m.image).all()


def test_a_job_that_ends_before_the_window_is_followed_by_the_next(monkeypatch):
    # The launcher's clock advances one second a reading, so the window holds
    # the same launches however fast the CPU is: a job's start and each
    # launch take one reading, so 6 s hold two jobs of two launches.
    ticks = itertools.count()
    monkeypatch.setattr(single, "time",
                        types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
    cell = tiny.cell("veach-1024-mis-preview", spp=2)
    seconds = 6.0
    m = single.run(cell, 7, seconds, False, common.SetupClock(time.perf_counter()),
                   device="cpu")
    assert len(m.window.launches) == 4
    assert all(p == 16 * 16 for _, _, p in m.window.launches)
    assert all(t0 < t1 for t0, t1, _ in m.window.launches)
    assert m.rounds in ([0], [0, 1])             # the last job's image
    assert m.window.launches[-1][1] - m.window.start >= seconds


def test_launch_p50_is_the_upper_median_over_every_launch():
    w = harness.Window(start=0.0, launches=[(0.0, v / 1e3, 1) for v in (4, 1, 3, 2)],
                       setup_s=0.0)
    assert launch_ms_p50.read(w) == pytest.approx(3.0)
    w.launches = w.launches[:3]
    assert launch_ms_p50.read(w) == pytest.approx(3.0)
