"""The kind of a configuration's ``correct`` check is found by name: a
``check`` block that names none is the ``image`` kind, an unknown kind is
refused naming the file looked for, and the ``image`` kind gives, on the
same window, the numbers, checks and diagnostics that the harness's one
judge gave before check kinds, bit for bit."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import check, harness, run
from benchmark.tests import tiny

SEED = 2**32 + 9

#: measure's diagnostics before check kinds, in their order: the generic
#: keys, then the image kind's.
DIAG_KEYS = ["launch_ms_min_median_max", "launch_ms", "setup", "setup_s", "reference_s",
             "launches", "paths", "spp_checked", "pixels_checked", "rays", "rays_per_path",
             "reference_rays_per_path"]


def _judge_before(cell, m, seed, dtype=None):
    """``run.judge`` and measure's image diagnostics as they stood before
    check kinds, kept here as the oracle of the ``image`` kind."""
    c = cell.config
    pixels = check.sample_pixels(c["width"] * c["height"], c["check"]["pixels"], seed)
    ref, ref_rays = check.reference(c, harness.ROOT, seed, m.rounds, pixels, "cpu")
    w = m.window
    prog = m.image[pixels]
    prog_rpp = m.rays / sum(p for _, _, p in w.launches)
    ref_rpp = ref_rays / (len(pixels) * len(m.rounds))
    if dtype is not None and dtype != torch.float32:
        prog, low_rays = check.reference(c, harness.ROOT, seed, m.rounds, pixels, "cpu", dtype)
        prog_rpp = low_rays / (len(pixels) * len(m.rounds))
    numbers = check.compare(prog, ref, prog_rpp, ref_rpp)
    elapsed = w.launches[-1][1] - w.start
    checks = check.checks(numbers, c["check"]["limits"], float(np.sum(m.image)),
                          m.rays / elapsed / cell.chips, m.num_tris)
    paths = sum(p for _, _, p in w.launches)
    diag = {"spp_checked": len(m.rounds), "pixels_checked": len(pixels), "rays": m.rays,
            "rays_per_path": m.rays / paths,
            "reference_rays_per_path": ref_rays / (len(pixels) * len(m.rounds))}
    return numbers, checks, diag


def test_a_check_block_without_a_kind_is_the_image_kind():
    assert harness.check_kind({"check": {"pixels": 4, "limits": {}}}) == "image"
    assert harness.check_kind({}) == "image"
    assert harness.check_kind({"check": {"kind": "loss"}}) == "loss"
    mod = harness.check_module("image")
    assert callable(mod.judge) and callable(mod.control)


def test_an_unknown_check_kind_is_refused_naming_the_file_it_looked_for():
    with pytest.raises(FileNotFoundError, match=r"benchmark/checks/no_such_kind\.py"):
        harness.check_module("no_such_kind")


@pytest.mark.parametrize("workload,kw,control", [
    ("veach-1024-mis-batch", {}, True),
    ("veach-1024-mis-preview", {}, False),
    ("bathroom-720p-mis-batch", {"size": 8}, False),
    ("veach-2048-mis-sharded4", {"chips": 2, "launch_spp": 1}, False),
], ids=["batch", "preview", "bathroom", "sharded"])
def test_the_image_kind_is_the_judge_it_replaced(workload, kw, control, monkeypatch):
    cell = tiny.cell(workload, **kw)
    m = run.window_run(cell, SEED, 0.0, False, device="cpu", t_start=time.perf_counter())
    kind = harness.check_module("image")
    want = _judge_before(cell, m, SEED)
    assert kind.judge(cell, m, SEED, "cpu") == want
    assert run.judge(cell, m, SEED, "cpu")[:2] == want[:2]
    if control:
        low = torch.bfloat16
        assert kind.judge(cell, m, SEED, "cpu", low)[:2] == _judge_before(cell, m, SEED, low)[:2]

    # measure reaches the same kind through the configuration, on this window.
    monkeypatch.setattr(run, "window_run", lambda *a, **k: m)
    line, checks, diag = run.measure(cell, SEED, 0.0, False, device="cpu",
                                     t_start=time.perf_counter())
    _, want_checks, want_diag = want
    assert checks == want_checks
    assert json.loads(line)["checks"] == want_checks
    assert json.loads(line)["correct"] is check.passed(want_checks)
    assert list(diag) == DIAG_KEYS
    assert {k: diag[k] for k in want_diag} == want_diag
