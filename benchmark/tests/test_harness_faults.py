"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a tiny size, once for each fault a cell can have."""

import json
import os
import sys
import time

import pytest

from benchmark import harness
from benchmark.run import measure
from benchmark.tests import faults, tiny


def _correct(cell, seed, seconds):
    line, checks, _ = measure(cell, seed, seconds, False, device="cpu",
                              t_start=time.perf_counter())
    return json.loads(line)["correct"], checks


@pytest.mark.parametrize("workload", ["veach-1024-mis-batch", "veach-1024-mis-preview"])
def test_a_sound_run_is_correct(workload):
    ok, checks = _correct(tiny.cell(workload), 2**32 + 9, 0.0)
    assert ok, checks


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", ["veach-1024-mis-batch", "bathroom-720p-mis-batch"])
def test_a_broken_launch_is_not_correct(workload, kind):
    cell = tiny.cell(workload, size=8 if workload.startswith("bathroom") else 16)
    undo = faults.install(kind)
    try:
        ok, checks = _correct(cell, 2**32 + 9, 0.0)
    finally:
        undo()
    assert not ok, checks


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_broken_sharded_run_is_not_correct(kind, tmp_path, monkeypatch):
    # The ranks are fresh interpreters: they plant the fault at start-up.
    (tmp_path / "sitecustomize.py").write_text(
        "import os\nfrom benchmark.tests import faults\n"
        "faults.install(os.environ['MCPT_TEST_FAULT'])\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), harness.ROOT]
                                                      + sys.path))
    monkeypatch.setenv("MCPT_TEST_FAULT", kind)
    cell = tiny.cell("veach-2048-mis-sharded4", chips=2, launch_spp=1)
    ok, checks = _correct(cell, 2**32 + 9, 0.0)
    assert not ok, checks


def test_a_sound_sharded_run_is_correct():
    cell = tiny.cell("veach-2048-mis-sharded4", chips=2, launch_spp=1)
    ok, checks = _correct(cell, 2**32 + 9, 0.0)
    assert ok, checks
