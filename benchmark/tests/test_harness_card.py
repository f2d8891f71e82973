"""On the card: one short run of a cell through the command, its last line
as the contract has it and ``correct`` true. Skips without a card (run it
on the card with ``python3 -m pytest benchmark/tests -m cuda``)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "veach-1024-mis-preview", "--seed", str(2**31 + 77), "--seconds", "3",
                          "--trace", str(trace)], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert d["correct"] is True
    assert d["device"]["platform"] == "gpu" and d["device"]["count"] == 1
    assert list(d)[-1] == "checks"
    cell = harness.resolve("veach-1024-mis-preview")
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(d["metrics"]) == want
    if trace:
        assert 0 < d["device"]["busy_s"] <= d["device"]["window_s"]
