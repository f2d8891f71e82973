"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from benchmark import harness

_LIST = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + _LIST], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": harness.ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_reference_and_metrics_load_no_jax():
    metrics = sorted(f[:-3] for f in os.listdir(os.path.join(harness.ROOT, "benchmark", "metrics"))
                     if f.endswith(".py") and not f.startswith("_"))
    code = ("import benchmark.run, benchmark.control, benchmark.check, benchmark.trace\n"
            "import benchmark.launchers.single, benchmark.launchers.sharded\n"
            "import benchmark.reference.scene, benchmark.reference.tracer\n"
            "from benchmark import harness\n"
            f"for m in {metrics!r}: harness.metric_module(m)\n")
    names = _top_level(code)
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)
    assert "benchmark" in names


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level("import benchmark.reference.scene, benchmark.reference.tracer, "
                       "benchmark.reference.threefry, benchmark.check")
    assert "monte_carlo_path_tracing_tpu_torch" not in names
    assert not names & set(harness.FORBIDDEN)


def test_a_whole_cpu_run_loads_no_jax():
    code = ("import time\nfrom benchmark.run import measure\nfrom benchmark.tests import tiny\n"
            "measure(tiny.cell('veach-1024-mis-preview'), 5, 0.0, False, device='cpu', "
            "t_start=time.perf_counter())\n")
    names = _top_level(code)
    assert "monte_carlo_path_tracing_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)
