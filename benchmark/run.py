"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA, the port's kernel library, the scene, one warm
launch of the cell's shapes) is timed by part; then the window measures
for ``--seconds`` through the mix's launcher (``launchers/<name>.py``);
then the check of the configuration's kind (``checks/<kind>.py``; the
``image`` kind re-renders a sample of the window's pixels with the plain
reference) decides ``correct``. Standard output ends with one JSON line
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``); an earlier line starting ``# setup`` gives set-up by
part, the check's seconds and its kind's diagnostics, and standard error
ends with each number compared beside its limit.

Exit codes: 0 with a result; 2 without the cards the cell asks for; 3
when JAX or the JAX package was loaded; any other error propagates.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):           # run as a file: the checkout is the import root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

#: Build and kernel caches, at fixed paths inside the checkout.
CACHE = os.path.join(harness.ROOT, "build", "bench_cache")


def _cache_env() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def window_run(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
               t_start: float = T_START):
    """One window of ``cell`` through its mix's launcher: a launchers.common.Measured."""
    import importlib

    from benchmark.launchers import common

    clock = common.SetupClock(t_start)
    clock.mark("import_s")
    launcher = importlib.import_module(f"benchmark.launchers.{cell.mix['launcher']}")
    return launcher.run(cell, seed, seconds, traced, clock, device=device)


def judge(cell, m, seed: int, device: str = "cuda", dtype=None):
    """(compared numbers, checks, reference rays, pixels) of an ``image``
    kind cell's window: the interface from before check kinds, which
    ``scripts/span_account.py`` reads. The harness calls its kind's judge."""
    return harness.check_module("image", cell.root).compare(cell, m, seed, device, dtype)


def measure(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
            t_start: float = T_START):
    """(result line, checks, diagnostics) of one run of ``cell``: the
    window, then the check of the configuration's kind on ``device``."""
    import numpy as np

    from benchmark import check
    from benchmark import trace as trace_mod

    m = window_run(cell, seed, seconds, traced, device, t_start)
    t_ref = time.perf_counter()
    kind = harness.check_module(harness.check_kind(cell.config), cell.root)
    _, checks, kind_diag = kind.judge(cell, m, seed, device)
    correct = check.passed(checks)
    ref_s = time.perf_counter() - t_ref

    w = m.window
    metrics = harness.read_metrics(cell.per_layer if traced else cell.end_to_end, w, cell.root)
    device_rec = dict(m.device)
    extra = None
    if traced:
        if not w.traces:
            raise RuntimeError("the traced run holds no traced launch")
        device_rec["busy_s"] = float(np.mean([t.busy_us() for t in w.traces])) / 1e6
        device_rec["window_s"] = float(np.mean([t.window_us for t in w.traces])) / 1e6
        extra = trace_mod.breakdown(w.traces)
    lat = sorted((t1 - t0) * 1e3 for t0, t1, _ in w.launches)
    diag = {"launch_ms_min_median_max": [lat[0], lat[len(lat) // 2], lat[-1]],
            "launch_ms": [round((t1 - t0) * 1e3, 1) for t0, t1, _ in w.launches],
            "setup": w.setup_parts, "setup_s": w.setup_s, "reference_s": ref_s,
            "launches": len(w.launches), "paths": sum(p for _, _, p in w.launches),
            **kind_diag}
    line = harness.result_line(correct, len(w.launches), 0, metrics, device_rec, checks, extra)
    return line, checks, diag


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number >= 0")
    cell = harness.resolve(args.workload)
    _cache_env()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    line, checks, diag = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print("# setup " + json.dumps(diag), flush=True)
    print(line, flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
