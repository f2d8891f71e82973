#!/usr/bin/env python
"""The exact-f32 reference for the port's bench: run the JAX package's
``bench.py`` (unedited) on the CPU and write
``docs/torch_bench_exact_ref.json``.

On the CPU the JAX package routes intersection to its plain version
(``ops/intersect.py``) and resolves its dot mode to ``vpu``, exact f32
(``ops/intersect_pallas.py:88-92``), where the TPU runs behind
``BENCH_r03/r04.json`` used ``mxu_fast`` (bf16x3). Each row is the bench's
cell (Veach MIS, 8 spp, MIS + Arvo NEE, depth 16, seed 0) at one
resolution, cached and uncached, one rep. ``chip_smoke.py`` phase "bench"
holds the port's bench on the card against these rows.

Usage (needs JAX; ~1.5 min at 256^2 and ~15 min at 1024^2 on 8 cores):

    python scripts/torch_bench_exact_ref.py            # --res 256 1024
"""

from __future__ import annotations

import argparse
import importlib.metadata
import json
import os
import platform
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "torch_bench_exact_ref.json")


def run_row(res: int, cache: bool) -> dict:
    knobs = dict(JAX_PLATFORMS="cpu", BENCH_RES=str(res), BENCH_REPS="1",
                 BENCH_REP_SPACING_S="0", BENCH_PRIMARY_CACHE="1" if cache else "0")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "XLA_"))}
    env.update(knobs)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"bench.py {knobs} exited {r.returncode}:\n{r.stderr[-4000:]}")
    result = json.loads([ln for ln in r.stdout.splitlines() if ln.startswith("{")][-1])
    extra = json.loads([ln for ln in r.stderr.splitlines() if ln.startswith("# {")][-1][2:])
    print(f"res {res} cache {cache}: {wall:.1f} s; {extra}", flush=True)
    return {
        "res": res, "spp": extra["spp"], "primary_cache": cache,
        "command": " ".join(f"{k}={v}" for k, v in knobs.items()) + " python bench.py",
        "wall_seconds": round(wall, 1),
        "fb_checksum": extra["fb_checksum"], "total_rays": extra["total_rays"],
        "rays_physical": extra["rays_physical"],
        "result_line": result, "extra_line": extra,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, nargs="+", default=[256, 1024])
    args = ap.parse_args()
    rows = [run_row(res, cache) for res in args.res for cache in (True, False)]
    doc = {
        "what": "the JAX package's bench.py, unedited, on the CPU: exact f32 (dot mode vpu)",
        "jax": importlib.metadata.version("jax"),
        "python": platform.python_version(),
        "host_cpus": os.cpu_count(),
        "rows": rows,
    }
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
