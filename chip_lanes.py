"""Lane sweep of the port's main path on one GPU.

Usage (from the repository root, on a machine with an NVIDIA GPU):

    python3 chip_lanes.py [--lanes 16384 32768 65536] [--repeats 1]

Renders the main path of ``chip_smoke.py`` (Veach MIS, 1024^2, 8 spp,
MIS + spherical-triangle NEE, depth 16, seed 0, the default route through
the primary-hit cache) through ``render_image_regen`` once per lane count
and repeat, after one small warm-up render that builds the kernels. For
each render it prints the host-clock seconds, the split between
``primary_prepass`` and the seeded loop (each timed with the device
synchronised at both ends), the loop's iteration count, logical rays and
Mrays/s, and the fb_checksum gap to the stream-determined value. The first
line names the card (``nvidia-smi`` name and power limit), as does the
line before the last; the last is one JSON object of all runs.
``chip_smoke.py``'s ``LANES_CACHED`` is the fastest lane count this sweep
found.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import chip_smoke as cs
from monte_carlo_path_tracing_tpu_torch.integrator import regen


def timed(fn, acc, iters_at=None):
    """``fn`` wrapped to add its synchronised seconds to ``acc`` (and the
    iteration count at ``iters_at`` of its result, for the loop)."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc["seconds"] += time.perf_counter() - t0
        if iters_at is not None:
            acc["iterations"] += int(out[iters_at])
        return out
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[1 << 14, 1 << 15, 1 << 16])
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    _, smi = cs.phase_device()
    scene_cpu = cs.load_scene(cs.VEACH, device="cpu")
    cs.render_image_regen(cs.with_res(scene_cpu, 64, 64).to("cuda"),
                          cs.RenderConfig(width=64, height=64, spp=1, seed=0), lanes=2048)
    scene = cs.with_res(scene_cpu, cs.RES, cs.RES).to("cuda")
    runs = []
    orig = regen.primary_prepass, regen.render_regen
    try:
        for _ in range(args.repeats):
            for lanes in args.lanes:
                pre = dict(seconds=0.0, iterations=0)
                loop = dict(seconds=0.0, iterations=0)
                regen.primary_prepass = timed(orig[0], pre)
                regen.render_regen = timed(orig[1], loop, iters_at=2)
                res = cs.render_image_regen(scene, cs.main_cfg(), lanes=lanes)
                regen.primary_prepass, regen.render_regen = orig
                checksum = float((res.image.astype(np.float64) * cs.SPP).sum())
                run = dict(lanes=lanes, seconds=res.seconds, prepass_s=pre["seconds"],
                           loop_s=loop["seconds"], iterations=loop["iterations"],
                           rays=res.rays_traced, mrays_s=res.rays_traced / res.seconds / 1e6,
                           checksum_gap=checksum / cs.REF_CHECKSUM_CACHED - 1.0)
                cs.log(f"[lanes] {lanes}: {run['seconds']:.3f} s (prepass {run['prepass_s']:.3f}"
                       f" s, loop {run['loop_s']:.3f} s, {run['iterations']} iterations), "
                       f"{run['rays']} rays, {run['mrays_s']:.3f} Mrays/s, fb_checksum gap "
                       f"{run['checksum_gap']:+.3e}")
                runs.append(run)
    finally:
        regen.primary_prepass, regen.render_regen = orig
    print(smi)
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()
