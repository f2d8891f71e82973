"""Sweep K4's design constants on one GPU.

Usage (from the repository root, on a machine with an NVIDIA Hopper GPU):

    python3 chip_sweep.py

K4 (``intersect_cuda.nearest_hit_culled``) takes its shape from constants
of ``csrc/intersect.cu``: rays per CTA (``RB_THREADS / RB_G * RB_R``), the
threads that share a block of rays (``RB_G``) and the rows of a ring stage
(``RB_TILE``). For each variant below the script copies ``csrc/`` into
``build/sweep/<variant>/``, rewrites those ``constexpr`` definitions in the
copy (the tree keeps one value of each and no switch), and builds a kernel
library with ``ops/_build.py``'s flags, one nvcc per source, all at once.
It then records the camera fan of one prepass chunk (``chip_smoke.py``'s
culled phase: pixel rows 480-511 of Veach at 1024^2) and, per variant,
checks K4 with separately rounded dots bit-equal to the plain version and
times K4 (CUDA events, median of 20 after warm-up) in turns: the variants
in order, then in reverse, twice over, with K1 on the same rays timed
beside each round. The last line is a JSON object of every variant's times.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import time

import torch

import chip_smoke
from monte_carlo_path_tracing_tpu_torch.ops import _build, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.scene import load_scene

SWEEP_ROOT = _build.BUILD_ROOT.parent / "sweep"
#: Variant name -> constants of csrc/intersect.cu it changes (the first is
#: the tree's own).
VARIANTS = {
    "tree (128 rays a CTA, RB_G 4, 128-row stages)": {},
    "64 rays a CTA": {"RB_THREADS": 64},
    "RB_G 2, 128 rays a CTA": {"RB_G": 2, "RB_THREADS": 64},
    "RB_G 8, 128 rays a CTA": {"RB_G": 8, "RB_THREADS": 256},
    "64-row stages": {"RB_TILE": 64},
}


def variant_source(changes: dict[str, int]) -> str:
    src = (_build.CSRC / "intersect.cu").read_text()
    for name, value in changes.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        assert n == 1, f"{name}: {n} definitions in csrc/intersect.cu"
    return src


def build_variants() -> dict[str, _build.KernelLibrary]:
    """One library per variant; the other sources are compiled once."""
    shutil.rmtree(SWEEP_ROOT, ignore_errors=True)
    nvcc = _build._nvcc()
    others = [s for s in _build._sources() if s.name != "intersect.cu"]
    common = SWEEP_ROOT / "common"
    common.mkdir(parents=True)
    jobs = [(common / f"{s.stem}.o", s) for s in others]
    dirs = {}
    for i, (name, changes) in enumerate(VARIANTS.items()):
        d = SWEEP_ROOT / f"v{i}"
        d.mkdir()
        (d / "intersect.cu").write_text(variant_source(changes))
        jobs.append((d / "intersect.o", d / "intersect.cu"))
        dirs[name] = d
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for o, s in jobs]
    for (o, s), p in zip(jobs, procs):
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {s}:\n{out}")
    libs = {}
    for name, d in dirs.items():
        lib = d / "libmcpt_kernels.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib), str(d / "intersect.o"),
                        *(str(o) for o, s in jobs[:len(others)])], check=True)
        libs[name] = _build.KernelLibrary(lib, "", 0.0)
    print(f"[sweep] built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def main():
    name, smi = chip_smoke.phase_device()
    libs = build_variants()
    first = next(iter(libs))
    _build._LIB = libs[first]
    scene = chip_smoke.with_res(load_scene(chip_smoke.VEACH, device="cpu"), chip_smoke.RES,
                                chip_smoke.RES).to("cuda")
    accel = ops_intersect.build_accel(scene)
    W, ids = accel.real_rows()
    (ro, rd), _ = chip_smoke.prepass_batches(scene, chip_smoke.main_cfg())
    n = ro.shape[0]
    excl = torch.full((n,), ops_intersect.NO_HIT, dtype=torch.int32, device=ro.device)
    g = ops_intersect.ray_features(ro, rd).contiguous()
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows)
    for v, lib in libs.items():
        _build._LIB = lib
        hs = intersect_cuda.nearest_hit_culled(*args, rows=c.rows, fma=False)
        hk = intersect_cuda.nearest_hit_culled(*args, rows=c.rows)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in ((hs.tri_id, hp.tri_id), (hs.t, hp.t),
                                                    (hs.u, hp.u), (hs.v, hp.v)))
        n_diff = int((hk.tri_id != hp.tri_id).sum())
        print(f"[sweep] {v}: separately rounded bit-equal to plain {exact}; fused ids differ "
              f"on {n_diff}", flush=True)
        assert exact and n_diff <= n // 1000, f"variant {v} disagrees with the plain version"
    times = {v: [] for v in libs}
    k1 = []
    order = list(libs) + list(libs)[::-1]
    for _ in range(2):
        for v in order:
            _build._LIB = libs[v]
            times[v].append(chip_smoke.time_ms(
                lambda: intersect_cuda.nearest_hit_culled(*args, rows=c.rows)))
        _build._LIB = libs[first]
        k1.append(chip_smoke.time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl)))
    for v, ts in times.items():
        print(f"[sweep] K4 {v}: {', '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
    print(f"[sweep] K1 on the same {n} rays: {', '.join(f'{t:.4f}' for t in k1)} ms")
    print(smi)
    print(json.dumps({"device": name, "power": smi, "k4_ms": times, "k1_ms": k1}))


if __name__ == "__main__":
    main()
