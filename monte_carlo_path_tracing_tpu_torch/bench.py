"""The port's benchmark: Veach MIS 1024x1024, MIS + Arvo spherical-triangle
NEE, depth 16, seed 0, on one card.

    python -m monte_carlo_path_tracing_tpu_torch.bench

Counterpart of the JAX package's ``bench.py`` (repository root), with its
contract and definitions. stdout holds ONE JSON line, {"metric":
"Mrays/s/chip", "value": ..., "unit": "Mrays/s", "vs_baseline": ...};
stderr holds one ``# {...}`` line of bookkeeping with ``bench.py``'s keys,
plus ``power_limit`` (nvidia-smi; null on the CPU), ``lanes`` and
``launches`` (each kernel's launches in the last timed rep; 0 on the CPU,
where the plain versions run).

Definitions
-----------
- rays  = LOGICAL trace operations whose lane was live (extension + NEE
          shadow rays), counted inside the integrator. The primary-hit
          cache (``integrator/regen.py::render_regen_cached``) traces one
          primary ray per pixel; it still counts once per SAMPLE here, and
          the physically traced count is ``rays_physical``.
- paths = pixels x spp.
- value = rays / wall seconds / 1e6 per device; each rep is timed until
          the framebuffer has been copied to the host.
- vs_baseline = paths/s over the reference C++ renderer's 136 paths/s at
          this scene and estimator (BASELINE.md).
- fb_checksum = the sum of the framebuffer of summed radiance (not of the
          mean image).

Knobs (environment): BENCH_SPP (8), BENCH_RES (1024), BENCH_ESTIMATOR
(mis), BENCH_SCENE (Veach MIS), BENCH_JITTER (0), BENCH_PRIMARY_CACHE (1),
BENCH_REPS (4), BENCH_CHUNK (lanes: 65,536 cached, 32,768 uncached, the
port's measured optima on an H100, ``chip_lanes.py``; the image does not
depend on them), BENCH_REP_SPACING_S (0: the JAX bench's 45 s spaced its
reps across TPU tenancy phases, which its calibration probe detected; the
probe is not ported, ROADMAP queue 1 "Do not port", so its keys read
``[]`` / ``"n/a"`` as on the JAX bench's sharded branch), BENCH_DOT_MODE
(unset or ``vpu``: the port computes exact f32; any other value is
refused), BENCH_DEVICE (unset: the card, and without one the bench fails;
``cpu`` runs on the CPU with the kernels' plain versions).

Under torchrun's variables (world size above 1) every rank renders its
interleaved share of the pixels (``parallel.sharded.make_regen_sharded``,
NCCL on the card, gloo on the CPU), and rank 0 alone prints; the metric
stays per device.

Exit codes: 0 with the two lines; 1 when a guard fails (a checksum that is
not a positive finite number, or a rate above the physical ceiling); 2 on
a refused knob. Any other error propagates.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Mapping

import numpy as np
import torch

REF_PATHS_PER_S = 136.0  # BASELINE.md, reference MIS 1x distance

# The physical ceiling on the reported rate (bench.py:40-58): the all-pairs
# test costs ~90 flops a (ray, triangle) pair; with a generous 10x culling
# factor and a 4e14 flop/s peak (above any current chip's f32 / bf16
# peak), rays/s < 4e14 / (90 * n_tris * 0.1). A rate above it means the
# clock stopped before the work did.
_PEAK_FLOPS = 4.0e14
_FLOPS_PER_PAIR = 90.0
_CULL_FACTOR = 0.1

#: Lanes of the cached and the uncached loop (chip_lanes.py on an H100).
LANES_CACHED, LANES_UNCACHED = 1 << 16, 1 << 15
DO_NOT_PORT = 'ROADMAP queue 1, "Do not port"'
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SCENE = os.path.join(_ROOT, "scenes", "veach-mis", "veach-mis.obj")


class BenchError(RuntimeError):
    """A refused knob (``code`` 2) or a failed guard (``code`` 1)."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def _ceiling_mrays(n_tris: int) -> float:
    return _PEAK_FLOPS / (_FLOPS_PER_PAIR * n_tris * _CULL_FACTOR) / 1e6


def _power_limit():
    """The card's power limit as nvidia-smi reports it ("700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].rsplit(",", 1)[1].strip()


def _launches() -> dict:
    from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, intersect_cuda

    return {"K1 nearest_hit": intersect_cuda.nearest_hit.launches,
            "K2 occluded": intersect_cuda.occluded.launches,
            "K3 arvo_select": arvo_cuda.arvo_select.launches,
            "K4 nearest_hit_culled": intersect_cuda.nearest_hit_culled.launches,
            "K5 occluded_culled": intersect_cuda.occluded_culled.launches}


def _launches_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches().items()}


def run(env: Mapping[str, str]):
    """One bench run configured by ``env`` (the ``BENCH_*`` knobs):
    (result, extra, fb) with ``fb`` the last rep's framebuffer of summed
    radiance [pixels, 3] in pixel order, on the host. torchrun's variables
    are read from the process environment (``init_distributed_if_needed``);
    under several ranks every rank returns the same three. Raises
    :class:`BenchError` on a refused knob or a failed guard."""
    dot_mode = env.get("BENCH_DOT_MODE") or None
    if dot_mode not in (None, "vpu"):
        raise BenchError(f"BENCH_DOT_MODE={dot_mode} is a TPU dot mode, not ported "
                         f"({DO_NOT_PORT}): the port computes exact f32 (vpu)", 2)
    device = env.get("BENCH_DEVICE") or "cuda"
    if device not in ("cuda", "cpu"):
        raise BenchError(f"BENCH_DEVICE={device}: 'cpu', or unset for the card", 2)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card "
                           "(BENCH_DEVICE=cpu asks for the CPU)")

    from monte_carlo_path_tracing_tpu_torch.parallel.mesh import init_distributed_if_needed

    init_distributed_if_needed("gloo" if device == "cpu" else "nccl")

    import torch.distributed as dist

    from monte_carlo_path_tracing_tpu_torch.core import rng
    from monte_carlo_path_tracing_tpu_torch.integrator.regen import (
        primary_cache_eligible, render_regen, render_regen_cached,
    )
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene
    from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

    spp = int(env.get("BENCH_SPP", "8"))
    res = int(env.get("BENCH_RES", "1024"))
    estimator = env.get("BENCH_ESTIMATOR", "mis")
    jitter = env.get("BENCH_JITTER", "0") == "1"
    cache_on = env.get("BENCH_PRIMARY_CACHE", "1") != "0"
    reps = int(env.get("BENCH_REPS", "4"))
    if reps < 1:
        raise BenchError(f"BENCH_REPS={reps}: at least one timed rep", 2)
    spacing = float(env.get("BENCH_REP_SPACING_S", "0"))
    scene_path = env.get("BENCH_SCENE", DEFAULT_SCENE)

    cfg = RenderConfig(
        width=res, height=res, spp=spp, estimator=estimator,
        light_sampler="spherical_triangle", max_depth=16, pixel_jitter=jitter, seed=0,
    )
    use_cache = cache_on and primary_cache_eligible(cfg)
    lanes = int(env.get("BENCH_CHUNK", LANES_CACHED if use_cache else LANES_UNCACHED))
    cfg = cfg.replace(ray_chunk=lanes)
    cfg.validate()

    scene = load_scene(scene_path, device=device)
    scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=res,
                                                                  height=res))
    n_pix = res * res
    total_samples = n_pix * spp
    key = rng.base_key(cfg.seed, device=scene.device)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1

    rep_secs = []
    if n_dev > 1:
        # Pixels interleaved over the ranks, one regen loop each; the
        # framebuffer is gathered inside the clock, as JAX's host copy of
        # its sharded framebuffer is.
        from monte_carlo_path_tracing_tpu_torch.parallel import gather_rows, make_mesh
        from monte_carlo_path_tracing_tpu_torch.parallel.sharded import (
            deinterleave_framebuffer, make_regen_sharded,
        )

        mesh = make_mesh((n_dev,), ("tiles",))
        fn = make_regen_sharded(scene, cfg, mesh, lanes, spp_cap=spp if cache_on else None,
                                with_physical=True)
        gather_rows(fn(scene, key, 1)[0], mesh).cpu()
        dist.barrier()
        before = _launches()
        t0 = time.perf_counter()
        fb, total_rays, rays_physical = fn(scene, key, spp)
        fb = deinterleave_framebuffer(gather_rows(fb, mesh).cpu().numpy(), n_dev)
        dt = time.perf_counter() - t0
        launches = _launches_since(before)
    else:
        def render(rounds_or_samples):
            if use_cache:
                return render_regen_cached(scene, cfg, key, n_pix, spp, rounds_or_samples,
                                           lanes=lanes)
            return render_regen(scene, cfg, key, n_pix, rounds_or_samples, lanes=lanes)

        # Warm-up outside the clock, as bench.py:166-176: 0 spp rounds
        # cached (the prepass's camera trace), one launch of lanes uncached.
        render(0 if use_cache else min(lanes, total_samples))[0].cpu()
        for i in range(reps):
            if i:
                time.sleep(spacing)
            before = _launches()
            t0 = time.perf_counter()
            fb, nrays, _, stats = render(spp if use_cache else total_samples)
            fb = fb.cpu().numpy()
            total_rays = int(nrays)
            rays_physical = int(stats.rays_physical) or total_rays
            rep_secs.append(time.perf_counter() - t0)
            launches = _launches_since(before)
        dt = min(rep_secs)

    checksum = float(fb.sum())
    if not np.isfinite(checksum) or checksum <= 0.0:
        raise BenchError(f"framebuffer checksum {checksum} is not a positive finite number: "
                         "the render did not execute", 1)
    paths = total_samples
    mrays = total_rays / dt / 1e6 / n_dev
    paths_per_s = paths / dt
    ceiling = _ceiling_mrays(scene.num_tris)
    if mrays >= ceiling:
        raise BenchError(f"measured {mrays:.1f} Mrays/s exceeds the physical ceiling "
                         f"{ceiling:.1f} Mrays/s for a {scene.num_tris}-triangle scene on one "
                         "device: the timing is broken; refusing to record it", 1)
    on_card = scene.device.type == "cuda"
    result = {
        "metric": "Mrays/s/chip",
        "value": round(mrays, 4),
        "unit": "Mrays/s",
        "vs_baseline": round(paths_per_s / REF_PATHS_PER_S, 1),
    }
    extra = {
        "device": torch.cuda.get_device_name(scene.device) if on_card else "cpu",
        "backend": scene.device.type,
        "power_limit": _power_limit() if on_card else None,
        "res": res, "spp": spp, "estimator": estimator, "jitter": jitter,
        "lanes": lanes,
        "seconds": round(dt, 3),
        "seconds_median": round(float(np.median(rep_secs)), 3) if rep_secs else round(dt, 3),
        "rep_seconds": [round(s, 3) for s in rep_secs],
        "rep_tenancy": [],
        "calib_seconds": [],
        "headline_phase": "n/a",
        "paths_per_s": round(paths_per_s, 1),
        "rays_per_path": round(total_rays / paths, 3),
        "total_rays": total_rays,
        "rays_physical": int(rays_physical),
        "mrays_physical": round(rays_physical / dt / 1e6 / n_dev, 4),
        "fb_checksum": checksum,
        "launches": launches,
    }
    return result, extra, fb


def main() -> int:
    import torch.distributed as dist

    try:
        result, extra, _ = run(os.environ)
    except BenchError as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return e.code
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(result), flush=True)
        print("# " + json.dumps(extra), file=sys.stderr, flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
