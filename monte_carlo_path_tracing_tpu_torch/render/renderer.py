"""Render drivers: the fixed-depth ``render_image`` and the
path-regeneration ``render_image_regen``.

Counterpart of ``monte_carlo_path_tracing_tpu/render/renderer.py``. A
render runs on the device that holds the scene's tensors (``Scene.to``).
``render_image`` processes the image as a flat pixel array in chunks of
``cfg.ray_chunk`` rays, one sample per pixel at a time, into an f32
framebuffer of summed radiance that can be handed back to resume the
render (the RNG state is implicit in (seed, next spp)).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator.wavefront import RayRenderer
from monte_carlo_path_tracing_tpu_torch.ops import grid as grid_mod
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig
from monte_carlo_path_tracing_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray          # [H, W, 3] f32 mean radiance
    spp_done: int
    seconds: float
    # render_image: primary rays (paths) of this call; render_image_regen:
    # logical rays, extension + shadow rays of live lanes.
    rays_traced: int


def _sample_pass(scene: Scene, cfg: RenderConfig, key, pixel_idx, sample_id,
                 renderer: RayRenderer):
    """Radiance of one sample for each pixel of the chunk, through
    ``renderer`` (``render_rays`` of the render). Each lane's key is
    fold(fold(base, sample_id), pixel_id), so the draws a pixel consumes
    depend on (seed, pixel, sample) alone: the image does not depend on
    ``ray_chunk``, and the streams are the regeneration renderer's."""
    lane = rng.lane_keys(rng.sample_key(key, sample_id), pixel_idx)
    jitter = rng.bounce_key(lane, 0, rng.P_PIXEL_JITTER) if cfg.pixel_jitter else None
    ro, rd = generate_rays(scene.camera, pixel_idx, jitter_key=jitter)
    return renderer(lane, ro, rd)


def render_image_regen(
    scene: Scene,
    cfg: RenderConfig,
    lanes: int = 1 << 16,
    max_samples_per_launch: int = 16 << 20,
    on_launch: Optional[Callable[[np.ndarray, int], None]] = None,
) -> RenderResult:
    """Path-regeneration render of ``cfg.spp`` samples per pixel.

    Long renders are split into launches of at most
    ``max_samples_per_launch`` paths (whole spp rounds, so the round-robin
    sample -> pixel map stays balanced); streams are keyed by global
    (spp index, pixel id), so the image does not depend on the split.
    ``on_launch(mean_image_hwc, spp_done)`` fires after every launch.

    Routing is the JAX package's: ``cfg.primary_cache`` None (the default)
    takes the primary-hit cache (``render_regen_cached``: one camera trace
    and one Arvo prepare per pixel and launch, then the loop over the
    continuation seeds) whenever ``primary_cache_eligible(cfg)`` holds, and
    the uncached loop otherwise; True / False force either. Both compute
    the same estimate from the same streams. Blocker chains dropped on a
    full queue (``mis_blocker_compat``) are summed over the launches and
    reported with a warning, as in the JAX package. A warm-up launch runs before
    the clock starts, as in the JAX package: 0 spp rounds cached (the
    prepass's camera trace), ``min(lanes, total)`` samples uncached; it
    touches no state of the render. Each timed launch ends with the
    framebuffer copied to the host, so ``seconds`` covers all its device
    work. Under a torch profiler each timed launch is a ``render.launch``
    span up to its ``on_launch``, its host accumulation a
    ``render.accumulate`` span inside it (``utils.profiling.span``).

    The call is one job (``integrator.regen.RegenJob``), which every launch
    passes on: the scene context, the state buffers and the captured
    prepass chunk and loop iteration are built and captured in the first
    launches (the warm-up's and the first timed one) and replayed in every
    later one, and freed when the call returns.
    """
    from monte_carlo_path_tracing_tpu_torch.integrator.regen import (
        RegenJob, primary_cache_eligible, render_regen, render_regen_cached,
    )

    cfg.validate()
    use_cache = (cfg.primary_cache if cfg.primary_cache is not None
                 else primary_cache_eligible(cfg))
    cam = scene.camera
    n_pix = cam.height * cam.width
    key = rng.base_key(cfg.seed, device=scene.device)
    spp_per_launch = max(1, min(cfg.spp, max_samples_per_launch // n_pix))

    with RegenJob() as job:
        if use_cache:
            render_regen_cached(scene, cfg, key, n_pix, spp_per_launch, 0, lanes=lanes, job=job)
        else:
            render_regen(scene, cfg, key, n_pix, min(lanes, n_pix * cfg.spp), lanes=lanes,
                         job=job)
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)

        t0 = time.perf_counter()
        fb_acc = np.zeros((n_pix, 3), np.float32)
        rays = 0
        spilled = 0
        done = 0
        while done < cfg.spp:
            step = min(spp_per_launch, cfg.spp - done)
            with span("render.launch"):
                if use_cache:
                    fb, nrays, _, stats = render_regen_cached(
                        scene, cfg, key, n_pix, spp_per_launch, step, lanes=lanes, spp0=done,
                        job=job,
                    )
                else:
                    fb, nrays, _, stats = render_regen(
                        scene, cfg, key, n_pix, n_pix * step, lanes=lanes, spp0=done, job=job,
                    )
                spilled += stats.spilled
                with span("regen.sync"):
                    rays += int(nrays)
                done += step
                with span("render.accumulate"):
                    fb_acc += fb.cpu().numpy()
                    mean = (None if on_launch is None
                            else (fb_acc / done).reshape(cam.height, cam.width, 3))
            if on_launch is not None:
                on_launch(mean, done)
        seconds = time.perf_counter() - t0
    if spilled:
        # Those chains fell back to the restructured estimator: surfaced.
        print(f"[regen] WARNING: {spilled} blocker chains spilled", flush=True)
    image = (fb_acc / cfg.spp).reshape(cam.height, cam.width, 3)
    return RenderResult(image=image, spp_done=cfg.spp, seconds=seconds, rays_traced=rays)


def render_image(
    scene: Scene,
    cfg: RenderConfig,
    start_spp: int = 0,
    framebuffer: Optional[np.ndarray] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    graph: Optional[bool] = None,
) -> RenderResult:
    """Fixed-depth render of ``cfg.spp`` samples per pixel through
    ``render_rays``, resuming from ``start_spp`` when a framebuffer of summed
    radiance [H, W, 3] is given; ``progress(s, spp)`` fires after each
    sample. The last chunk is padded with pixel 0, whose extra radiance is
    dropped, so every chunk has ``ray_chunk`` rays. The accel is built once
    per call: the uniform grid when ``cfg.accel == "grid"`` (a host build),
    else the triangle accel. Forward only (autograd off); ``diff.grad``
    differentiates.

    ``graph`` (``wavefront.RayRenderer``'s): ``None`` captures the bounce as one CUDA
    graph for the whole call on CUDA tensors and the triangle accel (the
    first chunk's bounce 0 eager, its bounce 1 captured, every later bounce
    of every chunk one replay) and runs it eagerly elsewhere; ``False`` runs
    it eagerly; ``True`` raises on the CPU or the grid."""
    cfg.validate()
    cam = scene.camera
    h, w = cam.height, cam.width
    n_pix = h * w
    key = rng.base_key(cfg.seed, device=scene.device)
    fb = (np.zeros((n_pix, 3), np.float32) if framebuffer is None
          else framebuffer.reshape(n_pix, 3).astype(np.float32).copy())
    chunk = min(cfg.ray_chunk, n_pix)
    pad = (-n_pix) % chunk
    idx_all = torch.arange(n_pix + pad, dtype=torch.int64, device=scene.device)
    idx_all[n_pix:] = 0                  # padded lanes recompute pixel 0
    accel = (grid_mod.build_grid(scene, n0=cfg.grid_n0) if cfg.accel == "grid"
             else ops_intersect.build_accel(scene))
    renderer = RayRenderer(scene, cfg, accel=accel, graph=graph)

    t0 = time.perf_counter()
    with torch.no_grad():
        for s in range(start_spp, cfg.spp):
            for c0 in range(0, n_pix + pad, chunk):
                rad = _sample_pass(scene, cfg, key, idx_all[c0:c0 + chunk], s, renderer)
                hi = min(c0 + chunk, n_pix)
                fb[c0:hi] += rad[:hi - c0].cpu().numpy()
            if progress is not None:
                progress(s + 1, cfg.spp)
    seconds = time.perf_counter() - t0
    image = (fb / max(cfg.spp, 1)).reshape(h, w, 3)
    return RenderResult(image=image, spp_done=cfg.spp, seconds=seconds,
                        rays_traced=(cfg.spp - start_spp) * n_pix)
