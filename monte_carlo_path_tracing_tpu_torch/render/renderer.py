"""Render driver for the path-regeneration renderer.

Counterpart of ``render_image_regen`` in
``monte_carlo_path_tracing_tpu/render/renderer.py``. The render runs on the
device that holds the scene's tensors (``Scene.to``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray          # [H, W, 3] f32 mean radiance
    spp_done: int
    seconds: float
    rays_traced: int           # logical rays: extension + shadow


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
    the same estimate from the same streams. Each launch ends with the
    framebuffer copied to the host, so ``seconds`` covers all device work;
    nothing is warmed up before the clock starts.
    """
    from monte_carlo_path_tracing_tpu_torch.integrator.regen import (
        primary_cache_eligible, render_regen, render_regen_cached,
    )

    cfg.validate()
    use_cache = (cfg.primary_cache if cfg.primary_cache is not None
                 else primary_cache_eligible(cfg))
    cam = scene.camera
    n_pix = cam.height * cam.width
    key = rng.base_key(cfg.seed, device=scene.device)
    spp_per_launch = max(1, min(cfg.spp, max_samples_per_launch // n_pix))

    t0 = time.perf_counter()
    fb_acc = np.zeros((n_pix, 3), np.float32)
    rays = 0
    done = 0
    while done < cfg.spp:
        step = min(spp_per_launch, cfg.spp - done)
        if use_cache:
            fb, nrays, _, _ = render_regen_cached(
                scene, cfg, key, n_pix, spp_per_launch, step, lanes=lanes, spp0=done
            )
        else:
            fb, nrays, _, _ = render_regen(
                scene, cfg, key, n_pix, n_pix * step, lanes=lanes, spp0=done
            )
        fb_acc += fb.cpu().numpy()
        rays += int(nrays)
        done += step
        if on_launch is not None:
            on_launch((fb_acc / done).reshape(cam.height, cam.width, 3), done)
    seconds = time.perf_counter() - t0
    image = (fb_acc / cfg.spp).reshape(cam.height, cam.width, 3)
    return RenderResult(image=image, spp_done=cfg.spp, seconds=seconds, rays_traced=rays)
