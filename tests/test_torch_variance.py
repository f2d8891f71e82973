"""The reference's section-9 variance experiments (README.md:314-316, 392)
on the port: JAX tests/test_variance.py with the port's ``render_rays`` on
the CPU. Veach MIS at 48x27, depth 6: per-pixel sample variance over K
independent 1-spp renders, with JAX's clips, K and inequalities. Both
cases are marked slow, as JAX's are: 83-86 s and 120-135 s on one CPU
thread (24 and 32 renders of 1,296 rays). Measured: variance brdf 9.61,
split 6.01, mis 6.95; uniform-area 126.1, spherical-triangle 68.4 (JAX's
comment at tests/test_variance.py:87: 68 vs 126)."""

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)


def _variance(veach_scene, cfg, seeds, clip):
    """Mean per-pixel variance of the clipped 1-spp renders keyed by
    ``key(seed)`` for each seed (JAX renders with ``jax.random.key(seed)``
    as the render_rays key)."""
    ts = scene_from_arrays(scene_arrays(veach_scene), 48, 27, device="cpu")
    ro, rd = generate_rays(ts.camera, torch.arange(48 * 27))
    imgs = np.stack([render_rays(ts, cfg, rng.base_key(s), ro, rd).numpy() for s in seeds])
    return float(np.clip(imgs, 0.0, clip).var(axis=0).mean())


@pytest.mark.slow
def test_estimator_variance_ordering(veach_scene):
    """BRDF-only has the highest variance on the crop (floor and plates);
    MIS stays within 1.5x of the split estimator's (the balance heuristic's
    bound, Veach '95 Thm. 9.2). K = 8, clip 50 (fireflies)."""
    var = {est: _variance(veach_scene, RenderConfig(spp=1, estimator=est, max_depth=6, seed=0,
                                                    light_sampler="spherical_triangle"),
                          range(100, 108), 50.0)
           for est in ("brdf", "split", "mis")}
    assert var["mis"] < var["brdf"], var
    assert var["split"] < var["brdf"], var
    assert var["mis"] < 1.5 * var["split"], var


@pytest.mark.slow
def test_light_sampler_variance_ordering(veach_scene):
    """Arvo spherical-triangle sampling has lower variance than uniform-area
    sampling (split estimator, K = 16, clip 1e3: the tail is the noise the
    reference's comparison shows)."""
    var = {ls: _variance(veach_scene, RenderConfig(spp=1, estimator="split", light_sampler=ls,
                                                   max_depth=6, seed=0),
                         range(200, 216), 1e3)
           for ls in ("uniform_area", "spherical_triangle")}
    assert var["spherical_triangle"] < 0.8 * var["uniform_area"], var
