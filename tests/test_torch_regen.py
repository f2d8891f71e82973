"""The port's uncached regeneration render (render/renderer.py::
render_image_regen with primary_cache=False -> integrator/regen.py) against
the JAX package's on the CPU, plus its stream invariances. The cached
render (the default route): tests/test_torch_prepass.py.

Tolerance. Both packages consume the same threefry streams, so the images
agree path for path up to f32 rounding — except that XLA on the CPU fuses
multiply-adds (and its rounding depends on how it compiled the program),
where the port rounds every op. A ulp-level difference occasionally flips a
discrete decision on a boundary (a grazing accept, a CDF step), and that
path then diverges. So: logical ray counts agree to 0.5%; pixels beyond
JAX's own rtol 1e-4 / atol 1e-5 are counted and reported; at most 1% of
pixels (and at least 2 allowed) may differ beyond rtol 1e-2 / atol 1e-3;
and the image means agree to 1e-3."""

import dataclasses

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen as jax_render
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)


def _pair(jax_scene, wh):
    """The same scene for both packages (the JAX leaves handed across)."""
    js = dataclasses.replace(jax_scene, camera=dataclasses.replace(
        jax_scene.camera, width=wh, height=wh))
    return js, scene_from_arrays(scene_arrays(jax_scene), wh, wh, device="cpu")


def _compare(a, b):
    """(pixels beyond JAX's rtol 1e-4 / atol 1e-5, pixels diverged beyond
    rtol 1e-2 / atol 1e-3)."""
    fine = ~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    coarse = ~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)
    return int(fine.sum()), int(coarse.sum())


@pytest.mark.parametrize("name,wh,depth,jitter", [
    ("cornell", 24, 32, False), ("veach", 16, 16, False), ("cornell", 24, 32, True),
])
def test_regen_matches_jax(request, name, wh, depth, jitter):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), wh)
    kw = dict(width=wh, height=wh, spp=2, estimator="mis",
              light_sampler="spherical_triangle", max_depth=depth, seed=11,
              pixel_jitter=jitter, primary_cache=False)
    a = jax_render(js, JaxConfig(**kw), lanes=512)
    b = render_image_regen(ts, RenderConfig(**kw), lanes=512)
    assert b.image.shape == (wh, wh, 3) and np.isfinite(b.image).all()
    assert abs(b.rays_traced - a.rays_traced) <= 0.005 * a.rays_traced, (a.rays_traced,
                                                                           b.rays_traced)
    fine, diverged = _compare(a.image, b.image)
    print(f"{name}: rays {a.rays_traced} vs {b.rays_traced}; {fine} of {wh * wh} pixels "
          f"beyond rtol 1e-4, {diverged} diverged")
    assert diverged <= max(2, wh * wh // 100)
    assert abs(b.image.mean() / a.image.mean() - 1.0) < 1e-3


def test_regen_lane_count_invariance(cornell_scene):
    """Streams are keyed by (spp, pixel, depth, purpose), not by lane: the
    port's image is the same at 256 and 2048 lanes (the framebuffer sums
    paths in another order: f32 round-off)."""
    _, ts = _pair(cornell_scene, 24)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator="mis", seed=5, max_depth=32,
                       primary_cache=False)
    a = render_image_regen(ts, cfg, lanes=256)
    b = render_image_regen(ts, cfg, lanes=2048)
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(a.image, b.image, rtol=1e-5, atol=1e-6)


def test_regen_launch_split_invariance(cornell_scene):
    """One spp per launch (spp0 carried across launches) gives the image
    of a single launch."""
    _, ts = _pair(cornell_scene, 24)
    cfg = RenderConfig(width=24, height=24, spp=3, estimator="mis", seed=7, max_depth=32,
                       primary_cache=False)
    seen = []
    a = render_image_regen(ts, cfg, lanes=512)
    b = render_image_regen(ts, cfg, lanes=512, max_samples_per_launch=24 * 24,
                           on_launch=lambda img, done: seen.append(done))
    assert seen == [1, 2, 3]
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(a.image, b.image, rtol=1e-5, atol=1e-6)


def test_render_regen_returns_sums_and_uses_plain_versions_on_cpu(cornell_scene):
    _, ts = _pair(cornell_scene, 8)
    cfg = RenderConfig(width=8, height=8, spp=1, estimator="mis", seed=1)
    counts = (intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches,
              arvo_cuda.arvo_select.launches)
    fb, nrays, iters, stats = regen.render_regen(ts, cfg, rng.base_key(1), 64, 64, lanes=32)
    assert fb.shape == (64, 3) and fb.dtype == torch.float32 and (fb >= 0).all()
    assert int(nrays) >= 64 and iters >= 2 and stats.spilled == 0
    assert counts == (intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches,
                      arvo_cuda.arvo_select.launches)


@pytest.mark.parametrize("change", [
    dict(ref_mis_weights=True), dict(ref_mis_weights=True, mis_blocker_compat=True),
    dict(ray_sort_every=2), dict(accel="grid"),
])
def test_unported_options_raise(cornell_scene, change):
    """One case per option the loop once refused. ``ray_sort_every > 1``
    still raises (ROADMAP queue 1, "Do not port"); ref_mis_weights, the
    blocker queue and accel="grid" (all pairs in the loop, as in JAX) now
    run, each held against JAX's render at this module's bounds."""
    js, ts = _pair(cornell_scene, 8)
    kw = dict(width=8, height=8, spp=1, seed=3, **change)
    if change.get("ray_sort_every"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render_image_regen(ts, RenderConfig(**kw), lanes=32)
        return
    a = jax_render(js, JaxConfig(**kw), lanes=32)
    b = render_image_regen(ts, RenderConfig(**kw), lanes=32)
    assert np.isfinite(b.image).all()
    assert abs(b.rays_traced - a.rays_traced) <= 0.005 * a.rays_traced
    assert _compare(a.image, b.image)[1] <= 2
    assert abs(b.image.mean() / a.image.mean() - 1.0) < 1e-3
