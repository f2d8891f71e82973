"""The port's camera (render/camera.py) and fixed-depth render driver
(render/renderer.py::render_image) against the JAX package and its golden
image on the CPU, the port's regeneration render against its fixed-depth
render, and render_image_regen's warm-up launch.

Golden. JAX pins tests/golden/cornell16_mis.npy at rtol 1e-5 / atol 1e-6.
XLA on the CPU fuses multiply-adds where the port rounds every op, so the
port reaches every pixel within rtol 1e-4 / atol 1e-5 (largest gap 2.0e-5
of radiance ~0.5), with a fringe of 5 of the 256 pixels beyond JAX's rtol
1e-5 / atol 1e-6; the test bounds that fringe at 5% of the pixels.
"""

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.render import camera as jcam
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen, render_rays
from monte_carlo_path_tracing_tpu_torch.render import camera as tcam
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image, render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell16_mis.npy")


def _pair(jax_scene, wh, fov_bug_compat=False):
    """The same scene for both packages (the JAX leaves handed across)."""
    js = dataclasses.replace(jax_scene, camera=dataclasses.replace(
        jax_scene.camera, width=wh, height=wh, fov_bug_compat=fov_bug_compat))
    return js, scene_from_arrays(scene_arrays(jax_scene), wh, wh, fov_bug_compat,
                                 device="cpu")


@pytest.mark.parametrize("jitter,fov_bug_compat", [(False, False), (True, False),
                                                   (False, True)])
def test_generate_rays_matches_jax(cornell_scene, jitter, fov_bug_compat):
    js, ts = _pair(cornell_scene, 24, fov_bug_compat)
    idx = np.arange(24 * 24, dtype=np.int32)
    jkey = tkey = None
    if jitter:
        jlane = jrng.lane_keys(jrng.sample_key(jrng.base_key(3), 1), jnp.asarray(idx))
        tlane = rng.lane_keys(rng.sample_key(rng.base_key(3), 1), torch.as_tensor(idx).long())
        jkey = jrng.bounce_key(jlane, 0, jrng.P_PIXEL_JITTER)
        tkey = rng.bounce_key(tlane, 0, rng.P_PIXEL_JITTER)
    jro, jrd = jcam.generate_rays(js.camera, jnp.asarray(idx), jitter_key=jkey)
    tro, trd = tcam.generate_rays(ts.camera, torch.as_tensor(idx).long(), jitter_key=tkey)
    np.testing.assert_allclose(tro.numpy(), np.asarray(jro), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trd.numpy(), np.asarray(jrd), rtol=1e-5, atol=1e-6)
    if jitter:   # the jitter moved the rays off the pixel centres
        assert not np.allclose(trd.numpy(), tcam.generate_rays(
            ts.camera, torch.as_tensor(idx).long())[1].numpy(), atol=1e-4)


def test_push_back_camera_matches_jax(cornell_scene):
    js, ts = _pair(cornell_scene, 8)
    a, b = jcam.push_back_camera(js.camera, 2.0), tcam.push_back_camera(ts.camera, 2.0)
    np.testing.assert_allclose(b.eye.numpy(), np.asarray(a.eye), rtol=1e-6)
    np.testing.assert_array_equal(b.lookat.numpy(), np.asarray(a.lookat))
    w1 = (ts.camera.lookat - ts.camera.eye).numpy()
    np.testing.assert_allclose((b.lookat - b.eye).numpy(), 2.0 * w1, rtol=1e-6)


def test_render_image_matches_golden(cornell_scene):
    """The JAX package's exact-stream golden (tests/test_render.py), within
    the tolerance of the module docstring."""
    _, ts = _pair(cornell_scene, 16)
    cfg = RenderConfig(width=16, height=16, spp=2, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=4, seed=123, ray_chunk=256)
    r = render_image(ts, cfg)
    golden = np.load(GOLDEN)
    assert r.image.shape == golden.shape and r.rays_traced == 2 * 256 and r.spp_done == 2
    fringe = int((~np.isclose(r.image, golden, rtol=1e-5, atol=1e-6).all(-1)).sum())
    print(f"golden: {fringe} of 256 pixels beyond rtol 1e-5 / atol 1e-6, max abs gap "
          f"{np.abs(r.image - golden).max():.3g}")
    np.testing.assert_allclose(r.image, golden, rtol=1e-4, atol=1e-5)
    assert fringe <= 256 // 20


def test_chunk_invariance(cornell_scene):
    """Streams are keyed by (sample, pixel): the image does not depend on
    ray_chunk, including a padded last chunk (576 = 4 x 128 + 64)."""
    _, ts = _pair(cornell_scene, 24)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=8, seed=42, ray_chunk=576)
    a = render_image(ts, cfg).image
    b = render_image(ts, cfg.replace(ray_chunk=128)).image
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_resume_from_framebuffer(cornell_scene):
    """2 spp, then the remaining 2 resumed from start_spp=2 and the summed
    framebuffer, give the 4 spp render; progress fires per sample."""
    _, ts = _pair(cornell_scene, 16)
    cfg = RenderConfig(width=16, height=16, spp=4, estimator="mis", seed=4, max_depth=4,
                       ray_chunk=256)
    full = render_image(ts, cfg).image
    half = render_image(ts, cfg.replace(spp=2))
    seen = []
    resumed = render_image(ts, cfg, start_spp=2, framebuffer=half.image * 2,
                           progress=lambda s, n: seen.append((s, n)))
    assert seen == [(3, 4), (4, 4)]
    assert resumed.rays_traced == 2 * 256 and resumed.spp_done == 4
    np.testing.assert_allclose(resumed.image, full, rtol=1e-5, atol=1e-6)


def test_estimator_consistency(cornell_scene):
    """brdf, split (both samplers) and mis (both samplers) are five
    estimators of one integral: their image means agree within the JAX
    test's 12% (tests/test_integrator.py), here at 16^2 x 32 spp (measured
    spread 4.9%). All 32 samples of every pixel go through render_rays as
    one batch with render_image's lane keys (the streams render_image
    would draw, chunk invariance being tested above): one call instead of
    32 small ones, which on the CPU take twice as long."""
    _, ts = _pair(cornell_scene, 16)
    spp = 32
    pix = torch.arange(256).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(256)
    keys = rng.lane_keys(rng.sample_key(rng.base_key(5), sample), pix)
    ro, rd = tcam.generate_rays(ts.camera, pix)
    means = {}
    for est, sampler in [("brdf", "spherical_triangle"), ("split", "uniform_area"),
                         ("split", "spherical_triangle"), ("mis", "uniform_area"),
                         ("mis", "spherical_triangle")]:
        cfg = RenderConfig(width=16, height=16, spp=spp, max_depth=8, seed=5, estimator=est,
                           light_sampler=sampler)
        rad = render_rays(ts, cfg, keys, ro, rd)
        assert bool(torch.isfinite(rad).all()), (est, sampler)
        means[(est, sampler)] = float(rad.mean())
    vals = np.asarray(list(means.values()))
    assert vals.max() / vals.min() < 1.12, means


@pytest.mark.parametrize("estimator", ["brdf", "split", "mis"])
def test_regen_matches_fixed_depth(cornell_scene, estimator):
    """The port's regeneration render and its fixed-depth render consume the
    same streams, so at depth 32 (no path reaches it) they give the same
    image to f32 round-off (JAX: tests/test_regen.py, rtol 1e-4)."""
    _, ts = _pair(cornell_scene, 24)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator=estimator,
                       light_sampler="spherical_triangle", max_depth=32, seed=11,
                       ray_chunk=24 * 24)
    a = render_image(ts, cfg).image
    b = render_image_regen(ts, cfg, lanes=512).image
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_render_image_regen_warm_up_is_outside_the_clock(cornell_scene, monkeypatch, cached):
    """render_image_regen runs one warm-up launch before its clock starts
    (0 spp rounds cached, min(lanes, total) samples uncached, as JAX's
    renderer does): the warm-up's time is not in ``seconds``, and the image
    is that of the render's own launch."""
    _, ts = _pair(cornell_scene, 12)
    cfg = RenderConfig(width=12, height=12, spp=2, estimator="mis", seed=3, max_depth=32,
                       primary_cache=cached)
    name = "render_regen_cached" if cached else "render_regen"
    real = getattr(regen, name)
    calls = []

    def spy(*a, **kw):
        calls.append(a[5] if cached else a[4])       # spp rounds / samples
        if len(calls) == 1:
            time.sleep(0.5)
        return real(*a, **kw)

    monkeypatch.setattr(regen, name, spy)
    t0 = time.perf_counter()
    r = render_image_regen(ts, cfg, lanes=64)
    wall = time.perf_counter() - t0
    assert calls == ([0, 2] if cached else [64, 288])
    assert wall - r.seconds >= 0.5
    key = rng.base_key(3)
    if cached:
        fb = real(ts, cfg, key, 144, 2, 2, lanes=64)[0]
    else:
        fb = real(ts, cfg, key, 144, 288, lanes=64)[0]
    np.testing.assert_array_equal(r.image, (fb.numpy() / 2).reshape(12, 12, 3))
