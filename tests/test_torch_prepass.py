"""The primary-hit cache: the port's ``primary_prepass``, its seeded loop
and ``render_regen_cached`` (integrator/regen.py) against the JAX
package's, and the cache's own contract — the same estimate and streams as
the uncached loop (the port of tests/test_primary_cache.py).

Tolerances. Both packages draw the same threefry streams, so the prepass
agrees decision for decision: equal primary hits, seed counts, seed sample
ids and ray counts. Floats differ by f32 rounding (XLA contracts
multiply-adds, the port rounds every op), which Phong exponents up to 1e3
amplify: seed directions to 1e-5, throughputs and pdfs to 1e-2 relative;
depth-0 radiance beyond rtol 1e-2 / atol 1e-3 on no pixel. Renders: as
tests/test_torch_regen.py (rays to 0.5%, at most 1% of pixels diverged,
means to 1e-3). Cached against uncached inside the port: rays equal,
images to rtol / atol 1e-5 (the framebuffer sums the depth-0 terms in
another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.integrator import regen as jregen
from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen as jax_render
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

ESTIMATORS = [(e, s) for e in ("mis", "brdf", "split")
              for s in ("spherical_triangle", "uniform_area")]


def _pair(jax_scene, w, h):
    js = dataclasses.replace(jax_scene, camera=dataclasses.replace(
        jax_scene.camera, width=w, height=h))
    return js, scene_from_arrays(scene_arrays(jax_scene), w, h, device="cpu")


def _kw(w, h, **kw):
    base = dict(width=w, height=h, spp=4, estimator="mis",
                light_sampler="spherical_triangle", max_depth=16, seed=7)
    base.update(kw)
    return base


def seed_mode_from_jax(out):
    """JAX ``primary_prepass`` outputs -> (the port's SeedMode, seed count)."""
    fb_pre, cache_f, cache_tri, seeds_sample, seeds_f, seed_count, _, _ = out
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    rows = lambda xs: torch.stack([t(x) for x in xs], dim=1)  # noqa: E731
    return regen.SeedMode(
        sample=t(seeds_sample).long(), wi=rows(seeds_f[0:3]), tp=rows(seeds_f[3:6]),
        pdf=t(seeds_f[6]), cache_p=rows(cache_f[0:3]), cache_ns=rows(cache_f[3:6]),
        cache_wsum=t(cache_f[6]), cache_tri=t(cache_tri), fb_pre=t(fb_pre),
    ), int(seed_count)


def _image_gaps(a, b):
    fine = ~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    coarse = ~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)
    return int(fine.sum()), int(coarse.sum())


@pytest.mark.parametrize("name,w,h,est,sampler", [
    ("cornell", 24, 16, "mis", "spherical_triangle"),
    ("veach", 16, 16, "mis", "spherical_triangle"),
    ("veach", 16, 16, "split", "uniform_area"),
    ("cornell", 24, 16, "mis", "uniform_area"),
])
def test_prepass_matches_jax(request, name, w, h, est, sampler):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), w, h)
    kw = _kw(w, h, estimator=est, light_sampler=sampler)
    n = w * h
    fb_pre, cache_f, cache_tri, ss, sf, count, n_log, n_phys = jregen.primary_prepass(
        js, JaxConfig(**kw), jrng.base_key(7), n, 4, jnp.int32(4))
    seeds, count_t, n_log_t, n_phys_t = regen.primary_prepass(
        ts, RenderConfig(**kw), rng.base_key(7), n, 4, 4)
    assert count_t == int(count) > 0
    assert (n_log_t, n_phys_t) == (int(n_log), int(n_phys))
    np.testing.assert_array_equal(seeds.cache_tri.numpy(), np.asarray(cache_tri))
    k = count_t
    np.testing.assert_array_equal(seeds.sample[:k].numpy(), np.asarray(ss)[:k])
    np.testing.assert_allclose(seeds.wi[:k].numpy(),
                               np.stack([np.asarray(x) for x in sf[0:3]], 1)[:k], atol=1e-5)
    np.testing.assert_allclose(seeds.tp[:k].numpy(),
                               np.stack([np.asarray(x) for x in sf[3:6]], 1)[:k], rtol=1e-2)
    np.testing.assert_allclose(seeds.pdf[:k].numpy(), np.asarray(sf[6])[:k], rtol=1e-2)
    np.testing.assert_allclose(seeds.cache_p.numpy(),
                               np.stack([np.asarray(x) for x in cache_f[0:3]], 1), atol=1e-5)
    np.testing.assert_allclose(seeds.cache_wsum.numpy(), np.asarray(cache_f[6]), rtol=1e-3)
    fine, coarse = _image_gaps(np.asarray(fb_pre), seeds.fb_pre.numpy())
    print(f"{name} {est}: {fine} of {n} pixels of fb_pre beyond rtol 1e-4")
    assert coarse == 0


def test_seeded_loop_takes_jax_seeds(veach_scene):
    """JAX's prepass outputs handed to the port's seeded render_regen give
    JAX's seeded loop result."""
    js, ts = _pair(veach_scene, 16, 16)
    kw = _kw(16, 16)
    out = jregen.primary_prepass(js, JaxConfig(**kw), jrng.base_key(7), 256, 4, jnp.int32(4))
    fb_j, rays_j, _, _ = jregen.render_regen(
        js, JaxConfig(**kw), jrng.base_key(7), 256, out[5], lanes=64,
        seed_mode=(out[3], out[4], out[1], out[2], out[0]))
    seeds, count = seed_mode_from_jax(out)
    fb_t, rays_t, _, _ = regen.render_regen(ts, RenderConfig(**kw), rng.base_key(7), 256, count,
                                            lanes=64, seed_mode=seeds)
    assert abs(int(rays_t) - float(rays_j)) <= 0.005 * float(rays_j)
    a, b = np.asarray(fb_j), fb_t.numpy()
    fine, coarse = _image_gaps(a, b)
    print(f"seeded loop: rays {float(rays_j)} vs {int(rays_t)}; {fine} pixels beyond rtol 1e-4")
    assert coarse <= max(2, 256 // 100)
    assert abs(b.mean() / a.mean() - 1.0) < 1e-3


@pytest.mark.parametrize("est,sampler", ESTIMATORS)
def test_cached_matches_uncached(cornell_scene, est, sampler):
    """Same streams by construction: the same estimate (up to the order of
    the per-pixel sums) and the same logical ray count."""
    _, ts = _pair(cornell_scene, 24, 16)
    cfg = RenderConfig(**_kw(24, 16, estimator=est, light_sampler=sampler))
    un = render_image_regen(ts, cfg.replace(primary_cache=False), lanes=64)
    ca = render_image_regen(ts, cfg.replace(primary_cache=True), lanes=64)
    np.testing.assert_allclose(ca.image, un.image, rtol=1e-5, atol=1e-5)
    assert ca.rays_traced == un.rays_traced


def test_cached_launch_split_and_lane_invariance(cornell_scene):
    """Each launch re-runs the prepass with spp0 riding in: the image does
    not depend on the launch split or the lane count."""
    _, ts = _pair(cornell_scene, 24, 16)
    cfg = RenderConfig(**_kw(24, 16)).replace(primary_cache=True)
    one = render_image_regen(ts, cfg, lanes=64)
    split = render_image_regen(ts, cfg, lanes=256, max_samples_per_launch=2 * 24 * 16)
    assert split.rays_traced == one.rays_traced
    np.testing.assert_allclose(split.image, one.image, rtol=1e-5, atol=1e-5)


def test_spp_rounds_clamped_to_cap(cornell_scene):
    """Rounds beyond spp_cap (which sizes the seed buffer) are clamped:
    work and the logical ray count agree with a run at the cap."""
    _, ts = _pair(cornell_scene, 24, 16)
    cfg = RenderConfig(**_kw(24, 16))
    key = rng.base_key(0)
    cap = regen.primary_prepass(ts, cfg, key, 24 * 16, 2, 4)
    ref = regen.primary_prepass(ts, cfg, key, 24 * 16, 2, 2)
    torch.testing.assert_close(cap[0].fb_pre, ref[0].fb_pre, rtol=1e-6, atol=0.0)
    assert cap[1:] == ref[1:]
    assert cap[0].sample.shape[0] == 2 * 24 * 16 + 1


@pytest.mark.parametrize("name,w,h,est,sampler", [
    ("cornell", 24, 16, "mis", "spherical_triangle"),
    ("veach", 16, 16, "mis", "spherical_triangle"),
    ("cornell", 24, 16, "split", "uniform_area"),
    ("veach", 16, 16, "brdf", "spherical_triangle"),
    ("cornell", 24, 16, "mis", "uniform_area"),
])
def test_cached_render_matches_jax(request, name, w, h, est, sampler):
    """The port's render_image_regen against the JAX package's, both on
    their default route (the cache)."""
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), w, h)
    kw = _kw(w, h, estimator=est, light_sampler=sampler)
    a = jax_render(js, JaxConfig(**kw), lanes=64)
    b = render_image_regen(ts, RenderConfig(**kw), lanes=64)
    assert b.image.shape == (h, w, 3) and np.isfinite(b.image).all()
    assert abs(b.rays_traced - a.rays_traced) <= 0.005 * a.rays_traced
    fine, coarse = _image_gaps(a.image, b.image)
    print(f"{name} {est} {sampler}: rays {a.rays_traced} vs {b.rays_traced}; {fine} of "
          f"{w * h} pixels beyond rtol 1e-4, {coarse} diverged")
    assert coarse <= max(2, w * h // 100)
    assert abs(b.image.mean() / a.image.mean() - 1.0) < 1e-3


@pytest.mark.parametrize("change", [
    {}, dict(pixel_jitter=True), dict(estimator="split"), dict(estimator="brdf"),
    dict(light_sampler="uniform_area"), dict(primary_cache=False), dict(primary_cache=True),
    dict(ref_mis_weights=True, mis_blocker_compat=True),
])
def test_routes_to_the_cache_as_jax_does(cornell_scene, monkeypatch, change):
    """render_image_regen takes the cache exactly when JAX's does: the
    configuration's primary_cache, else primary_cache_eligible."""
    _, ts = _pair(cornell_scene, 8, 8)
    kw = dict(width=8, height=8, spp=1, seed=3, **change)
    jcfg = JaxConfig(**kw)
    want = (jcfg.primary_cache if jcfg.primary_cache is not None
            else jregen.primary_cache_eligible(jcfg))
    assert regen.primary_cache_eligible(RenderConfig(**kw)) == jregen.primary_cache_eligible(jcfg)
    calls = []
    real = regen.render_regen_cached
    monkeypatch.setattr(regen, "render_regen_cached",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if change.get("mis_blocker_compat"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render_image_regen(ts, RenderConfig(**kw), lanes=32)
    else:
        render_image_regen(ts, RenderConfig(**kw), lanes=32)
    assert bool(calls) == want


def test_prepass_uses_plain_versions_on_cpu(cornell_scene):
    _, ts = _pair(cornell_scene, 24, 16)
    counts = (intersect_cuda.nearest_hit_culled.launches, intersect_cuda.occluded_culled.launches)
    seeds, count, n_log, n_phys = regen.primary_prepass(
        ts, RenderConfig(**_kw(24, 16)), rng.base_key(1), 24 * 16, 2, 2)
    assert 0 < count <= 2 * 24 * 16 and n_log > n_phys > 24 * 16
    assert (seeds.fb_pre >= 0).all() and seeds.fb_pre.shape == (24 * 16, 3)
    assert counts == (intersect_cuda.nearest_hit_culled.launches,
                      intersect_cuda.occluded_culled.launches)
