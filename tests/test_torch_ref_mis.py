"""ref_mis_weights (quirk Q11, the reference's MIS denominator) in the port
against the JAX package on the CPU: the lights-only accel, the fixed-depth
wavefront, its gradients, the regeneration loop and the cached route.

Tolerances are those of tests/test_torch_wavefront.py and
tests/test_torch_regen.py, whose docstrings give the reasons: both
packages draw the same threefry streams, XLA contracts multiply-adds where
the port rounds every op, so a ulp can flip a discrete decision and a path
diverges. Fixed depth: rays to 0.5%, lanes beyond rtol 1e-4 / atol 1e-5
counted, at most 1% (at least 2) beyond rtol 1e-2 / atol 1e-3. Renders:
rays to 0.5%, at most 1% of pixels (at least 2) beyond rtol 1e-2 / atol
1e-3, image means to 1e-3. Gradients: cosine per material field at least
0.99999. The light accel: ids equal, W to f32 round-off (rtol / atol 1e-5,
as tests/test_torch_intersect.py holds build_accel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.diff import grad as jgrad
from monte_carlo_path_tracing_tpu.integrator import render_rays as jax_render_rays
from monte_carlo_path_tracing_tpu.ops import intersect as jintersect
from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen as jax_render
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.diff import grad as tgrad
from monte_carlo_path_tracing_tpu_torch.integrator import regen, render_rays
from monte_carlo_path_tracing_tpu_torch.ops import intersect as tintersect
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_regen import _compare
from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _chunk, _pair

SAMPLERS = ["spherical_triangle", "uniform_area"]


@pytest.mark.parametrize("name,n_lights", [("cornell", 2), ("veach", 320)])
def test_build_light_accel_matches_jax(request, name, n_lights):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), 8)
    a, b = jintersect.build_light_accel(js), tintersect.build_light_accel(ts)
    np.testing.assert_array_equal(np.asarray(a.tri_ids), b.tri_ids.numpy())
    np.testing.assert_allclose(np.asarray(a.W), b.W.numpy(), rtol=1e-5, atol=1e-5)
    W, ids = b.real_rows()
    assert b.num_tris == n_lights and W.shape[0] == n_lights
    assert set(ids.tolist()) == set(ts.light_tri_ids.tolist())


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("name", ["cornell", "veach"])
def test_render_rays_ref_mis_matches_jax(request, name, sampler):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), 16)
    kw = dict(spp=1, estimator="mis", light_sampler=sampler, max_depth=8, seed=0,
              ref_mis_weights=True)
    (jk, jro, jrd), (tk, tro, trd) = _chunk(js, ts, seed=5)
    la, sa = jax_render_rays(js, JaxConfig(**kw), jk, jro, jrd, with_stats=True)
    n1 = intersect_cuda.nearest_hit.launches
    lb, sb = render_rays(ts, RenderConfig(**kw), tk, tro, trd, with_stats=True)
    assert intersect_cuda.nearest_hit.launches == n1, "a kernel ran on CPU tensors"
    a, b = np.asarray(la), lb.numpy()
    assert b.shape == (256, 3) and np.isfinite(b).all() and int(sb["nonfinite"]) == 0
    ra, rb = int(sa["rays"]), int(sb["rays"])
    assert abs(rb - ra) <= 0.005 * ra, (ra, rb)
    fine, diverged = _compare(a, b)
    print(f"{name}/{sampler}: rays {ra} vs {rb}; {fine} of 256 lanes beyond rtol 1e-4, "
          f"{diverged} diverged")
    assert diverged <= max(2, 256 // 100)


def test_light_accel_trace_runs_per_bounce(cornell_scene, monkeypatch):
    """With ref_mis_weights every bounce traces the BRDF direction against
    the lights-only accel (global ids, the 2 light triangles), and without
    the flag never."""
    js, ts = _pair(cornell_scene, 8)
    _, (tk, tro, trd) = _chunk(js, ts, seed=1)
    seen = []
    real = tintersect.intersect

    def spy(accel, *a, **kw):
        seen.append(accel.num_tris if isinstance(accel, tintersect.TriAccel) else None)
        return real(accel, *a, **kw)

    monkeypatch.setattr(tintersect, "intersect", spy)
    kw = dict(estimator="mis", max_depth=3, seed=1)
    render_rays(ts, RenderConfig(**kw), tk, tro, trd)
    assert ts.num_lights not in seen
    seen.clear()
    render_rays(ts, RenderConfig(ref_mis_weights=True, **kw), tk, tro, trd)
    assert seen.count(ts.num_lights) == seen.count(ts.num_tris) >= 1


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_pixel_grad_ref_mis_matches_jax(cornell_scene, sampler):
    """pixel_grad with the flag (its new detached denominator included)
    against JAX's: cosine >= 0.99999 per material field."""
    js, ts = _pair(cornell_scene, 16)
    kw = dict(spp=1, estimator="mis", light_sampler=sampler, max_depth=4, seed=0,
              ref_mis_weights=True)
    (jk, jro, jrd), (tk, tro, trd) = _chunk(js, ts, seed=3)
    sel = np.random.default_rng(0).uniform(0.0, 1.0, (tro.shape[0], 3)).astype(np.float32)
    gj = jgrad.pixel_grad(js, JaxConfig(**kw), jk, jro, jrd, jnp.asarray(sel))
    gt = tgrad.pixel_grad(ts, RenderConfig(**kw), tk, tro, trd, torch.as_tensor(sel))
    for field in ("kd", "ks", "ns", "emission"):
        a = np.asarray(getattr(gj, field), np.float64).ravel()
        b = getattr(gt, field).numpy().astype(np.float64).ravel()
        assert np.isfinite(b).all(), field
        na = np.linalg.norm(a)
        if na == 0.0:
            assert np.linalg.norm(b) == 0.0, field
            continue
        cos = float(a @ b / (na * np.linalg.norm(b)))
        print(f"{sampler} {field}: cosine {cos:.8f}")
        assert cos >= 0.99999, (field, cos)


@pytest.mark.parametrize("name,wh,sampler,cached", [
    ("cornell", 24, "spherical_triangle", False),
    ("veach", 16, "spherical_triangle", False),
    ("veach", 16, "spherical_triangle", True),
    ("cornell", 24, "uniform_area", True),
])
def test_regen_ref_mis_matches_jax(request, name, wh, sampler, cached):
    """The loop (JAX tests/test_regen.py:107) and the cached route (JAX
    tests/test_primary_cache.py:48) with the flag, against JAX's."""
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), wh)
    kw = dict(width=wh, height=wh, spp=2, estimator="mis", light_sampler=sampler,
              max_depth=16, seed=11, ref_mis_weights=True, primary_cache=cached)
    a = jax_render(js, JaxConfig(**kw), lanes=256)
    b = render_image_regen(ts, RenderConfig(**kw), lanes=256)
    assert np.isfinite(b.image).all() and b.image.mean() > 0
    assert abs(b.rays_traced - a.rays_traced) <= 0.005 * a.rays_traced
    fine, diverged = _compare(a.image, b.image)
    print(f"{name} {sampler} cached={cached}: rays {a.rays_traced} vs {b.rays_traced}; {fine} "
          f"of {wh * wh} pixels beyond rtol 1e-4, {diverged} diverged")
    assert diverged <= max(2, wh * wh // 100)
    assert abs(b.image.mean() / a.image.mean() - 1.0) < 1e-3


def test_ref_mis_takes_the_cache_and_matches_uncached(veach_scene, monkeypatch):
    """The flag alone keeps the render eligible for the primary cache (as
    in JAX), and the cached route gives the uncached estimate: rays equal,
    images to rtol / atol 1e-5 (tests/test_torch_prepass.py's bound)."""
    _, ts = _pair(veach_scene, 16)
    cfg = RenderConfig(width=16, height=16, spp=2, estimator="mis", max_depth=16, seed=2,
                       ref_mis_weights=True)
    assert regen.primary_cache_eligible(cfg)
    calls = []
    real = regen.render_regen_cached
    monkeypatch.setattr(regen, "render_regen_cached",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ca = render_image_regen(ts, cfg, lanes=128)
    assert calls
    un = render_image_regen(ts, cfg.replace(primary_cache=False), lanes=128)
    assert ca.rays_traced == un.rays_traced
    np.testing.assert_allclose(ca.image, un.image, rtol=1e-5, atol=1e-5)


def test_ref_mis_flag_changes_occluded_lights(veach_scene):
    """The reference's denominator differs from the balance heuristic only
    where the nearest light along a BRDF ray is occluded (otherwise
    1/(p_b + p_l) x 1 equals 1/p_b x p_b/(p_b + p_l)): the fixed-depth
    images of the two weightings agree in the mean to 2% (Veach, 16^2,
    2 spp) on the same streams."""
    _, ts = _pair(veach_scene, 16)
    from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image

    kw = dict(width=16, height=16, spp=2, estimator="mis", max_depth=8, seed=4)
    a = render_image(ts, RenderConfig(**kw)).image
    b = render_image(ts, RenderConfig(ref_mis_weights=True, **kw)).image
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-2)
