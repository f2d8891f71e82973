"""The port's uniform grid (ops/grid.py, C10 / C12) against the JAX
package's on the CPU: JAX tests/test_grid.py's cases, each also held
against JAX's ``build_grid`` / ``intersect_grid``, then renders with
``accel="grid"``.

Tolerances. The build is the same numpy code: arrays equal. The DDA runs
the same f32 steps, so hits are compared id for id against JAX's (equal
on all rays measured; bound 0.5%, the Moller-Trumbore dots may round
differently), and t to rtol / atol 1e-4 on equal ids. Against the
all-pairs trace the bounds are JAX's own test's. Renders: JAX
test_grid.py:134's bounds (98.5% of values within rtol / atol 1e-3,
means to 5e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.ops import grid as jgrid
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff.grad import pixel_grad
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.ops import grid as tgrid
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import NO_HIT
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image, render_image_regen
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _pair


def _random_rays(scene, n, seed, spread=1.0):
    """Rays from jittered points near the camera toward the geometry (JAX
    test_grid.py's helper), as numpy."""
    g = np.random.default_rng(seed)
    v0 = scene.tri_v0.numpy()
    lo, hi = v0.min(0), v0.max(0)
    ro = scene.camera.eye.numpy()[None, :] + g.normal(scale=spread, size=(n, 3)).astype(np.float32)
    rd = g.uniform(lo, hi, size=(n, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _both(jg, tg, ro, rd, excl=None):
    """(JAX hit, port hit) of the same rays."""
    hj = jgrid.intersect_grid(jg, jnp.asarray(ro), jnp.asarray(rd),
                              None if excl is None else jnp.asarray(excl))
    ht = tgrid.intersect_grid(tg, torch.as_tensor(ro), torch.as_tensor(rd),
                              None if excl is None else torch.as_tensor(excl))
    return hj, ht


def _same_as_jax(hj, ht):
    ids = np.asarray(hj.tri_id)
    same = ids == ht.tri_id.numpy()
    assert same.mean() >= 0.995, same.mean()
    np.testing.assert_allclose(ht.t.numpy()[same], np.asarray(hj.t)[same], rtol=1e-4, atol=1e-4)
    return same


@pytest.mark.parametrize("name,n0", [("cornell", 5000), ("veach", 100_000)])
def test_grid_build_equals_jax(request, name, n0):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), 8)
    a, b = jgrid.build_grid(js, n0=n0), tgrid.build_grid(ts, n0=n0)
    assert a.dims == b.dims
    for f in ("cell_start", "cell_tris", "bmin"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy(), f)
    assert float(a.cell_w) == b.cell_w and float(a.inv_w) == b.inv_w
    # JAX test_grid_build_invariants on the port's arrays.
    nx, ny, nz = b.dims
    start, tris = b.cell_start.numpy(), b.cell_tris.numpy()
    assert start.shape == (nx * ny * nz + 1,) and start[0] == 0 and start[-1] == tris.shape[0]
    assert np.all(np.diff(start) >= 0)
    assert set(np.unique(tris)) == set(range(ts.num_tris))


@pytest.mark.parametrize("name,n0,seed,spread", [("cornell", 5000, 0, 50.0),
                                                 ("veach", 100_000, 1, 2.0)])
def test_grid_matches_jax_and_all_pairs(request, name, n0, seed, spread):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), 8)
    jg, tg = jgrid.build_grid(js, n0=n0), tgrid.build_grid(ts, n0=n0)
    ro, rd = _random_rays(ts, 512, seed, spread)
    hj, ht = _both(jg, tg, ro, rd)
    _same_as_jax(hj, ht)
    hb = ops_intersect.intersect(ops_intersect.build_accel(ts), torch.as_tensor(ro),
                                 torch.as_tensor(rd))
    agree = (ht.valid == hb.valid).float().mean()
    assert agree > 0.995
    both = ht.valid & hb.valid
    assert float((ht.tri_id[both] == hb.tri_id[both]).float().mean()) > 0.99
    np.testing.assert_allclose(ht.t[both].numpy(), hb.t[both].numpy(), rtol=1e-3, atol=1e-3)


def test_grid_outside_origin_entry(cornell_scene):
    """Rays starting far outside the AABB enter the grid (the slab clamp),
    and the camera-seeded AABB (quirk Q7) builds and hits as JAX's."""
    js, ts = _pair(cornell_scene, 8)
    tg = tgrid.build_grid(ts, n0=5000)
    v0 = ts.tri_v0.numpy()
    center = (v0.min(0) + v0.max(0)) / 2.0
    ro = np.tile(center + np.array([0.0, 0.0, -10000.0], np.float32), (8, 1)).astype(np.float32)
    rd = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (8, 1))
    hb = ops_intersect.intersect(ops_intersect.build_accel(ts), torch.as_tensor(ro),
                                 torch.as_tensor(rd))
    _, ht = _both(jgrid.build_grid(js, n0=5000), tg, ro, rd)
    assert torch.equal(ht.valid, hb.valid)
    np.testing.assert_allclose(ht.t.numpy(), hb.t.numpy(), rtol=1e-4, atol=1e-2)
    jg2 = jgrid.build_grid(js, n0=5000, include_point=ro[0])
    tg2 = tgrid.build_grid(ts, n0=5000, include_point=ro[0])
    assert jg2.dims == tg2.dims
    hj2, ht2 = _both(jg2, tg2, ro, rd)
    assert torch.equal(ht2.valid, hb.valid)
    _same_as_jax(hj2, ht2)


def test_grid_exclusion_and_miss(cornell_scene):
    js, ts = _pair(cornell_scene, 8)
    jg, tg = jgrid.build_grid(js, n0=5000), tgrid.build_grid(ts, n0=5000)
    ro, rd = _random_rays(ts, 64, 2, 50.0)
    h1 = tgrid.intersect_grid(tg, torch.as_tensor(ro), torch.as_tensor(rd))
    hj2, h2 = _both(jg, tg, ro, rd, excl=h1.tri_id.numpy())
    _same_as_jax(hj2, h2)
    both = h1.valid & h2.valid
    assert (h1.tri_id[both] != h2.tri_id[both]).all()
    away = tgrid.intersect_grid(tg, torch.as_tensor(ro + 1e4),
                                torch.tensor([0.0, 0.0, 1.0]).expand(64, 3).contiguous())
    assert not away.valid.any() and (away.tri_id == NO_HIT).all()


def test_grid_lights_only(veach_scene):
    """The lights-only grid (C12) against the lights-only accel and JAX's."""
    js, ts = _pair(veach_scene, 8)
    jg = jgrid.build_grid(js, n0=100_000, lights_only=True)
    tg = tgrid.build_grid(ts, n0=100_000, lights_only=True)
    assert set(np.unique(tg.cell_tris.numpy())) == set(ts.light_tri_ids.tolist())
    ro, rd = _random_rays(ts, 256, 3, 2.0)
    hj, ht = _both(jg, tg, ro, rd)
    _same_as_jax(hj, ht)
    hb = ops_intersect.intersect(ops_intersect.build_light_accel(ts), torch.as_tensor(ro),
                                 torch.as_tensor(rd))
    assert float((ht.valid == hb.valid).float().mean()) > 0.995
    both = ht.valid & hb.valid
    assert float((ht.tri_id[both] == hb.tri_id[both]).float().mean()) > 0.99


def test_render_with_grid_matches_all_pairs(cornell_scene):
    """JAX test_grid.py:134 on the port: render_image with accel="grid"
    (the grid built once per render) reproduces the all-pairs render."""
    _, ts = _pair(cornell_scene, 24)
    base = dict(width=24, height=24, spp=2, estimator="mis", max_depth=4, ray_chunk=576, seed=5)
    img_bf = render_image(ts, RenderConfig(**base)).image
    img_g = render_image(ts, RenderConfig(**base, accel="grid", grid_n0=5000)).image
    assert np.isfinite(img_g).all()
    assert np.isclose(img_g, img_bf, rtol=1e-3, atol=1e-3).mean() > 0.985
    np.testing.assert_allclose(img_g.mean(), img_bf.mean(), rtol=5e-3)


def test_render_rays_builds_the_grid_and_refuses_gradients(cornell_scene):
    """render_rays with accel="grid" and no accel builds the grid (radiance
    equal to an injected one's); a gradient through it raises, as JAX's
    reverse mode refuses the DDA's while_loop."""
    _, ts = _pair(cornell_scene, 8)
    idx = torch.arange(64)
    ro, rd = generate_rays(ts.camera, idx)
    key = rng.lane_keys(rng.base_key(1), idx)
    cfg = RenderConfig(max_depth=3, accel="grid", grid_n0=5000)
    a = render_rays(ts, cfg, key, ro, rd)
    b = render_rays(ts, cfg, key, ro, rd, accel=tgrid.build_grid(ts, n0=5000))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="grid"):
        pixel_grad(ts, cfg, key, ro, rd, torch.ones(64, 3))


def test_regen_with_grid_runs_all_pairs(cornell_scene):
    """The regen loop takes accel="grid" and runs all pairs, as JAX's does:
    the image equals accel="all_pairs"'s, cached and uncached."""
    _, ts = _pair(cornell_scene, 16)
    for cached in (True, False):
        base = dict(width=16, height=16, spp=2, max_depth=8, seed=3, primary_cache=cached)
        a = render_image_regen(ts, RenderConfig(**base, accel="all_pairs"), lanes=128)
        b = render_image_regen(ts, RenderConfig(**base, accel="grid"), lanes=128)
        assert a.rays_traced == b.rays_traced
        np.testing.assert_array_equal(a.image, b.image)
