"""accel="auto" in the port's regeneration loop against the JAX package:
the dispatch policy, the lane sort, and bathroom (29,596 triangles, inside
the sort + cull window) rendered by both packages on the CPU.

Tolerances are those of tests/test_torch_regen.py: the packages consume the
same streams, XLA on the CPU fuses multiply-adds where the port rounds every
op, so logical ray counts agree to 0.5%, at most 1% of pixels (at least 2)
may differ beyond rtol 1e-2 / atol 1e-3, and the image means agree to 1e-3.
The sort is a pure permutation of the lanes, so within the port sorted and
unsorted renders trace equal rays and their images differ only by the
framebuffer's summation order (rtol 1e-5). The port's sorted, culled loop
against its all-pairs loop on bathroom at full size is chip_smoke.py's
phase "auto cull"."""

import dataclasses
import os

import numpy as np
import pytest

from monte_carlo_path_tracing_tpu.ops.intersect import auto_policy as jax_auto_policy
from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen as jax_render
from monte_carlo_path_tracing_tpu.scene import load_scene as jax_load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.integrator import regen
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

BATHROOM = os.path.join(os.path.dirname(__file__), "..", "scenes", "bathroom", "bathroom.obj")


@pytest.mark.parametrize("num_tris", [3_136, 23_999, 24_000, 29_596, 100_000])
def test_auto_policy_matches_jax(num_tris):
    assert ops_intersect.auto_policy(num_tris) == jax_auto_policy(num_tris)


def _jax_sort_key(ro, rd, alive, lo, inv):
    """JAX regen.py sort_lanes' key, in numpy (f32 arithmetic, int32 casts
    of in-range values)."""
    def spread5(x):
        x = (x | (x << 8)) & 0x0100F
        x = (x | (x << 4)) & 0x010C3
        x = (x | (x << 2)) & 0x09249
        return x

    f = np.float32
    q = np.clip(((ro - lo) * inv * f(31.0)).astype(np.int32), 0, 31)
    morton = spread5(q[:, 0]) | (spread5(q[:, 1]) << 1) | (spread5(q[:, 2]) << 2)
    dq = np.clip(((rd * f(0.5) + f(0.5)) * f(7.0)).astype(np.int32), 0, 7)
    dkey = (dq[:, 0] << 6) | (dq[:, 1] << 3) | dq[:, 2]
    return np.where(alive, (dkey << 15) | morton, (1 << 24) - 1).astype(np.int32)


def test_lane_sort_key_and_permutation_match_jax(cornell_scene, monkeypatch):
    """On loop states recorded from a cornell render with ray_sort=True:
    the key equals JAX's formula bit for bit, the permutation is its stable
    argsort, and every lane array is permuted by it."""
    ts = scene_from_arrays(scene_arrays(cornell_scene), 12, 12, device="cpu")
    states = []
    orig = regen.sort_lanes

    def record(st, lo, inv):
        # The loop's state is its own buffers, written in place by the
        # iteration that sorts them: keep a copy.
        out = orig(st, lo, inv)
        states.append(({k: v.clone() for k, v in st.items()}, out, lo, inv))
        return out

    monkeypatch.setattr(regen, "sort_lanes", record)
    cfg = RenderConfig(width=12, height=12, spp=2, estimator="mis", max_depth=8, seed=3,
                       ray_sort=True, primary_cache=False)
    render_image_regen(ts, cfg, lanes=128)
    assert len(states) > 4
    n_dead = 0
    for st, out, lo, inv in states[1:]:
        alive = st["alive"].numpy()
        n_dead += int((~alive).sum())
        key = regen.lane_sort_key(st["ro"], st["rd"], st["alive"], lo, inv).numpy()
        want = _jax_sort_key(st["ro"].numpy(), st["rd"].numpy(), alive, lo.numpy(),
                             inv.numpy())
        np.testing.assert_array_equal(key, want)
        order = np.argsort(want, kind="stable")
        for k in regen.LANE_ARRAYS:
            np.testing.assert_array_equal(out[k].numpy(), st[k].numpy()[order], err_msg=k)
    assert n_dead > 0, "no recorded state had a dead lane"


@pytest.mark.parametrize("estimator", ["mis", "split"])
def test_ray_sort_changes_no_value(cornell_scene, estimator):
    """ray_sort=True against False (cornell, below the cull window: both
    trace all pairs): equal ray counts, images to the summation order."""
    ts = scene_from_arrays(scene_arrays(cornell_scene), 16, 16, device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=2, estimator=estimator, max_depth=16, seed=5)
    a = render_image_regen(ts, cfg, lanes=256)
    b = render_image_regen(ts, cfg.replace(ray_sort=True), lanes=256)
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(b.image, a.image, rtol=1e-5, atol=1e-6)


def test_ray_sort_every_raises(cornell_scene):
    ts = scene_from_arrays(scene_arrays(cornell_scene), 8, 8, device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=1, ray_sort=True, ray_sort_every=2)
    with pytest.raises(NotImplementedError, match="Do not port"):
        render_image_regen(ts, cfg, lanes=32)


@pytest.fixture(scope="module")
def bathroom():
    return jax_load_scene(BATHROOM)


def test_bathroom_auto_matches_jax(bathroom, monkeypatch):
    """Bathroom at 16x12, 1 spp, depth 3, 64 lanes with the default
    accel="auto" (tests/test_accel_auto.py's call): the port sorts the
    lanes and traces every loop ray through the plain culled versions,
    never the all-pairs ones, and lands on JAX's render."""
    assert ops_intersect.auto_policy(bathroom.num_tris)["cull"]
    js = dataclasses.replace(bathroom, camera=dataclasses.replace(bathroom.camera, width=16,
                                                                  height=12))
    ts = scene_from_arrays(scene_arrays(bathroom), 16, 12, device="cpu")
    kw = dict(width=16, height=12, spp=1, estimator="mis",
              light_sampler="spherical_triangle", max_depth=3, seed=0)
    calls = {"sort_lanes": 0, "nearest_hit_plain": 0, "occluded_plain": 0,
             "nearest_hit_culled_plain": 0, "occluded_culled_plain": 0}

    def counted(mod, name):
        orig = getattr(mod, name)

        def call(*a, **k):
            calls[name] += 1
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, call)

    counted(regen, "sort_lanes")
    for name in list(calls)[1:]:
        counted(intersect_cuda, name)
    a = jax_render(js, JaxConfig(**kw), lanes=64)
    b = render_image_regen(ts, RenderConfig(**kw), lanes=64)
    assert calls["nearest_hit_plain"] == calls["occluded_plain"] == 0, calls
    assert min(calls["sort_lanes"], calls["nearest_hit_culled_plain"],
               calls["occluded_culled_plain"]) > 0, calls
    assert b.image.shape == (12, 16, 3) and np.isfinite(b.image).all() and b.image.sum() > 0
    assert abs(b.rays_traced - a.rays_traced) <= 0.005 * a.rays_traced, (a.rays_traced,
                                                                           b.rays_traced)
    diverged = ~np.isclose(b.image, a.image, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)
    assert abs(b.image.mean() / a.image.mean() - 1.0) < 1e-3

