"""The plain reference against the port's CPU path at a tiny size: the same
streams give the same paths, so rays agree exactly and images to rounding.
(This test imports both; the reference itself imports nothing of the port.)

Cornell at 24x16 holds camera rays through pixel centres that meet the
edges of its axis-aligned box exactly, where two triangles give the same
t: the reference takes the one first in the Morton order of the JAX
package's accel, as the port does, so they agree there too."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer


@pytest.mark.parametrize("name,width,height,spp", [
    ("veach-mis", 16, 16, 2), ("bathroom", 8, 8, 2), ("cornell", 24, 16, 6),
], ids=["veach-mis-16", "bathroom-8", "cornell-24x16"])
def test_reference_agrees_with_the_ports_cpu_render(name, width, height, spp):
    from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene
    from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

    path = os.path.join(harness.ROOT, "scenes", name, name + ".obj")
    sc = load_scene(path, device="cpu")
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=width,
                                                            height=height))
    seed = 2**33 + 5
    cfg = RenderConfig(width=width, height=height, spp=spp, seed=seed)
    r = render_image_regen(sc, cfg, lanes=256)
    prog = r.image.reshape(-1, 3).astype(np.float64) * spp
    pixels = np.arange(width * height)
    conf = {"scene": f"scenes/{name}/{name}.obj", "width": width, "height": height,
            "rr_prob": 0.6}
    ref, rays = check.reference(conf, harness.ROOT, seed, list(range(spp)), pixels, "cpu")
    assert rays == r.rays_traced
    got = check.compare(prog, ref, r.rays_traced, rays)
    assert got["pixels_off_share"] == 0.0
    assert got["sum_gap"] < 1e-4
    assert got["rays_per_path_gap"] == 0.0
    # and so within the limits of the Veach configurations' check
    limits = harness.resolve("veach-1024-mis-batch").config["check"]["limits"]
    assert all(got[k] <= v for k, v in limits.items()), got


@pytest.mark.parametrize("name", ["cornell", "veach-mis", "bathroom"])
def test_the_reference_orders_triangles_as_the_ports_accel(name):
    """Ties between triangles go to the first in this order on both sides."""
    from monte_carlo_path_tracing_tpu_torch.ops import intersect
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene

    path = os.path.join(harness.ROOT, "scenes", name, name + ".obj")
    port = intersect.build_accel(load_scene(path, device="cpu"))
    ref = ref_scene.load(path)
    order = tracer.morton_order(ref.v0, ref.e1, ref.e2)
    assert torch.equal(order, port.tri_ids[:port.num_tris].long())


def test_reference_scene_matches_the_ports_loader():
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene

    path = os.path.join(harness.ROOT, "scenes", "veach-mis", "veach-mis.obj")
    port = load_scene(path, device="cpu")
    ref = ref_scene.load(path)
    torch.testing.assert_close(ref.v0, port.tri_v0)
    torch.testing.assert_close(ref.gn, port.geo_n)
    torch.testing.assert_close(ref.vn, port.tri_vn)
    assert torch.equal(ref.light_tri, port.light_tri_ids.long())
    torch.testing.assert_close(ref.emission[ref.light_tri], port.light_emission())
    assert (ref.width, ref.height) == (port.camera.width, port.camera.height)


def test_the_bfloat16_control_fails_the_check():
    conf = {"scene": "scenes/veach-mis/veach-mis.obj", "width": 16, "height": 16, "rr_prob": 0.6}
    pixels = np.arange(256)
    ref, rays = check.reference(conf, harness.ROOT, 11, [0, 1], pixels, "cpu")
    low, low_rays = check.reference(conf, harness.ROOT, 11, [0, 1], pixels, "cpu",
                                    torch.bfloat16)
    limits = harness.resolve("veach-1024-mis-batch").config["check"]["limits"]
    got = check.compare(low, ref, low_rays, rays)
    assert any(got[k] > v for k, v in limits.items())


def test_sample_pixels_is_one_per_run_and_follows_the_seed():
    a = check.sample_pixels(1000, 10, 2**40 + 1)
    assert np.array_equal(a, check.sample_pixels(1000, 10, 2**40 + 1))
    assert not np.array_equal(a, check.sample_pixels(1000, 10, 2**40 + 2))
    assert np.array_equal(a // 100, np.arange(10))
