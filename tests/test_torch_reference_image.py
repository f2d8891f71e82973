"""The port's image path on cornell against the benchmark's plain reference
(``benchmark.check.reference``, benchmark/reference/tracer.py), on the CPU.

``render_image_regen`` on cornell 24x16 x 6 spp (MIS + Arvo, RR 0.6) and
the reference on every pixel, keyed by the same seed, trace the same
paths: 0 pixels off, the summed radiance within 1e-4 and the rays equal,
so within the limits of the ``image`` kind's Veach configurations (0.05 /
0.002 / 0.009). At 24x16 camera rays through pixel centres meet the edges
that cornell's floor and ceiling share with its walls at the same t from
both triangles; both sides take the triangle first in the Morton order of
the port's accel. This guards the scene's image path beside its gradient
path (tests/test_torch_inverse_reference.py)."""

import dataclasses
import os

import numpy as np
import pytest

from benchmark import check, harness
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("seed", [2**33 + 5, 11])
def test_cornell_render_matches_the_plain_reference(seed):
    width, height, spp = 24, 16, 6
    path = os.path.join(harness.ROOT, "scenes", "cornell", "cornell.obj")
    sc = load_scene(path, device="cpu")
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=width,
                                                            height=height))
    r = render_image_regen(sc, RenderConfig(width=width, height=height, spp=spp, seed=seed),
                           lanes=256)
    prog = r.image.reshape(-1, 3).astype(np.float64) * spp
    conf = {"scene": "scenes/cornell/cornell.obj", "width": width, "height": height,
            "rr_prob": 0.6}
    ref, rays = check.reference(conf, harness.ROOT, seed, list(range(spp)),
                                np.arange(width * height), "cpu")
    assert rays == r.rays_traced
    got = check.compare(prog, ref, r.rays_traced, rays)
    assert got["pixels_off_share"] == 0.0
    assert got["sum_gap"] < 1e-4
    assert got["rays_per_path_gap"] == 0.0
    limits = harness.resolve("veach-1024-mis-batch").config["check"]["limits"]
    assert all(got[k] <= v for k, v in limits.items()), got
