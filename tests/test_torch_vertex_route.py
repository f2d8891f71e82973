"""Which calls of shading.vertex take the fused MIS vertex
(ops/vertex_cuda.py), read on the CPU from shading.takes_fused, the
function of a call's inputs that shading.vertex decides by on CUDA
tensors.

Each case runs a real caller of the vertex at a tiny size (cornell, 8x8,
1 spp) and records, for every vertex call, what takes_fused says of it:
the regen loop's MIS / Arvo step (uncached and cached) would run fused on
the card, and every other caller stays on the torch math."""

import dataclasses
import os

import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff.grad import pixel_grad
from monte_carlo_path_tracing_tpu_torch.integrator import regen, render_rays, shading
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell", "cornell.obj")
WH = 8


@pytest.fixture(scope="module")
def scene():
    sc = load_scene(CORNELL, device="cpu")
    return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=WH, height=WH))


def _regen(sc, **kw):
    cfg = RenderConfig(width=WH, height=WH, spp=1, max_depth=8, seed=5, **kw)
    regen.render_regen(sc, cfg, rng.base_key(5), WH * WH, WH * WH, lanes=32)


def _cached(sc, **kw):
    cfg = RenderConfig(width=WH, height=WH, spp=2, max_depth=8, seed=5, **kw)
    regen.render_regen_cached(sc, cfg, rng.base_key(5), WH * WH, 2, 2, lanes=32)


def _rays(sc):
    idx = torch.arange(WH * WH)
    ro, rd = generate_rays(sc.camera, idx)
    return rng.lane_keys(rng.sample_key(rng.base_key(5), 0), idx), ro, rd


def _fixed_depth(sc):
    cfg = RenderConfig(width=WH, height=WH, spp=1, estimator="mis", max_depth=3, seed=5)
    render_rays(sc, cfg, *_rays(sc))


def _grad(sc):
    cfg = RenderConfig(width=WH, height=WH, spp=1, estimator="mis", max_depth=2, seed=5)
    key, ro, rd = _rays(sc)
    pixel_grad(sc, cfg, key, ro, rd, torch.ones(WH * WH, 3))


CASES = {
    "regen_mis_spherical": (lambda sc: _regen(sc, estimator="mis"), True),
    "regen_cached_mis_spherical": (lambda sc: _cached(sc, estimator="mis"), True),
    "fixed_depth_bounce": (_fixed_depth, False),
    "split": (lambda sc: _regen(sc, estimator="split"), False),
    "brdf_only": (lambda sc: _regen(sc, estimator="brdf"), False),
    "uniform_sampler": (lambda sc: _regen(sc, estimator="mis", light_sampler="uniform_area"),
                        False),
    "ref_mis_weights": (lambda sc: _regen(sc, estimator="mis", ref_mis_weights=True), False),
    "blocker": (lambda sc: _regen(sc, estimator="mis", ref_mis_weights=True,
                                  mis_blocker_compat=True), False),
    "requires_grad": (_grad, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_which_vertex_calls_fuse(scene, monkeypatch, case):
    run, want = CASES[case]
    seen = []
    real = shading.vertex

    def spy(c, si, hit, tp, L, nrays, kd, depth, prev=None, row_offset=0, cull=None,
            via_point=False, nee=None):
        seen.append(shading.takes_fused(c, si, tp, L, kd, depth, prev, nee))
        return real(c, si, hit, tp, L, nrays, kd, depth, prev, row_offset, cull, via_point, nee)

    monkeypatch.setattr(shading, "vertex", spy)
    run(scene)
    assert seen and set(seen) == {want}, (case, set(seen))


def test_fused_wrappers_take_cuda_tensors_only(monkeypatch):
    """The fused kernels' wrappers refuse CPU tensors before building or
    launching anything: shading's torch math is the CPU's path."""
    from monte_carlo_path_tracing_tpu_torch.ops import _build, vertex_cuda

    def no_build():
        raise AssertionError("a CPU call reached _build.load")

    monkeypatch.setattr(_build, "load", no_build)
    before = (vertex_cuda.nee_add.launches, vertex_cuda.light_brdf.launches)
    n, v3, b = 4, torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        vertex_cuda.nee_add(v3, v3, v3, b)
    keys, i32 = torch.zeros(n, 2, dtype=torch.int64), torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        vertex_cuda.light_brdf(keys, i32, torch.zeros(n), v3, v3, v3, v3, v3, torch.zeros(n), b,
                               v3, torch.zeros(2, 16), torch.zeros((), dtype=torch.int64), False)
    assert (vertex_cuda.nee_add.launches, vertex_cuda.light_brdf.launches) == before
