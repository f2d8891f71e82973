"""What ``diff.inverse.StepRenders`` captures on the card, checked on the
CPU: ``wavefront.run_loop`` without its early exit (every bounce run, no
host read) gives the eager loop's radiance and rays, and
``inverse.unrolled_streams`` gives ``stream_radiance``'s two streams and
their gradients bit for bit. Off CUDA the renders run eagerly, and a
capture asked for there raises. The captured renders themselves run only
on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import os

import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.diff import inverse
from monte_carlo_path_tracing_tpu_torch.integrator import shading, wavefront
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell", "cornell.obj")
W = H = 16
N = 192


@pytest.fixture(scope="module")
def scene():
    sc = load_scene(CORNELL, device="cpu")
    return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=W, height=H))


def _cfg(max_depth):
    return RenderConfig(width=W, height=H, spp=1, estimator="mis",
                        light_sampler="spherical_triangle", max_depth=max_depth, seed=0)


def _step(scene, seed):
    k_step, idx = inverse.step_keys(seed, 3, N, W * H, "cpu")
    return (k_step, *generate_rays(scene.camera, idx))


def _latents(scene, seed):
    g = torch.Generator().manual_seed(seed)
    lm = dgrad.latent_leaves(dgrad.to_latent(scene.materials))
    return [(x + 0.3 * torch.randn(x.shape, generator=g)).requires_grad_(True) for x in lm]


@pytest.mark.parametrize("seed", [1, 2])
def test_run_loop_without_its_early_exit_gives_the_same_radiance_and_rays(scene, seed,
                                                                          monkeypatch):
    bounces = []
    inner = wavefront._bounce
    monkeypatch.setattr(wavefront, "_bounce",
                        lambda *a, **k: bounces.append(1) or inner(*a, **k))
    cfg = _cfg(16)
    ctx = shading.scene_context(scene, cfg)
    k_step, ro, rd = _step(scene, seed)
    early = wavefront.run_loop(ctx, k_step, ro, rd)
    n_early = len(bounces)
    every = wavefront.run_loop(ctx, k_step, ro, rd, early_exit=False)
    assert n_early < 16 and len(bounces) - n_early == 16   # every lane died early
    assert torch.equal(every["L"], early["L"]) and torch.equal(every["nrays"], early["nrays"])


@pytest.mark.parametrize("max_depth,seed", [(3, 1), (3, 2), (16, 3)])
def test_unrolled_streams_are_stream_radiance_with_its_gradients(scene, max_depth, seed):
    cfg = _cfg(max_depth)
    k_step, ro, rd = _step(scene, seed)
    lat = _latents(scene, seed)
    eager = inverse.stream_radiance(scene, dgrad.LatentMaterials(*lat), cfg, k_step, ro, rd)
    g_eager = torch.autograd.grad(sum(r.sum() for r in eager), lat)
    unrolled = inverse.unrolled_streams(scene, cfg, ops_intersect.build_accel(scene), *lat,
                                        k_step, ro, rd)
    g_unrolled = torch.autograd.grad(sum(r.sum() for r in unrolled), lat)
    assert all(torch.equal(a, b) for a, b in zip(unrolled, eager))
    assert all(torch.equal(a, b) for a, b in zip(g_unrolled, g_eager))
    assert any(bool(g.abs().sum() > 0) for g in g_eager)


def test_step_renders_run_eagerly_off_cuda(scene):
    cfg = _cfg(3)
    r = inverse.StepRenders(scene, cfg, N)
    assert r._target is None and r._streams is None
    k_step, ro, rd = _step(scene, 1)
    lat = dgrad.LatentMaterials(*_latents(scene, 1))
    assert torch.equal(r.target(k_step, ro, rd),
                       inverse.target_radiance(scene, cfg, k_step, ro, rd))
    for a, b in zip(r.streams(lat, k_step, ro, rd),
                    inverse.stream_radiance(scene, lat, cfg, k_step, ro, rd)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA graph"):
        inverse.StepRenders(scene, cfg, N, graph=True)
    with pytest.raises(ValueError, match="triangle accel"):
        inverse.StepRenders(scene, dataclasses.replace(cfg, accel="grid"), N, graph=True)


def test_a_job_given_renders_takes_its_steps_from_them(scene, monkeypatch):
    cfg = _cfg(3)
    calls = []
    r = inverse.StepRenders(scene, cfg, N)
    monkeypatch.setattr(r, "streams", lambda *a: calls.append(1) or
                        inverse.StepRenders.streams(r, *a))
    kw = dict(steps=2, lr=0.1, rays_per_step=N, seed=5)
    given = inverse.recover_materials(scene, scene.materials, cfg, renders=r, **kw)
    built = inverse.recover_materials(scene, scene.materials, cfg, **kw)
    assert len(calls) == 2 and given.losses == built.losses
