"""The port's fixed-depth wavefront (integrator/wavefront.py::render_rays)
and gradients (diff/grad.py) against the JAX package on the CPU.

Tolerance. Both packages consume the same threefry streams, so radiance
agrees lane for lane up to f32 rounding, except where XLA's fused
multiply-adds (the port rounds every op) flip a discrete decision on a
boundary and a path diverges (see test_torch_regen.py). So: ray counts
agree to 0.5%; lanes beyond rtol 1e-4 / atol 1e-5 are counted; at most 1%
of lanes (and at least 2 allowed) may differ beyond rtol 1e-2 / atol 1e-3.
Measured on cornell 16^2 at depth 32: ray counts equal, 0-1 lanes beyond
rtol 1e-4, none beyond 1e-2, for every estimator and sampler.

Gradients (pixel_grad, cornell 16^2, depth 4, random pixel weights): per
material field, the cosine between the port's and JAX's gradient is at
least 0.999, and the relative gap |g_port - g_jax| / |g_jax| is at most
1e-5 for kd, ks and emission and 2e-3 for ns. Measured: cosine 1.0000000
(7 digits) everywhere; gaps kd <= 6.0e-7, ks <= 1.2e-6, emission <=
1.3e-7, ns 7.7e-5 - 7.6e-4. Cornell's only specular material has Ns = 500:
its gradient holds x^500 (x^500 log x), which multiplies the relative
rounding of x by ~500, and its two terms cancel. Where JAX's gradient of a
field is exactly zero (ns under brdf, whose paths at depth 4 shade the
Ks > 0 material only where the gradient vanishes), the port's is too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.diff import grad as jgrad
from monte_carlo_path_tracing_tpu.integrator import common as jcommon
from monte_carlo_path_tracing_tpu.integrator import render_rays as jax_render_rays
from monte_carlo_path_tracing_tpu.render.camera import generate_rays as jax_generate_rays
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as tgrad
from monte_carlo_path_tracing_tpu_torch.integrator import common, render_rays
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, phong
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

#: Relative gradient gap bounds per material field (module docstring).
GRAD_GAP = {"kd": 1e-5, "ks": 1e-5, "ns": 2e-3, "emission": 1e-5}

ESTIMATORS = [("brdf", "spherical_triangle"), ("split", "spherical_triangle"),
              ("split", "uniform_area"), ("mis", "spherical_triangle"),
              ("mis", "uniform_area")]


def _pair(jax_scene, wh):
    """The same scene for both packages (the JAX leaves handed across)."""
    js = dataclasses.replace(jax_scene, camera=dataclasses.replace(
        jax_scene.camera, width=wh, height=wh))
    return js, scene_from_arrays(scene_arrays(jax_scene), wh, wh, device="cpu")


def _chunk(js, ts, seed, sample=0):
    """One chunk of every pixel's camera ray with its lane keys, for both
    packages: (jax key, ro, rd), (port key, ro, rd)."""
    n = js.camera.width * js.camera.height
    idx = np.arange(n, dtype=np.int32)
    jkey = jrng.lane_keys(jrng.sample_key(jrng.base_key(seed), sample), jnp.asarray(idx))
    tidx = torch.as_tensor(idx, dtype=torch.int64)
    tkey = rng.lane_keys(rng.sample_key(rng.base_key(seed), sample), tidx)
    return (jkey, *jax_generate_rays(js.camera, jnp.asarray(idx))), \
        (tkey, *generate_rays(ts.camera, tidx))


@pytest.mark.parametrize("estimator,sampler", ESTIMATORS)
def test_render_rays_matches_jax(cornell_scene, estimator, sampler):
    js, ts = _pair(cornell_scene, 16)
    kw = dict(spp=1, estimator=estimator, light_sampler=sampler, max_depth=32, seed=0)
    (jk, jro, jrd), (tk, tro, trd) = _chunk(js, ts, seed=5)
    la, sa = jax_render_rays(js, JaxConfig(**kw), jk, jro, jrd, with_stats=True)
    lb, sb = render_rays(ts, RenderConfig(**kw), tk, tro, trd, with_stats=True)
    a, b = np.asarray(la), lb.numpy()
    assert b.shape == (256, 3) and np.isfinite(b).all() and int(sb["nonfinite"]) == 0
    ra, rb = int(sa["rays"]), int(sb["rays"])
    assert abs(rb - ra) <= 0.005 * ra, (ra, rb)
    fine = int((~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)).sum())
    diverged = int((~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)).sum())
    print(f"{estimator}/{sampler}: rays {ra} vs {rb}; {fine} of 256 lanes beyond rtol 1e-4, "
          f"{diverged} diverged")
    assert diverged <= max(2, 256 // 100)


def test_russian_roulette_matches_jax():
    jk = jrng.lane_keys(jrng.base_key(4), jnp.arange(64))
    tk = rng.lane_keys(rng.base_key(4), torch.arange(64))
    ja, jw = jcommon.russian_roulette(jrng.bounce_key(jk, 3, jrng.P_RR), 64, 0.6)
    ta, tw = common.russian_roulette(rng.bounce_key(tk, 3, rng.P_RR), 64, 0.6)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert tw == jw


def test_render_rays_stats_accel_and_tripwire(cornell_scene, capsys):
    """with_stats returns tensor counts; an injected accel gives the same
    radiance; debug_checks prints the non-finite lane count; on CPU
    tensors no kernel launches."""
    _, ts = _pair(cornell_scene, 8)
    idx = torch.arange(64)
    ro, rd = generate_rays(ts.camera, idx)
    key = rng.lane_keys(rng.base_key(2), idx)
    cfg = RenderConfig(estimator="mis", max_depth=6, seed=2)
    counts = (intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches,
              arvo_cuda.arvo_select.launches)
    a, stats = render_rays(ts, cfg, key, ro, rd, with_stats=True)
    assert stats["rays"].dtype == torch.int64 and int(stats["rays"]) >= 64
    assert int(stats["nonfinite"]) == 0
    b = render_rays(ts, cfg.replace(debug_checks=True), key, ro, rd,
                    accel=ops_intersect.build_accel(ts))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert "[tripwire] non-finite radiance lanes: 0" in capsys.readouterr().out
    assert counts == (intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches,
                      arvo_cuda.arvo_select.launches)


@pytest.mark.parametrize("change,match", [
    (dict(estimator="shoot"), "Compat and accel extras"),
    (dict(ref_mis_weights=True), "Compat and accel extras"),
    (dict(accel="grid"), "Compat and accel extras"),
    (dict(ref_mis_weights=True, mis_blocker_compat=True), "render_image_regen"),
])
def test_render_rays_options_raise(cornell_scene, change, match):
    """One case per option the fixed-depth path does not run: unported ones
    name their ROADMAP item by title; blocker compat belongs to the regen
    renderer, as in JAX."""
    _, ts = _pair(cornell_scene, 4)
    idx = torch.arange(16)
    ro, rd = generate_rays(ts.camera, idx)
    with pytest.raises(NotImplementedError, match=match):
        render_rays(ts, RenderConfig(**change), rng.lane_keys(rng.base_key(0), idx), ro, rd)


def test_detach_sites(cornell_scene):
    """The sampled BRDF direction, the sampled light point and the accel
    carry no gradient; the pdf and the light's emission do (they are
    detached only where the estimators divide by them)."""
    _, ts = _pair(cornell_scene, 4)
    n = 32
    g = torch.Generator().manual_seed(0)
    nrm = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    wo = torch.nn.functional.normalize(nrm + 0.5 * torch.randn(n, 3, generator=g), dim=-1)
    kd = torch.full((n, 3), 0.5, requires_grad=True)
    bs = phong.sample_brdf(rng.lane_keys(rng.base_key(1), torch.arange(n)), nrm, wo, kd,
                           torch.full((n, 3), 0.3), torch.full((n,), 20.0))
    assert not bs.wi.requires_grad and bs.pdf.requires_grad

    em = ts.materials.emission.clone().requires_grad_(True)
    sc = ts.with_materials(dataclasses.replace(ts.materials, emission=em))
    x1 = torch.tensor([[0.0, 0.5, 0.0]]).expand(n, 3).contiguous()
    up = torch.tensor([[0.0, 1.0, 0.0]]).expand(n, 3).contiguous()
    ls, wsum = light_spherical.sample(rng.lane_keys(rng.base_key(2), torch.arange(n)), sc,
                                      x1, up)
    assert not ls.coord.requires_grad and not wsum.requires_grad
    assert ls.emission.requires_grad

    v0 = ts.tri_v0.clone().requires_grad_(True)
    accel = ops_intersect.build_accel(dataclasses.replace(ts, tri_v0=v0))
    assert not accel.W.requires_grad and not accel.aabb_lo.requires_grad


def _grad_pair(js, ts, est, sampler, depth=4, seed=3):
    kw = dict(spp=1, estimator=est, light_sampler=sampler, max_depth=depth, seed=0)
    (jk, jro, jrd), (tk, tro, trd) = _chunk(js, ts, seed=seed)
    n = tro.shape[0]
    sel = np.random.default_rng(0).uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    gj = jgrad.pixel_grad(js, JaxConfig(**kw), jk, jro, jrd, jnp.asarray(sel))
    gt = tgrad.pixel_grad(ts, RenderConfig(**kw), tk, tro, trd, torch.as_tensor(sel))
    return gj, gt


@pytest.mark.parametrize("estimator,sampler", [
    ("brdf", "spherical_triangle"), ("split", "spherical_triangle"),
    ("mis", "spherical_triangle"), ("mis", "uniform_area"),
])
def test_pixel_grad_matches_jax(cornell_scene, estimator, sampler):
    """pixel_grad for kd, ks, ns and emission against JAX's diff.grad
    on the same streams (cosine >= 0.999; relative gap within GRAD_GAP)."""
    js, ts = _pair(cornell_scene, 16)
    gj, gt = _grad_pair(js, ts, estimator, sampler)
    for field in ("kd", "ks", "ns", "emission"):
        a = np.asarray(getattr(gj, field), np.float64).ravel()
        b = getattr(gt, field).numpy().astype(np.float64).ravel()
        assert np.isfinite(b).all(), field
        na = np.linalg.norm(a)
        if na == 0.0:
            assert np.linalg.norm(b) == 0.0, field
            continue
        cos = float(a @ b / (na * np.linalg.norm(b)))
        gap = float(np.linalg.norm(a - b) / na)
        print(f"{estimator}/{sampler} {field}: cosine {cos:.7f}, relative gap {gap:.2e}")
        assert cos >= 0.999 and gap <= GRAD_GAP[field], (field, cos, gap)


def test_grad_matches_finite_difference_exact_stream(cornell_scene):
    """The port's version of the JAX package's exact-stream check: with the
    BRDF-only estimator emission enters no sampling distribution, so the
    analytic gradient equals central finite differences on one fixed
    threefry stream (the Monte Carlo noise cancels exactly)."""
    _, ts = _pair(cornell_scene, 16)
    cfg = RenderConfig(spp=1, estimator="brdf", max_depth=3, seed=0)
    idx = torch.arange(256)
    ro, rd = generate_rays(ts.camera, idx)
    key = rng.lane_keys(rng.base_key(11), idx)
    g = tgrad.pixel_grad(ts, cfg, key, ro, rd, torch.ones(256, 3))
    mats = ts.materials

    def total(emission):
        sc = ts.with_materials(dataclasses.replace(mats, emission=emission))
        return float(render_rays(sc, cfg, key, ro, rd).double().sum())

    eps = 0.5
    for coord in [(7, 0), (7, 2)]:
        up, dn = mats.emission.clone(), mats.emission.clone()
        up[coord] += eps
        dn[coord] -= eps
        fd = (total(up) - total(dn)) / (2 * eps)
        an = float(g.emission[coord])
        assert abs(fd - an) <= 1e-3 * max(1.0, abs(fd)), (coord, fd, an)


def test_loss_and_grad_is_pixel_grad_of_the_residual(cornell_scene):
    """loss_and_grad's gradient is pixel_grad with each pixel weighted by
    d loss / d radiance = 2 (radiance - target) / (3N), on the same stream;
    its loss is the mean squared error of the forward render."""
    _, ts = _pair(cornell_scene, 8)
    cfg = RenderConfig(spp=1, estimator="mis", light_sampler="spherical_triangle", max_depth=3,
                       seed=0)
    idx = torch.arange(64)
    ro, rd = generate_rays(ts.camera, idx)
    key = rng.lane_keys(rng.base_key(7), idx)
    target = torch.full((64, 3), 0.25)
    loss, g = tgrad.loss_and_grad(ts.materials, ts, cfg, key, ro, rd, target)
    rad = render_rays(ts, cfg, key, ro, rd)
    assert not loss.requires_grad
    torch.testing.assert_close(loss, torch.mean((rad - target) ** 2))
    gp = tgrad.pixel_grad(ts, cfg, key, ro, rd, 2.0 * (rad - target) / rad.numel())
    for field in ("kd", "ks", "ns", "emission"):
        torch.testing.assert_close(getattr(g, field), getattr(gp, field), rtol=1e-5, atol=1e-9)


def test_latent_map(cornell_scene):
    """to_latent as JAX's, and from_latent its inverse within the clip."""
    js, ts = _pair(cornell_scene, 8)
    lj, lt = jgrad.to_latent(js.materials), tgrad.to_latent(ts.materials)
    for f in ("kd_l", "ks_l", "ns_l", "emission_l"):
        np.testing.assert_allclose(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)),
                                   rtol=1e-5, atol=1e-5)
    m2, mj = tgrad.from_latent(lt), jgrad.from_latent(lj)
    kd = ts.materials.kd.numpy()
    np.testing.assert_allclose(m2.kd.numpy(), np.clip(kd, 1e-4, 1 - 1e-4), atol=2e-4)
    np.testing.assert_allclose(m2.ns.numpy(), ts.materials.ns.numpy(), rtol=1e-4)
    for f in ("kd", "ks", "ns", "emission"):
        np.testing.assert_allclose(getattr(m2, f).numpy(), np.asarray(getattr(mj, f)),
                                   rtol=1e-5, atol=1e-7)
