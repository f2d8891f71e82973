"""The legacy shoot estimator (integrator/legacy_shoot.py, C17) of the port
against the JAX package on the CPU: its helpers on JAX tests/test_shoot.py's
cases, then ``render_rays_shoot`` on the same streams.

Tolerances. The helpers run the same f32 formulas; XLA and torch differ in
their pow / trig rounding and in the Simpson sum's order: Newton's theta
and the frames to 1e-5 absolute (2e-3 where JAX's own test holds the CDF),
M to rtol 1e-5. Renders: a different theta moves a bounce, so lanes beyond
rtol 1e-3 / atol 1e-5 are counted and at most 1% of them (at least 2) may
differ beyond rtol 1e-2 / atol 1e-3; ray counts within 0.5%. Measured on
cornell and Veach 32^2 (depth 6, seeds 0 and 1): no lane beyond rtol 1e-3,
ray counts and chain lengths equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.integrator import legacy_shoot as jls
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import legacy_shoot as tls
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _chunk, _pair


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_inverse_F_theta_matches_jax_and_the_cdf():
    """Newton solves F(theta) = ksi (JAX's bound 2e-3) and gives JAX's theta."""
    g = np.random.default_rng(0)
    x, y = g.uniform(0.05, 2.0, 64), g.uniform(0.0, 2.0, 64)
    n, ksi = g.uniform(1.0, 100.0, 64), g.uniform(0.01, 0.99, 64)
    args = [a.astype(np.float32) for a in (x, y, n, ksi)]
    tj = np.asarray(jls._inverse_F_theta(*map(jnp.asarray, args)))
    th = tls._inverse_F_theta(*map(_t, args))
    c = torch.cos(th)
    xt, yt, nt, _ = map(_t, args)
    F = 1.0 - (xt * (nt + 1.0) * c + yt * c ** (nt + 1.0)) / (xt * (nt + 1.0) + yt)
    np.testing.assert_allclose(F.numpy(), args[3], atol=2e-3)
    np.testing.assert_allclose(th.numpy(), tj, atol=1e-5)


def test_inverse_F_theta_diffuse_closed_form_and_ends():
    """y = 0 gives F = 1 - cos(theta), so theta = acos(1 - ksi); ksi 0 and 1
    give 0 and pi/2."""
    ksi = torch.linspace(0.05, 0.95, 16)
    th = tls._inverse_F_theta(torch.ones_like(ksi), torch.zeros_like(ksi),
                              torch.full_like(ksi, 10.0), ksi)
    np.testing.assert_allclose(th.numpy(), np.arccos(1.0 - ksi.numpy()), atol=2e-3)
    ends = tls._inverse_F_theta(torch.ones(2), torch.ones(2), torch.full((2,), 5.0),
                                torch.tensor([0.0, 1.0]))
    np.testing.assert_allclose(ends.numpy(), [0.0, np.pi / 2], atol=1e-7)


def test_cal_M_matches_jax_and_is_one_on_a_flat_horizon():
    """a1 = a2 ~ 0: theta0 = pi/2 everywhere, the integrand vanishes and
    M = 1 (main.cpp:61-62, 85); on random inputs JAX's M to rtol 1e-5."""
    one = torch.ones(4)
    M = tls._cal_M(one, one, 10.0 * one, 1e-12 * one, 1e-12 * one, one)
    np.testing.assert_allclose(M.numpy(), 1.0, atol=1e-5)
    g = np.random.default_rng(5)
    args = [g.uniform(lo, hi, 32).astype(np.float32)
            for lo, hi in ((0.05, 2.0), (0.0, 2.0), (1.0, 50.0), (-1, 1), (-1, 1), (-1, 1))]
    mj = np.asarray(jls._cal_M(*map(jnp.asarray, args)))
    np.testing.assert_allclose(tls._cal_M(*map(_t, args)).numpy(), mj, rtol=1e-5)
    phi = g.uniform(0, 2 * np.pi, 32).astype(np.float32)
    np.testing.assert_allclose(tls._theta0(*map(_t, args[3:] + [phi])).numpy(),
                               np.asarray(jls._theta0(*map(jnp.asarray, args[3:] + [phi]))),
                               atol=1e-5)


def test_r_frame_orthonormal_degenerate_and_as_jax():
    g = np.random.default_rng(3)
    ns = g.normal(size=(32, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    l = g.normal(size=(32, 3)).astype(np.float32)
    l /= np.linalg.norm(l, axis=-1, keepdims=True)
    l[:16] = ns[:16]                      # exactly degenerate lanes (main.cpp:189)
    cols = tls._r_frame(_t(ns), _t(l))
    for a, b in [(0, 1), (1, 2), (0, 2)]:
        np.testing.assert_allclose((cols[a] * cols[b]).sum(-1).numpy(), 0.0, atol=1e-5)
    for c in cols:
        np.testing.assert_allclose(torch.linalg.norm(c, dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(cols[2][:16].numpy(), ns[:16], atol=1e-6)
    for c, cj in zip(cols, jls._r_frame(jnp.asarray(ns), jnp.asarray(l))):
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5)


def _fringe(a, b):
    fine = ~np.isclose(b, a, rtol=1e-3, atol=1e-5).all(-1)
    coarse = ~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)
    return int(fine.sum()), int(coarse.sum())


@pytest.mark.parametrize("name,seed", [("cornell", 0), ("veach", 1)])
def test_render_rays_shoot_matches_jax(request, name, seed):
    """A scalar key, as JAX tests/test_shoot.py draws: radiance, px, chain
    lengths and ray counts against JAX's on the same streams."""
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), 16)
    (_, jro, jrd), (_, tro, trd) = _chunk(js, ts, seed=0)
    jcfg = JaxConfig(estimator="shoot", max_depth=6, seed=seed)
    la, sa = jax.jit(lambda s, k: jls.render_rays_shoot(s, jcfg, k, jro, jrd, with_stats=True))(
        js, jax.random.key(seed))
    lb, sb = tls.render_rays_shoot(ts, RenderConfig(estimator="shoot", max_depth=6, seed=seed),
                                   rng.base_key(seed), tro, trd, with_stats=True)
    a, b = np.asarray(la), lb.numpy()
    assert np.isfinite(b).all() and (b >= 0).all() and b.max() > 0
    assert (sb["px"] > 0).all() and (sb["steps"] <= 6).all()
    ra, rb = int(sa["rays"]), int(sb["rays"])
    assert abs(rb - ra) <= 0.005 * ra, (ra, rb)
    fine, coarse = _fringe(a, b)
    same_steps = float((np.asarray(sa["steps"]) == sb["steps"].numpy()).mean())
    print(f"{name}: rays {ra} vs {rb}; {fine} of 256 lanes beyond rtol 1e-3, {coarse} "
          f"diverged; chain lengths equal on {same_steps:.1%}")
    assert coarse <= max(2, 256 // 100)


def test_shoot_via_render_rays_lane_keys_and_row_offset(cornell_scene):
    """estimator="shoot" through render_rays with lane keys (stats carry
    "nonfinite"), and a scalar key's rows [r0, r0 + n) equal rows r0.. of
    the draw over all rays (row_offset, as every scalar-key draw under
    render_rays)."""
    js, ts = _pair(cornell_scene, 8)
    _, (tk, tro, trd) = _chunk(js, ts, seed=2)
    cfg = RenderConfig(estimator="shoot", max_depth=4, seed=1)
    L, stats = render_rays(ts, cfg, tk, tro, trd, with_stats=True)
    assert L.shape == (64, 3) and torch.isfinite(L).all() and int(stats["nonfinite"]) == 0
    key = rng.base_key(7)
    full = render_rays(ts, cfg, key, tro, trd)
    part = render_rays(ts, cfg, key, tro[40:], trd[40:], row_offset=40)
    torch.testing.assert_close(part, full[40:], rtol=0, atol=0)


def test_render_image_shoot_finite(cornell_scene):
    """render_image with the shoot estimator: finite, some light."""
    _, ts = _pair(cornell_scene, 8)
    img = render_image(ts, RenderConfig(width=8, height=8, spp=1, estimator="shoot",
                                        max_depth=4)).image
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0
