"""Statistical tests of the port's samplers (sampling/phong.py,
sampling/light_uniform.py, sampling/light_spherical.py): JAX
tests/test_phong.py:19-100 and tests/test_lights.py:11-206 run on the
port's functions, with the port's threefry streams (keys from
``rng.base_key``) and numpy draws made from a seed.

The full spherical projection (``light_spherical.project``) is held
against JAX's on seeded configurations and through the ports of
tests/test_lights.py:64-90, :152 and :206.

Tolerances are the JAX tests' own: Monte Carlo bounds set by their sample
counts (pdf normalisation to 3% over 200,000 uniform directions, the
cos(theta) histogram to rtol 0.12 / atol 0.05 per bin, class frequencies
to 0.01, the octant's mean direction to 0.01, the white furnace below
1.05), and f32 round-off for the closed forms (rtol 1e-5 / 1e-4)."""

import math

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.core.radiometry import radiance_sum
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, light_uniform, phong

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _pair


def _mat(kd, ks, ns, n=1):
    return (torch.tensor([kd]).expand(n, 3), torch.tensor([ks]).expand(n, 3),
            torch.full((n,), float(ns)))


def _rows(v, n):
    return vm.normalize(torch.tensor([v], dtype=torch.float32)).expand(n, 3).contiguous()


def _uniform_dirs(n, seed):
    g = np.random.default_rng(seed)
    return vm.normalize(torch.as_tensor(g.normal(size=(n, 3)).astype(np.float32)))


@pytest.fixture(scope="module")
def scenes(cornell_scene, veach_scene):
    return {"cornell": _pair(cornell_scene, 8)[1], "veach": _pair(veach_scene, 8)[1]}


# ---------------------------------------------------------------------------
# Phong (JAX tests/test_phong.py:19-100)
# ---------------------------------------------------------------------------

def test_pdf_normalizes_to_one():
    """The mixture pdf integrates to 1 over the sphere (uniform MC)."""
    M = 200_000
    wi = _uniform_dirs(M, 0)
    kd, ks, ns = _mat((0.4, 0.4, 0.4), (0.4, 0.4, 0.4), 32.0, M)
    pdf = phong.pdf_brdf(_rows([0.0, 0.0, 1.0], M), wi, _rows([0.3, 0.1, 0.9], M), kd, ks, ns)
    integral = float(pdf.double().mean()) * 4.0 * math.pi
    assert abs(integral - 1.0) < 0.03, integral


def test_sample_matches_pdf_histogram():
    """Binned cos(theta) of the samples against the analytic mixture at
    normal incidence, p(c) = pd 2c + ps (ns+1) c^ns, bin-averaged."""
    M = 200_000
    n = _rows([0.0, 0.0, 1.0], M)
    kd, ks, ns = _mat((0.5, 0.5, 0.5), (0.3, 0.3, 0.3), 16.0, M)
    bs = phong.sample_brdf(rng.base_key(1), n, n, kd, ks, ns)
    cos_t = vm.dot(bs.wi, n).numpy()
    pd, ps = 0.5 / 0.8, 0.3 / 0.8
    bins = np.linspace(0, 1, 21)
    hist, _ = np.histogram(np.clip(cos_t, 0, 1), bins=bins, density=True)
    cdf = lambda x: pd * x ** 2 + ps * x ** 17.0  # noqa: E731
    np.testing.assert_allclose(hist, (cdf(bins[1:]) - cdf(bins[:-1])) / np.diff(bins),
                               rtol=0.12, atol=0.05)


def test_sample_pdf_consistency():
    """The pdf sample_brdf returns is pdf_brdf at the sampled direction."""
    M = 4096
    n, wo = _rows([0.2, -0.4, 0.9], M), _rows([-0.1, 0.3, 0.95], M)
    kd, ks, ns = _mat((0.6, 0.5, 0.4), (0.2, 0.25, 0.3), 50.0, M)
    bs = phong.sample_brdf(rng.base_key(2), n, wo, kd, ks, ns)
    np.testing.assert_allclose(bs.pdf.numpy(), phong.pdf_brdf(n, bs.wi, wo, kd, ks, ns).numpy(),
                               rtol=1e-4, atol=1e-6)


def test_branch_pdf_compat_diffuse_only():
    """With Ks = 0 the branch pdf is the mixture pdf (one lobe)."""
    M = 2048
    n = _rows([0.0, 0.0, 1.0], M)
    kd, ks, ns = _mat((0.7, 0.7, 0.7), (0.0, 0.0, 0.0), 10.0, M)
    b1 = phong.sample_brdf(rng.base_key(3), n, n, kd, ks, ns, branch_pdf_compat=True)
    b2 = phong.sample_brdf(rng.base_key(3), n, n, kd, ks, ns, branch_pdf_compat=False)
    np.testing.assert_allclose(b1.pdf.numpy(), b2.pdf.numpy(), rtol=1e-4)
    assert not b1.is_specular.any()


def test_eval_brdf_values():
    """f_r at the mirror direction against the closed form (BRDF.cpp:17-25)."""
    f = phong.eval_brdf(torch.tensor([[0.0, 0.0, 1.0]]), _rows([0.0, 0.6, 0.8], 1),
                        _rows([0.0, -0.6, 0.8], 1), torch.tensor([[0.3] * 3]),
                        torch.tensor([[0.5] * 3]), torch.tensor([8.0]))[0]
    np.testing.assert_allclose(f.numpy(), 0.3 / math.pi + 0.5 * 9.0 / (2 * math.pi), rtol=1e-5)


def test_energy_conservation_white_furnace():
    """The integral of f_r cos over the sphere stays below 1 (kd + ks <= 1)."""
    M = 200_000
    wi = _uniform_dirs(M, 4)
    n = _rows([0.0, 0.0, 1.0], M)
    kd, ks, ns = _mat((0.6, 0.6, 0.6), (0.3, 0.3, 0.3), 40.0, M)
    f = phong.eval_brdf(n, wi, _rows([0.0, 0.4, 0.9], M), kd, ks, ns)
    integral = float((f[:, 0] * torch.clamp(vm.dot(wi, n), min=0.0)).double().mean()) * 4 * math.pi
    assert integral < 1.05, integral


# ---------------------------------------------------------------------------
# Lights (JAX tests/test_lights.py:11-206)
# ---------------------------------------------------------------------------

def test_uniform_select_table_sums_to_one(scenes):
    for sc in scenes.values():
        p = light_uniform.select_table(sc)
        assert p.shape == (sc.num_lights,) and (p >= 0).all()
        np.testing.assert_allclose(float(p.sum()), 1.0, rtol=1e-5)


def test_uniform_sample_on_triangle(scenes):
    """Every point lies on its triangle's plane; pdf = p_sel / area."""
    sc = scenes["cornell"]
    ls = light_uniform.sample(rng.base_key(0), sc, 4096)
    tri = ls.tri_id.long()
    nrm = torch.linalg.cross(sc.tri_e1[tri], sc.tri_e2[tri], dim=-1)
    np.testing.assert_allclose(((ls.coord - sc.tri_v0[tri]) * nrm).sum(-1).numpy(), 0.0, atol=1e-5)
    p_sel, lidx = light_uniform.select_table(sc), ls.light_idx.long()
    np.testing.assert_allclose(ls.pdf.numpy(), (p_sel[lidx] / sc.light_area[lidx]).numpy(),
                               rtol=1e-5)


def test_uniform_class_frequencies(scenes):
    """Class pick frequencies over 200,000 draws match the radiance-sum
    weighting."""
    sc = scenes["veach"]
    ls = light_uniform.sample(rng.base_key(1), sc, 200_000)
    cls = sc.light_class.numpy()
    freq = np.bincount(cls[ls.light_idx.numpy()], minlength=4) / 200_000
    p_sel = light_uniform.select_table(sc).numpy()
    np.testing.assert_allclose(freq, [p_sel[cls == k].sum() for k in range(4)], atol=0.01)


def _octant(M=1):
    """The positive octant as a spherical triangle seen from the origin
    (area pi/2), its light normal facing the origin."""
    x1 = torch.zeros((M, 3))
    pa, pb, pc = (torch.tensor([v]).expand(M, 3) for v in
                  ([2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 2.0]))
    return x1, _rows([1.0, 1.0, 1.0], M), pa, pb, pc, _rows([-1.0, -1.0, -1.0], M)


def test_octant_solid_angle_and_culls():
    """The octant's solid angle is pi/2, its warp angle alpha pi/2; behind
    the light plane or below the horizon the triangle is culled."""
    x1, n, pa, pb, pc, nl = _octant()
    sA, valid = light_spherical.solid_angle_fast(x1, n, pa, pb, pc, nl)
    assert bool(valid[0])
    np.testing.assert_allclose(float(sA[0]), math.pi / 2, rtol=1e-4)
    _, _, _, alpha, cos_c, sA_w = light_spherical._project_for_warp(x1, n, pa, pb, pc)
    np.testing.assert_allclose([float(alpha[0]), float(sA_w[0])], [math.pi / 2] * 2, rtol=1e-4)
    np.testing.assert_allclose(float(cos_c[0]), 0.0, atol=1e-6)
    assert not bool(light_spherical.solid_angle_fast(x1, n, pa, pb, pc, -nl)[1][0])
    assert not bool(light_spherical.solid_angle_fast(x1, -n, pa, pb, pc, nl)[1][0])


def test_arvo_samples_uniform_in_octant():
    """Arvo's warp in the octant: unit directions inside it, and uniform
    (by symmetry each coordinate's mean is 1/2)."""
    M = 50_000
    x1, n, pa, pb, pc, _ = _octant(M)
    A, B, C, alpha, cos_c, sA = light_spherical._project_for_warp(x1, n, pa, pb, pc)
    P = light_spherical._arvo_warp(rng.base_key(2), A, B, C, alpha, cos_c, sA).numpy()
    assert np.all(P > -1e-5)
    np.testing.assert_allclose(np.linalg.norm(P, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(P.mean(axis=0), 0.5, atol=0.01)


def test_sample_and_pdf_consistency(scenes):
    """Points on cornell's floor looking up: every sample is valid, lands
    on the ceiling light's plane, and pdf_of_tri reproduces its pdf."""
    sc = scenes["cornell"]
    N = 1024
    g = np.random.default_rng(3)
    x1 = torch.as_tensor(np.stack([g.uniform(-0.9, 0.9, N), np.full(N, 0.01),
                                   g.uniform(-0.9, 0.9, N)], 1).astype(np.float32))
    n = _rows([0.0, 1.0, 0.0], N)
    ls, wsum = light_spherical.sample(rng.base_key(3), sc, x1, n)
    assert ls.valid.all()
    np.testing.assert_allclose(ls.coord[:, 1].numpy(), 1.999, atol=1e-3)
    pdf2 = light_spherical.pdf_of_tri(sc, x1, n, ls.light_idx, wsum)
    np.testing.assert_allclose(pdf2.numpy(), ls.pdf.numpy(), rtol=1e-4)


def test_spherical_pdf_integrates_to_one(scenes):
    """sum over lights of sA_l pdf_l = sum of weights / wsum = 1: the
    sampler is a density over the union of projected triangles."""
    w, wsum = light_spherical.prepare(scenes["cornell"], torch.tensor([[0.3, 0.2, -0.1]]),
                                      torch.tensor([[0.0, 1.0, 0.0]]))
    np.testing.assert_allclose((w.sum(-1) / wsum).numpy(), [1.0], rtol=1e-5)


def test_no_light_fallback(scenes):
    """A receiver facing away from every light gets the dummy sample."""
    ls, _ = light_spherical.sample(rng.base_key(4), scenes["cornell"],
                                   torch.tensor([[0.0, 0.5, 0.0]]),
                                   torch.tensor([[0.0, -1.0, 0.0]]))
    assert not bool(ls.valid[0]) and float(ls.pdf[0]) == 1.0
    assert (ls.emission == 0).all()


def test_prepare_matches_direct_solid_angles(scenes):
    """prepare's quadratic-form weights equal the direct per-pair solid
    angles times the radiance sum on both scenes (JAX's bounds: at most
    0.2% of pairs off by 2e-3 of the largest weight, sums to rtol 5e-3)."""
    g = np.random.default_rng(1234)
    for sc in scenes.values():
        N = 128
        x1 = torch.as_tensor(g.uniform(-3, 3, (N, 3)).astype(np.float32))
        n = vm.normalize(torch.as_tensor(g.normal(size=(N, 3)).astype(np.float32)))
        w, wsum = light_spherical.prepare(sc, x1, n)
        pa, pb, pc = sc.light_verts()
        nl = sc.geo_n[sc.light_tri_ids.long()]
        sA, valid = light_spherical.solid_angle_fast(x1[:, None], n[:, None], pa[None], pb[None],
                                                     pc[None], nl[None])
        w_ref = torch.where(valid, sA * radiance_sum(sc.light_emission())[None],
                            torch.zeros_like(sA)).numpy()
        bad = (np.abs(w.numpy() - w_ref) > 2e-3 * max(w_ref.max(), 1e-6)).mean()
        assert bad < 2e-3, bad
        np.testing.assert_allclose(wsum.numpy(), w_ref.sum(-1), rtol=5e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# The full projection (JAX sampling/light_spherical.py::project)
# ---------------------------------------------------------------------------

def _random_projections(N, seed):
    """N seeded random (x1, n, pa, pb, pc, nl) as in JAX test_lights.py:152:
    light normals turned toward x1 so that the front cull passes about half
    the time; f32 numpy arrays."""
    g = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    x1 = f(g.uniform(-1, 1, (N, 3)))
    n = g.normal(size=(N, 3))
    n = f(n / np.linalg.norm(n, axis=-1, keepdims=True))
    pa = f(x1 + g.uniform(1, 3, (N, 3)))
    pb = f(pa + g.normal(size=(N, 3)))
    pc = f(pa + g.normal(size=(N, 3)))
    nl = np.cross(pb - pa, pc - pa)
    nl = nl / np.linalg.norm(nl, axis=-1, keepdims=True)
    flip = (nl * (x1 - pa)).sum(-1) < 0
    return x1, n, pa, pb, pc, f(np.where(flip[:, None], -nl, nl))


def test_project_matches_jax():
    """project against JAX's on 4,096 seeded configurations: valid equal
    but for a counted fringe of at most 0.1% (the culls compare at EPS,
    and XLA contracts multiply-adds that the port rounds; measured 0);
    where both are valid, A, B, C and edge_c within rtol 1e-5 / atol 1e-6.
    alpha and sA take acos of nearly antiparallel edge-plane normals and
    sA subtracts pi from their sum, so one ulp of a dot moves them by up
    to ~2e-4 in either package: they are held to JAX's accuracy instead,
    against the same chain in f64 (the port's mean error at most 1.25x
    JAX's; measured 1.02-1.07x), and within 1e-3 of JAX's values (JAX
    test_lights.py:206 holds this chain to 2e-3)."""
    import jax.numpy as jnp

    from monte_carlo_path_tracing_tpu.sampling import light_spherical as jls

    args = _random_projections(4096, 7)
    pj = jls.project(*(jnp.asarray(a) for a in args))
    pt = light_spherical.project(*(torch.from_numpy(a) for a in args))
    p64 = light_spherical.project(*(torch.from_numpy(a).double() for a in args))
    vj, vt = np.asarray(pj["valid"]), pt["valid"].numpy()
    assert (vj != vt).sum() <= 4, int((vj != vt).sum())
    both = vj & vt
    assert both.sum() > 1000
    for k in ("A", "B", "C", "edge_c"):
        np.testing.assert_allclose(pt[k].numpy()[both], np.asarray(pj[k])[both], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    both &= p64["valid"].numpy()
    for k in ("alpha", "sA"):
        got, want, exact = pt[k].numpy()[both], np.asarray(pj[k])[both], p64[k].numpy()[both]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=k)
        assert np.abs(got - exact).mean() <= 1.25 * np.abs(want - exact).mean(), k


def test_project_octant_area_and_culls():
    """JAX test_lights.py:64-90: the octant's excess, angle at A and arc AB
    are pi/2; behind the light plane or below the horizon it is culled."""
    x1, n, pa, pb, pc, nl = _octant()
    pr = light_spherical.project(x1, n, pa, pb, pc, nl)
    assert bool(pr["valid"][0])
    np.testing.assert_allclose([float(pr[k][0]) for k in ("sA", "alpha", "edge_c")],
                               [math.pi / 2] * 3, rtol=1e-4)
    assert not bool(light_spherical.project(x1, n, pa, pb, pc, -nl)["valid"][0])
    assert not bool(light_spherical.project(x1, -n, pa, pb, pc, nl)["valid"][0])


def test_fast_solid_angle_matches_girard():
    """JAX test_lights.py:152: Van Oosterom-Strackee's sA equals the Girard
    excess of project on random valid configurations (rtol 2e-3 / atol
    1e-4: the acos chain loses digits near degenerate triangles)."""
    args = [torch.from_numpy(a) for a in _random_projections(512, 1234)]
    pr = light_spherical.project(*args)
    sA, valid = light_spherical.solid_angle_fast(*args)
    both = (pr["valid"] & valid).numpy()
    assert both.sum() > 50
    np.testing.assert_allclose(sA.numpy()[both], pr["sA"].numpy()[both], rtol=2e-3, atol=1e-4)


def test_project_for_warp_matches_full_projection():
    """JAX test_lights.py:206: the warp's lean projection (one acos, one
    atan2) agrees with project on all that Arvo's warp consumes."""
    g = np.random.default_rng(11)
    M = 256
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x1 = f(g.normal(size=(M, 3)))
    n = vm.normalize(f(g.normal(size=(M, 3))))
    pa, pb, pc = (x1 + f(g.normal(size=(M, 3)) + 3.0) for _ in range(3))
    nl = vm.normalize(vm.cross(pb - pa, pc - pa))
    pr = light_spherical.project(x1, n, pa, pb, pc, nl)
    A, B, C, alpha, cos_c, sA = light_spherical._project_for_warp(x1, n, pa, pb, pc)
    v = pr["valid"].numpy()
    assert v.sum() > 20
    for a, b, tol in ((A, pr["A"], 1e-5), (B, pr["B"], 1e-5), (C, pr["C"], 1e-5),
                      (alpha, pr["alpha"], 2e-3), (cos_c, torch.cos(pr["edge_c"]), 1e-5),
                      (sA, pr["sA"], 2e-3)):
        np.testing.assert_allclose(a.numpy()[v], b.numpy()[v], atol=tol)
