"""Arvo light selection and sampling of the port (ops/arvo_cuda.py,
sampling/light_spherical.py) against the JAX package. K3 against its plain
version on a card: tests/test_torch_cuda.py.

Tolerances. The per-light weights come from quadratic forms in x whose f32
cancellation amplifies rounding for small, distant light triangles; XLA on
the CPU contracts multiply-adds into FMAs where torch rounds each op, so
weights_sum agrees with JAX to rtol 1e-3 (the bound the JAX suite itself
states for its fused kernel against ``prepare``, tests/test_arvo_pallas.py)
and picks agree except on a counted CDF-boundary fringe."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.ops import arvo_pallas
from monte_carlo_path_tracing_tpu.sampling import light_spherical as jls
from monte_carlo_path_tracing_tpu_torch.core import rng as trng
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical as tls
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def scenes(veach_scene):
    cam = veach_scene.camera
    return veach_scene, scene_from_arrays(scene_arrays(veach_scene), cam.width, cam.height,
                                          device="cpu")



def _points(scene, n, seed=0):
    g = np.random.default_rng(seed)
    v = scene.tri_v0.numpy()
    lo, hi = v.min(0), v.max(0)
    x1 = (g.random((n, 3)) * (hi - lo) * 0.8 + lo + 0.1 * (hi - lo)).astype(np.float32)
    nrm = g.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    return x1, nrm, g.random(n).astype(np.float32)


def test_plain_matches_pallas_interpret(scenes):
    js, ts = scenes
    x1, nrm, u = _points(ts, 512)
    ij, wj = arvo_pallas.arvo_select(js, jnp.asarray(x1), jnp.asarray(nrm), jnp.asarray(u))
    it, wt = arvo_cuda.arvo_select(arvo_cuda.pack_consts(ts), *map(torch.from_numpy, (x1, nrm, u)))
    assert it.dtype == torch.int32
    n_diff = int((np.asarray(ij) != it.numpy()).sum())
    assert n_diff <= 5, n_diff                       # CDF-boundary fringe
    np.testing.assert_allclose(np.asarray(wj), wt.numpy(), rtol=1e-3, atol=1e-6)


def test_plain_matches_prepare_and_pick(scenes):
    js, ts = scenes
    x1, nrm, _ = _points(ts, 512, seed=1)
    wj, sj = jls.prepare(js, jnp.asarray(x1), jnp.asarray(nrm))
    wt, st = tls.prepare(ts, torch.from_numpy(x1), torch.from_numpy(nrm))
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), rtol=1e-3, atol=1e-6)
    # Culls agree except where sA, or a front / horizon margin, lies within
    # rounding of its threshold.
    assert int(((np.asarray(wj) > 0) != (wt.numpy() > 0)).sum()) <= wt.numel() // 10000
    ids = np.arange(512, dtype=np.int32)
    pj = np.asarray(jrng.pick_weighted(jrng.fold_in(jrng.base_key(4), jnp.asarray(ids)),
                                       wj, 512, sj))
    tk = trng.fold_in(trng.base_key(4), torch.from_numpy(ids))
    pt = trng.pick_weighted(tk, wt, 512, st).numpy()
    assert int((pj != pt).sum()) <= 5
    # arvo_select_plain is prepare + that pick, on the same uniform.
    u = trng.uniform(tk, (512,))
    ip, wp = arvo_cuda.arvo_select_plain(arvo_cuda.pack_consts(ts), torch.from_numpy(x1),
                                         torch.from_numpy(nrm), u)
    np.testing.assert_array_equal(ip.numpy(), pt)
    np.testing.assert_array_equal(wp.numpy(), st.numpy())


def test_sample_and_pdf_of_tri(scenes):
    """Light samples from the same streams: same picks; landing points to
    1e-4 of the distance on 85% of lanes and 1e-2 on all (the warp inherits
    the solid angle's cancellation, see the module note); pdf_of_tri to
    rtol 1e-3."""
    js, ts = scenes
    x1, nrm, _ = _points(ts, 512, seed=2)
    jk, tk = jrng.fold_in(jrng.base_key(0), 1234), trng.fold_in(trng.base_key(0), 1234)
    lj, wj = jls.sample(jk, js, jnp.asarray(x1), jnp.asarray(nrm))
    lt, wt = tls.sample(tk, ts, torch.from_numpy(x1), torch.from_numpy(nrm))
    same = np.asarray(lj.light_idx) == lt.light_idx.numpy()
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(np.asarray(lj.valid), lt.valid.numpy())
    np.testing.assert_array_equal(np.asarray(lj.tri_id)[same], lt.tri_id.numpy()[same])
    ok = same & lt.valid.numpy()
    ct = lt.coord.numpy()
    rel = (np.linalg.norm(np.asarray(lj.coord) - ct, axis=-1)
           / np.linalg.norm(ct - x1, axis=-1))[ok]
    assert np.mean(rel < 1e-4) >= 0.85 and rel.max() < 1e-2, np.sort(rel)[-5:]
    np.testing.assert_allclose(np.asarray(lj.pdf)[same], lt.pdf.numpy()[same], rtol=1e-3)
    pj = np.asarray(jls.pdf_of_tri(js, jnp.asarray(x1), jnp.asarray(nrm), lj.light_idx, wj))
    pt = tls.pdf_of_tri(ts, torch.from_numpy(x1), torch.from_numpy(nrm), lt.light_idx, wt).numpy()
    np.testing.assert_allclose(pj[same], pt[same], rtol=1e-3, atol=1e-7)
    # a non-light (-1) has pdf 0
    assert (tls.pdf_of_tri(ts, torch.from_numpy(x1), torch.from_numpy(nrm),
                           torch.full((512,), -1, dtype=torch.int32), wt) == 0).all()


def _dark(scene, x1, nrm):
    """Points above every light vertex along an axis, normals along it: no
    vertex is above any point's horizon, so every weight is 0."""
    pa, pb, pc = scene.light_verts()
    top = float(torch.cat([pa, pb, pc])[:, 1].max()) + 1.0
    x1 = x1.copy()
    x1[:, 1] = top + np.abs(x1[:, 1])
    nrm = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (x1.shape[0], 1))
    return x1, nrm


@pytest.fixture(scope="module")
def cornell_pair(cornell_scene):
    cam = cornell_scene.camera
    return cornell_scene, scene_from_arrays(scene_arrays(cornell_scene), cam.width, cam.height,
                                            device="cpu")


@pytest.mark.parametrize("case", ["sees_no_light", "u_zero", "u_top", "cornell_fewer_lights"])
def test_pick_contract_matches_pallas_interpret(scenes, cornell_pair, case):
    """The pick contract K3 is held to: idx = count(cdf <= u * wsum),
    clamped to L - 1 — a point that sees no light gets L - 1 and wsum 0,
    u = 0 the first light of nonzero weight, u = 1 - 2**-24 the last one
    or, where u * wsum rounds to the last cdf value or above, L - 1 (the
    fringe by construction, so there picks are held to that rule, not to
    each other); and a scene with fewer lights than K3's threads per point
    (cornell: 2). The plain version matches the JAX kernel in interpret
    mode on each, picks except the CDF-boundary fringe."""
    js, ts = cornell_pair if case == "cornell_fewer_lights" else scenes
    x1, nrm, u = _points(ts, 512)
    if case == "sees_no_light":
        x1, nrm = _dark(ts, x1, nrm)
    elif case == "u_zero":
        u = np.zeros_like(u)
    elif case == "u_top":
        u = np.full_like(u, 1.0 - 2.0 ** -24)
    ij, wj = arvo_pallas.arvo_select(js, jnp.asarray(x1), jnp.asarray(nrm), jnp.asarray(u))
    C = arvo_cuda.pack_consts(ts)
    it, wt = arvo_cuda.arvo_select(C, *map(torch.from_numpy, (x1, nrm, u)))
    L = C.shape[0]
    assert it.dtype == torch.int32 and int(it.min()) >= 0 and int(it.max()) <= L - 1
    n_diff = int((np.asarray(ij) != it.numpy()).sum())
    assert case == "u_top" or n_diff <= 3, n_diff    # CDF-boundary fringe
    np.testing.assert_allclose(np.asarray(wj), wt.numpy(), rtol=1e-3, atol=1e-6)
    w, _ = arvo_cuda.prepare_from_consts(C, torch.from_numpy(x1), torch.from_numpy(nrm))
    lit = w.sum(dim=1) > 0
    if case == "sees_no_light":
        assert not bool(lit.any()) and bool((it == L - 1).all()) and bool((wt == 0).all())
        np.testing.assert_array_equal(np.asarray(ij), L - 1)
    elif case == "u_zero":                           # the first nonzero weight
        first = (w > 0).int().argmax(dim=1)
        assert bool(lit.any()) and torch.equal(it[lit], first[lit].int())
    elif case == "u_top":                            # the last nonzero weight, or L - 1
        last = (L - 1 - (w > 0).flip(1).int().argmax(dim=1)).int()
        assert bool(lit.any()) and bool(((it == last) | (it == L - 1))[lit].all())
        # JAX's Kogge-Stone cdf is not monotone across zero weights, so it
        # may also pick a zero-weight light after the last nonzero one.
        pj = torch.from_numpy(np.array(ij))
        assert bool((pj >= last)[lit].all())
        print(f"u_top: JAX picks a zero-weight light after the last nonzero on "
              f"{int(((pj != last) & (pj != L - 1))[lit].sum())} of {int(lit.sum())} points")
    else:
        assert L < 8 and bool(lit.any())


def test_pack_light_consts_is_pack_consts(scenes):
    """pack_consts is pack_light_consts on the scene's light triangles."""
    from monte_carlo_path_tracing_tpu_torch.core.radiometry import radiance_sum

    _, ts = scenes
    pa, pb, pc = ts.light_verts()
    C = arvo_cuda.pack_light_consts(pa, pb, pc, ts.geo_n[ts.light_tri_ids],
                                    radiance_sum(ts.light_emission()))
    assert C.shape == (ts.num_lights, arvo_cuda.N_CONSTS)
    assert torch.equal(C, arvo_cuda.pack_consts(ts))


def _searchsorted_picks(w, wsum, u):
    """The prepass's dense pick as a [chunk, L] cdf: cumsum, then
    searchsorted(right=True) of each pixel's row of thresholds u * wsum
    (u [R, N], rounds major), clamped to L - 1."""
    cdf = torch.cumsum(w, dim=-1)
    thresh = (u * wsum[None, :]).t().contiguous()
    return torch.clamp(torch.searchsorted(cdf, thresh, right=True),
                       max=w.shape[-1] - 1).t().to(torch.int32)


@pytest.mark.parametrize("case", ["random", "zero_rows", "ties"])
def test_round_picks_are_searchsorted(case):
    """rng.pick_from_uniform with uniforms [R, N] (the R-round pick of
    arvo_select_plain) is the cumsum + searchsorted(right=True)
    formulation bit for bit: on random rows, on rows of zero weight (all
    picks L - 1), and on tied cdf values (runs of zero weights, and
    thresholds that land exactly on a cdf value, which both count); each
    round is the [N] pick with its own uniforms."""
    g = torch.Generator().manual_seed(19)
    N, L, R = 257, 40, 6
    w = torch.rand(N, L, generator=g)
    u = torch.rand(R, N, generator=g)
    if case == "zero_rows":
        w[::3] = 0.0
    elif case == "ties":
        w = torch.randint(0, 3, (N, L), generator=g).float()       # integer cdf values
        cdf = torch.cumsum(w, dim=-1)
        col = torch.randint(0, L, (R, N), generator=g)
        u = torch.gather(cdf, 1, col.t()).t() / torch.clamp(cdf[:, -1], min=1.0)[None, :]
    wsum = w.sum(dim=-1)
    got = trng.pick_from_uniform(u, w, wsum)
    want = _searchsorted_picks(w, wsum, u)
    assert got.shape == (R, N) and got.dtype == torch.int32
    assert torch.equal(got, want)
    if case == "zero_rows":
        assert bool((got[:, ::3] == L - 1).all())
    if case == "ties":                  # thresholds on a cdf value occur
        thresh = u * wsum[None, :]
        assert bool((torch.cumsum(w, -1)[None] == thresh[..., None]).any())
    for r in range(R):
        assert torch.equal(trng.pick_from_uniform(u[r], w, wsum), got[r])


def test_plain_round_picks_on_veach(scenes):
    """arvo_select_plain with uniforms [R, N] at Veach's shading points:
    picks [R, N] equal to prepare + searchsorted(right=True) bit for bit,
    wsum the [N] call's; [1, N] is the [N] call."""
    _, ts = scenes
    x1, nrm, u = map(torch.from_numpy, _points(ts, 512, seed=2))
    C = arvo_cuda.pack_consts(ts)
    u4 = torch.stack([u, torch.flip(u, [0]), 1.0 - u, torch.zeros_like(u)])
    i4, w4 = arvo_cuda.arvo_select(C, x1, nrm, u4)
    w, wsum = tls.prepare(ts, x1, nrm, consts=C)
    assert torch.equal(i4, _searchsorted_picks(w, wsum, u4)) and torch.equal(w4, wsum)
    i1, w1 = arvo_cuda.arvo_select(C, x1, nrm, u)
    i11, w11 = arvo_cuda.arvo_select(C, x1, nrm, u[None])
    assert i11.shape == (1, 512) and torch.equal(i11[0], i1) and torch.equal(w11, w1)
    assert torch.equal(i4[0], i1)
