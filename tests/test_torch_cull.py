"""The port's culled intersection (K4 / K5 plain versions, their schedule and
the chunked composition of ops/intersect.py) against the JAX package.

JAX's culled Pallas kernels (``_kernel_nearest`` / ``_kernel_occluded`` with
``cull=True``) do not lower in interpret mode on the CPU (``pl.program_id``
inside the body's ``lax.cond``), so the JAX package's own tests run them
only where one triangle tile sends the call to the streamed kernel. Here
the kernel bodies themselves run tile by tile as plain JAX, ``program_id``
supplied per ray tile, on the inputs JAX's ``_call_nearest`` /
``_call_occluded`` build (``_pack_blocks``, ``_pad_rays``, ``_tile_aabbs``,
``_cull_masks``, ``_scene_exit_cap``).

Tolerances: the schedule's te to 1e-6 relative, visit orders equal except
between tiles whose te agree to that; given JAX's schedule, the port's
plain versions return the same triangle ids and blocked flags; with their
own schedule, ids and flags equal except a fringe of 0.5% of rays (XLA
contracts multiply-adds, the port rounds every op). K4 / K5 against their
plain versions on a card: tests/test_torch_cuda.py, whose crafted tie case
(:func:`test_torch_cuda._tie_accel`) is also run here against JAX."""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.integrator.regen import _primary_dirs
from monte_carlo_path_tracing_tpu.ops import intersect as jops
from monte_carlo_path_tracing_tpu.ops import intersect_pallas as jip
from monte_carlo_path_tracing_tpu.ops import intersect_ref as jir
from monte_carlo_path_tracing_tpu.render.camera import camera_basis, pixel_len
from monte_carlo_path_tracing_tpu.scene import load_scene as jax_load_scene
from monte_carlo_path_tracing_tpu_torch.ops import intersect as tops
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda as tic

from test_torch_cuda import TIE_COPY, TIE_ORIGINAL, _tie_accel
from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
T_EPS = jir.T_EPS


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_accel(a) -> tops.TriAccel:
    """A JAX TriAccel handed across."""
    return tops.TriAccel(W=_t(a.W), tri_ids=_t(a.tri_ids), aabb_lo=_t(a.aabb_lo),
                         aabb_hi=_t(a.aabb_hi))


def _fan(wh=32):
    """Veach accel and its camera fan: one ray per pixel of a wh^2 camera;
    t_max from each ray's nearest hit scaled by U(0.3, 1.2), so that about
    a quarter of the segments are blocked."""
    s = jax_load_scene(os.path.join(SCENES, "veach-mis", "veach-mis.obj"))
    s = dataclasses.replace(s, camera=dataclasses.replace(s.camera, width=wh, height=wh))
    u, v, n, d = camera_basis(s.camera)
    ro, rd = _primary_dirs(s.camera, u, v, n, d, pixel_len(s.camera, d),
                           jnp.arange(wh * wh, dtype=jnp.int32))
    accel = jops.build_accel(s)
    hit = jir.intersect_matmul(ro, rd, accel.W, accel.tri_ids)
    scale = np.random.default_rng(1).uniform(0.3, 1.2, wh * wh).astype(np.float32)
    tmax = jnp.where(hit.valid, hit.t, 30.0) * scale
    return accel, ro, rd, jnp.full((wh * wh,), -1, jnp.int32), tmax


def _random(T=700, N=1000, seed=3):
    """A random triangle soup (Morton-ordered accel) and incoherent rays,
    every 7th excluding a triangle."""
    g = np.random.default_rng(seed)
    f = lambda a: jnp.asarray(a.astype(np.float32))  # noqa: E731
    v0, e1, e2 = f(g.uniform(-2, 2, (T, 3))), f(g.normal(size=(T, 3))), f(g.normal(size=(T, 3)))
    accel = jops._build(v0, e1, e2, jnp.arange(T, dtype=jnp.int32), jops.TRI_BLOCK)
    rd = g.normal(size=(N, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    excl = np.where(np.arange(N) % 7 == 0, np.arange(N) % T, -1).astype(np.int32)
    return (accel, f(g.uniform(-4, 4, (N, 3))), f(rd), jnp.asarray(excl),
            f(g.uniform(0.5, 6.0, N)))


CASES = {"veach_fan": _fan, "random": _random}


class _Ref:
    """A kernel ref over a JAX array (whole-array writes only)."""

    def __init__(self, a=None):
        self.a = a

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, v):
        self.a = v


def _jax_culled(monkeypatch, accel, ro, rd, excl, scaled=None):
    """JAX's culled call (``_call_nearest`` / ``_call_occluded`` with the
    accel's AABBs), its kernel body run per ray tile. Returns (winner index
    into the padded W, or blocked flags, for the real rays; the inputs and
    schedule the kernel saw)."""
    N = ro.shape[0]
    g = jir.ray_features(ro, rd)
    tile = jip._tri_tile(accel.W.shape[0], "vpu", cull=True)
    Wb, idb, Wflat = jip._pack_blocks(accel.W, accel.tri_ids, tile)
    nb = Wb.shape[0]
    assert nb > 1
    if scaled is None:
        g, (ex, ro_p, rd_p) = jip._pad_rays(g, [excl, ro, rd], [-1, 0.0, 0.0])
    else:
        g, (ex, bound, ro_p, rd_p) = jip._pad_rays(g, [excl, scaled, ro, rd],
                                                   [-1, 0.0, 0.0, 0.0])
    lo_t, hi_t = jip._tile_aabbs(accel.aabb_lo, accel.aabb_hi, tile)
    if scaled is None:
        order, te = jip._cull_masks(ro_p, rd_p, lo_t, hi_t, jnp.full((g.shape[0],), jip._BIG_T))
        bound = jip._scene_exit_cap(ro_p, rd_p, lo_t, hi_t, T_EPS)
    else:
        order, te = jip._cull_masks(ro_p, rd_p, lo_t, hi_t, bound)
    RT = jip.RAY_TILE
    outs = []
    for i in range(g.shape[0] // RT):
        monkeypatch.setattr(jip, "pl", SimpleNamespace(program_id=lambda axis, i=i: i))
        sl = slice(i * RT, (i + 1) * RT)
        refs = [_Ref(g[sl]), _Ref(Wb), _Ref(idb), _Ref(ex[sl][:, None])]
        if scaled is None:
            t_ref, idx_ref = _Ref(), _Ref()
            jip._kernel_nearest(*refs, _Ref(order), _Ref(te), _Ref(bound[sl][:, None]), t_ref,
                                idx_ref, nb=nb, t_eps=T_EPS, mode="vpu", cull=True)
            outs.append(np.asarray(idx_ref.a[:, 0]))
        else:
            out_ref = _Ref()
            jip._kernel_occluded(*refs, _Ref(bound[sl][:, None]), _Ref(order), _Ref(te), out_ref,
                                 nb=nb, t_eps=T_EPS, mode="vpu", cull=True)
            outs.append(np.asarray(out_ref.a[:, 0]) > 0)
    sched = dict(g=g, W=Wflat, ids=idb.reshape(-1), excl=ex, bound=bound, order=order, te=te,
                 lo_t=lo_t, hi_t=hi_t, ro=ro_p, rd=rd_p)
    return np.concatenate(outs)[:N], sched


def _ids(idx, ids):
    ids = np.asarray(ids)
    return np.where(idx >= 0, ids[np.maximum(idx, 0)], -1)


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_jax(case):
    """tile_aabbs, cull_schedule and scene_exit_cap against JAX's
    _tile_aabbs, _cull_masks and _scene_exit_cap."""
    accel, ro, rd, _, tmax = CASES[case]()
    tile = tic.cull_tile(accel.W.shape[0])
    assert tile == jip._tri_tile(accel.W.shape[0], "vpu", cull=True)
    lo_j, hi_j = jip._tile_aabbs(accel.aabb_lo, accel.aabb_hi, tile)
    lo_t, hi_t = tic.tile_aabbs(_t(accel.aabb_lo), _t(accel.aabb_hi), tile)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))

    g = jir.ray_features(ro, rd)
    gp, (ro_p, rd_p, tm) = jip._pad_rays(g, [ro, rd, tmax], [0.0, 0.0, 0.0])
    gt, (ro_t, rd_t, tm_t) = tic.pad_rays(_t(g), [_t(ro), _t(rd), _t(tmax)], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gp))
    big = jnp.full((gp.shape[0],), jip._BIG_T)
    for t_cap, t_cap_t in ((big, _t(big)), (tm, tm_t)):
        o_j, te_j = (np.asarray(x) for x in jip._cull_masks(ro_p, rd_p, lo_j, hi_j, t_cap))
        o_t, te_t = tic.cull_schedule(ro_t, rd_t, lo_t, hi_t, t_cap_t)
        assert o_t.dtype == torch.int32 and o_t.shape == o_j.shape
        np.testing.assert_allclose(te_t.numpy(), te_j, rtol=1e-6)
        # Orders equal where te differs: a swapped pair holds equal te.
        te_unsorted = np.take_along_axis(te_j, np.argsort(o_j, axis=1), axis=1)
        picked = np.take_along_axis(te_unsorted, o_t.numpy().astype(np.int64), axis=1)
        np.testing.assert_allclose(picked, te_j, rtol=1e-6)
    cap_j = jip._scene_exit_cap(ro_p, rd_p, lo_j, hi_j, T_EPS)
    cap_t = tic.scene_exit_cap(ro_t, rd_t, lo_t, hi_t, T_EPS)
    np.testing.assert_allclose(cap_t.numpy(), np.asarray(cap_j), rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_culled_plain_matches_jax_kernels(monkeypatch, case):
    """On JAX's own schedule the plain versions of K4 / K5 return the JAX
    kernels' triangle ids and blocked flags; through ops/intersect.py, on
    the port's schedule, ids and flags agree except the fringe."""
    accel, ro, rd, excl, tmax = CASES[case]()
    N = ro.shape[0]
    idx_j, s = _jax_culled(monkeypatch, accel, ro, rd, excl)
    ids_j = _ids(idx_j, s["ids"])
    args = [_t(s[k]) for k in ("g", "W", "ids", "excl", "bound", "order", "te")]
    hp = tic.nearest_hit_culled_plain(*args, rows=args[1].shape[0])
    np.testing.assert_array_equal(hp.tri_id[:N].numpy(), ids_j)

    scaled = tmax * (1.0 - jops.OCCLUSION_MARGIN)
    blk_j, s = _jax_culled(monkeypatch, accel, ro, rd, excl, scaled)
    args = [_t(s[k]) for k in ("g", "W", "ids", "excl", "bound", "order", "te")]
    np.testing.assert_array_equal(
        tic.occluded_culled_plain(*args, rows=args[1].shape[0])[:N].numpy(), blk_j)
    assert 0 < blk_j.sum() < N

    pa = _port_accel(accel)
    h = tops.intersect(pa, _t(ro), _t(rd), _t(excl), cull=True)
    b = tops.occluded(pa, _t(ro), _t(rd), _t(tmax), _t(excl), cull=True)
    n_id, n_blk = int((h.tri_id.numpy() != ids_j).sum()), int((b.numpy() != blk_j).sum())
    print(f"{case}: ids differ on {n_id}, flags on {n_blk} of {N} rays")
    assert n_id <= N // 200 and n_blk <= N // 200
    # Culling changes no answer: the all-pairs kernels' plain versions agree.
    h_all = tops.intersect(pa, _t(ro), _t(rd), _t(excl))
    assert (h_all.tri_id == h.tri_id).all()
    assert (tops.occluded(pa, _t(ro), _t(rd), _t(tmax), _t(excl)) == b).all()


@pytest.mark.parametrize("scene,block,chunk", [("cornell", 64, 64), ("veach-mis", 512, 1024)])
def test_chunked_cull_composition_matches(monkeypatch, scene, block, chunk):
    """Above CULL_CHUNK_TRIS the culled path runs per Morton-contiguous
    chunk (cornell: one-tile chunks, so each falls back to the all-pairs
    kernel as in JAX; veach: 1,024-triangle chunks, culled) and composes
    the hits; identical to the unchunked all-pairs path."""
    from monte_carlo_path_tracing_tpu_torch.render.camera import primary_dirs
    from monte_carlo_path_tracing_tpu_torch.render import camera as tcam
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene

    s = load_scene(os.path.join(SCENES, scene, f"{scene}.obj"), device="cpu")
    cam = dataclasses.replace(s.camera, width=24, height=16)
    u, v, n, d = tcam.camera_basis(cam)
    ro, rd = primary_dirs(cam, u, v, n, d, tcam.pixel_len(cam, d), torch.arange(24 * 16))
    accel = tops.build_accel(s, block=block)
    assert accel.W.shape[0] > chunk
    ref = tops.intersect(accel, ro, rd)
    t_max = torch.full((24 * 16,), 5.0)
    occ_ref = tops.occluded(accel, ro, rd, t_max)
    monkeypatch.setattr(tops, "CULL_CHUNK_TRIS", chunk)
    got = tops.intersect(accel, ro, rd, cull=True)
    assert (got.tri_id == ref.tri_id).all()
    torch.testing.assert_close(got.t, ref.t, rtol=1e-6, atol=0.0)
    assert (tops.occluded(accel, ro, rd, t_max, cull=True) == occ_ref).all()


def test_culled_wrappers_take_plain_versions_on_cpu():
    """CPU tensors go to the plain versions (no launch counted); a triangle
    set of one tile has nothing to cull (culled_call is None)."""
    accel, ro, rd, excl, tmax = _fan(16)
    pa = _port_accel(accel)
    counts = (tic.nearest_hit_culled.launches, tic.occluded_culled.launches)
    c = tops.culled_call(pa, slice(None), _t(ro), _t(rd), _t(excl))
    assert c.g.shape[0] % tic.RAY_TILE == 0 and c.order.shape == c.te.shape
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    a, b = (tic.nearest_hit_culled(*args, rows=c.rows),
            tic.nearest_hit_culled_plain(*args, rows=c.rows))
    assert (a.tri_id == b.tri_id).all() and torch.equal(a.t, b.t)
    c = tops.culled_call(pa, slice(None), _t(ro), _t(rd), _t(excl), _t(tmax))
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    assert torch.equal(tic.occluded_culled(*args, rows=c.rows),
                       tic.occluded_culled_plain(*args, rows=c.rows))
    assert counts == (tic.nearest_hit_culled.launches, tic.occluded_culled.launches)
    assert tops.culled_call(pa, slice(0, 200), _t(ro), _t(rd), _t(excl)) is None


def test_culled_kernel_shapes_are_checked():
    """The kernels' tile limits are checked before a launch: ray tiles of
    RAY_TILE rays, triangle tiles of at most CULL_TILE."""
    order = torch.zeros((4, 14), dtype=torch.int32)
    te = torch.zeros((4, 14))
    assert tic._culled_shape("k", 2048, 3584, order, te) == (4, 14, 256)
    for N, T, o in ((2000, 3584, order), (2048, 3584, order[:, :7].contiguous()),
                    (4 * 1024, 3584, order), (4 * 128, 3584, order), (4 * 48, 3584, order),
                    (2048, 3584, order[0])):
        with pytest.raises(ValueError):
            tic._culled_shape("k", N, T, o, te if o.shape == te.shape else o)


@pytest.mark.parametrize("chunk", [None, 1024])
def test_culled_call_real_rows(monkeypatch, chunk):
    """culled_call hands K5 the count of real rows of its triangles: the
    Morton-ordered accel keeps its padding last, so real rows are a prefix
    (ids >= 0 below the count, padding ids -2 from it). Veach: 3,136 real
    rows of 3,584 in one call, or 1,024 / 1,024 / 1,024 / 64 in chunks of
    1,024. The plain K5 leaves the rows at and above the count out, which
    changes no flag; the same rows cut below a blocker do."""
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene

    s = load_scene(os.path.join(SCENES, "veach-mis", "veach-mis.obj"), device="cpu")
    accel = tops.build_accel(s)
    assert (accel.num_tris, accel.W.shape[0]) == (3136, 3584)
    accel_j, ro, rd, excl, tmax = _fan(16)
    ro, rd, excl = _t(ro), _t(rd), _t(excl)
    tmax = _t(tmax) * (1.0 - tops.OCCLUSION_MARGIN)
    if chunk:
        monkeypatch.setattr(tops, "CULL_CHUNK_TRIS", chunk)
    want = [1024, 1024, 1024, 64] if chunk else [3136]
    got = []
    for sl in tops._chunks(accel):
        c = tops.culled_call(accel, sl, ro, rd, excl, tmax)
        ids = c.tri_ids
        assert bool((ids[:c.rows] >= 0).all()) and bool((ids[c.rows:] == -2).all())
        args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
        full = tic.occluded_culled_plain(*args, rows=c.W.shape[0])
        assert torch.equal(tic.occluded_culled_plain(*args, rows=c.rows), full)
        assert torch.equal(tic.occluded_culled(*args, rows=c.rows, fma=False), full)
        got.append(c.rows)
        if bool(full.any()):                 # rows cut to none: nothing blocks
            assert not bool(tic.occluded_culled_plain(*args, rows=0).any())
    assert got == want
    hand = tops.TriAccel(W=accel.W, tri_ids=accel.tri_ids, aabb_lo=accel.aabb_lo,
                         aabb_hi=accel.aabb_hi)
    assert tops.culled_call(hand, slice(None), ro, rd, excl, tmax).rows == 3584



def test_k4_tie_goes_to_the_first_visited_tile(monkeypatch):
    """One triangle in two triangle tiles, the higher-indexed tile visited
    first: every ray ties between the two copies, and the first visited
    copy wins, in JAX's culled kernel body and in the port's plain K4 (on
    either schedule); the all-pairs rule, lowest index, picks the other."""
    accel, ro, rd, excl = _tie_accel("cpu")
    j = SimpleNamespace(**{k: jnp.asarray(getattr(accel, k).numpy())
                           for k in ("W", "tri_ids", "aabb_lo", "aabb_hi")})
    idx_j, s = _jax_culled(monkeypatch, j, *(jnp.asarray(x.numpy()) for x in (ro, rd, excl)))
    assert np.asarray(s["order"]).tolist() == [[1, 0]]
    np.testing.assert_array_equal(_ids(idx_j, s["ids"]), TIE_COPY)
    args = [_t(s[k]) for k in ("g", "W", "ids", "excl", "bound", "order", "te")]
    assert bool((tic.nearest_hit_culled_plain(*args, rows=512).tri_id == TIE_COPY).all())

    c = tops.culled_call(accel, slice(None), ro, rd, excl)
    assert c.order.tolist() == [[1, 0]] and c.rows == 512
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    assert bool((tic.nearest_hit_culled_plain(*args, rows=c.rows).tri_id == TIE_COPY).all())
    assert bool((tops.intersect(accel, ro, rd, excl).tri_id == TIE_ORIGINAL).all())


@pytest.mark.parametrize("chunk", [None, 1024])
def test_k4_plain_leaves_padding_rows_out(monkeypatch, chunk):
    """The plain K4 with ``rows`` = culled_call's real-row count returns
    what it returns with every row (the rows above are padding, never
    accepted): ids and t / u / v bit for bit, on Veach's camera fan in one
    call or in chunks of 1,024 triangles; with no rows, nothing is hit."""
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene

    s = load_scene(os.path.join(SCENES, "veach-mis", "veach-mis.obj"), device="cpu")
    accel = tops.build_accel(s)
    _, ro, rd, excl, _ = _fan(16)
    ro, rd, excl = _t(ro), _t(rd), _t(excl)
    if chunk:
        monkeypatch.setattr(tops, "CULL_CHUNK_TRIS", chunk)
    padded = hits = 0
    for sl in tops._chunks(accel):
        c = tops.culled_call(accel, sl, ro, rd, excl)
        args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
        full = tic.nearest_hit_culled_plain(*args, rows=c.W.shape[0])
        part = tic.nearest_hit_culled_plain(*args, rows=c.rows)
        for a, b in ((part.tri_id, full.tri_id), (part.t, full.t), (part.u, full.u),
                     (part.v, full.v)):
            assert torch.equal(a, b)
        assert not bool(tic.nearest_hit_culled_plain(*args, rows=0).valid.any())
        padded += c.W.shape[0] - c.rows
        hits += int(full.valid.sum())
    assert padded == 448 and hits > 0
