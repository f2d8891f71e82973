"""The port's CUDA kernels K1-K5 against their plain torch versions (K4 / K5
also against K1 / K2), and the port's renders on the card against the same
renders on the CPU: the regeneration render uncached and cached, bathroom
with accel="auto" (K4 / K5 in the loop), the fixed-depth render_image,
pixel_grad, recover_materials, and the sharded regeneration render at
world size 1 on NCCL; utils.profiling.device_trace's trace of K1.

Needs an NVIDIA GPU: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.ops import _build, arvo_cuda, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.ops import intersect_ref
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.diff.grad import pixel_grad
from monte_carlo_path_tracing_tpu_torch.diff.inverse import recover_materials
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image, render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(name, wh=None):
    sc = load_scene(os.path.join(SCENES, name, f"{name}.obj"), device="cpu")
    if wh:
        sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=wh, height=wh))
    return sc


def _rays(T, N, dev, seed=0):
    g = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    W = intersect_ref.pack_tri_matrix(f(g.uniform(-2, 2, (T, 3))), f(g.normal(size=(T, 3))),
                                      f(g.normal(size=(T, 3)))).contiguous()
    rd = g.normal(size=(N, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    g10 = intersect_ref.ray_features(f(g.uniform(-4, 4, (N, 3))), f(rd)).contiguous()
    excl = torch.from_numpy(np.where(np.arange(N) % 7 == 0, np.arange(N) % T, -1)
                            .astype(np.int32)).to(dev)
    tmax = f(g.uniform(0.5, 6.0, N)) * (1.0 - ops_intersect.OCCLUSION_MARGIN)
    return g10, W, torch.arange(T, dtype=torch.int32, device=dev), excl, tmax


@pytest.mark.parametrize("T,N", [(1, 5), (300, 257), (3000, 4097)])
def test_k1_k2_match_plain(dev, T, N):
    """With separately rounded dots K1 / K2 are the plain versions bit for
    bit (ordered dots, -fmad=false). With fused dots (the default) ids and
    flags may differ only on pairs whose margin is within an ulp of zero
    (at most 0.1% of rays, one for small batches); t / u / v on equal ids
    stay equal (winner recovery is separately rounded)."""
    g, W, ids, excl, tmax = _rays(T, N, dev, seed=T)
    n1, n2 = intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches
    hk = intersect_cuda.nearest_hit(g, W, ids, excl)
    hp = intersect_cuda.nearest_hit_plain(g, W, ids, excl)
    assert (intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches) == (n1 + 1, n2)
    same = hk.tri_id == hp.tri_id
    assert int((~same).sum()) <= max(1, N // 1000)
    for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)):
        torch.testing.assert_close(a[same], b[same], rtol=1e-6, atol=1e-6)
    hs = intersect_cuda.nearest_hit(g, W, ids, excl, fma=False)
    for a, b in ((hs.tri_id, hp.tri_id), (hs.t, hp.t), (hs.u, hp.u), (hs.v, hp.v)):
        assert torch.equal(a, b)
    bk = intersect_cuda.occluded(g, W, ids, excl, tmax)
    assert intersect_cuda.occluded.launches == n2 + 1
    bp = intersect_cuda.occluded_plain(g, W, ids, excl, tmax)
    assert int((bk != bp).sum()) <= max(1, N // 1000)
    assert torch.equal(intersect_cuda.occluded(g, W, ids, excl, tmax, fma=False), bp)


#: K1 / K2: rays per CTA (128 threads, 4 rays each, 4 threads per block of
#: rays: csrc/intersect.cu RB_THREADS, RB_R, RB_G); triangles per staged
#: tile.
RAYS_PER_CTA, TRI_TILE, RB_G = 128, 128, 4


@pytest.mark.parametrize("N", [1, RAYS_PER_CTA - 1, RAYS_PER_CTA + 1, 65537])
@pytest.mark.parametrize("T", [1, TRI_TILE - 1, TRI_TILE + 1])
def test_k1_k2_ragged_sizes(dev, T, N):
    """Ragged ray blocks and triangle tiles (the bulk copy of the last tile
    is 160 bytes a row): separately rounded equals the plain version, fused
    differs on the counted fringe only."""
    g, W, ids, excl, tmax = _rays(T, N, dev, seed=N + T)
    hp = intersect_cuda.nearest_hit_plain(g, W, ids, excl)
    bp = intersect_cuda.occluded_plain(g, W, ids, excl, tmax)
    hs = intersect_cuda.nearest_hit(g, W, ids, excl, fma=False)
    assert torch.equal(hs.tri_id, hp.tri_id) and torch.equal(hs.t, hp.t)
    assert torch.equal(intersect_cuda.occluded(g, W, ids, excl, tmax, fma=False), bp)
    hk = intersect_cuda.nearest_hit(g, W, ids, excl)
    assert int((hk.tri_id != hp.tri_id).sum()) <= max(1, N // 1000)
    bk = intersect_cuda.occluded(g, W, ids, excl, tmax)
    assert int((bk != bp).sum()) <= max(1, N // 1000)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_k1_tie_rule_duplicated_rows(dev, shift):
    """Every triangle twice over, the copy's ids + 2**20 and ``shift``
    rows of copies between: K1's threads take a tile's rows by index mod
    RB_G, so each triangle and its copy fall to different threads and the
    shuffle merge settles the tie. The lowest index wins every tie, so no
    hit lands on a copy."""
    T, N = 700, 3000
    assert T % RB_G == 0 and shift % RB_G
    g, W, ids, _, _ = _rays(T, N, dev, seed=5)
    excl = torch.full((N,), -1, dtype=torch.int32, device=dev)
    W2 = torch.cat([W, W[:shift], W]).contiguous()
    ids2 = torch.cat([ids, ids[:shift] + (1 << 20), ids + (1 << 20)]).contiguous()
    once = intersect_cuda.nearest_hit(g, W, ids, excl)
    twice = intersect_cuda.nearest_hit(g, W2, ids2, excl)
    assert bool(twice.valid.any()) and int((twice.tri_id >= (1 << 20)).sum()) == 0
    assert torch.equal(twice.tri_id, once.tri_id)


@pytest.mark.parametrize("where", [0, 150, 299])
def test_k2_all_blocked_and_never_blocked(dev, where):
    """Rays towards +z and a large triangle at z = 1 at index ``where`` of a
    soup that lies beyond z = 20: every ray is blocked with t_max = 10 (the
    CTAs' all-blocked exit), none with t_max = 0.5."""
    g0 = np.random.default_rng(where)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    T, N = 300, 5000
    v0 = np.concatenate([g0.uniform(-1, 1, (T, 2)), g0.uniform(20, 30, (T, 1))], -1)
    v0[where] = [-50.0, -50.0, 1.0]
    e1, e2 = g0.normal(size=(T, 3)), g0.normal(size=(T, 3))
    e1[where], e2[where] = [200.0, 0.0, 0.0], [0.0, 200.0, 0.0]
    W = intersect_ref.pack_tri_matrix(f(v0), f(e1), f(e2)).contiguous()
    ro = np.concatenate([g0.uniform(-0.5, 0.5, (N, 2)), np.zeros((N, 1))], -1)
    rd = np.tile([0.0, 0.0, 1.0], (N, 1)) + g0.normal(size=(N, 3)) * 0.05
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    g = intersect_ref.ray_features(f(ro), f(rd)).contiguous()
    ids = torch.arange(T, dtype=torch.int32, device=dev)
    excl = torch.full((N,), -1, dtype=torch.int32, device=dev)
    for t_max, want in ((10.0, True), (0.5, False)):
        tmax = torch.full((N,), t_max, device=dev)
        bp = intersect_cuda.occluded_plain(g, W, ids, excl, tmax)
        assert bool((bp == want).all())
        assert torch.equal(intersect_cuda.occluded(g, W, ids, excl, tmax), bp)


def _culled_case(T, N, dev, seed=0):
    """A random soup of small triangles (Morton-ordered accel with AABBs)
    and N rays: half a coherent fan from one point, half random."""
    g = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    accel = ops_intersect._build(
        f(g.uniform(-2, 2, (T, 3))), f(g.normal(size=(T, 3)) * 0.3),
        f(g.normal(size=(T, 3)) * 0.3), torch.arange(T, dtype=torch.int32, device=dev),
        ops_intersect.TRI_BLOCK)
    h = N // 2
    ro = np.concatenate([np.tile([-6.0, -5.0, -4.0], (h, 1)), g.uniform(-4, 4, (N - h, 3))])
    rd = np.concatenate([g.uniform(-0.7, 0.7, (h, 3)) - ro[:h], g.normal(size=(N - h, 3))])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    excl = torch.from_numpy(np.where(np.arange(N) % 7 == 0, np.arange(N) % T, -1)
                            .astype(np.int32)).to(dev)
    tmax = f(g.uniform(0.5, 8.0, N)) * (1.0 - ops_intersect.OCCLUSION_MARGIN)
    return accel, f(ro), f(rd), excl, tmax


@pytest.mark.parametrize("T,N", [(300, 257), (3000, 4097), (12000, 20000)])
def test_k4_k5_match_plain_and_k1_k2(dev, T, N):
    """On the same schedule K4 and K5 with separately rounded dots equal
    their plain versions bit for bit (same f32 arithmetic, same visit
    order): ids, t / u / v and flags; and culling changes no answer: K1 /
    K2 with separately rounded dots agree on the same rays. With fused
    dots (the default) K4's ids and K5's flags differ from their plain
    versions, and K5's from fused K2, only on a counted fringe (0.1% of
    rays, one for small batches), t / u / v on equal ids to 1e-6."""
    accel, ro, rd, excl, tmax = _culled_case(T, N, dev, seed=T)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    n4 = intersect_cuda.nearest_hit_culled.launches
    hk = intersect_cuda.nearest_hit_culled(*args, rows=c.rows)
    assert intersect_cuda.nearest_hit_culled.launches == n4 + 1
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows)
    _assert_k4_matches(args, c.rows, hp, max(1, N // 1000))
    same = hk.tri_id == hp.tri_id
    assert int((~same).sum()) <= max(1, N // 1000)
    for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)):
        torch.testing.assert_close(a[same], b[same], rtol=1e-6, atol=1e-6)
    g = ops_intersect.ray_features(ro, rd).contiguous()
    h1 = intersect_cuda.nearest_hit(g, accel.W, accel.tri_ids, excl, fma=False)
    assert (hp.tri_id[:N] == h1.tri_id).all()
    assert bool(h1.valid.any())

    # K5: separately rounded, the plain version bit for bit and K2's
    # separately rounded flags; fused (the default), a counted fringe of
    # both and of fused K2.
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl, tmax)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    n5 = intersect_cuda.occluded_culled.launches
    bk = intersect_cuda.occluded_culled(*args, rows=c.rows)
    assert intersect_cuda.occluded_culled.launches == n5 + 1
    bp = intersect_cuda.occluded_culled_plain(*args, rows=c.rows)
    bs = intersect_cuda.occluded_culled(*args, rows=c.rows, fma=False)
    b2 = intersect_cuda.occluded(g, accel.W, accel.tri_ids, excl, tmax, fma=False)
    assert torch.equal(bs, bp) and torch.equal(bs[:N], b2) and bool(b2.any())
    b2f = intersect_cuda.occluded(g, accel.W, accel.tri_ids, excl, tmax)
    fringe = max(1, N // 1000)
    assert int((bk != bp).sum()) <= fringe and int((bk[:N] != b2f).sum()) <= fringe


def test_culled_wrappers_reject_bad_schedules(dev):
    accel, ro, rd, excl, tmax = _culled_case(600, 300, dev)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    with pytest.raises(ValueError):          # rays not padded to the ray tile
        intersect_cuda.nearest_hit_culled(c.g[:300].contiguous(), c.W, c.tri_ids,
                                          c.excl[:300].contiguous(), c.bound[:300].contiguous(),
                                          c.order, c.te, rows=c.rows)
    with pytest.raises(TypeError):
        intersect_cuda.nearest_hit_culled(c.g, c.W, c.tri_ids, c.excl, c.bound,
                                          c.order.long(), c.te, rows=c.rows)
    shifted = torch.empty(c.W.numel() + 1, device=dev)[1:].view(c.W.shape)
    shifted.copy_(c.W)                       # 4 bytes off the 16-byte grid
    k4 = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl, tmax)
    k5 = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    for kernel, args in ((intersect_cuda.nearest_hit_culled, k4),
                         (intersect_cuda.occluded_culled, k5)):
        for rows in (-1, c.W.shape[0] + 1):  # real rows outside W
            with pytest.raises(ValueError):
                kernel(*args, rows=rows)
        with pytest.raises(ValueError):
            kernel(args[0], shifted, *args[2:], rows=c.rows)


def _quarters_case(dev, T=1000):
    """One ray tile (512 rays) from below a large triangle at z = 1 that
    sits at the end of a soup beyond z = 20: the quarters of 128 rays are
    all blocked (t_max 40, past the soup, so its tiles are visited too),
    never blocked (t_max 0.5) and two mixed (t_max U(0.5, 1.5))."""
    g0 = np.random.default_rng(T)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    v0 = np.concatenate([g0.uniform(-1, 1, (T, 2)), g0.uniform(20, 30, (T, 1))], -1)
    e1, e2 = g0.normal(size=(T, 3)) * 0.3, g0.normal(size=(T, 3)) * 0.3
    v0[T - 1], e1[T - 1], e2[T - 1] = [-50.0, -50.0, 1.0], [200.0, 0.0, 0.0], [0.0, 200.0, 0.0]
    accel = ops_intersect._build(f(v0), f(e1), f(e2), torch.arange(T, dtype=torch.int32,
                                                                   device=dev),
                                 ops_intersect.TRI_BLOCK)
    N = intersect_cuda.RAY_TILE
    ro = np.concatenate([g0.uniform(-0.5, 0.5, (N, 2)), np.zeros((N, 1))], -1)
    rd = np.tile([0.0, 0.0, 1.0], (N, 1)) + g0.normal(size=(N, 3)) * 0.05
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    q = np.arange(N) // 128
    tmax = np.where(q == 0, 40.0, np.where(q == 1, 0.5, g0.uniform(0.5, 1.5, N)))
    excl = torch.full((N,), -1, dtype=torch.int32, device=dev)
    return accel, f(ro), f(rd), excl, f(tmax)


def test_k5_quarters_of_a_ray_tile_differ(dev):
    """The four CTAs of a ray tile walk its one schedule row, each for its
    own 128 rays: one quarter all blocked (its CTA takes the all-blocked
    exit, with the next tiles' copies in flight), one never blocked, two
    mixed; each equals the plain version, and a second launch after the
    early exits does too."""
    accel, ro, rd, excl, tmax = _quarters_case(dev)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl, tmax)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    assert c.order.shape[0] == 1 and int((c.te < 1.5e38).sum()) >= 3
    bp = intersect_cuda.occluded_culled_plain(*args, rows=c.rows)
    quarters = bp.view(4, 128)
    assert bool(quarters[0].all()) and not bool(quarters[1].any())
    assert all(0 < int(quarters[i].sum()) < 128 for i in (2, 3))
    for _ in range(2):
        assert torch.equal(intersect_cuda.occluded_culled(*args, rows=c.rows, fma=False), bp)
        assert int((intersect_cuda.occluded_culled(*args, rows=c.rows) != bp).sum()) <= 1


@pytest.mark.parametrize("T", [257, 300, 511, 700, 1000])
def test_k5_last_schedule_tile_partly_padding(dev, T):
    """Triangle counts whose last schedule tile (256 rows) is partly
    padding: K5 copies and computes only the real rows below ``rows``, and
    with ``rows`` cut below the real count it leaves the cut rows out
    exactly as the plain version does."""
    accel, ro, rd, excl, tmax = _culled_case(T, 3000, dev, seed=T)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl, tmax)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    assert c.rows == T and c.W.shape[0] % 256 == 0 and c.W.shape[0] > T
    for rows in (T, T - 100, 130):
        bp = intersect_cuda.occluded_culled_plain(*args, rows=rows)
        assert torch.equal(intersect_cuda.occluded_culled(*args, rows=rows, fma=False), bp)
        assert int((intersect_cuda.occluded_culled(*args, rows=rows) != bp).sum()) <= 3
    assert bool(intersect_cuda.occluded_culled_plain(*args, rows=T).any())


def test_k5_all_blocked_exit_with_copies_in_flight(dev):
    """3,000 stacked large triangles (z = 1 + 0.001 i; 12 schedule tiles of
    256, fed as 24 ring stages) over rays towards +z: with t_max 100 (even
    ray tiles) the first triangle a thread tests blocks its rays, so each
    CTA leaves after its first stage while the next stage's copy is in
    flight, and waits for it; with t_max 0.5 (odd ray tiles) the schedule
    culls every tile and their CTAs visit none. Launched many times over,
    the flags stay the plain version's."""
    T, N = 3000, 4096
    g0 = np.random.default_rng(9)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    v0 = np.tile([-50.0, -50.0, 1.0], (T, 1)) + np.outer(np.arange(T) * 1e-3, [0.0, 0.0, 1.0])
    e1, e2 = np.tile([200.0, 0.0, 0.0], (T, 1)), np.tile([0.0, 200.0, 0.0], (T, 1))
    accel = ops_intersect._build(f(v0), f(e1), f(e2), torch.arange(T, dtype=torch.int32,
                                                                   device=dev),
                                 ops_intersect.TRI_BLOCK)
    ro = np.concatenate([g0.uniform(-0.5, 0.5, (N, 2)), np.zeros((N, 1))], -1)
    rd = np.tile([0.0, 0.0, 1.0], (N, 1)) + g0.normal(size=(N, 3)) * 0.05
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    far = (np.arange(N) // intersect_cuda.RAY_TILE) % 2 == 0
    excl = torch.full((N,), -1, dtype=torch.int32, device=dev)
    c = ops_intersect.culled_call(accel, slice(None), f(ro), f(rd), excl,
                                  f(np.where(far, 100.0, 0.5)))
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    bp = intersect_cuda.occluded_culled_plain(*args, rows=c.rows)
    assert torch.equal(bp, torch.from_numpy(far).to(dev))
    assert int((c.te < 1.5e38).sum(dim=1)[0::2].min()) == c.order.shape[1] == 12
    for fma in (False, True, False, True):
        for _ in range(10):
            out = intersect_cuda.occluded_culled(*args, rows=c.rows, fma=fma)
        assert torch.equal(out, bp)


def _assert_k4_matches(args, rows, hp, fringe, reps=1):
    """K4 with separately rounded dots is the plain version ``hp`` bit for
    bit (ids, t, u, v); with fused dots its ids differ on ``fringe`` rays at
    most. ``reps`` launches of each."""
    for _ in range(reps):
        hs = intersect_cuda.nearest_hit_culled(*args, rows=rows, fma=False)
        for a, b in ((hs.tri_id, hp.tri_id), (hs.t, hp.t), (hs.u, hp.u), (hs.v, hp.v)):
            assert torch.equal(a, b)
        hk = intersect_cuda.nearest_hit_culled(*args, rows=rows)
        assert int((hk.tri_id != hp.tri_id).sum()) <= fringe


#: The crafted tie case: triangle S at rows 10 (tile 0) and 300 (tile 1).
TIE_ORIGINAL, TIE_COPY = 10, 300


def _tie_accel(dev, seed=0):
    """Two triangle tiles of 256 rows that both hold one large triangle S at
    z = 5 (rows TIE_ORIGINAL and TIE_COPY; ids are the rows) and 512 rays
    from near the origin towards +z, all hitting S. Tile 0's other
    triangles lie behind S (z 6.4-9.6), tile 1's in front of it but off the
    rays (x 20-30), so the schedule visits tile 1 first and every ray ties
    between the copies of S. A hand-built accel, rows in this order."""
    g = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    v0 = np.concatenate([np.c_[g.uniform(-1, 1, (256, 2)), g.uniform(7, 9, 256)],
                         np.c_[g.uniform(20, 30, 256), g.uniform(-1, 1, 256),
                               g.uniform(1, 2, 256)]])
    e1, e2 = g.uniform(-0.3, 0.3, (512, 3)), g.uniform(-0.3, 0.3, (512, 3))
    for i in (TIE_ORIGINAL, TIE_COPY):
        v0[i], e1[i], e2[i] = [-50.0, -50.0, 5.0], [200.0, 0.0, 0.0], [0.0, 200.0, 0.0]
    v0, e1, e2 = f(v0), f(e1), f(e2)
    accel = ops_intersect.TriAccel(
        W=intersect_ref.pack_tri_matrix(v0, e1, e2).contiguous(),
        tri_ids=torch.arange(512, dtype=torch.int32, device=dev),
        aabb_lo=torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2)),
        aabb_hi=torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2)))
    ro = np.c_[g.uniform(-0.5, 0.5, (512, 2)), np.zeros(512)]
    rd = np.tile([0.0, 0.0, 1.0], (512, 1)) + g.normal(size=(512, 3)) * 0.05
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return accel, f(ro), f(rd), torch.full((512,), -1, dtype=torch.int32, device=dev)


def test_k4_tie_goes_to_the_first_visited_tile(dev):
    """The crafted tie case: the schedule visits tile 1 first, so every ray
    takes S's copy in it (row TIE_COPY), fused or not, though the lowest
    index is TIE_ORIGINAL; both instances are the plain version's."""
    accel, ro, rd, excl = _tie_accel(dev)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    assert c.order.tolist() == [[1, 0]]
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows)
    assert bool((hp.tri_id == TIE_COPY).all())
    _assert_k4_matches(args, c.rows, hp, 0)


def test_k4_quarters_end_at_different_tiles(dev):
    """One ray tile on a hand-made schedule of 8 triangle tiles (visit order
    a permutation, te[k] = k + 0.5, every row zero but one): visit k's
    triangle lies at z = k + 1 and covers the rays of quarter k // 2 only,
    each quarter off along x. Quarter q hits at visit 2q, in the first or
    the second stage of the tile, and its CTA's walk ends there, with the
    next tile's copy in flight: the four CTAs end at different tiles. K4
    equals the plain version; ids are the expected rows."""
    tile, nb, N = 256, 8, intersect_cuda.RAY_TILE
    perm = [5, 2, 7, 0, 3, 6, 1, 4]
    rows = [(37 * k + 100) % tile for k in range(nb)]
    g0 = np.random.default_rng(4)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    v0, e1, e2 = np.zeros((nb * tile, 3)), np.zeros((nb * tile, 3)), np.zeros((nb * tile, 3))
    for k in range(nb):
        i = perm[k] * tile + rows[k]
        v0[i], e1[i], e2[i] = [10.0 * (k // 2) - 2.0, -2.0, k + 1.0], [8.0, 0.0, 0.0], [0.0, 8.0, 0.0]
    W = intersect_ref.pack_tri_matrix(f(v0), f(e1), f(e2)).contiguous()
    q = np.arange(N) // 128
    ro = np.c_[10.0 * q + g0.uniform(-0.5, 0.5, N), g0.uniform(-0.5, 0.5, N), np.zeros(N)]
    rd = np.tile([0.0, 0.0, 1.0], (N, 1)) + g0.normal(size=(N, 3)) * 0.02
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    args = (intersect_ref.ray_features(f(ro), f(rd)).contiguous(), W,
            torch.arange(nb * tile, dtype=torch.int32, device=dev),
            torch.full((N,), -1, dtype=torch.int32, device=dev), torch.full((N,), 100.0, device=dev),
            torch.tensor([perm], dtype=torch.int32, device=dev),
            torch.arange(nb, device=dev, dtype=torch.float32)[None] + 0.5)
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=nb * tile)
    want = torch.tensor([perm[2 * qq] * tile + rows[2 * qq] for qq in q], dtype=torch.int32,
                        device=dev)
    assert torch.equal(hp.tri_id, want)
    _assert_k4_matches(args, nb * tile, hp, 0, reps=2)


@pytest.mark.parametrize("T", [257, 300, 511, 700, 1000])
def test_k4_last_schedule_tile_partly_padding(dev, T):
    """Triangle counts whose last schedule tile (256 rows) is partly
    padding: K4 copies and computes only the rows below ``rows``, and with
    ``rows`` cut below the real count it leaves the cut rows out exactly as
    the plain version does."""
    accel, ro, rd, excl, _ = _culled_case(T, 3000, dev, seed=T)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    assert c.rows == T and c.W.shape[0] % 256 == 0 and c.W.shape[0] > T
    for rows in (T, T - 100, 130):
        hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=rows)
        assert bool(hp.valid.any())
        _assert_k4_matches(args, rows, hp, 3)


def test_k4_walk_ends_with_copies_in_flight(dev):
    """3,000 stacked large triangles (z = 1 + 0.001 i; 12 schedule tiles of
    256, fed as 24 ring stages) over rays towards +z (even ray tiles): the
    first tile holds every ray's hit, so each CTA's walk ends after it while
    the next tile's first stage is in flight, and waits for it. Rays towards
    -z (odd ray tiles) miss the scene box (cap 0), so their CTAs visit no
    tile. Launched many times over, K4 stays the plain version."""
    T, N = 3000, 4096
    g0 = np.random.default_rng(9)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    v0 = np.tile([-50.0, -50.0, 1.0], (T, 1)) + np.outer(np.arange(T) * 1e-3, [0.0, 0.0, 1.0])
    e1, e2 = np.tile([200.0, 0.0, 0.0], (T, 1)), np.tile([0.0, 200.0, 0.0], (T, 1))
    accel = ops_intersect._build(f(v0), f(e1), f(e2), torch.arange(T, dtype=torch.int32,
                                                                   device=dev),
                                 ops_intersect.TRI_BLOCK)
    up = (np.arange(N) // intersect_cuda.RAY_TILE) % 2 == 0
    ro = np.concatenate([g0.uniform(-0.5, 0.5, (N, 2)), np.zeros((N, 1))], -1)
    rd = np.tile([0.0, 0.0, 1.0], (N, 1)) + g0.normal(size=(N, 3)) * 0.05
    rd[:, 2] *= np.where(up, 1.0, -1.0)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    excl = torch.full((N,), -1, dtype=torch.int32, device=dev)
    c = ops_intersect.culled_call(accel, slice(None), f(ro), f(rd), excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows)
    assert torch.equal(hp.tri_id, torch.from_numpy(np.where(up, 0, -1).astype(np.int32)).to(dev))
    assert c.order.shape[1] == 12 and bool((c.bound.view(-1, 512)[1::2] == 0).all())
    _assert_k4_matches(args, c.rows, hp, 0, reps=10)


#: K3's threads per point (csrc/arvo.cu G).
ARVO_G = 16


def _lights(L, dev, seed=0):
    """L random small light triangles above the points of :func:`_points`,
    facing down, with random radiance sums: the [L, 24] constants."""
    g = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    pa = g.uniform(-3, 3, (L, 3)) + [0.0, 4.0, 0.0]
    pb, pc = pa + g.normal(size=(L, 3)) * 0.3, pa + g.normal(size=(L, 3)) * 0.3
    nl = np.cross(pb - pa, pc - pa)
    nl *= np.where(nl[:, 1:2] > 0, -1.0, 1.0) / np.linalg.norm(nl, axis=-1, keepdims=True)
    return arvo_cuda.pack_light_consts(f(pa), f(pb), f(pc), f(nl), f(g.uniform(0.5, 5.0, L)))


def _points(N, dev, seed=1):
    g = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev).contiguous()  # noqa: E731
    nrm = g.normal(size=(N, 3)) * 0.5 + [0.0, 1.0, 0.0]
    return (f(g.uniform(-4, 4, (N, 3)) * [1.0, 0.2, 1.0]),
            f(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)), f(g.random(N)))


@pytest.mark.parametrize("L", [1, ARVO_G - 1, ARVO_G + 1, 320, 1000])
def test_k3_light_counts(dev, L):
    """K3 at light counts that leave its batches of G lights and its blocks
    of ceil(L / G) ragged (L not a multiple of G, L < G) and at 1,000
    lights, whose constants are read from global memory, not staged: picks
    equal the plain version's except the CDF-boundary fringe, wsum to rtol
    1e-5."""
    C = _lights(L, dev, seed=L)
    x1, nrm, u = _points(4099, dev, seed=L)
    ik, wk = arvo_cuda.arvo_select(C, x1, nrm, u)
    ip, wp = arvo_cuda.arvo_select_plain(C, x1, nrm, u)
    assert bool((wp > 0).any()) and int(ik.min()) >= 0 and int(ik.max()) < L
    assert int((ik != ip).sum()) <= 5
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["sees_no_light", "u_zero", "u_top"])
def test_k3_pick_edges(dev, case):
    """A point that sees no light gets L - 1 and wsum 0; u = 0 picks the
    first light of nonzero weight; u = 1 - 2**-24 the last one, or L - 1
    where u * wsum rounds to the last cdf value or above."""
    C = _lights(320, dev)
    x1, nrm, u = _points(4096, dev)
    L = C.shape[0]
    if case == "sees_no_light":                  # above every light, facing up
        x1 = x1 + torch.tensor([0.0, 20.0, 0.0], device=dev)
        nrm = torch.tensor([[0.0, 1.0, 0.0]], device=dev).expand_as(nrm).contiguous()
    else:
        u = torch.full_like(u, 0.0 if case == "u_zero" else 1.0 - 2.0 ** -24)
    ik, wk = arvo_cuda.arvo_select(C, x1, nrm, u)
    w, _ = arvo_cuda.prepare_from_consts(C, x1, nrm)
    lit = w.sum(dim=1) > 0
    if case == "sees_no_light":
        assert not bool(lit.any()) and bool((ik == L - 1).all()) and bool((wk == 0).all())
        return
    assert bool(lit.any())
    first = (w > 0).int().argmax(dim=1).int()
    last = (L - 1 - (w > 0).flip(1).int().argmax(dim=1)).int()
    # A weight whose sA lies within rounding of the 1e-6 cull may be zero in
    # one version only: counted.
    if case == "u_zero":
        assert int((ik != first)[lit].sum()) <= 2
    else:
        assert int((~((ik == last) | (ik == L - 1)))[lit].sum()) <= 2


def test_k3_matches_plain(dev):
    sc = _scene("veach-mis").to(dev)
    g = np.random.default_rng(3)
    v = sc.tri_v0.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    x1 = f(g.random((8192, 3)) * (hi - lo) * 0.8 + lo + 0.1 * (hi - lo))
    nrm = g.normal(size=(8192, 3))
    nrm = f(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    u = f(g.random(8192))
    C = arvo_cuda.pack_consts(sc)
    n3 = arvo_cuda.arvo_select.launches
    ik, wk = arvo_cuda.arvo_select(C, x1, nrm, u)
    ip, wp = arvo_cuda.arvo_select_plain(C, x1, nrm, u)
    assert arvo_cuda.arvo_select.launches == n3 + 1
    assert int((ik != ip).sum()) <= 8                 # CDF-boundary fringe
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    g, W, ids, excl, tmax = _rays(16, 8, dev)
    with pytest.raises(TypeError):
        intersect_cuda.nearest_hit(g.double(), W, ids, excl)
    with pytest.raises(ValueError):
        intersect_cuda.nearest_hit(g, W, ids, excl.cpu())
    with pytest.raises(ValueError):
        intersect_cuda.occluded(g, W, ids, excl, tmax[:4])
    with pytest.raises(ValueError):
        intersect_cuda.nearest_hit(g.t().contiguous().t(), W, ids, excl)
    assert _build.load() is _build.load()             # one build per process


@pytest.mark.parametrize("primary_cache", [False, None])
def test_render_card_matches_cpu(dev, primary_cache):
    """The port's render_image_regen on the card (K1-K3; K4 / K5 on the
    default, cached route) and on the CPU (plain versions): ray counts to
    0.1%, at most 1% of pixels diverged beyond rtol 1e-2 / atol 1e-3
    (transcendentals differ by ulps)."""
    sc = _scene("cornell", 24)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator="mis", seed=11, max_depth=32,
                       primary_cache=primary_cache)
    kernels = [intersect_cuda.nearest_hit, arvo_cuda.arvo_select]
    if primary_cache is None:
        kernels += [intersect_cuda.nearest_hit_culled, intersect_cuda.occluded_culled]
    counts = [k.launches for k in kernels]
    a = render_image_regen(sc, cfg, lanes=512)
    b = render_image_regen(sc.to(dev), cfg, lanes=512)
    assert all(k.launches > n for k, n in zip(kernels, counts))
    assert abs(a.rays_traced - b.rays_traced) <= a.rays_traced // 1000
    diverged = ~np.isclose(b.image, a.image, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)


def test_render_regen_sharded_world_size_1_matches_unsharded(dev, monkeypatch):
    """parallel.render_regen_sharded at world size 1 on NCCL, joined through
    init_distributed_if_needed under torchrun's variables: the cached route
    on the card (K1-K5 launch) equals render_image_regen of the same
    configuration within rtol 1e-5 / atol 1e-6 (index_add_ sums in another
    order), with the same ray count."""
    import socket

    import torch.distributed as dist

    from monte_carlo_path_tracing_tpu_torch.parallel import make_mesh
    from monte_carlo_path_tracing_tpu_torch.parallel.mesh import init_distributed_if_needed
    from monte_carlo_path_tracing_tpu_torch.parallel.sharded import render_regen_sharded

    sc = _scene("cornell", 24).to(dev)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator="mis", seed=11, max_depth=32)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                     LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    kernels = [intersect_cuda.nearest_hit, intersect_cuda.occluded, arvo_cuda.arvo_select,
               intersect_cuda.nearest_hit_culled, intersect_cuda.occluded_culled]
    try:
        init_distributed_if_needed(timeout_s=120)
        assert dist.get_backend() == "nccl"
        counts = [k.launches for k in kernels]
        fb, rays = render_regen_sharded(sc, cfg, rng.base_key(cfg.seed, device=dev),
                                        make_mesh((1,)), lanes_per_device=512, spp_cap=cfg.spp)
        assert all(k.launches > n for k, n in zip(kernels, counts))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    want = render_image_regen(sc, cfg, lanes=512)
    np.testing.assert_allclose(fb.reshape(24, 24, 3) / cfg.spp, want.image, rtol=1e-5, atol=1e-6)
    assert rays == want.rays_traced


@pytest.mark.parametrize("estimator", ["mis", "split", "brdf"])
def test_render_image_card_matches_cpu(dev, estimator):
    """The fixed-depth render_image on the card runs K1 (and K2 / K3 where
    the estimator samples lights), never the culled K4 / K5, and agrees
    with the CPU render: at most 1% of pixels diverged beyond rtol 1e-2 /
    atol 1e-3, image means within 1e-3."""
    sc = _scene("cornell", 24)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator=estimator, seed=11, max_depth=32,
                       ray_chunk=256)
    used = [intersect_cuda.nearest_hit]
    if estimator != "brdf":
        used += [intersect_cuda.occluded, arvo_cuda.arvo_select]
    unused = [intersect_cuda.nearest_hit_culled, intersect_cuda.occluded_culled]
    counts = [k.launches for k in used + unused]
    a = render_image(sc, cfg)
    b = render_image(sc.to(dev), cfg)
    after = [k.launches for k in used + unused]
    assert all(n1 > n0 for n0, n1 in zip(counts[:len(used)], after[:len(used)]))
    assert after[len(used):] == counts[len(used):]
    assert a.rays_traced == b.rays_traced == 2 * 24 * 24
    diverged = ~np.isclose(b.image, a.image, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)
    assert abs(b.image.mean() / a.image.mean() - 1.0) <= 1e-3


def test_pixel_grad_card_matches_cpu(dev):
    """pixel_grad through K1-K3 on the card against the plain versions on
    the CPU (cornell 16^2, MIS, depth 4): finite, cosine >= 0.999 per
    material field."""
    sc = _scene("cornell", 16)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=4, seed=0)
    out = []
    for s in (sc, sc.to(dev)):
        idx = torch.arange(256, device=s.device)
        ro, rd = generate_rays(s.camera, idx)
        key = rng.lane_keys(rng.base_key(3, device=s.device), idx)
        g = pixel_grad(s, cfg, key, ro, rd, torch.ones(256, 3, device=s.device))
        out.append({f: getattr(g, f).detach().cpu().double().flatten()
                    for f in ("kd", "ks", "ns", "emission")})
    for f, a in out[0].items():
        b = out[1][f]
        assert bool(torch.isfinite(b).all()), f
        if float(a.norm()) == 0.0:
            assert float(b.norm()) == 0.0, f
            continue
        assert float(a @ b / (a.norm() * b.norm())) >= 0.999, f


def test_bathroom_auto_card_matches_cpu(dev):
    """Bathroom (29,596 triangles) at 64^2 with the default accel="auto":
    on the card the loop's traces run through K4 / K5 (launches beyond the
    prepass's three: the warm-up's and the render's camera fans and one
    shadow batch), never K1 / K2; the CPU runs the plain culled versions.
    Ray counts to 0.1%, at most 1% of pixels diverged beyond rtol 1e-2 /
    atol 1e-3."""
    sc = _scene("bathroom", 64)
    cfg = RenderConfig(width=64, height=64, spp=1, estimator="mis", seed=3, max_depth=3)
    kernels = [intersect_cuda.nearest_hit, intersect_cuda.occluded,
               intersect_cuda.nearest_hit_culled, intersect_cuda.occluded_culled]
    a = render_image_regen(sc, cfg, lanes=4096)
    counts = [k.launches for k in kernels]
    b = render_image_regen(sc.to(dev), cfg, lanes=4096)
    k1, k2, k4, k5 = (k.launches - n for k, n in zip(kernels, counts))
    assert k1 == k2 == 0 and k4 > 2 and k5 > 1, (k1, k2, k4, k5)
    assert abs(a.rays_traced - b.rays_traced) <= a.rays_traced // 1000
    diverged = ~np.isclose(b.image, a.image, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)


def test_recover_materials_card_matches_cpu(dev):
    """Three steps of recover_materials (cornell 16^2, MIS, depth 3, 128
    rays a step) on the card, through K1-K3, against the CPU: the same
    streams, so losses to rtol 1e-3 and latents to atol 1e-4 (the kernels'
    fused dots and the transcendentals differ by ulps)."""
    sc = _scene("cornell", 16)
    cfg = RenderConfig(width=16, height=16, spp=1, estimator="mis", max_depth=3, seed=0)
    init = dataclasses.replace(sc.materials, kd=torch.clamp(sc.materials.kd + 0.2, 0.02, 0.95))
    kw = dict(steps=3, lr=0.1, rays_per_step=128, seed=2)
    a = recover_materials(sc, init, cfg, **kw)
    kernels = [intersect_cuda.nearest_hit, intersect_cuda.occluded, arvo_cuda.arvo_select]
    counts = [k.launches for k in kernels]
    b = recover_materials(sc.to(dev), init, cfg, **kw)
    assert all(k.launches > n for k, n in zip(kernels, counts))
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-3)
    for x, y in zip(dgrad.latent_leaves(dgrad.to_latent(b.materials)),
                    dgrad.latent_leaves(dgrad.to_latent(a.materials))):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,n_lights", [("cornell", 2), ("veach-mis", 320)])
def test_k1_on_the_lights_only_accel(dev, name, n_lights):
    """K1 on the ref_mis_weights light accel (T = 2 or 320 light triangles,
    global ids): BRDF-like rays from random points toward the lights
    against the plain version; ids may differ on 0.1% (fused dots), the
    separately rounded instance is bit-equal."""
    path = os.path.join(SCENES, name, "veach-mis.obj" if "veach" in name else f"{name}.obj")
    sc = load_scene(path, device="cpu").to(dev)
    la = ops_intersect.build_light_accel(sc)
    W, ids = la.real_rows()
    assert W.shape[0] == n_lights
    g = np.random.default_rng(4)
    N = 65536
    lo, hi = sc.tri_v0.amin(0).cpu().numpy(), sc.tri_v0.amax(0).cpu().numpy()
    ro = torch.as_tensor(g.uniform(lo, hi, (N, 3)).astype(np.float32), device=dev)
    tgt = sc.tri_v0[sc.light_tri_ids.long()][torch.as_tensor(g.integers(0, n_lights, N),
                                                               device=dev)]
    rd = torch.nn.functional.normalize(tgt - ro + 0.05 * torch.randn(N, 3, device=dev), dim=-1)
    g10 = intersect_ref.ray_features(ro, rd).contiguous()
    excl = torch.full((N,), -1, dtype=torch.int32, device=dev)
    n1 = intersect_cuda.nearest_hit.launches
    hk = intersect_cuda.nearest_hit(g10, W, ids, excl)
    assert intersect_cuda.nearest_hit.launches == n1 + 1
    hp = intersect_cuda.nearest_hit_plain(g10, W, ids, excl)
    assert int(hp.valid.sum()) > N // 10
    assert int((hk.tri_id != hp.tri_id).sum()) <= N // 1000
    hs = intersect_cuda.nearest_hit(g10, W, ids, excl, fma=False)
    assert torch.equal(hs.tri_id, hp.tri_id) and torch.equal(hs.t, hp.t)
    assert set(hp.tri_id[hp.valid].tolist()) <= set(sc.light_tri_ids.tolist())


def test_blocker_render_card_matches_cpu(dev):
    """mis_blocker_compat (uncached, the blocker-chain queue) on the card
    and on the CPU, cornell 32^2 x 2 spp: rays within 0.5%. A chain's
    stream is keyed by its place in the enqueue order, so one path that
    takes another turn on the card (fused dots, ulps) renumbers the later
    chains: chains agree within three Poisson sigmas and the means within
    1% (measured on an H100: 207 against 202 chains, means 6e-4 apart)."""
    from monte_carlo_path_tracing_tpu_torch.integrator import regen

    sc = _scene("cornell", 32)
    cfg = RenderConfig(width=32, height=32, spp=2, estimator="mis", seed=5, max_depth=32,
                       ref_mis_weights=True, mis_blocker_compat=True)
    out = {}
    for d in ("cpu", dev):
        fb, nrays, _, st = regen.render_regen(sc.to(d), cfg, rng.base_key(5), 1024, 2048,
                                              lanes=1024)
        out[str(d)] = (fb.cpu().numpy() / 2, int(nrays), st)
    (a, ra, sa), (b, rb, sb) = out["cpu"], out[str(dev)]
    assert sa.chains > 0 and sa.spilled == sb.spilled == 0
    assert abs(ra - rb) <= 0.005 * ra and abs(sa.chains - sb.chains) <= 3 * sa.chains ** 0.5
    assert abs(b.mean() / a.mean() - 1.0) < 1e-2


@pytest.mark.parametrize("change", [dict(estimator="shoot"), dict(accel="grid", grid_n0=5000),
                                    dict(ref_mis_weights=True)])
def test_compat_render_image_card_matches_cpu(dev, change):
    """render_image with the shoot estimator, the uniform grid or
    ref_mis_weights on the card (K1 in each) against the CPU: at most 1%
    of pixels beyond rtol 1e-2 / atol 1e-3."""
    sc = _scene("cornell", 24)
    cfg = RenderConfig(width=24, height=24, spp=2, max_depth=8, seed=3, **change)
    a = render_image(sc, cfg).image
    n1 = intersect_cuda.nearest_hit.launches
    b = render_image(sc.to(dev), cfg).image
    if "accel" not in change:
        assert intersect_cuda.nearest_hit.launches > n1
    assert np.isfinite(b).all()
    diverged = ~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)


def test_device_trace_records_the_kernels(dev, tmp_path):
    """utils.profiling.device_trace on the card: each K1 launch inside the
    block is one nearest_kernel event in the written Chrome trace; a block
    that runs no kernel raises (no CPU-only trace), and writes nothing."""
    import json

    from monte_carlo_path_tracing_tpu_torch.utils.profiling import device_trace

    g, W, ids, excl, _ = _rays(300, 257, dev)
    intersect_cuda.nearest_hit(g, W, ids, excl)          # build and warm up outside
    torch.cuda.synchronize()
    n1 = intersect_cuda.nearest_hit.launches
    with device_trace(str(tmp_path / "t"), device="cuda") as prof:
        for _ in range(3):
            intersect_cuda.nearest_hit(g, W, ids, excl)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("nearest_kernel" in n for n in names) == intersect_cuda.nearest_hit.launches - n1
    assert intersect_cuda.nearest_hit.launches - n1 == 3
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        with device_trace(str(tmp_path / "empty"), device="cuda"):
            torch.ones(3).sum()
    assert not os.listdir(tmp_path / "empty")
