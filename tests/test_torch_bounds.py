"""The pair counts behind K2's, K4's and K5's bounds in ``chip_smoke.py``.

``chip_smoke.anyhit_pairs`` counts the (ray, triangle) pairs an any-hit
call needs on its inputs: each ray's real triangles in visit order, up to
and including its first blocker. It is held here against a count made
pair by pair with the plain K2 on one triangle at a time, on small scenes
whose rays are blocked at the first triangle, at the last, never, or as a
random soup gives it; in accel order (K2) and on a culling schedule (K5).
``chip_smoke.nearest_culled_pairs`` (K4) is held against a count made pair
by pair from the schedule.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda, intersect_ref

BIG_T = intersect_ref.BIG_T


def _tri(v0, e1, e2):
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return intersect_ref.pack_tri_matrix(f(v0), f(e1), f(e2))


def _scene(case: str, n_rays: int, n_real: int, n_pad: int, seed: int):
    """Rays from near the origin towards +z, a soup of small triangles, and
    for "first" / "last" a large triangle at z = 1 across every ray at that
    index; padding rows (W = 0, id -2) at the end."""
    g = np.random.default_rng(seed)
    z = (20.0, 30.0) if case in ("first", "last", "never") else (0.5, 4.0)
    v0 = np.stack([g.uniform(-0.3, 0.3, n_real), g.uniform(-0.3, 0.3, n_real),
                   g.uniform(*z, n_real)], -1)
    W = _tri(v0, g.normal(size=(n_real, 3)) * 0.3, g.normal(size=(n_real, 3)) * 0.3)
    big = _tri([[-50.0, -50.0, 1.0]], [[200.0, 0.0, 0.0]], [[0.0, 200.0, 0.0]])
    if case in ("first", "last"):
        W[0 if case == "first" else n_real - 1] = big[0]
    W = torch.cat([W, torch.zeros((n_pad, 10, 4))]).contiguous()
    ids = torch.cat([torch.arange(n_real, dtype=torch.int32),
                     torch.full((n_pad,), -2, dtype=torch.int32)])
    ro = np.stack([g.uniform(-0.1, 0.1, n_rays), g.uniform(-0.1, 0.1, n_rays),
                   np.zeros(n_rays)], -1)
    rd = np.tile([0.0, 0.0, 1.0], (n_rays, 1)) + g.normal(size=(n_rays, 3)) * 0.05
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    gf = intersect_ref.ray_features(torch.as_tensor(ro, dtype=torch.float32),
                                    torch.as_tensor(rd, dtype=torch.float32)).contiguous()
    # Every 5th ray excludes the large triangle's index (quirk Q8).
    mine = n_real - 1 if case == "last" else 0
    excl = torch.as_tensor(np.where(np.arange(n_rays) % 5 == 0, mine, -1), dtype=torch.int32)
    tmax = torch.full((n_rays,), 0.5 if case == "never" else 10.0)
    if case == "soup":
        tmax = torch.as_tensor(g.uniform(0.5, 5.0, n_rays), dtype=torch.float32)
    return gf, W, ids, excl, tmax


def _brute(g, W, ids, excl, tmax, order, te):
    """Pairs needed, one ray and one triangle at a time."""
    nrt, nb = order.shape
    rt, tile = g.shape[0] // nrt, W.shape[0] // nb
    total = 0
    for i in range(g.shape[0]):
        r = i // rt
        done = False
        for k in range(nb):
            if done or not float(te[r, k]) < BIG_T / 2:
                continue
            for j in range(int(order[r, k]) * tile, (int(order[r, k]) + 1) * tile):
                if int(ids[j]) < 0:
                    continue
                total += 1
                if bool(intersect_cuda.occluded_plain(g[i:i + 1], W[j:j + 1], ids[j:j + 1],
                                                      excl[i:i + 1], tmax[i:i + 1])[0]):
                    done = True
                    break
    return total


@pytest.mark.parametrize("case", ["first", "last", "never", "soup"])
def test_anyhit_pairs_k2_matches_brute_force(case):
    g, W, ids, excl, tmax = _scene(case, n_rays=23, n_real=37, n_pad=11, seed=7)
    blocked = intersect_cuda.occluded_plain(g, W, ids, excl, tmax)
    want = {"first": (0.7, 0.9), "last": (0.7, 0.9), "never": (0.0, 0.0), "soup": (0.1, 0.9)}[case]
    assert want[0] <= float(blocked.float().mean()) <= want[1], case
    one = torch.zeros((1, 1), dtype=torch.int32)
    got = chip_smoke.anyhit_pairs(g, W, ids, excl, tmax)
    assert got == _brute(g, W, ids, excl, tmax, one, torch.zeros((1, 1)))
    if case == "first":       # blocked rays need one pair, the excluding ones all 37
        n_ex = int((excl >= 0).sum())
        assert got == (23 - n_ex) + n_ex * 37
    if case in ("last", "never"):
        assert got == 23 * 37


@pytest.mark.parametrize("case", ["first", "soup"])
def test_anyhit_pairs_k5_schedule_matches_brute_force(case):
    """Two ray tiles of 12 and three triangle tiles of 16 (the last padded),
    visited in a per-ray-tile order with one tile culled (te = BIG_T)."""
    g, W, ids, excl, tmax = _scene(case, n_rays=24, n_real=40, n_pad=8, seed=11)
    order = torch.tensor([[2, 0, 1], [1, 2, 0]], dtype=torch.int32)
    te = torch.tensor([[0.1, 0.3, BIG_T], [0.2, 0.4, BIG_T]])
    got = chip_smoke.anyhit_pairs(g, W, ids, excl, tmax, order=order, te=te)
    assert got == _brute(g, W, ids, excl, tmax, order, te)
    assert 0 < got < 24 * 40


@pytest.mark.parametrize("case", ["mixed", "behind"])
def test_arvo_seen_pairs_matches_brute_force(case):
    """K3's bound counts a weight only for the (point, light) pairs that
    pass its culls: ``chip_smoke.arvo_seen_pairs`` on the packed constants
    equals the count made from the vertices pair by pair (front: the point
    lies on the side the light's normal faces; above: some vertex lies above
    the point's horizon), and every pair of nonzero weight is among them."""
    from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda

    g = np.random.default_rng(5)
    n_pts, L = 40, 13
    pa = g.uniform(-2, 2, (L, 3)) + [0.0, 3.0, 0.0]
    pb, pc = pa + g.normal(size=(L, 3)) * 0.4, pa + g.normal(size=(L, 3)) * 0.4
    nl = np.cross(pb - pa, pc - pa)
    nl /= np.linalg.norm(nl, axis=-1, keepdims=True)
    if case == "behind":                      # every light faces up, away from the points
        nl = np.tile([0.0, 1.0, 0.0], (L, 1))
    x = np.stack([g.uniform(-3, 3, n_pts), g.uniform(-1, 0, n_pts), g.uniform(-3, 3, n_pts)], -1)
    nrm = g.normal(size=(n_pts, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    C = arvo_cuda.pack_light_consts(f(pa), f(pb), f(pc), f(nl), f(g.uniform(0.5, 5.0, L)))
    want = 0
    for i in range(n_pts):
        for j in range(L):
            front = np.dot(x[i] - pa[j], nl[j]) > 1e-6
            above = any(np.dot(nrm[i], v[j] - x[i]) > 1e-6 for v in (pa, pb, pc))
            want += bool(front and above)
    got = chip_smoke.arvo_seen_pairs(C, f(x), f(nrm))
    assert got == want
    w, _ = arvo_cuda.prepare_from_consts(C, f(x), f(nrm))
    assert int((w > 0).sum()) <= got
    assert (got == 0) if case == "behind" else (0 < got < n_pts * L)


@pytest.mark.parametrize("group,n", [(1, 24), (1, 21), (4, 24), (4, 21)])
def test_nearest_culled_pairs_matches_brute_force(group, n):
    """K4's count: for each of the first ``n`` rays, the real triangles of
    the tiles of its ray tile's schedule whose te is at most its final best
    t, or, with ``group``, the largest final best t of its group of
    consecutive rays. Two ray tiles of 12, three triangle tiles of 16 (the
    last padded), one culled tile (te = BIG_T) in each schedule."""
    g = np.random.default_rng(group + n)
    ids = torch.cat([torch.arange(40, dtype=torch.int32), torch.full((8,), -2, dtype=torch.int32)])
    c = SimpleNamespace(order=torch.tensor([[2, 0, 1], [1, 2, 0]], dtype=torch.int32),
                        te=torch.tensor([[0.1, 0.3, BIG_T], [0.2, 0.4, BIG_T]]),
                        g=torch.zeros((24, 10)), W=torch.zeros((48, 10, 4)), tri_ids=ids)
    best_t = torch.as_tensor(g.choice([0.05, 0.15, 0.25, 0.35, 0.5, 1.0], 24), dtype=torch.float32)
    far = best_t.view(-1, group).amax(dim=1).repeat_interleave(group)
    want = 0
    for i in range(n):
        r = i // 12
        for k in range(3):
            if float(c.te[r, k]) <= float(far[i]):
                tile = int(c.order[r, k])
                want += int((ids[tile * 16:(tile + 1) * 16] >= 0).sum())
    got = chip_smoke.nearest_culled_pairs(c, best_t, n, group=group)
    assert got == want and 0 < got < n * 40
