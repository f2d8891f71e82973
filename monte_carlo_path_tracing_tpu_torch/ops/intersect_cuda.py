"""Intersection kernels on CUDA, each beside its plain version.

Counterpart of ``monte_carlo_path_tracing_tpu/ops/intersect_pallas.py``:

- K1 :func:`nearest_hit` and K2 :func:`occluded` — the streamed kernels
  ``_kernel_nearest_s`` / ``_kernel_occluded_s`` (``csrc/intersect.cu``);
- K4 :func:`nearest_hit_culled` and K5 :func:`occluded_culled` — the culled
  kernels ``_kernel_nearest`` / ``_kernel_occluded`` with ``cull=True``
  (also ``csrc/intersect.cu``), and the culling schedule they consume
  (:func:`tile_aabbs`, :func:`cull_schedule`, :func:`scene_exit_cap`),
  which the JAX package computes in XLA outside its kernels and the port
  computes in plain torch.

The accept test is the Pallas kernels' margin form: after sign correction
by sign(det), a triangle is accepted iff u', v', |det|-u'-v', t'-t_eps|det|
and |det|-DET_EPS are all >= 0 and its id is not the ray's excluded id.

Every wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain torch version, a CUDA tensor to the kernel (or an error) — never
to the plain version.
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.ops import _build
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import (
    BIG_T, DET_EPS, NO_HIT, T_EPS, Hit, dot10, recover,
)

#: Triangles per block of the plain versions' [N, block] fields.
PLAIN_BLOCK = 512

#: Rays per tile of the culling schedule (JAX ``RAY_TILE``): one tile shares
#: one visit order; K4 / K5 run one CTA per tile (``CULL_RAYS`` there).
RAY_TILE = 512
#: Largest triangle tile of the culled kernels (JAX ``_tri_tile(cull=True)``).
CULL_TILE = 256
#: te at or above this marks a triangle tile the ray tile cannot touch.
_SKIP_TE = BIG_T / 2
#: Elements per plain-version field: bounds its memory on large batches.
_PLAIN_FIELD = 1 << 23


def _accept(g, Wb, ids, excl, t_eps):
    """Margin accept of every (ray, triangle) pair of a block: returns
    (ok [..., N,B], tp, adet), the arithmetic of the kernels' ``accept``;
    leading dimensions of ``g`` [..., N,10], ``Wb`` [..., B,10,4], ``ids``
    [..., B] and ``excl`` [..., N] batch tiles."""
    det, un, vn, tn = (dot10(g, Wb[..., c]) for c in range(4))
    s = torch.sign(det)
    adet = det * s
    up, vp, tp = un * s, vn * s, tn * s
    m = torch.minimum(up, vp)
    m = torch.minimum(m, adet - (up + vp))
    m = torch.minimum(m, tp - t_eps * adet)
    m = torch.minimum(m, adet - DET_EPS)
    ok = (m >= 0.0) & (ids[..., None, :] != excl[..., :, None])
    return ok, tp, adet


def nearest_hit_plain(g, W, tri_ids, excl, t_eps: float = T_EPS,
                      block: int = PLAIN_BLOCK) -> Hit:
    """Plain version of K1: running (min t, lowest index) over triangle
    blocks in accel order, then winner recovery."""
    N = g.shape[0]
    best_t = torch.full((N,), BIG_T, device=g.device)
    best_i = torch.full((N,), -1, dtype=torch.int64, device=g.device)
    for b0 in range(0, W.shape[0], block):
        ok, tp, adet = _accept(g, W[b0:b0 + block], tri_ids[b0:b0 + block], excl, t_eps)
        t = torch.where(ok, tp / torch.where(adet > 0, adet, torch.ones_like(adet)),
                        torch.full_like(tp, BIG_T))
        bt, bi = torch.min(t, dim=1)          # first minimal index
        better = bt < best_t
        best_t = torch.where(better, bt, best_t)
        best_i = torch.where(better, b0 + bi, best_i)
    return recover(g, W, tri_ids, best_i)


def occluded_plain(g, W, tri_ids, excl, tmax, t_eps: float = T_EPS,
                   block: int = PLAIN_BLOCK) -> torch.Tensor:
    """Plain version of K2: OR over triangle blocks of (accepted and
    t' < tmax |det|); ``tmax`` is already scaled by the occlusion margin."""
    blocked = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    for b0 in range(0, W.shape[0], block):
        ok, tp, adet = _accept(g, W[b0:b0 + block], tri_ids[b0:b0 + block], excl, t_eps)
        blocked |= (ok & (tp < tmax[:, None] * adet)).any(dim=1)
    return blocked


def _check_cuda(name, **tensors):
    """Device, dtype, shape and contiguity checks of a kernel call."""
    dev = tensors["g"].device
    want = {"g": torch.float32, "W": torch.float32, "tri_ids": torch.int32,
            "excl": torch.int32, "tmax": torch.float32, "cap": torch.float32,
            "order": torch.int32, "te": torch.float32}
    for k, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, g on {dev}")
        if t.dtype != want[k]:
            raise TypeError(f"{name}: {k} must be {want[k]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    N, T = tensors["g"].shape[0], tensors["W"].shape[0]
    if tensors["g"].shape != (N, 10) or tensors["W"].shape != (T, 10, 4):
        raise ValueError(f"{name}: g {tuple(tensors['g'].shape)}, W {tuple(tensors['W'].shape)}")
    for k in ("excl", "tmax", "cap"):
        if k in tensors and tensors[k].shape != (N,):
            raise ValueError(f"{name}: {k} must be [{N}]")
    if tensors["tri_ids"].shape != (T,):
        raise ValueError(f"{name}: tri_ids must be [{T}]")
    return N, T


def _check_aligned(name, W):
    """K1, K2, K4 and K5 copy tiles of W with Hopper bulk copies: 16-byte
    aligned."""
    if W.data_ptr() % 16:
        raise ValueError(f"{name}: W must be 16-byte aligned")


def _route(g: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if g.device.type == "cuda":
        return True
    if g.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {g.device}")


def nearest_hit(g, W, tri_ids, excl, t_eps: float = T_EPS, *, fma: bool = True) -> Hit:
    """Nearest hit of rays ``g`` [N,10] against packed triangles ``W``
    [T,10,4] (accel order) with ids ``tri_ids`` [T] and per-ray excluded
    ids ``excl`` [N]. CUDA tensors: K1, with fused (``fma``) or separately
    rounded dots; CPU tensors: the plain version."""
    if not _route(g, "nearest_hit"):
        return nearest_hit_plain(g, W, tri_ids, excl, t_eps)
    N, T = _check_cuda("nearest_hit", g=g, W=W, tri_ids=tri_ids, excl=excl)
    _check_aligned("nearest_hit", W)
    lib = _build.load()
    t = torch.empty(N, dtype=torch.float32, device=g.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tid = torch.empty(N, dtype=torch.int32, device=g.device)
    err = lib.mcpt_nearest(
        g.data_ptr(), W.data_ptr(), tri_ids.data_ptr(), excl.data_ptr(), N, T,
        float(t_eps), t.data_ptr(), u.data_ptr(), v.data_ptr(), tid.data_ptr(),
        int(fma), torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "nearest_hit (K1)")
    nearest_hit.launches += 1
    return Hit(t=t, tri_id=tid, u=u, v=v, valid=tid != NO_HIT)


def occluded(g, W, tri_ids, excl, tmax, t_eps: float = T_EPS, *,
             fma: bool = True) -> torch.Tensor:
    """[N] bool: some accepted triangle lies at t < ``tmax`` (pre-scaled by
    the occlusion margin). CUDA tensors: K2 (``fma`` as in
    :func:`nearest_hit`); CPU tensors: the plain version."""
    if not _route(g, "occluded"):
        return occluded_plain(g, W, tri_ids, excl, tmax, t_eps)
    N, T = _check_cuda("occluded", g=g, W=W, tri_ids=tri_ids, excl=excl, tmax=tmax)
    _check_aligned("occluded", W)
    lib = _build.load()
    out = torch.empty(N, dtype=torch.int32, device=g.device)
    err = lib.mcpt_occluded(
        g.data_ptr(), W.data_ptr(), tri_ids.data_ptr(), excl.data_ptr(),
        tmax.data_ptr(), N, T, float(t_eps), out.data_ptr(), int(fma),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "occluded (K2)")
    occluded.launches += 1
    return out != 0


nearest_hit.launches = 0
occluded.launches = 0


# ---------------------------------------------------------------------------
# K4 / K5: the culled kernels and their schedule
# ---------------------------------------------------------------------------

def cull_tile(T: int) -> int:
    """Triangle tile of a culled call over T triangles (JAX
    ``_tri_tile(T, cull=True)``)."""
    return min(CULL_TILE, -(-T // 256) * 256)


def pad_tris(W, tri_ids, lo, hi, tile: int):
    """Pad a triangle set to a multiple of ``tile`` with rows that are never
    accepted (W = 0, id -2) and empty AABBs (+inf, -inf)."""
    pad = (-W.shape[0]) % tile
    if not pad:
        return W, tri_ids, lo, hi
    dev = W.device
    inf = float("inf")
    return (torch.cat([W, W.new_zeros((pad, 10, 4))]),
            torch.cat([tri_ids, torch.full((pad,), NO_HIT - 1, dtype=torch.int32, device=dev)]),
            torch.cat([lo, torch.full((pad, 3), inf, device=dev)]),
            torch.cat([hi, torch.full((pad, 3), -inf, device=dev)]))


def pad_rays(g, extras, pad_vals):
    """Pad rays to a multiple of ``RAY_TILE`` (JAX ``_pad_rays``): features
    0 and each extra [N, ...] with its value, so the schedule of the last
    tile is JAX's."""
    pad = (-g.shape[0]) % RAY_TILE
    if not pad:
        return g, extras
    g = torch.cat([g, g.new_zeros((pad, 10))])
    extras = [torch.cat([e, torch.full((pad,) + e.shape[1:], v, dtype=e.dtype, device=e.device)])
              for e, v in zip(extras, pad_vals)]
    return g, extras


def tile_aabbs(lo, hi, tile: int):
    """Per-triangle AABBs [T,3] -> per-tile AABBs [nb,3] (JAX
    ``_tile_aabbs``; padding tiles are empty)."""
    pad = (-lo.shape[0]) % tile
    if pad:
        lo = torch.cat([lo, torch.full((pad, 3), float("inf"), device=lo.device)])
        hi = torch.cat([hi, torch.full((pad, 3), float("-inf"), device=hi.device)])
    nb = lo.shape[0] // tile
    return lo.reshape(nb, tile, 3).amin(dim=1), hi.reshape(nb, tile, 3).amax(dim=1)


def cull_schedule(ro, rd, lo_t, hi_t, t_cap):
    """Visit schedule of the culled kernels (JAX ``_cull_masks``): per ray
    tile, the triangle tiles in order of a conservative entry distance te.

    te comes from an interval slab test of the tile's origin box and
    direction box (t in [0, the tile's max ``t_cap``]) against each
    triangle tile's AABB; a direction interval that straddles zero gives no
    constraint. Tiles the ray tile cannot touch get te = BIG_T. Returns
    (order [nrt, nb] int32, te [nrt, nb] f32 sorted ascending); the sort is
    stable, so equal te keep triangle-tile order as jnp.argsort does."""
    nrt = ro.shape[0] // RAY_TILE
    o = ro.reshape(nrt, RAY_TILE, 3)
    d = rd.reshape(nrt, RAY_TILE, 3)
    o_lo, o_hi = o.amin(dim=1), o.amax(dim=1)
    d_lo, d_hi = d.amin(dim=1), d.amax(dim=1)
    tc = t_cap.reshape(nrt, RAY_TILE).amax(dim=1)

    n_lo = lo_t[None] - o_hi[:, None]                    # [nrt, nb, 3]
    n_hi = hi_t[None] - o_lo[:, None]
    dl = d_lo[:, None].expand_as(n_lo)
    dh = d_hi[:, None].expand_as(n_lo)
    straddle = (dl <= 0.0) & (dh >= 0.0)
    one = torch.ones_like(n_lo)
    dls = torch.where(straddle, one, dl)
    dhs = torch.where(straddle, one, dh)
    q = torch.stack([n_lo / dls, n_lo / dhs, n_hi / dls, n_hi / dhs])
    t_enter = torch.where(straddle, -BIG_T, q.amin(dim=0)).amax(dim=-1)   # [nrt, nb]
    t_exit = torch.where(straddle, BIG_T, q.amax(dim=0)).amin(dim=-1)
    nonempty = (hi_t >= lo_t).all(dim=-1)[None]
    ok = (t_enter <= t_exit) & (t_exit >= 0.0) & (t_enter <= tc[:, None]) & nonempty
    te = torch.where(ok, torch.clamp(t_enter, min=0.0), BIG_T)
    order = torch.argsort(te, dim=1, stable=True)
    return order.to(torch.int32).contiguous(), torch.gather(te, 1, order).contiguous()


def scene_exit_cap(ro, rd, lo_t, hi_t, t_eps: float = T_EPS) -> torch.Tensor:
    """Per-ray upper bound on any triangle hit t (JAX ``_scene_exit_cap``):
    the exit parameter of the ray against the scene's AABB, with slack; 0
    for rays that miss the box."""
    inf = float("inf")
    glo = torch.where(torch.isfinite(lo_t), lo_t, inf).amin(dim=0)
    ghi = torch.where(torch.isfinite(hi_t), hi_t, -inf).amax(dim=0)
    inv = 1.0 / torch.where(rd.abs() > 1e-30, rd, torch.full_like(rd, 1e-30))
    t0 = (glo[None] - ro) * inv
    t1 = (ghi[None] - ro) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit_box = t_far >= torch.clamp(t_near, min=0.0)
    cap = t_far * 1.001 + 1e-3 + t_eps
    return torch.where(hit_box, cap, 0.0).to(torch.float32).contiguous()


def _culled_tiles(g, W, tri_ids, excl, order, rows: int):
    """Tile views of a culled call: (g [nrt,rt,10], excl [nrt,rt],
    W [nb,tile,10,4], ids [nb,tile], real [nb,tile] (the rows below
    ``rows``), tile, rows per plain-version step)."""
    nrt, nb = order.shape
    rt, tile = g.shape[0] // nrt, W.shape[0] // nb
    real = (torch.arange(W.shape[0], device=g.device) < rows).view(nb, tile)
    return (g.view(nrt, rt, 10), excl.view(nrt, rt), W.view(nb, tile, 10, 4),
            tri_ids.view(nb, tile), real, tile, max(1, _PLAIN_FIELD // (rt * tile)))


def nearest_hit_culled_plain(g, W, tri_ids, excl, cap, order, te,
                             t_eps: float = T_EPS, *, rows: int) -> Hit:
    """Plain version of K4, replaying its schedule: each ray tile visits
    triangle tiles in ``order`` while the largest best t of its rays is >=
    the tile's te (te ascends, so the first miss ends the tile); the best-t
    carry starts at the scene-exit ``cap``, updates with strict '<' (the
    first visited tile, then the lowest index within it, wins a tie); then
    winner recovery. Triangles at or above ``rows`` (padding, never
    accepted) are left out."""
    gt, ex, Wt, idt, real, tile, step = _culled_tiles(g, W, tri_ids, excl, order, rows)
    best_t = cap.view(gt.shape[:2]).clone()
    best_i = torch.full(gt.shape[:2], -1, dtype=torch.int64, device=g.device)
    for k in range(order.shape[1]):
        rows = torch.nonzero(best_t.amax(dim=1) >= te[:, k]).flatten()
        if rows.numel() == 0:
            break
        for r in rows.split(step):
            b = order[r, k].long()
            ok, tp, adet = _accept(gt[r], Wt[b], idt[b], ex[r], t_eps)
            ok &= real[b][:, None, :]
            t = torch.where(ok, tp / torch.where(adet > 0, adet, torch.ones_like(adet)),
                            torch.full_like(tp, BIG_T))
            tb, lane = torch.min(t, dim=2)          # first minimal index
            better = tb < best_t[r]
            best_t[r] = torch.where(better, tb, best_t[r])
            best_i[r] = torch.where(better, b[:, None] * tile + lane, best_i[r])
    return recover(g, W, tri_ids, best_i.view(-1))


def occluded_culled_plain(g, W, tri_ids, excl, tmax, order, te,
                          t_eps: float = T_EPS, *, rows: int) -> torch.Tensor:
    """Plain version of K5: each ray tile ORs (accepted and t' < tmax |det|)
    over the triangle tiles of ``order`` with te < BIG_T / 2, and stops
    once every ray of the tile is blocked; triangles at or above ``rows``
    (padding, never accepted) are left out."""
    gt, ex, Wt, idt, real, tile, step = _culled_tiles(g, W, tri_ids, excl, order, rows)
    tm = tmax.view(gt.shape[:2])
    blocked = torch.zeros(gt.shape[:2], dtype=torch.bool, device=g.device)
    for k in range(order.shape[1]):
        live = torch.nonzero((te[:, k] < _SKIP_TE) & ~blocked.all(dim=1)).flatten()
        if live.numel() == 0:
            break
        for r in live.split(step):
            b = order[r, k].long()
            ok, tp, adet = _accept(gt[r], Wt[b], idt[b], ex[r], t_eps)
            ok &= real[b][:, None, :]
            blocked[r] |= (ok & (tp < tm[r][..., None] * adet)).any(dim=2)
    return blocked.view(-1)


def _culled_shape(name, N, T, order, te):
    """(nrt, nb, triangle tile) of a culled kernel call."""
    if order.dim() != 2 or te.shape != order.shape:
        raise ValueError(f"{name}: order {tuple(order.shape)} and te {tuple(te.shape)} "
                         "must both be [ray tiles, triangle tiles]")
    nrt, nb = order.shape
    if nrt == 0 or nb == 0 or N % nrt or T % nb:
        raise ValueError(f"{name}: {N} rays / {T} triangles do not tile as {nrt} x {nb}")
    rt, tile = N // nrt, T // nb
    if rt != RAY_TILE or tile > CULL_TILE:
        raise ValueError(f"{name}: ray tile {rt} (must be {RAY_TILE}) or "
                         f"triangle tile {tile} (<= {CULL_TILE}) not supported")
    return nrt, nb, tile


def _culled_rows(name, W, rows) -> int:
    """The real-row count of a culled kernel call, checked against W (and
    W's alignment)."""
    _check_aligned(name, W)
    real = int(rows)
    if not 0 <= real <= W.shape[0]:
        raise ValueError(f"{name}: rows {real} outside [0, {W.shape[0]}]")
    return real


def nearest_hit_culled(g, W, tri_ids, excl, cap, order, te, t_eps: float = T_EPS, *,
                       rows: int, fma: bool = True) -> Hit:
    """Culled nearest hit of rays ``g`` [N,10] (N a multiple of the ray
    tile) against ``W`` [T,10,4] (T a multiple of the triangle tile) on the
    schedule (``order``, ``te``) of :func:`cull_schedule`, best-t carry
    starting at ``cap`` (:func:`scene_exit_cap`); rows of ``W`` at or above
    ``rows`` are padding (``CulledCall.rows``). CUDA tensors: K4 (``fma`` as
    in :func:`nearest_hit`); CPU tensors: the plain version."""
    if not _route(g, "nearest_hit_culled"):
        return nearest_hit_culled_plain(g, W, tri_ids, excl, cap, order, te, t_eps, rows=rows)
    N, T = _check_cuda("nearest_hit_culled", g=g, W=W, tri_ids=tri_ids, excl=excl,
                       cap=cap, order=order, te=te)
    nrt, nb, tile = _culled_shape("nearest_hit_culled", N, T, order, te)
    real = _culled_rows("nearest_hit_culled", W, rows)
    lib = _build.load()
    t = torch.empty(N, dtype=torch.float32, device=g.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tid = torch.empty(N, dtype=torch.int32, device=g.device)
    err = lib.mcpt_nearest_culled(
        g.data_ptr(), W.data_ptr(), tri_ids.data_ptr(), excl.data_ptr(), cap.data_ptr(),
        order.data_ptr(), te.data_ptr(), nrt, nb, tile, real, float(t_eps),
        t.data_ptr(), u.data_ptr(), v.data_ptr(), tid.data_ptr(), int(fma),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "nearest_hit_culled (K4)")
    nearest_hit_culled.launches += 1
    return Hit(t=t, tri_id=tid, u=u, v=v, valid=tid != NO_HIT)


def occluded_culled(g, W, tri_ids, excl, tmax, order, te, t_eps: float = T_EPS, *,
                    rows: int, fma: bool = True) -> torch.Tensor:
    """[N] bool: culled any hit below ``tmax`` (pre-scaled by the occlusion
    margin) on the schedule (``order``, ``te``) of :func:`cull_schedule`;
    rows of ``W`` at or above ``rows`` are padding (``CulledCall.rows``).
    CUDA tensors: K5 (``fma`` as in :func:`nearest_hit`); CPU tensors: the
    plain version."""
    if not _route(g, "occluded_culled"):
        return occluded_culled_plain(g, W, tri_ids, excl, tmax, order, te, t_eps, rows=rows)
    N, T = _check_cuda("occluded_culled", g=g, W=W, tri_ids=tri_ids, excl=excl,
                       tmax=tmax, order=order, te=te)
    nrt, nb, tile = _culled_shape("occluded_culled", N, T, order, te)
    real = _culled_rows("occluded_culled", W, rows)
    lib = _build.load()
    out = torch.empty(N, dtype=torch.int32, device=g.device)
    err = lib.mcpt_occluded_culled(
        g.data_ptr(), W.data_ptr(), tri_ids.data_ptr(), excl.data_ptr(), tmax.data_ptr(),
        order.data_ptr(), te.data_ptr(), nrt, nb, tile, real, float(t_eps), out.data_ptr(),
        int(fma), torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "occluded_culled (K5)")
    occluded_culled.launches += 1
    return out != 0


nearest_hit_culled.launches = 0
occluded_culled.launches = 0
