"""Intersection engine: accel build and device dispatch.

Counterpart of ``monte_carlo_path_tracing_tpu/ops/intersect.py``. The
"accel" is every triangle's packed [10, 4] matrix in Morton order of the
centroids (so consecutive triangles are spatially compact), padded to a
multiple of ``TRI_BLOCK``, with per-triangle AABBs in the same order.
:func:`intersect` and :func:`occluded` run through ``ops/intersect_cuda.py``:
the all-pairs kernels K1 / K2 on the real rows by default, the culled
kernels K4 / K5 on the padded arrays with
``cull=True`` (coherent batches: camera fans and the primary pre-pass's
shadow batches, and the regeneration loop's sorted lanes where
:func:`auto_policy` turns culling on) — kernels for CUDA tensors, their
plain torch versions for CPU tensors.

A second, lights-only accel (:func:`build_light_accel`) serves the
reference's closet_ray_intersect_light_triangle (Myobj.cpp:476-622) under
``ref_mis_weights`` (quirk Q11): K1 on the light triangles alone. A
``GridAccel`` (``ops/grid.py``, the reference's uniform grid) takes its
3D-DDA instead of the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.ops import grid as grid_mod
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import (  # noqa: F401
    BIG_T, NO_HIT, T_EPS, Hit, pack_tri_matrix, ray_features,
)
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene

#: Padding multiple of the accel's triangle arrays.
TRI_BLOCK = 512

#: Relative margin for shadow-ray occlusion: a hit counts as blocking only
#: below t_max * (1 - margin), keeping the sampled light surface itself out.
OCCLUSION_MARGIN = 1e-3

#: accel="auto" threshold: scenes of at least this many triangles run the
#: regeneration loop with in-loop culling and the lane sort. The JAX
#: package's value (``monte_carlo_path_tracing_tpu/ops/intersect.py``
#: ``AUTO_CULL_MIN_TRIS``), kept so that both packages pick the same
#: configuration for a scene; whether it is the card's crossover is
#: measured by ``chip_smoke.py`` on bathroom (PERF.md).
AUTO_CULL_MIN_TRIS = 24_000

#: Most triangles per culled kernel call; above it the triangle set is cut
#: into Morton-contiguous chunks whose results are composed here (JAX:
#: whole-W residency in VMEM; here it bounds one call's schedule).
CULL_CHUNK_TRIS = 32_768


def auto_policy(num_tris: int) -> dict:
    """accel='auto' dispatch for a scene of ``num_tris`` triangles (JAX
    ``auto_policy``): in-loop culling and the lane sort that makes the
    loop's ray tiles coherent go together; coherent one-off batches (camera
    fans, pre-pass shadow batches) always cull."""
    cull = num_tris >= AUTO_CULL_MIN_TRIS
    return {"cull": cull, "ray_sort": cull, "cull_coherent": True}


@dataclasses.dataclass(frozen=True)
class TriAccel:
    W: torch.Tensor        # [Tpad, 10, 4] packed coefficient matrices
    tri_ids: torch.Tensor  # [Tpad] int32 global ids (padding rows: -2)
    # Per-triangle AABBs in the same (Morton) order; padding rows are
    # (+inf, -inf), so padding tiles cull themselves. None (hand-built
    # accels) disables culling, as in JAX.
    aabb_lo: torch.Tensor | None = None  # [Tpad, 3]
    aabb_hi: torch.Tensor | None = None  # [Tpad, 3]
    # Real (unpadded) rows, a Python int so that slicing needs no host
    # sync; None (hand-built accels): every row.
    num_tris: int | None = None

    def real_rows(self):
        """(W, tri_ids) without the padding rows, which are never accepted:
        what the all-pairs kernels K1 / K2 are handed."""
        n = self.W.shape[0] if self.num_tris is None else self.num_tris
        return self.W[:n], self.tri_ids[:n]


def _spread10(x: torch.Tensor) -> torch.Tensor:  # 10 bits -> every 3rd bit of 30
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_order(v0, e1, e2) -> torch.Tensor:
    """Stable sort order by the 3x10-bit Morton code of the centroid (a
    stable sort keeps equal codes in id order, as jnp.argsort does)."""
    c = v0 + (e1 + e2) / 3.0
    lo = torch.amin(torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2)), dim=0)
    hi = torch.amax(torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2)), dim=0)
    q = torch.clamp(
        ((c - lo) / torch.clamp(hi - lo, min=1e-20) * 1023.0).to(torch.int32), 0, 1023
    )
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


def _build(v0, e1, e2, ids, block: int) -> TriAccel:
    order = _morton_order(v0, e1, e2)
    v0, e1, e2, ids = v0[order], e1[order], e2[order], ids[order]
    T = v0.shape[0]
    W = pack_tri_matrix(v0, e1, e2)
    lo = torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2))
    hi = torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2))
    pad = (-T) % block
    if pad:
        dev = v0.device
        W = torch.cat([W, torch.zeros((pad, 10, 4), dtype=W.dtype, device=dev)])
        ids = torch.cat([ids, torch.full((pad,), -2, dtype=torch.int32, device=dev)])
        lo = torch.cat([lo, torch.full((pad, 3), float("inf"), device=dev)])
        hi = torch.cat([hi, torch.full((pad, 3), float("-inf"), device=dev)])
    # Geometry is not a differentiation target (materials and emission
    # are): the accel never carries a gradient.
    return TriAccel(W=W.detach().contiguous(), tri_ids=ids.contiguous(),
                    aabb_lo=lo.detach().contiguous(), aabb_hi=hi.detach().contiguous(),
                    num_tris=T)


def build_accel(scene: Scene, block: int = TRI_BLOCK) -> TriAccel:
    ids = torch.arange(scene.num_tris, dtype=torch.int32, device=scene.device)
    return _build(scene.tri_v0, scene.tri_e1, scene.tri_e2, ids, block)


def build_light_accel(scene: Scene, block: int = TRI_BLOCK) -> TriAccel:
    """Accel of the emissive triangles alone; its ids stay global triangle
    ids, and ``num_tris`` is the light count, so that ``real_rows()`` hands
    K1 the light triangles only."""
    sel = scene.light_tri_ids.to(torch.int32)
    idx = sel.long()
    return _build(scene.tri_v0[idx], scene.tri_e1[idx], scene.tri_e2[idx], sel, block)


def _exclude(exclude_id, n, device):
    if exclude_id is None:
        return torch.full((n,), NO_HIT, dtype=torch.int32, device=device)
    return exclude_id.to(torch.int32).contiguous()


def _compose_nearest(a: Hit, b: Hit) -> Hit:
    """Min-t composition of two partial nearest-hit results."""
    take_b = b.valid & (~a.valid | (b.t < a.t))
    pick = lambda x, y: torch.where(take_b, y, x)  # noqa: E731
    return Hit(t=pick(a.t, b.t), tri_id=pick(a.tri_id, b.tri_id),
               u=pick(a.u, b.u), v=pick(a.v, b.v), valid=a.valid | b.valid)


def _chunks(accel: TriAccel):
    """Morton-contiguous slices of at most CULL_CHUNK_TRIS triangles."""
    T = accel.W.shape[0]
    return [slice(c0, c0 + CULL_CHUNK_TRIS) for c0 in range(0, T, CULL_CHUNK_TRIS)]


def _real_rows(accel: TriAccel, sl: slice, n: int) -> int:
    """Real rows among the ``n`` rows of ``accel`` that ``sl`` selects: the
    Morton-ordered accel holds its padding after the last real triangle,
    so they are a prefix (all ``n`` for a hand-built accel)."""
    if accel.num_tris is None:
        return n
    return max(0, min(n, accel.num_tris - sl.indices(accel.W.shape[0])[0]))


class CulledCall(NamedTuple):
    """One culled kernel call's inputs, padded (JAX ``_call_nearest`` /
    ``_call_occluded`` with AABBs): rays to a multiple of the ray tile,
    triangles to a multiple of the triangle tile."""

    W: torch.Tensor        # [nb * tile, 10, 4]
    tri_ids: torch.Tensor  # [nb * tile]
    g: torch.Tensor        # [nrt * RAY_TILE, 10] ray features
    excl: torch.Tensor     # [nrt * RAY_TILE] excluded ids
    bound: torch.Tensor    # K4: scene-exit cap; K5: scaled t_max
    order: torch.Tensor    # [nrt, nb] visit order
    te: torch.Tensor       # [nrt, nb] entry distances, ascending
    rows: int              # rows of W holding real triangles (the rest: padding)


def culled_call(accel: TriAccel, sl: slice, ro, rd, excl, scaled_tmax=None,
                t_eps: float = T_EPS):
    """The culled call over triangles ``sl`` of the accel: a nearest-hit
    call (K4) when ``scaled_tmax`` is None, an any-hit call (K5) otherwise;
    both skip the padding rows at and above ``rows``. None when the
    triangles fit one tile: JAX then runs the all-pairs kernel, there being
    nothing to cull."""
    n = accel.W[sl].shape[0]
    tile = intersect_cuda.cull_tile(n)
    W, ids, lo, hi = intersect_cuda.pad_tris(
        accel.W[sl], accel.tri_ids[sl], accel.aabb_lo[sl], accel.aabb_hi[sl], tile)
    if W.shape[0] <= tile:
        return None
    lo_t, hi_t = intersect_cuda.tile_aabbs(lo, hi, tile)
    g = ray_features(ro, rd)
    if scaled_tmax is None:
        g, (ex, ro_p, rd_p) = intersect_cuda.pad_rays(g, [excl, ro, rd], [NO_HIT, 0.0, 0.0])
        t_cap = torch.full((g.shape[0],), BIG_T, device=g.device)
        bound = intersect_cuda.scene_exit_cap(ro_p, rd_p, lo_t, hi_t, t_eps)
    else:
        g, (ex, t_cap, ro_p, rd_p) = intersect_cuda.pad_rays(
            g, [excl, scaled_tmax, ro, rd], [NO_HIT, 0.0, 0.0, 0.0])
        bound = t_cap.contiguous()
    order, te = intersect_cuda.cull_schedule(ro_p, rd_p, lo_t, hi_t, t_cap)
    return CulledCall(W=W, tri_ids=ids, g=g.contiguous(), excl=ex.contiguous(), bound=bound,
                      order=order, te=te, rows=_real_rows(accel, sl, n))


def intersect(
    accel: TriAccel,
    ro: torch.Tensor,
    rd: torch.Tensor,
    exclude_id: torch.Tensor | None = None,
    t_eps: float = T_EPS,
    cull: bool | None = None,
) -> Hit:
    """Nearest hit of N rays against the accel's triangles; self-
    intersection avoidance by triangle-id exclusion (quirk Q8). ``cull=True``
    runs K4 on tiles of ``intersect_cuda.RAY_TILE`` rays — for coherent
    batches such as camera fans; above ``CULL_CHUNK_TRIS`` triangles per chunk,
    with the chunks' hits min-composed. A ``GridAccel`` takes the grid's
    3D-DDA (``ops/grid.py``)."""
    if isinstance(accel, grid_mod.GridAccel):
        return grid_mod.intersect_grid(accel, ro, rd, exclude_id, t_eps=t_eps)
    N = ro.shape[0]
    excl = _exclude(exclude_id, N, ro.device)
    if not cull or accel.aabb_lo is None:
        g = ray_features(ro, rd).contiguous()
        return intersect_cuda.nearest_hit(g, *accel.real_rows(), excl, t_eps)
    best = None
    for sl in _chunks(accel):
        c = culled_call(accel, sl, ro, rd, excl, t_eps=t_eps)
        if c is None:
            g = ray_features(ro, rd).contiguous()
            h = intersect_cuda.nearest_hit(g, accel.W[sl], accel.tri_ids[sl], excl, t_eps)
        else:
            h = intersect_cuda.nearest_hit_culled(c.g, c.W, c.tri_ids, c.excl, c.bound,
                                                  c.order, c.te, t_eps, rows=c.rows)
            h = Hit(t=h.t[:N], tri_id=h.tri_id[:N], u=h.u[:N], v=h.v[:N], valid=h.valid[:N])
        best = h if best is None else _compose_nearest(best, h)
    return best


def occluded(
    accel: TriAccel,
    ro: torch.Tensor,
    rd: torch.Tensor,
    t_max: torch.Tensor,
    exclude_id: torch.Tensor | None = None,
    t_eps: float = T_EPS,
    cull: bool | None = None,
) -> torch.Tensor:
    """[N] bool: something blocks the segment ro -> ro + t_max * rd (the
    NEE visibility predicate, with ``OCCLUSION_MARGIN``). ``cull=True`` runs
    K5 on tiles of ``intersect_cuda.RAY_TILE`` rays (coherent shadow
    batches), the swept interval of each tile capped by its largest t_max;
    chunks above ``CULL_CHUNK_TRIS`` are ORed. A ``GridAccel`` tests the
    grid's nearest hit against the same margin."""
    if isinstance(accel, grid_mod.GridAccel):
        hit = grid_mod.intersect_grid(accel, ro, rd, exclude_id, t_eps=t_eps)
        return hit.valid & (hit.t < t_max * (1.0 - OCCLUSION_MARGIN))
    N = ro.shape[0]
    excl = _exclude(exclude_id, N, ro.device)
    scaled = (t_max * (1.0 - OCCLUSION_MARGIN)).to(torch.float32).contiguous()
    if not cull or accel.aabb_lo is None:
        g = ray_features(ro, rd).contiguous()
        return intersect_cuda.occluded(g, *accel.real_rows(), excl, scaled, t_eps)
    blocked = None
    for sl in _chunks(accel):
        c = culled_call(accel, sl, ro, rd, excl, scaled, t_eps=t_eps)
        if c is None:
            g = ray_features(ro, rd).contiguous()
            b = intersect_cuda.occluded(g, accel.W[sl], accel.tri_ids[sl], excl, scaled, t_eps)
        else:
            b = intersect_cuda.occluded_culled(c.g, c.W, c.tri_ids, c.excl, c.bound, c.order,
                                               c.te, t_eps, rows=c.rows)[:N]
        blocked = b if blocked is None else blocked | b
    return blocked
