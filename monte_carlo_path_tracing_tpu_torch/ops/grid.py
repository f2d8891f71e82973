"""Uniform-grid acceleration structure and 3D-DDA traversal (C10 / C12).

Counterpart of ``monte_carlo_path_tracing_tpu/ops/grid.py``. The reference
builds a uniform grid over the scene AABB (cal_scene_boundingbox /
meshing, Myobj.cpp:78-162) and walks it with a 3D-DDA
(closet_ray_intersect, Myobj.cpp:334-474). Here, as in the JAX package:

- :func:`build_grid` is a host-side numpy CSR build (cells -> triangle
  lists), the same code as JAX's, so both give equal arrays;
- :func:`intersect_grid` is the batched DDA in plain torch: the outer loop
  steps every lane one cell; the inner loop scans each lane's cell list one
  triangle a step, up to the longest list among the lanes still scanning.
  One host sync per outer step reads that length (and whether any lane is
  left); the JAX ``lax.while_loop`` conditions are the same.

Reference semantics kept: cell width d = max_extent / n0^(1/3)
(Myobj.cpp:119-120); an optional seed point in the AABB (quirk Q7,
Myobj.cpp:85-88), with origins outside clamped forward to the grid by a
slab test; triangles inserted into every cell their AABB overlaps
(Myobj.cpp:129-159); a hit is accepted only if its point lies in the
current cell (Myobj.cpp:427-441), so the first cell with an accepted hit
holds the nearest; exclusion by triangle id (quirk Q8); eps-aware step
signs with F32_MAX boundary parameters on axes the ray does not move along
(Myobj.cpp:345-385). The JAX grid is jnp code, not a Pallas kernel; this
is its port and runs where the rays are, on the card or the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core import vecmath as vm
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import BIG_T, DET_EPS, NO_HIT, T_EPS, Hit
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene

_F32_MAX = float(np.float32(3.0e38))


@dataclasses.dataclass(frozen=True)
class GridAccel:
    """CSR uniform grid: C = nx * ny * nz cells, M tri-cell pairs."""

    bmin: torch.Tensor        # [3] grid origin (world)
    inv_w: float              # 1 / cell width, rounded to f32
    cell_w: float             # cell width (meshing d, Myobj.cpp:119), rounded to f32
    cell_start: torch.Tensor  # [C+1] int64 CSR offsets (x-major, z fastest)
    cell_tris: torch.Tensor   # [M] int32 triangle ids
    v0: torch.Tensor          # [T, 3]
    e1: torch.Tensor          # [T, 3]
    e2: torch.Tensor          # [T, 3]
    dims: tuple               # (nx, ny, nz)


def build_grid(scene: Scene, n0: int = 100_000, include_point: np.ndarray | None = None,
               lights_only: bool = False, max_axis_cells: int = 103) -> GridAccel:
    """Host-side grid build (meshing, Myobj.cpp:110-162), on the scene's
    device. ``n0`` is the reference's target cell count (main.cpp:520);
    ``include_point`` seeds the AABB (Q7); ``lights_only`` builds the C12
    grid over the emissive triangles (global ids kept)."""
    v0 = scene.tri_v0.detach().cpu().numpy()
    e1 = scene.tri_e1.detach().cpu().numpy()
    e2 = scene.tri_e2.detach().cpu().numpy()
    if lights_only:
        ids = scene.light_tri_ids.cpu().numpy().astype(np.int32)
    else:
        ids = np.arange(v0.shape[0], dtype=np.int32)
    p0, p1, p2 = v0[ids], v0[ids] + e1[ids], v0[ids] + e2[ids]

    lo = np.minimum(np.minimum(p0, p1), p2)          # [K, 3] per-triangle AABB
    hi = np.maximum(np.maximum(p0, p1), p2)
    bmin = lo.min(axis=0)
    bmax = hi.max(axis=0)
    if include_point is not None:
        bmin = np.minimum(bmin, include_point)
        bmax = np.maximum(bmax, include_point)
    # A small margin, so that boundary vertices land strictly inside.
    span = np.maximum(bmax - bmin, 1e-6)
    bmin = bmin - 1e-4 * span
    bmax = bmax + 1e-4 * span
    extent = bmax - bmin

    d = float(extent.max()) / float(np.cbrt(n0))     # Myobj.cpp:119-120
    dims = np.clip(np.ceil(extent / d).astype(np.int64), 1, max_axis_cells)
    nx, ny, nz = (int(dims[0]), int(dims[1]), int(dims[2]))

    # Cell ranges overlapped by each triangle's AABB (Myobj.cpp:129-159).
    clo = np.clip(np.floor((lo - bmin) / d).astype(np.int64), 0, dims - 1)
    chi = np.clip(np.floor((hi - bmin) / d).astype(np.int64), 0, dims - 1)

    counts = np.zeros(nx * ny * nz, np.int64)
    spans = []
    for k in range(ids.shape[0]):
        xs = np.arange(clo[k, 0], chi[k, 0] + 1)
        ys = np.arange(clo[k, 1], chi[k, 1] + 1)
        zs = np.arange(clo[k, 2], chi[k, 2] + 1)
        cid = ((xs[:, None] * ny + ys[None, :])[:, :, None] * nz + zs).ravel()
        spans.append((cid, ids[k]))
        np.add.at(counts, cid, 1)
    start = np.zeros(nx * ny * nz + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    tris = np.empty(int(start[-1]), np.int32)
    cursor = start[:-1].copy()
    for cid, tid in spans:
        tris[cursor[cid]] = tid
        cursor[cid] += 1

    dev = scene.device
    return GridAccel(
        bmin=torch.as_tensor(bmin.astype(np.float32), device=dev),
        inv_w=float(np.float32(1.0 / d)), cell_w=float(np.float32(d)),
        cell_start=torch.as_tensor(start, device=dev),
        cell_tris=torch.as_tensor(tris, device=dev),
        v0=scene.tri_v0.detach(), e1=scene.tri_e1.detach(), e2=scene.tri_e2.detach(),
        dims=(nx, ny, nz),
    )


def _tri_test(grid: GridAccel, tid, ro, rd, t_eps: float):
    """Moller-Trumbore against one gathered triangle per lane
    (intersect_with_triangle, Myobj.cpp:165-192): (ok, t, u, v)."""
    t_ = tid.long()
    a, e1, e2 = grid.v0[t_], grid.e1[t_], grid.e2[t_]
    pvec = vm.cross(rd, e2)
    det = vm.dot(pvec, e1)
    big = torch.abs(det) > DET_EPS
    inv = torch.where(big, 1.0 / det, torch.zeros_like(det))
    tvec = ro - a
    u = vm.dot(pvec, tvec) * inv
    qvec = vm.cross(tvec, e1)
    v = vm.dot(qvec, rd) * inv
    t = vm.dot(qvec, e2) * inv
    ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_eps)
    return ok, t, u, v


def intersect_grid(grid: GridAccel, ro: torch.Tensor, rd: torch.Tensor,
                   exclude_id: torch.Tensor | None = None, t_eps: float = T_EPS) -> Hit:
    """Nearest hit by the batched 3D-DDA (closet_ray_intersect,
    Myobj.cpp:334-474): every lane marches one cell per outer step until it
    hits, leaves the grid, or ``nx + ny + nz + 3`` steps have passed."""
    N, dev = ro.shape[0], ro.device
    nx, ny, nz = grid.dims
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    if exclude_id is None:
        exclude_id = torch.full((N,), NO_HIT, dtype=torch.int32, device=dev)
    bmin = grid.bmin[None, :]
    cw = grid.cell_w

    eps = 1e-12
    # Entry clamp: origins outside the AABB advance to the grid boundary.
    bmax = grid.bmin + cw * dims.to(torch.float32)
    safe_rd = torch.where(torch.abs(rd) < eps,
                          torch.where(rd < 0, torch.full_like(rd, -eps), torch.full_like(rd, eps)),
                          rd)
    t_lo = (bmin - ro) / safe_rd
    t_hi = (bmax[None, :] - ro) / safe_rd
    t_near = torch.minimum(t_lo, t_hi).amax(dim=-1)
    t_far = torch.maximum(t_lo, t_hi).amin(dim=-1)
    inside = ((ro >= grid.bmin) & (ro <= bmax)).all(dim=-1)
    t_entry = torch.where(inside, torch.zeros_like(t_near), torch.clamp(t_near, min=0.0) + 1e-5)
    done = (~inside) & ((t_near > t_far) | (t_far < 0.0))

    p_start = ro + t_entry[:, None] * rd
    cell = torch.floor((p_start - bmin) * grid.inv_w).to(torch.int32)
    cell = torch.minimum(torch.clamp(cell, min=0), dims[None, :] - 1)

    # Step signs with eps-zero handling (Myobj.cpp:345-353) and the ray
    # parameters of the next boundaries (355-385; F32_MAX where the step is 0).
    step = torch.where(rd > eps, 1, torch.where(rd < -eps, -1, 0)).to(torch.int32)
    moving = step != 0
    next_plane = bmin + (cell + (step > 0).to(torch.int32)).to(torch.float32) * cw
    t_next = torch.where(moving, (next_plane - ro) / safe_rd, _F32_MAX)
    dt = torch.where(moving, cw / torch.abs(safe_rd), _F32_MAX)

    best_t = torch.full((N,), BIG_T, device=dev)
    best_id = torch.full((N,), NO_HIT, dtype=torch.int32, device=dev)
    best_u = torch.zeros(N, device=dev)
    best_v = torch.zeros(N, device=dev)
    max_steps = nx + ny + nz + 3
    n_cells, m_last = nx * ny * nz, grid.cell_tris.shape[0] - 1

    for it in range(max_steps):
        cid = (cell[:, 0].long() * ny + cell[:, 1]) * nz + cell[:, 2]
        cid = torch.clamp(cid, 0, n_cells - 1)
        s, e = grid.cell_start[cid], grid.cell_start[cid + 1]
        # The inner loop runs while a lane still scanning has triangles
        # left: as many steps as the longest such list (one host sync).
        longest = int(torch.where(done, torch.zeros_like(s), e - s).max()) if N else 0
        if not bool((~done).any()):
            break
        lo_c = cell.to(torch.float32)
        for k in range(longest):
            j = s + k
            scan = (~done) & (j < e)
            tid = grid.cell_tris[torch.clamp(j, 0, m_last)]
            ok, t, u, v = _tri_test(grid, tid, ro, rd, t_eps)
            ok = ok & scan & (tid != exclude_id)
            # Accept only a hit point in the current cell (Myobj.cpp:427-441),
            # with a tolerance of 1e-4 cells around its slab.
            p = ro + t[:, None] * rd
            pc = torch.floor((p - bmin) * grid.inv_w).to(torch.int32)
            in_cell = (torch.abs(pc - cell) <= 0).all(dim=-1) | (
                (p >= (lo_c - 1e-4) * cw + bmin) & (p <= (lo_c + 1.0 + 1e-4) * cw + bmin)
            ).all(dim=-1)
            ok = ok & in_cell & (t < best_t)
            best_t = torch.where(ok, t, best_t)
            best_id = torch.where(ok, tid, best_id)
            best_u = torch.where(ok, u, best_u)
            best_v = torch.where(ok, v, best_v)

        found = (~done) & (best_id != NO_HIT)
        # Step the axis of the smallest boundary parameter (Myobj.cpp:452-470).
        onehot = torch.nn.functional.one_hot(torch.argmin(t_next, dim=-1), 3).to(torch.int32)
        cell_new = cell + onehot * step
        t_next_new = t_next + onehot.to(t_next.dtype) * dt
        oob = ((cell_new < 0) | (cell_new >= dims[None, :])).any(dim=-1)
        stop = (done | found | oob | (it + 1 >= max_steps))[:, None]
        cell = torch.where(stop, cell, cell_new)
        t_next = torch.where(stop, t_next, t_next_new)
        done = stop[:, 0]

    valid = best_id != NO_HIT
    return Hit(t=torch.where(valid, best_t, torch.full_like(best_t, BIG_T)),
               tri_id=torch.where(valid, best_id, torch.full_like(best_id, NO_HIT)),
               u=best_u, v=best_v, valid=valid)
