"""Ray-triangle intersection in matmul form: records, packing, reference.

Counterpart of ``monte_carlo_path_tracing_tpu/ops/intersect_ref.py``.
Moller-Trumbore for ray (ro, rd) against triangle (v0, e1, e2) reduces to
four bilinear forms in the ray feature g = [ro, rd, ro x rd, 1]:

    det   = rd . (e2 x e1)
    u_num = m . e2 + rd . (v0 x e2)          (u * det)
    v_num = -m . e1 + rd . (e1 x v0)         (v * det)
    t_num = ro . n - v0 . n,  n = e1 x e2    (t * det)

so each triangle is one packed [10, 4] matrix W and a ray-triangle test is
g . W[:, c]. The dots here are the ordered sums k = 0..9 (``dot10``), the
arithmetic of the port's kernels; no matmul (and so no TF32) is involved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core import vecmath as vm

#: Smallest |det| treated as a real (non-parallel, non-degenerate) hit.
DET_EPS = 1e-9
#: Minimum ray parameter (f32 analogue of the reference's 1e-8, vec.h:7).
T_EPS = 1e-4
#: Sentinels for "no hit".
NO_HIT = -1
BIG_T = float(np.float32(3.0e38))


@dataclasses.dataclass(frozen=True)
class Hit:
    """Wavefront hit record (the reference's ``intersec_result``)."""

    t: torch.Tensor       # [N] ray parameter (BIG_T when miss)
    tri_id: torch.Tensor  # [N] int32 (-1 when miss)
    u: torch.Tensor       # [N] barycentric weight of v1
    v: torch.Tensor       # [N] barycentric weight of v2
    valid: torch.Tensor   # [N] bool


def pack_tri_matrix(v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Per-triangle [..., 10, 4] matrix W. Rows: g = [ro, rd, m, 1];
    columns: det, u, v, t numerators. Degenerate (and padding) triangles
    give det == 0 and are never hit."""
    n = vm.cross(e1, e2)
    W = torch.zeros(v0.shape[:-1] + (10, 4), dtype=v0.dtype, device=v0.device)
    W[..., 3:6, 0] = vm.cross(e2, e1)
    W[..., 3:6, 1] = vm.cross(v0, e2)
    W[..., 6:9, 1] = e2
    W[..., 3:6, 2] = vm.cross(e1, v0)
    W[..., 6:9, 2] = -e1
    W[..., 0:3, 3] = n
    W[..., 9, 3] = -vm.dot(v0, n)
    return W


def ray_features(ro: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """Per-ray feature vector g = [ro, rd, ro x rd, 1], shape [N, 10]."""
    one = torch.ones(ro.shape[:-1] + (1,), dtype=ro.dtype, device=ro.device)
    return torch.cat([ro, rd, vm.cross(ro, rd), one], dim=-1)


def dot10(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., N,10] x [..., B,10] -> [..., N,B]: the ordered sum over
    k = 0..9 (leading dimensions batch tiles)."""
    acc = g[..., 0:1] * w[..., None, :, 0]
    for k in range(1, 10):
        acc = acc + g[..., k:k + 1] * w[..., None, :, k]
    return acc


def recover(g: torch.Tensor, W: torch.Tensor, tri_ids: torch.Tensor,
            idx: torch.Tensor) -> Hit:
    """Winner recovery: re-evaluate triangle ``idx`` [N] (index into W,
    -1 = none) with the ordered dots; t, u, v = numerator * (1/det)."""
    valid = idx >= 0
    safe = torch.clamp(idx, min=0).long()
    Ww = W[safe]                                           # [N,10,4]
    vals = []
    for c in range(4):
        acc = g[:, 0] * Ww[:, 0, c]
        for k in range(1, 10):
            acc = acc + g[:, k] * Ww[:, k, c]
        vals.append(acc)
    det = vals[0]
    inv_det = 1.0 / torch.where(det.abs() > 0, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    return Hit(
        t=torch.where(valid, vals[3] * inv_det, torch.full_like(det, BIG_T)),
        tri_id=torch.where(valid, tri_ids[safe], torch.full_like(tri_ids[safe], NO_HIT)),
        u=torch.where(valid, vals[1] * inv_det, zero),
        v=torch.where(valid, vals[2] * inv_det, zero),
        valid=valid,
    )


def intersect_matmul(
    ro: torch.Tensor,
    rd: torch.Tensor,
    W: torch.Tensor,
    tri_ids: torch.Tensor,
    exclude_id: torch.Tensor | None = None,
    t_eps: float = T_EPS,
    block: int = 512,
) -> Hit:
    """All-pairs nearest hit with the strict accept rules of the JAX
    reference (|det| > eps, u, v >= 0, u + v <= |det|, t > t_eps; quirk Q8
    id exclusion), scanning triangle blocks."""
    N = ro.shape[0]
    if exclude_id is None:
        exclude_id = torch.full((N,), NO_HIT, dtype=torch.int32, device=ro.device)
    g = ray_features(ro, rd)
    best_t = torch.full((N,), BIG_T, device=ro.device)
    best_i = torch.full((N,), -1, dtype=torch.int64, device=ro.device)
    for b0 in range(0, W.shape[0], block):
        Wb = W[b0:b0 + block]
        det, un, vn, tn = (dot10(g, Wb[:, :, c]) for c in range(4))
        s = torch.sign(det)
        adet = det.abs()
        up, vp, tp = un * s, vn * s, tn * s
        ok = ((adet > DET_EPS) & (up >= 0.0) & (vp >= 0.0) & (up + vp <= adet)
              & (tp > t_eps * adet)
              & (tri_ids[None, b0:b0 + block] != exclude_id[:, None]))
        t = torch.where(ok, tn / torch.where(adet > 0, det, torch.ones_like(det)),
                        torch.full_like(det, BIG_T))
        bt, bi = torch.min(t, dim=1)
        better = bt < best_t
        best_t = torch.where(better, bt, best_t)
        best_i = torch.where(better, b0 + bi, best_i)
    return recover(g, W, tri_ids, best_i)
