"""K1 (nearest hit) and K2 (any hit) on CUDA, each beside its plain version.

Counterpart of the streamed Pallas kernels of
``monte_carlo_path_tracing_tpu/ops/intersect_pallas.py``
(``_kernel_nearest_s`` / ``_kernel_occluded_s``); the CUDA sources are
``csrc/intersect.cu``. The accept test is the Pallas kernels' margin form:
after sign correction by sign(det), a triangle is accepted iff u', v',
|det|-u'-v', t'-t_eps|det| and |det|-DET_EPS are all >= 0 and its id is not
the ray's excluded id.

:func:`nearest_hit` and :func:`occluded` dispatch on the device of their
tensors: a CPU tensor goes to the plain torch version, a CUDA tensor to the
kernel (or an error) — never to the plain version.
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.ops import _build
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import (
    BIG_T, DET_EPS, NO_HIT, T_EPS, Hit, dot10, recover,
)

#: Triangles per block of the plain versions' [N, block] fields.
PLAIN_BLOCK = 512


def _accept(g, Wb, ids, excl, t_eps):
    """Margin accept of every (ray, triangle) pair of a block: returns
    (ok [N,B], tp, adet), the arithmetic of the kernels' ``accept``."""
    det, un, vn, tn = (dot10(g, Wb[:, :, c]) for c in range(4))
    s = torch.sign(det)
    adet = det * s
    up, vp, tp = un * s, vn * s, tn * s
    m = torch.minimum(up, vp)
    m = torch.minimum(m, adet - (up + vp))
    m = torch.minimum(m, tp - t_eps * adet)
    m = torch.minimum(m, adet - DET_EPS)
    ok = (m >= 0.0) & (ids[None, :] != excl[:, None])
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
            "excl": torch.int32, "tmax": torch.float32}
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
    for k in ("excl", "tmax"):
        if k in tensors and tensors[k].shape != (N,):
            raise ValueError(f"{name}: {k} must be [{N}]")
    if tensors["tri_ids"].shape != (T,):
        raise ValueError(f"{name}: tri_ids must be [{T}]")
    return N, T


def _route(g: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if g.device.type == "cuda":
        return True
    if g.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {g.device}")


def nearest_hit(g, W, tri_ids, excl, t_eps: float = T_EPS) -> Hit:
    """Nearest hit of rays ``g`` [N,10] against packed triangles ``W``
    [T,10,4] (accel order) with ids ``tri_ids`` [T] and per-ray excluded
    ids ``excl`` [N]. CUDA tensors: K1; CPU tensors: the plain version."""
    if not _route(g, "nearest_hit"):
        return nearest_hit_plain(g, W, tri_ids, excl, t_eps)
    N, T = _check_cuda("nearest_hit", g=g, W=W, tri_ids=tri_ids, excl=excl)
    lib = _build.load()
    t = torch.empty(N, dtype=torch.float32, device=g.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tid = torch.empty(N, dtype=torch.int32, device=g.device)
    err = lib.mcpt_nearest(
        g.data_ptr(), W.data_ptr(), tri_ids.data_ptr(), excl.data_ptr(), N, T,
        float(t_eps), t.data_ptr(), u.data_ptr(), v.data_ptr(), tid.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "nearest_hit (K1)")
    nearest_hit.launches += 1
    return Hit(t=t, tri_id=tid, u=u, v=v, valid=tid != NO_HIT)


def occluded(g, W, tri_ids, excl, tmax, t_eps: float = T_EPS) -> torch.Tensor:
    """[N] bool: some accepted triangle lies at t < ``tmax`` (pre-scaled by
    the occlusion margin). CUDA tensors: K2; CPU tensors: the plain
    version."""
    if not _route(g, "occluded"):
        return occluded_plain(g, W, tri_ids, excl, tmax, t_eps)
    N, T = _check_cuda("occluded", g=g, W=W, tri_ids=tri_ids, excl=excl, tmax=tmax)
    lib = _build.load()
    out = torch.empty(N, dtype=torch.int32, device=g.device)
    err = lib.mcpt_occluded(
        g.data_ptr(), W.data_ptr(), tri_ids.data_ptr(), excl.data_ptr(),
        tmax.data_ptr(), N, T, float(t_eps), out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "occluded (K2)")
    occluded.launches += 1
    return out != 0


nearest_hit.launches = 0
occluded.launches = 0
