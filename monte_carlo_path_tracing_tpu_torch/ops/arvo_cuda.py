"""K3: fused Arvo light selection on CUDA, beside its plain version.

Counterpart of ``monte_carlo_path_tracing_tpu/ops/arvo_pallas.py``; the
CUDA source is ``csrc/arvo.cu``. Per shading point it weights every light
triangle by its Van Oosterom-Strackee solid angle times radiance_sum
(after the front / horizon / sA > eps culls of
``sampling/light_spherical.prepare``) and picks one by inverse CDF with a
given uniform. :func:`arvo_select` dispatches on device: CUDA tensors go to
the kernel, CPU tensors to :func:`arvo_select_plain`
(``prepare`` + the inverse-CDF pick of ``rng.pick_weighted``).

The pick contract both hold: idx = count(cdf <= u * wsum), clamped to
L - 1, so a point that sees no light (wsum 0) gets L - 1 and u = 0 the
first light of nonzero weight. The kernel sums in another order (blocks
of lights, csrc/arvo.cu), so wsum agrees to rounding and a pick may move
by one index on the CDF-boundary fringe. Uniforms ``u`` [R, N] (rounds
major) give R picks a point against the one weight row: idx [R, N], wsum
[N] (the prepass's pick for each of its rounds).
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.core.radiometry import radiance_sum
from monte_carlo_path_tracing_tpu_torch.ops import _build

#: Floats per light in :func:`pack_consts` (the layout csrc/arvo.cu reads).
N_CONSTS = 24


def pack_consts(scene) -> torch.Tensor:
    """[L, 24] static per-light constants, on the scene's device:
    pa(3) pb(3) pc(3) crs(3) nl(3) | pa.pb pb.pc pc.pa |pa|^2 |pb|^2 |pc|^2
    nl.pa det(pa,pb,pc) radiance_sum, with crs = pa x pb + pb x pc + pc x pa.
    The same quantities as the Pallas kernel's (Wx, Wn, rowc, lsum), one
    row per light instead of lane-padded blocks."""
    pa, pb, pc = scene.light_verts()
    return pack_light_consts(pa, pb, pc, scene.geo_n[scene.light_tri_ids],
                             radiance_sum(scene.light_emission()))


def pack_light_consts(pa, pb, pc, nl, rad) -> torch.Tensor:
    """The [L, 24] table of :func:`pack_consts` from light vertices pa, pb,
    pc [L,3], geometric normals nl [L,3] and radiance sums rad [L]."""
    crs = vm.cross(pa, pb) + vm.cross(pb, pc) + vm.cross(pc, pa)
    cols = [
        vm.dot(pa, pb), vm.dot(pb, pc), vm.dot(pc, pa),
        vm.dot(pa, pa), vm.dot(pb, pb), vm.dot(pc, pc),
        vm.dot(nl, pa), vm.det3(pa, pb, pc), rad,
    ]
    return torch.cat([pa, pb, pc, crs, nl, torch.stack(cols, dim=1)], dim=1).contiguous()


def prepare_from_consts(C: torch.Tensor, x1: torch.Tensor, n: torch.Tensor,
                        eps: float = 1e-6):
    """Weights [N, L] and weights_sum [N] of Arvo light selection from the
    :func:`pack_consts` table: the [N, L] field, op for op as csrc/arvo.cu
    evaluates it per (point, light)."""
    def xdot(v, j):  # v . C[:, j:j+3] -> [N, L]
        return (v[:, 0:1] * C[None, :, j] + v[:, 1:2] * C[None, :, j + 1]
                + v[:, 2:3] * C[None, :, j + 2])

    xa, xb, xc, xcrs, xnl = (xdot(x1, j) for j in (0, 3, 6, 9, 12))
    na, nb, nc = (xdot(n, j) for j in (0, 3, 6))
    xx = vm.dot(x1, x1)[:, None]
    nx = vm.dot(n, x1)[:, None]
    c = lambda j: C[None, :, j]

    ab = c(15) - xa - xb + xx
    bc = c(16) - xb - xc + xx
    ca = c(17) - xc - xa + xx
    la = torch.sqrt(torch.clamp(c(18) - 2.0 * xa + xx, min=1e-20))
    lb = torch.sqrt(torch.clamp(c(19) - 2.0 * xb + xx, min=1e-20))
    lc = torch.sqrt(torch.clamp(c(20) - 2.0 * xc + xx, min=1e-20))
    det = c(22) - xcrs
    denom = la * lb * lc + ab * lc + bc * la + ca * lb
    sA = 2.0 * torch.atan2(det.abs(), denom)

    front = (xnl - c(21)) > eps
    above = ((na - nx) > eps) | ((nb - nx) > eps) | ((nc - nx) > eps)
    valid = front & above & (sA > eps) & torch.isfinite(sA)
    zero = torch.zeros_like(sA)
    w = torch.where(valid, sA * c(23), zero)
    w = torch.where(torch.isfinite(w), w, zero)
    return w, w.sum(dim=-1)


def arvo_select_plain(C, x1, n, u):
    """Plain version of K3: ``prepare`` + the inverse-CDF pick of
    ``rng.pick_weighted`` on uniforms ``u`` ([N] or [R, N]). Returns (idx
    int32 shaped as ``u``, wsum [N])."""
    w, wsum = prepare_from_consts(C, x1, n)
    return rng.pick_from_uniform(u, w, wsum), wsum


def arvo_select(C, x1, n, u):
    """Light pick per point: (light_idx int32, weights_sum [N]) for
    constants ``C`` (:func:`pack_consts`), points ``x1`` [N,3], normals
    ``n`` [N,3] and uniforms ``u``: [N] for one pick a point (light_idx
    [N]), or [R, N] for one a round (light_idx [R, N]), all in one
    launch. CUDA tensors: K3; CPU: the plain version."""
    if x1.device.type == "cpu":
        return arvo_select_plain(C, x1, n, u)
    if x1.device.type != "cuda":
        raise ValueError(f"arvo_select: unsupported device {x1.device}")
    N, L = x1.shape[0], C.shape[0]
    R = u.shape[0] if u.dim() == 2 else 1
    for name, t, shape in (("C", C, (L, N_CONSTS)), ("x1", x1, (N, 3)),
                           ("n", n, (N, 3)), ("u", u, (R, N) if u.dim() == 2 else (N,))):
        if t.device != x1.device or t.dtype != torch.float32:
            raise TypeError(f"arvo_select: {name} must be float32 on {x1.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"arvo_select: {name} must be contiguous {shape}")
    if L == 0:
        raise ValueError("arvo_select: scene has no light triangles")
    if C.data_ptr() % 16:                     # bulk copies / float4 loads of C
        raise ValueError("arvo_select: C must be 16-byte aligned")
    lib = _build.load()
    idx = torch.empty(u.shape, dtype=torch.int32, device=x1.device)
    wsum = torch.empty(N, dtype=torch.float32, device=x1.device)
    err = lib.mcpt_arvo_select(
        x1.data_ptr(), n.data_ptr(), u.data_ptr(), C.data_ptr(), N, L, R,
        idx.data_ptr(), wsum.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    _build.check(err, "arvo_select (K3)")
    arvo_select.launches += 1
    arvo_select.picks += N * R
    return idx, wsum


arvo_select.launches = 0
#: Points times rounds over K3's launches: a prepass chunk's one launch
#: picks spp_cap lights a pixel.
arvo_select.picks = 0
