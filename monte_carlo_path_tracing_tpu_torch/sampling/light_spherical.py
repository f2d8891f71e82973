"""Arvo spherical-triangle light sampling (reference Mylight.cpp:163-493).

Counterpart of ``monte_carlo_path_tracing_tpu/sampling/light_spherical.py``.
Per shading point (x1, n) every light triangle is weighted by its solid
angle times radiance_sum; one is drawn by inverse CDF, and a direction is
sampled uniformly inside its spherical projection by Arvo's (1995) warp.
The pdf is the solid-angle density l_sum / weights_sum.

The selection is ``ops/arvo_cuda.arvo_select``: the K3 kernel for CUDA
tensors, ``prepare`` + the inverse-CDF pick for CPU tensors (the JAX
package's ``fused=`` flag is decided here by device). Both consume the
same uniform, drawn from ``fold_in(key, 0)``.

Callers in a loop may pass the static per-light tables (``consts`` from
``arvo_cuda.pack_consts``, ``table`` from :func:`light_table`) to build
them once.
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.core.radiometry import radiance_sum
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda
from monte_carlo_path_tracing_tpu_torch.sampling.light_uniform import LightSample
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene

#: Geometric cull epsilon (f32 floor for the reference's 1e-8).
EPS = 1e-6
_CLAMP = 1.0 - 1e-7


def _acos_c(x: torch.Tensor) -> torch.Tensor:
    return torch.acos(torch.clamp(x, -_CLAMP, _CLAMP))


def solid_angle_fast(x1, n, pa, pb, pc, nl):
    """(sA, valid) via Van Oosterom-Strackee, tan(sA/2) = |det[A B C]| /
    (1 + A.B + B.C + C.A), with the front / horizon culls of ``prepare``."""
    front = vm.dot(nl, x1 - pa) > EPS
    above = ((vm.dot(n, pa - x1) > EPS) | (vm.dot(n, pb - x1) > EPS)
             | (vm.dot(n, pc - x1) > EPS))
    A = vm.normalize(pa - x1)
    B = vm.normalize(pb - x1)
    C = vm.normalize(pc - x1)
    det = vm.det3(A, B, C).abs()
    denom = 1.0 + vm.dot(A, B) + vm.dot(B, C) + vm.dot(C, A)
    sA = 2.0 * torch.atan2(det, denom)
    valid = front & above & (sA > EPS) & torch.isfinite(sA)
    return sA, valid


def light_table(scene: Scene) -> torch.Tensor:
    """[L,16] per-light record: pa(3) pb(3) pc(3) nl(3) emission(3) l_sum(1)."""
    pa, pb, pc = scene.light_verts()
    nl = scene.geo_n[scene.light_tri_ids]
    em = scene.light_emission()
    return torch.cat([pa, pb, pc, nl, em, radiance_sum(em)[:, None]], dim=1)


def _project_for_warp(x1, n, pa, pb, pc):
    """Oriented unit directions and what Arvo's warp consumes:
    (A, B, C, alpha, cos_c, sA), for the selected triangle only."""
    A = vm.normalize(pa - x1)
    B0 = vm.normalize(pb - x1)
    C0 = vm.normalize(pc - x1)
    swap = vm.dot(vm.cross(C0 - A, B0 - A), n) < 0.0   # winding (Mylight.cpp:205-211)
    B = torch.where(swap[..., None], C0, B0)
    C = torch.where(swap[..., None], B0, C0)
    n_ba = vm.normalize(vm.cross(B, A))
    n_ac = vm.normalize(vm.cross(A, C))
    alpha = _acos_c(-vm.dot(n_ba, n_ac))
    cos_c = vm.dot(A, B)
    det = vm.det3(A, B, C).abs()
    denom = 1.0 + vm.dot(A, B) + vm.dot(B, C) + vm.dot(C, A)
    sA = 2.0 * torch.atan2(det, denom)
    return A, B, C, alpha, cos_c, sA


def prepare(scene: Scene, x1: torch.Tensor, n: torch.Tensor, consts=None):
    """Weights [N, L] and weights_sum [N] (Mylight.cpp:322-422), in the
    quadratic-form expansion: no [N, L, 3] direction vectors exist."""
    C = arvo_cuda.pack_consts(scene) if consts is None else consts
    return arvo_cuda.prepare_from_consts(C, x1, n, EPS)


def _arvo_warp(key, A, B, C, alpha, cos_c, sA):
    """Arvo §5.2 uniform sample of a spherical triangle (Mylight.cpp:289-297).
    Returns unit directions [N,3]."""
    N = A.shape[0]
    xi = rng.uniform(key, (N, 2))
    sA1 = xi[:, 0] * sA
    s = torch.sin(sA1 - alpha)
    t = torch.cos(sA1 - alpha)
    u = t - torch.cos(alpha)
    v = s + torch.sin(alpha) * cos_c
    denom = (v * s + u * t) * torch.sin(alpha)
    denom = torch.where(denom.abs() > 1e-20, denom, torch.sign(denom) * 1e-20 + 1e-30)
    q = ((v * t - u * s) * torch.cos(alpha) - v) / denom
    q = torch.clamp(q, -1.0, 1.0)

    c_perp = vm.normalize(C - vm.dot(C, A)[..., None] * A)
    C1 = q[..., None] * A + torch.sqrt(torch.clamp(1.0 - q * q, min=0.0))[..., None] * c_perp

    z = 1.0 - xi[:, 1] * (1.0 - vm.dot(C1, B))
    z = torch.clamp(z, -1.0, 1.0)
    b_perp = vm.normalize(C1 - vm.dot(C1, B)[..., None] * B)
    P = z[..., None] * B + torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))[..., None] * b_perp
    return vm.normalize(P)


def sample(key, scene: Scene, x1: torch.Tensor, n: torch.Tensor,
           consts=None, table=None):
    """Batched 'lights_spherical_triangle_sampling' (Mylight.cpp:424-482).
    Returns (LightSample, weights_sum [N]); points with no projectable
    light triangle get the reference's dummy sample (valid=False)."""
    C = arvo_cuda.pack_consts(scene) if consts is None else consts
    k_sel, k_warp = rng.fold_in(key, 0), rng.fold_in(key, 1)
    u = rng.uniform(k_sel, (x1.shape[0],))
    # The pick runs outside autograd (K3 on the card): a discrete choice,
    # and weights_sum reaches only detached pdfs.
    lidx, weights_sum = arvo_cuda.arvo_select(C.detach(), x1.detach().contiguous(),
                                              n.detach().contiguous(), u)
    ls = sample_from_pick(k_warp, scene, x1, n, lidx, weights_sum, table=table)
    return ls, weights_sum


def sample_from_pick(k_warp, scene: Scene, x1, n, lidx, weights_sum, table=None) -> LightSample:
    """Arvo-warp a direction inside the selected triangle ``lidx`` and land
    the point on the flat triangle (Mylight.cpp:449-481)."""
    has = weights_sum > EPS
    rec = (light_table(scene) if table is None else table)[lidx.long()]
    pa_s, pb_s, pc_s = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    nl = rec[:, 9:12]
    em = rec[:, 12:15]
    l_sum_s = rec[:, 15]

    A, B, C, alpha, cos_c, sA = _project_for_warp(x1, n, pa_s, pb_s, pc_s)
    P = _arvo_warp(k_warp, A, B, C, alpha, cos_c, sA)

    # Land on the flat triangle: plane intersection along P.
    denom = vm.dot(nl, P)
    t = vm.dot(nl, pa_s - x1) / torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    t = torch.clamp(t, min=0.0)

    one = torch.ones_like(l_sum_s)
    pdf = torch.where(has, l_sum_s / torch.clamp(weights_sum, min=1e-30), one)
    # Detached sampling: the sampled point is a constant of differentiation;
    # the emission stays attached for d/d(radiance).
    coord = torch.where(has[:, None], x1 + P * t[:, None], x1 - n).detach()
    return LightSample(
        coord=coord,
        light_idx=lidx,
        tri_id=scene.light_tri_ids[lidx.long()],
        emission=torch.where(has[:, None], em, torch.zeros_like(em)),
        pdf=pdf,
        valid=has,
        nl=nl,
    )


def pdf_of_tri(scene: Scene, x1, n, light_idx, weights_sum, table=None) -> torch.Tensor:
    """Solid-angle pdf this sampler assigns to directions hitting light
    triangle ``light_idx`` from (x1, n) with the given ``weights_sum``
    (Mylight.cpp:484-493); zero for culled triangles and non-lights."""
    safe = torch.clamp(light_idx, 0, scene.num_lights - 1).long()
    rec = (light_table(scene) if table is None else table)[safe]
    _, valid = solid_angle_fast(x1, n, rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], rec[:, 9:12])
    ok = valid & (light_idx >= 0) & (weights_sum > EPS)
    return torch.where(ok, rec[:, 15] / torch.clamp(weights_sum, min=1e-30),
                       torch.zeros_like(weights_sum))
