"""Per-vertex machinery shared by the integrators.

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/common.py``: the
surface-interaction gather (barycentric interpolation + facet attributes,
main.cpp:273-292 / Myobj.cpp:626-709), Russian roulette and the
solid-angle pdf conversion.
The JAX package packs the per-triangle fields into one 34-wide table to
save TPU gathers; here each field is gathered directly.
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import Hit
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene


@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    """Everything the estimators read at a path vertex."""

    p: torch.Tensor          # [N,3] hit position
    ns: torch.Tensor         # [N,3] interpolated unit shading normal
    ng: torch.Tensor         # [N,3] vote-oriented geometric normal
    wo: torch.Tensor         # [N,3] toward the previous vertex (unit)
    kd: torch.Tensor         # [N,3]
    ks: torch.Tensor         # [N,3]
    ns_exp: torch.Tensor     # [N] Phong exponent
    emission: torch.Tensor   # [N,3]
    is_light: torch.Tensor   # [N] bool
    front: torch.Tensor      # [N] bool: ns . wo > 0 (backface => black, Q9)
    tri_id: torch.Tensor     # [N] int32
    light_idx: torch.Tensor  # [N] index into light arrays (-1 for non-lights)


def light_index_table(scene: Scene) -> torch.Tensor:
    """[T] map tri_id -> light index (-1 for non-lights), the reference's
    per-point indiceMap (Mylight.h:119)."""
    table = torch.full((scene.num_tris,), -1, dtype=torch.int32, device=scene.device)
    table[scene.light_tri_ids.long()] = torch.arange(
        scene.num_lights, dtype=torch.int32, device=scene.device)
    return table


def gather_interaction(scene: Scene, hit: Hit, rd: torch.Tensor,
                       tri_to_light: torch.Tensor) -> SurfaceInteraction:
    tri = torch.clamp(hit.tri_id, min=0).long()   # miss sentinel -> safe gather
    mat = scene.tri_mat_id[tri].long()
    mats = scene.materials
    v0, e1, e2 = scene.tri_v0[tri], scene.tri_e1[tri], scene.tri_e2[tri]
    vn = scene.tri_vn[tri]
    u = hit.u[:, None]
    v = hit.v[:, None]
    p = v0 + u * e1 + v * e2
    ns = vm.normalize((1.0 - u - v) * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    wo = -rd
    return SurfaceInteraction(
        p=p, ns=ns, ng=scene.geo_n[tri], wo=wo,
        kd=mats.kd[mat], ks=mats.ks[mat], ns_exp=mats.ns[mat],
        emission=mats.emission[mat],
        is_light=scene.is_light[tri] & hit.valid,
        front=vm.dot(ns, wo) > 0.0,
        tri_id=hit.tri_id,
        light_idx=torch.where(hit.valid, tri_to_light[tri], torch.full_like(hit.tri_id, -1)),
    )


def russian_roulette(key: torch.Tensor, n: int, p_survive: float, row_offset: int = 0):
    """Survive mask [n] and 1/p weight (reference: ksi > 0.6 => stop,
    main.cpp:321-329). A scalar key draws from row ``row_offset`` on."""
    return rng.uniform(key, (n,), row_offset=row_offset) < p_survive, 1.0 / p_survive


def area_pdf_to_solid_angle(pdf_area, dist2, cos_light):
    """p(w) = p(A) r^2 / cos(theta_light); zero when the light is seen
    edge-on or from behind."""
    ok = cos_light > 1e-7
    return torch.where(ok, pdf_area * dist2 / torch.clamp(cos_light, min=1e-7),
                       torch.zeros_like(pdf_area))
