"""Uniform area-light sampling (reference Mylight.cpp:102-160).

Counterpart of ``monte_carlo_path_tracing_tpu/sampling/light_uniform.py``.
A three-stage draw: light class (mtlname) by radiance sum, triangle within
the class by area, then a uniform point by the barycentric warp
beta = 1 - sqrt(1 - xi1), gamma = (1 - beta) xi2. The first two stages are
one static per-light-triangle categorical p_sel[l] = P(class) area_l /
area(class). ``pdf`` is an area density p_sel / area.
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.core.radiometry import radiance_sum
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene


@dataclasses.dataclass(frozen=True)
class LightSample:
    """sampledLightPoint (Mylight.h:67-97). ``pdf`` is a solid-angle density
    for the spherical sampler and an area density for the uniform one."""

    coord: torch.Tensor      # [N,3]
    light_idx: torch.Tensor  # [N] index into scene.light_tri_ids
    tri_id: torch.Tensor     # [N] global triangle id
    emission: torch.Tensor   # [N,3]
    pdf: torch.Tensor        # [N]
    valid: torch.Tensor      # [N] bool (False => dummy sample, contributes 0)
    nl: torch.Tensor         # [N,3] light geometric normal (vote-oriented)


def select_table(scene: Scene) -> torch.Tensor:
    """Static per-light-triangle selection probabilities p_sel [L]: class
    weight = the class's radiance sum (Mylight.cpp:112-123), triangle
    weight within the class = area."""
    l_sum = radiance_sum(scene.light_emission())
    cls = scene.light_class.long()
    area = scene.light_area
    class_rad = torch.zeros_like(area).scatter_reduce(0, cls, l_sum, "amax", include_self=False)
    class_area = torch.zeros_like(area).index_add_(0, cls, area)
    w_class = torch.where(class_area > 0, class_rad, torch.zeros_like(class_rad))
    p_class = w_class / torch.clamp(w_class.sum(), min=1e-30)
    return p_class[cls] * (area / torch.clamp(class_area[cls], min=1e-30))


def sample(key: torch.Tensor, scene: Scene, n_rays: int, row_offset: int = 0) -> LightSample:
    """One light point per ray: the pick from ``fold_in(key, 0)``, the warp
    from ``fold_in(key, 1)``; a scalar key draws from row ``row_offset``
    on."""
    p_sel = select_table(scene)
    lidx = rng.pick_weighted(rng.fold_in(key, 0), p_sel, n_rays, row_offset=row_offset)
    xi = rng.uniform(rng.fold_in(key, 1), (n_rays, 2), row_offset=row_offset)
    beta = 1.0 - torch.sqrt(torch.clamp(1.0 - xi[:, 0], min=0.0))
    gamma = (1.0 - beta) * xi[:, 1]
    li = lidx.long()
    tri = scene.light_tri_ids[li].long()
    coord = (scene.tri_v0[tri] + beta[:, None] * scene.tri_e1[tri]
             + gamma[:, None] * scene.tri_e2[tri])
    return LightSample(
        coord=coord,
        light_idx=lidx,
        tri_id=scene.light_tri_ids[li],
        emission=scene.light_emission()[li],
        pdf=(p_sel / torch.clamp(scene.light_area, min=1e-30))[li],
        valid=torch.ones(n_rays, dtype=torch.bool, device=coord.device),
        nl=scene.geo_n[tri],
    )


def pdf_area(scene: Scene, light_idx: torch.Tensor) -> torch.Tensor:
    """Area density of sampling a point on light triangle ``light_idx``."""
    li = light_idx.long()
    return select_table(scene)[li] / torch.clamp(scene.light_area[li], min=1e-30)
