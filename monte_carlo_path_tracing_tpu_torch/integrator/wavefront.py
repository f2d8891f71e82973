"""Veach MIS light-strategy terms shared by the renderers.

Counterpart of the two helpers of
``monte_carlo_path_tracing_tpu/integrator/wavefront.py`` that the
regeneration renderer imports: :func:`_light_pdf_of_hit` and
:func:`_nee_term`, for the spherical-triangle sampler. The fixed-depth
``render_rays`` and the uniform sampler's branches are not ported yet
(ROADMAP queue 1, items 8 and 16).
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.core import vecmath as vm
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, phong
from monte_carlo_path_tracing_tpu_torch.utils.config import LS_SPHERICAL


def _require_spherical(cfg) -> None:
    if cfg.light_sampler != LS_SPHERICAL:
        raise NotImplementedError(
            "the uniform-area light sampler is not ported yet "
            "(ROADMAP queue 1, item 16: split and uniform sampling in regen)"
        )


def _light_pdf_of_hit(scene, cfg, si, prev_p, prev_ns, prev_wsum, table=None):
    """Solid-angle pdf with which the light sampler at the previous vertex
    would have generated the direction that hit light ``si``."""
    _require_spherical(cfg)
    return light_spherical.pdf_of_tri(
        scene, prev_p, prev_ns, si.light_idx, prev_wsum, table=table
    )


def _nee_term(scene, cfg, accel, si, ls, wsum, alive):
    """MIS light strategy as NEE (main.cpp:443-464 restructured per Q11):
    I * f * cos / (p_light + p_brdf), both solid-angle densities, where the
    shadow ray to the sampled point is unblocked."""
    _require_spherical(cfg)
    wl_raw = ls.coord - si.p
    dist2 = torch.clamp(vm.dot(wl_raw, wl_raw), min=1e-20)
    dist = torch.sqrt(dist2)
    wl = wl_raw / dist[:, None]
    cos_x = vm.dot(wl, si.ns)
    cos_l = -vm.dot(wl, ls.nl)
    ok = alive & ls.valid & (cos_x > 0.0) & (cos_l > 0.0)

    blocked = ops_intersect.occluded(accel, si.p, wl, dist, si.tri_id)
    visible = ok & ~blocked

    f, p_brdf = phong.eval_and_pdf_brdf(si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp)
    denom = torch.clamp(ls.pdf + p_brdf, min=1e-20)
    contrib = ls.emission * f * (cos_x / denom)[:, None]
    return torch.where(visible[:, None], contrib, torch.zeros_like(contrib))
