"""Light-strategy terms shared by the renderers.

Counterpart of the helpers of
``monte_carlo_path_tracing_tpu/integrator/wavefront.py`` that the
regeneration renderer imports: :func:`_light_pdf_of_hit` and
:func:`_nee_term` (Veach MIS), :func:`_sample_light` and
:func:`_direct_term` (the split estimator), for both light samplers. The
fixed-depth ``render_rays`` is not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.core import vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu_torch.utils.config import LS_SPHERICAL, LS_UNIFORM_AREA


def _light_pdf_of_hit(scene, cfg, si, prev_p, prev_ns, prev_wsum, table=None):
    """Solid-angle pdf with which the light sampler at the previous vertex
    would have generated the direction that hit light ``si``."""
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.pdf_of_tri(
            scene, prev_p, prev_ns, si.light_idx, prev_wsum, table=table
        )
    wl_raw = si.p - prev_p
    dist2 = torch.clamp(vm.dot(wl_raw, wl_raw), min=1e-20)
    pdf_a = light_uniform.pdf_area(scene, torch.clamp(si.light_idx, min=0))
    wl = wl_raw / torch.sqrt(dist2)[:, None]
    cos_l = -vm.dot(wl, si.ng)   # the hit triangle's vote-oriented normal
    pdf = common.area_pdf_to_solid_angle(pdf_a, dist2, cos_l)
    return torch.where(si.light_idx >= 0, pdf, torch.zeros_like(pdf))


def _shadow_ray(si, ls):
    """(unit direction, distance, squared distance, cos at x, cos at the
    light) of the shadow ray from ``si.p`` to the light sample."""
    wl_raw = ls.coord - si.p
    dist2 = torch.clamp(vm.dot(wl_raw, wl_raw), min=1e-20)
    dist = torch.sqrt(dist2)
    wl = wl_raw / dist[:, None]
    return wl, dist, dist2, vm.dot(wl, si.ns), -vm.dot(wl, ls.nl)


def _nee_term(scene, cfg, accel, si, ls, wsum, alive, cull=None):
    """MIS light strategy as NEE (main.cpp:443-464 restructured per Q11):
    I * f * cos / (p_light + p_brdf), both solid-angle densities, where the
    shadow ray to the sampled point is unblocked. ``cull`` forwards to the
    occlusion test (the primary pre-pass passes True: its shadow batches
    are pixel-ordered, hence coherent)."""
    wl, dist, dist2, cos_x, cos_l = _shadow_ray(si, ls)
    ok = alive & ls.valid & (cos_x > 0.0) & (cos_l > 0.0)
    blocked = ops_intersect.occluded(accel, si.p, wl, dist, si.tri_id, cull=cull)
    visible = ok & ~blocked

    if cfg.light_sampler == LS_SPHERICAL:
        p_light = ls.pdf
    else:
        p_light = common.area_pdf_to_solid_angle(ls.pdf, dist2, cos_l)
    f, p_brdf = phong.eval_and_pdf_brdf(si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp)
    denom = torch.clamp(p_light + p_brdf, min=1e-20)
    contrib = ls.emission * f * (cos_x / denom)[:, None]
    return torch.where(visible[:, None], contrib, torch.zeros_like(contrib))


def _sample_light(key, scene, cfg, si, consts=None, table=None):
    """The configured light sampler: (LightSample, weights_sum or None)."""
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.sample(key, scene, si.p, si.ns, consts=consts, table=table)
    return light_uniform.sample(key, scene, si.p.shape[0]), None


def _direct_term(scene, cfg, accel, si, ls, alive, cull=None):
    """Shadow-rayed direct light of the split estimator (main.cpp:298-314).
    With the uniform sampler (or ``measure_bug_compat``, quirk Q3) the
    geometry factor is the area form cos_x cos_l / r^2; the spherical
    sampler's solid-angle pdf already holds it."""
    wl, dist, dist2, cos_x, cos_l = _shadow_ray(si, ls)
    ok = alive & ls.valid & (cos_x > 0.0) & (cos_l > 0.0)
    blocked = ops_intersect.occluded(accel, si.p, wl, dist, si.tri_id, cull=cull)
    visible = ok & ~blocked

    f = phong.eval_brdf(si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp)
    pdf = torch.clamp(ls.pdf, min=1e-20)
    if cfg.light_sampler == LS_UNIFORM_AREA or cfg.measure_bug_compat:
        g = cos_x * cos_l / dist2
    else:
        g = cos_x
    contrib = ls.emission * f * (g / pdf)[:, None]
    return torch.where(visible[:, None], contrib, torch.zeros_like(contrib))
