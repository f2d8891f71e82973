"""Wavefront radiance estimators: the fixed-depth, differentiable path.

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/wavefront.py``.
The reference's three recursive estimators (SURVEY.md §3.2-3.3):

  - ``shade_with_brdf`` (main.cpp:348-399) -> :func:`_run_brdf`
  - ``shade``           (main.cpp:269-344) -> :func:`_run_split`
  - ``shade_with_mis``  (main.cpp:402-494) -> :func:`_run_mis`

as a bounded wavefront: all N rays advance one bounce per iteration of a
Python loop over ``cfg.max_depth`` bounces, with termination as masks
(miss, backface, emissive stop, Russian roulette) over [N] tensors. The
loop stops early once no lane is alive (one host sync a bounce), which
changes no value and no ray count. Per bounce it runs K1 (extension
rays), K3 (Arvo light pick, spherical sampler) and K2 (shadow rays) on
CUDA tensors, their plain versions on CPU tensors; nothing here culls.

MIS is the restructured next-event estimation of the JAX package (quirk
Q11): an unoccluded light ray contributes its emission, an occluded one
nothing, and the BRDF continuation divides by the BRDF pdf alone.

Differentiability: gradients flow through BRDF values, emission, cosines
and MIS weights into the material table; discrete events (lobe and
triangle choices, RR masks, visibility) and sampling pdfs are detached,
at the JAX package's ``stop_gradient`` sites. K1-K3 run outside autograd:
their inputs (rays, points, normals, the packed light constants) carry no
gradient.

The light terms :func:`_light_pdf_of_hit`, :func:`_nee_term`,
:func:`_sample_light` and :func:`_direct_term` are shared with the
regeneration renderer (``integrator/regen.py``).
"""

from __future__ import annotations

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import (
    EST_BRDF, EST_MIS, EST_SHOOT, EST_SPLIT, LS_SPHERICAL, LS_UNIFORM_AREA, RenderConfig,
)

#: Where the options the port does not run yet are queued: by title, so
#: that a renumbering of ROADMAP.md leaves the messages true.
COMPAT_ITEM = 'ROADMAP queue 1, "Compat and accel extras"'


def render_rays(scene: Scene, cfg: RenderConfig, key: torch.Tensor, ro: torch.Tensor,
                rd: torch.Tensor, with_stats: bool = False, accel=None):
    """Radiance [N,3] arriving at the ray origins along -rd, one path per
    ray, on the device of the scene's tensors. ``key`` holds the [N,2]
    lane keys (``rng.lane_keys``); every draw is
    fold(fold(lane key, bounce), purpose), as in the JAX package.

    ``with_stats=True`` also returns {"rays": int64 tensor, the extension
    and shadow rays of lanes live at each trace; "nonfinite": lanes whose
    radiance is not finite}. ``accel`` injects a prebuilt
    ``ops.intersect.TriAccel``. Differentiable in the scene's materials."""
    if cfg.mis_blocker_compat:
        raise NotImplementedError(
            "mis_blocker_compat (the reference's occluded-blocker recursion) "
            "is a work-queue feature of the regeneration renderer — use "
            "render_image_regen / integrator.regen.render_regen"
        )
    todo = [
        (cfg.estimator == EST_SHOOT, "estimator 'shoot' (integrator/legacy_shoot.py)"),
        (cfg.ref_mis_weights, "ref_mis_weights light-accel MIS"),
        (cfg.accel == "grid", "accel='grid'"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"not ported yet: {what} ({COMPAT_ITEM})")
    runs = {EST_BRDF: _run_brdf, EST_SPLIT: _run_split, EST_MIS: _run_mis}
    if cfg.estimator not in runs:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    if accel is None:
        accel = ops_intersect.build_accel(scene)
    L, nrays = runs[cfg.estimator](scene, cfg, accel, common.light_index_table(scene),
                                   key.to(ro.device), ro, rd)
    nonfinite = (~torch.isfinite(L).all(dim=-1)).sum()
    if cfg.debug_checks:
        # Tripwire (the reference's printf style, main.cpp:110 / Myobj.cpp:465).
        print(f"[tripwire] non-finite radiance lanes: {int(nonfinite)}", flush=True)
    if with_stats:
        return L, {"rays": nrays, "nonfinite": nonfinite}
    return L


def _trace(accel, ro, rd, exclude):
    """Nearest hit of the extension rays: K1 on CUDA tensors."""
    return ops_intersect.intersect(accel, ro, rd, exclude)


def _init(ro):
    """(active, excl, tp, L, nrays) at depth 0."""
    N, dev = ro.shape[0], ro.device
    return (torch.ones(N, dtype=torch.bool, device=dev),
            torch.full((N,), ops_intersect.NO_HIT, dtype=torch.int32, device=dev),
            torch.ones((N, 3), device=dev), torch.zeros((N, 3), device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _brdf_step(cfg, key, d, si, alive, tp, w_rr=1.0):
    """Sample the BRDF continuation and weight the throughput: (bs, alive,
    tp). The pdf in the denominator is detached."""
    bs = phong.sample_brdf(rng.bounce_key(key, d, rng.P_BSDF), si.ns, si.wo, si.kd, si.ks,
                           si.ns_exp, branch_pdf_compat=cfg.branch_pdf_compat)
    cos_i = vm.dot(bs.wi, si.ns)
    alive = alive & (cos_i > 0.0) & (bs.pdf > 1e-12)
    f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
    scale = torch.clamp(cos_i, min=0.0) / torch.clamp(bs.pdf, min=1e-12).detach() * w_rr
    return bs, alive, torch.where(alive[:, None], tp * f * scale[:, None], tp)


# ---------------------------------------------------------------------------
# BRDF-only estimator (shade_with_brdf, main.cpp:348-399)
# ---------------------------------------------------------------------------

def _run_brdf(scene, cfg, accel, tri_to_light, key, ro, rd):
    N = ro.shape[0]
    active, excl, tp, L, nrays = _init(ro)
    for d in range(cfg.max_depth):
        if d and not bool(active.any()):
            break
        hit = _trace(accel, ro, rd, excl)
        nrays = nrays + active.sum()
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front            # backface => 0 (Q9)

        # An emissive hit ends the path with its radiance at any depth
        # (main.cpp:362-366, 392-396).
        emit_now = alive & si.is_light
        L = L + torch.where(emit_now[:, None], tp * si.emission, 0.0)
        alive = alive & ~si.is_light

        # Russian roulette (main.cpp:375-380), then the BRDF bounce.
        survive, w_rr = common.russian_roulette(rng.bounce_key(key, d, rng.P_RR), N,
                                                cfg.rr_prob)
        bs, alive, tp = _brdf_step(cfg, key, d, si, alive & survive, tp, w_rr)
        active, ro, rd, excl = alive, si.p, bs.wi, hit.tri_id
    return L, nrays


# ---------------------------------------------------------------------------
# Light terms (shared with integrator/regen.py)
# ---------------------------------------------------------------------------

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
    denom = torch.clamp(p_light + p_brdf, min=1e-20).detach()
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
    pdf = torch.clamp(ls.pdf, min=1e-20).detach()
    if cfg.light_sampler == LS_UNIFORM_AREA or cfg.measure_bug_compat:
        g = cos_x * cos_l / dist2
    else:
        g = cos_x
    contrib = ls.emission * f * (g / pdf)[:, None]
    return torch.where(visible[:, None], contrib, torch.zeros_like(contrib))


# ---------------------------------------------------------------------------
# Split direct / indirect estimator (shade, main.cpp:269-344)
# ---------------------------------------------------------------------------

def _run_split(scene, cfg, accel, tri_to_light, key, ro, rd):
    N = ro.shape[0]
    consts, table = _light_tables(scene, cfg)
    active, excl, tp, L, nrays = _init(ro)
    for d in range(cfg.max_depth):
        if d and not bool(active.any()):
            break
        hit = _trace(accel, ro, rd, excl)
        nrays = nrays + active.sum()
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front

        # Lights are pure emitters (Q5): they count only when a primary ray
        # hits them; the direct term owns BRDF-sampled light hits
        # (main.cpp:283-288, 338).
        emit_now = alive & si.is_light & (d == 0)
        L = L + torch.where(emit_now[:, None], tp * si.emission, 0.0)
        alive = alive & ~si.is_light

        # Direct light through the configured sampler (main.cpp:298-314).
        ls, _ = _sample_light(rng.bounce_key(key, d, rng.P_LIGHT_SELECT), scene, cfg, si,
                              consts=consts, table=table)
        nrays = nrays + alive.sum()                      # shadow rays
        L = L + tp * _direct_term(scene, cfg, accel, si, ls, alive)

        # RR gates only the indirect continuation (main.cpp:321-329).
        survive, w_rr = common.russian_roulette(rng.bounce_key(key, d, rng.P_RR), N,
                                                cfg.rr_prob)
        bs, alive, tp = _brdf_step(cfg, key, d, si, alive & survive, tp, w_rr)
        active, ro, rd, excl = alive, si.p, bs.wi, hit.tri_id
    return L, nrays


def _light_tables(scene, cfg):
    """(K3's packed constants, the light table) of the spherical sampler,
    built once per call; (None, None) for the uniform one. The table
    carries the emission's gradient."""
    if cfg.light_sampler != LS_SPHERICAL:
        return None, None
    return arvo_cuda.pack_consts(scene), light_spherical.light_table(scene)


# ---------------------------------------------------------------------------
# Veach MIS estimator (shade_with_mis, main.cpp:402-494)
# ---------------------------------------------------------------------------

def _run_mis(scene, cfg, accel, tri_to_light, key, ro, rd):
    N = ro.shape[0]
    spherical = cfg.light_sampler == LS_SPHERICAL
    consts, table = _light_tables(scene, cfg)
    active, excl, tp, L, nrays = _init(ro)
    prev_pb, prev_p, prev_ns = torch.ones(N, device=ro.device), ro, rd
    prev_wsum = torch.zeros(N, device=ro.device)
    for d in range(cfg.max_depth):
        if d and not bool(active.any()):
            break
        hit = _trace(accel, ro, rd, excl)
        nrays = nrays + active.sum()
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front            # backface => 0 (main.cpp:410-413)

        # Emissive hit: primary rays get the full emission (main.cpp:416-421),
        # BRDF-continued ones the balance-heuristic weight p_b / (p_b + p_light).
        is_emit = alive & si.is_light
        if d > 0:
            p_l = _light_pdf_of_hit(scene, cfg, si, prev_p, prev_ns, prev_wsum, table=table)
            w_emit = prev_pb / torch.clamp(prev_pb + p_l, min=1e-20).detach()
        else:
            w_emit = torch.ones(N, device=ro.device)
        L = L + torch.where(is_emit[:, None], tp * si.emission * w_emit[:, None], 0.0)
        alive = alive & ~si.is_light

        # RR gates both strategies (main.cpp:429-437).
        survive, w_rr = common.russian_roulette(rng.bounce_key(key, d, rng.P_RR), N,
                                                cfg.rr_prob)
        alive = alive & survive
        tp = torch.where(alive[:, None], tp * w_rr, tp)

        # Light strategy: NEE with the MIS weight.
        k_light = rng.bounce_key(key, d, rng.P_LIGHT_SELECT)
        if spherical:
            ls, wsum = light_spherical.sample(k_light, scene, si.p, si.ns, consts=consts,
                                              table=table)
        else:
            ls, wsum = light_uniform.sample(k_light, scene, N), torch.zeros(N, device=ro.device)
        nrays = nrays + alive.sum()                      # shadow rays
        L = L + tp * _nee_term(scene, cfg, accel, si, ls, wsum, alive)

        # BRDF strategy: sample, weight, continue (main.cpp:471-491).
        bs, alive, tp = _brdf_step(cfg, key, d, si, alive, tp)
        active, ro, rd, excl = alive, si.p, bs.wi, hit.tri_id
        prev_pb, prev_p, prev_ns, prev_wsum = bs.pdf.detach(), si.p, si.ns, wsum
    return L, nrays
