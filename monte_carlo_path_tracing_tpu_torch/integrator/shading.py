"""Per-vertex shading of the three estimators, for both integrators.

Counterpart of the per-vertex math of the JAX package: the bounce bodies
of ``_run_brdf``, ``_run_split`` and ``_run_mis`` and the light terms
(``_sample_light``, ``_direct_term``, ``_light_pdf_of_hit``,
``_nee_term``) of ``integrator/wavefront.py``, and their copies in
``integrator/regen.py`` (the bounce of ``render_regen``'s loop body and
the depth-0 stage of ``primary_prepass``). Here that math is written
once: :func:`vertex` (emission, Russian roulette, the light strategy,
:func:`brdf_step`) is the fixed-depth bounce's and the regen loop's
step, and the prepass calls the light terms and :func:`brdf_step`.
:func:`scene_context` builds what they read of the scene, once a
``regen.RegenJob`` and once a ``wavefront.RayRenderer`` call.

On the card the regen loop's MIS step with the spherical sampler runs as
three CUDA kernels around K3 and K2 / K5 (:func:`vertex_fused`,
``ops/vertex_cuda.py``); :func:`vertex` decides from its inputs
(:func:`takes_fused`), and every other call, the CPU's included, runs
the torch math (:func:`vertex_plain`), which the kernels equal bit for
bit.

Where JAX's call sites differ, the difference is an argument: the depth
(per lane in the regen loop, the bounce index in the fixed-depth step),
``row_offset`` of scalar-key draws, ``cull`` of the NEE shadow rays,
``via_point`` of :func:`light_pdf_along`, and the MIS light strategy
(``nee``: the regen loop's blocker queue).

MIS is the JAX package's restructured NEE (quirk Q11): an unoccluded
light ray adds its emission, an occluded one nothing, and the BRDF
continuation divides by the BRDF pdf alone. ``cfg.ref_mis_weights``
reproduces the reference's weighting instead: every continuation's
denominator adds the sampler pdf of the nearest light triangle along the
ray (Myobj.cpp:476-622), traced against a lights-only accel, and emission
counts with weight 1. Gradients (the fixed-depth path) flow through BRDF
values, emission, cosines and MIS weights; discrete events and sampling
pdfs are detached, at JAX's ``stop_gradient`` sites (with autograd off, a
detach launches nothing).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, vertex_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import (
    EST_BRDF, EST_MIS, EST_SPLIT, LS_SPHERICAL, LS_UNIFORM_AREA, RenderConfig,
)


class SceneContext(NamedTuple):
    """What shading reads of the scene besides its own tensors
    (:func:`scene_context`)."""

    scene: Scene
    cfg: RenderConfig
    accel: object               # the triangle accel (fixed depth: or the grid)
    tri_to_light: torch.Tensor  # [T] light index of each triangle (-1: none)
    consts: object              # K3's packed per-light constants (spherical sampler, else None)
    table: object               # the spherical sampler's light table (else None)
    light_accel: object         # the lights-only accel (MIS with ref_mis_weights), else None


def scene_context(scene: Scene, cfg: RenderConfig, accel=None) -> SceneContext:
    """The context of ``scene`` under ``cfg``; ``accel`` None builds the
    triangle accel. The light table carries the emission's gradient, so a
    differentiable call builds its context inside its autograd."""
    spherical = cfg.light_sampler == LS_SPHERICAL
    light_accel = (ops_intersect.build_light_accel(scene)
                   if cfg.estimator == EST_MIS and cfg.ref_mis_weights else None)
    return SceneContext(scene, cfg, ops_intersect.build_accel(scene) if accel is None else accel,
                        common.light_index_table(scene),
                        arvo_cuda.pack_consts(scene) if spherical else None,
                        light_spherical.light_table(scene) if spherical else None, light_accel)


def light_pdf_of_hit(scene, cfg, si, prev_p, prev_ns, prev_wsum, table=None):
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


def light_pdf_along(scene, cfg, light_accel, tri_to_light, si, wi, wsum, table=None,
                    via_point=False):
    """ref_mis_weights (quirk Q11, main.cpp:484-491): the solid-angle pdf
    with which the light sampler at ``si`` would pick the nearest light
    triangle along ``wi`` (closet_ray_intersect_light_triangle,
    Myobj.cpp:476-622), traced against the lights-only accel with ``si``'s
    triangle excluded (K1 on CUDA tensors); 0 where the ray meets no light.
    The uniform sampler's squared distance is each JAX call site's own:
    |(p + t wi) - p|^2 in the fixed-depth MIS (``via_point``), t^2 in the
    regen loop and the prepass."""
    lh = ops_intersect.intersect(light_accel, si.p, wi, si.tri_id)
    tri = torch.clamp(lh.tri_id, min=0).long()
    lidx = torch.where(lh.valid, tri_to_light[tri], torch.full_like(lh.tri_id, -1))
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.pdf_of_tri(scene, si.p, si.ns, lidx, wsum, table=table)
    if via_point:
        dp = (si.p + lh.t[:, None] * wi) - si.p
        d2 = vm.dot(dp, dp)
    else:
        d2 = lh.t * lh.t
    d2 = torch.clamp(d2, min=1e-20)
    pdf = common.area_pdf_to_solid_angle(
        light_uniform.pdf_area(scene, torch.clamp(lidx, min=0)), d2,
        -vm.dot(wi, scene.geo_n[tri]))
    return torch.where(lh.valid, pdf, torch.zeros_like(pdf))


def shadow_ray(si, ls):
    """(unit direction, distance, squared distance, cos at x, cos at the
    light) of the shadow ray from ``si.p`` to the light sample."""
    wl_raw = ls.coord - si.p
    dist2 = torch.clamp(vm.dot(wl_raw, wl_raw), min=1e-20)
    dist = torch.sqrt(dist2)
    wl = wl_raw / dist[:, None]
    return wl, dist, dist2, vm.dot(wl, si.ns), -vm.dot(wl, ls.nl)


def nee_term(scene, cfg, accel, si, ls, wsum, alive, cull=None):
    """MIS light strategy as NEE (main.cpp:443-464 restructured per Q11):
    I * f * cos / (p_light + p_brdf), both solid-angle densities, where the
    shadow ray to the sampled point is unblocked. ``cull`` forwards to the
    occlusion test (the primary pre-pass passes True: its shadow batches
    are pixel-ordered, hence coherent)."""
    wl, dist, dist2, cos_x, cos_l = shadow_ray(si, ls)
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


def sample_light(key, scene, cfg, si, consts=None, table=None, row_offset=0):
    """The configured light sampler: (LightSample, weights_sum or None)."""
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.sample(key, scene, si.p, si.ns, consts=consts, table=table,
                                      row_offset=row_offset)
    return light_uniform.sample(key, scene, si.p.shape[0], row_offset), None


def direct_term(scene, cfg, accel, si, ls, alive, cull=None):
    """Shadow-rayed direct light of the split estimator (main.cpp:298-314).
    With the uniform sampler (or ``measure_bug_compat``, quirk Q3) the
    geometry factor is the area form cos_x cos_l / r^2; the spherical
    sampler's solid-angle pdf already holds it."""
    wl, dist, dist2, cos_x, cos_l = shadow_ray(si, ls)
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


def brdf_step(c: SceneContext, kd, si, alive, tp=None, w_rr=1.0, wsum=None, row_offset=0,
              via_point=False):
    """The BRDF continuation (main.cpp:471-491) from the depth-folded key
    ``kd``: (BRDF sample, alive, throughput). A lane goes on where its
    sample leaves above the surface with a positive pdf. The throughput is
    ``tp`` * f cos / pdf * ``w_rr`` on the lanes that go on and ``tp``
    elsewhere; without ``tp`` (unit throughput, the prepass's seeds) it is
    f cos / pdf * ``w_rr`` on every lane. The denominator is the BRDF pdf,
    under ref_mis_weights plus :func:`light_pdf_along` (main.cpp:484-491;
    ``wsum``, ``via_point``), and is detached."""
    bs = phong.sample_brdf(rng.fold_in(kd, rng.P_BSDF), si.ns, si.wo, si.kd, si.ks, si.ns_exp,
                           branch_pdf_compat=c.cfg.branch_pdf_compat, row_offset=row_offset)
    cos_i = vm.dot(bs.wi, si.ns)
    alive = alive & (cos_i > 0.0) & (bs.pdf > 1e-12)
    pdf = bs.pdf
    if c.light_accel is not None:
        pdf = pdf + light_pdf_along(c.scene, c.cfg, c.light_accel, c.tri_to_light, si, bs.wi,
                                    wsum, table=c.table, via_point=via_point)
    f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
    scale = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf, min=1e-12).detach() * w_rr
    if tp is None:
        return bs, alive, f * scale[:, None]
    return bs, alive, torch.where(alive[:, None], tp * f * scale[:, None], tp)


def emission(c: SceneContext, si, hit, tp, L, depth, prev=None):
    """``L`` with the radiance of the emissive hits among ``hit`` (the live
    front-facing hits) added, each times ``tp`` and its weight. Primary
    hits (``depth`` 0: per lane in the regen loop, the bounce index, an int
    or a device scalar, in the fixed-depth step) weigh 1
    (main.cpp:416-421). Later ones: BRDF-only 1 (main.cpp:362-366,
    392-396); split 0, as lights are pure emitters (Q5) whose BRDF-sampled
    hits the direct term owns (main.cpp:283-288, 338); MIS the balance
    heuristic p_b / (p_b + p_light) of the previous vertex ``prev`` =
    (BRDF pdf, point, shading normal, weights_sum), or 1 under
    ref_mis_weights, which put the light pdf into the throughput there."""
    emit = hit & si.is_light
    est = c.cfg.estimator
    w = None
    if est == EST_SPLIT:
        emit = emit & (depth == 0)
    elif est == EST_MIS and c.light_accel is None and not (isinstance(depth, int) and depth == 0):
        pb, prev_p, prev_ns, prev_wsum = prev
        p_l = light_pdf_of_hit(c.scene, c.cfg, si, prev_p, prev_ns, prev_wsum, table=c.table)
        w = pb / torch.clamp(pb + p_l, min=1e-20).detach()
        if torch.is_tensor(depth):
            w = torch.where(depth == 0, torch.ones_like(w), w)
    add = tp * si.emission if w is None else tp * si.emission * w[:, None]
    return L + torch.where(emit[:, None], add, 0.0)


class Vertex(NamedTuple):
    """What :func:`vertex` leaves of a path vertex."""

    L: torch.Tensor            # [N,3] radiance, the vertex's emission and light added
    alive: torch.Tensor        # [N] bool: the path goes on along bs.wi
    tp: torch.Tensor           # [N,3] throughput of the continuation
    bs: phong.BsdfSample       # the BRDF sample
    wsum: torch.Tensor | None  # [N] weights_sum of the spherical light sample (else None)
    nrays: torch.Tensor        # the ray count, the vertex's shadow rays added


def takes_fused(c: SceneContext, si, tp, L, kd, depth, prev=None,
                nee: Callable[..., torch.Tensor] | None = None) -> bool:
    """Whether a :func:`vertex` call with these inputs, on CUDA tensors,
    runs the fused kernels (``ops/vertex_cuda.py``): the regen loop's MIS
    step with the spherical sampler. That takes the MIS estimator and the
    spherical (Arvo) light sampler, no lights-only accel (``c.light_accel``
    None: no ref_mis_weights), no light strategy of the caller's (``nee``
    None: no blocker queue), a per-lane key ``kd`` [N, 2] and depth [N] and
    ``prev`` (the fixed-depth bounce passes one depth for all lanes), and
    no input that requires grad. No caller under autograd passes per-lane
    depths, so the last is a guard for later callers: the kernels have no
    backward."""
    cfg = c.cfg
    n = si.p.shape[0]
    return (cfg.estimator == EST_MIS and cfg.light_sampler == LS_SPHERICAL
            and c.light_accel is None and nee is None and prev is not None
            and kd.shape == (n, 2) and torch.is_tensor(depth) and depth.shape == (n,)
            and not (torch.is_grad_enabled() and any(
                torch.is_tensor(t) and t.requires_grad
                for t in (si.p, si.ns, si.wo, si.kd, si.ks, si.ns_exp, si.emission, tp, L,
                          c.table, *prev))))


def vertex(c: SceneContext, si, hit, tp, L, nrays, kd, depth, prev=None, row_offset=0,
           cull=None, via_point=False,
           nee: Callable[..., torch.Tensor] | None = None) -> Vertex:
    """One step of ``c.cfg.estimator`` at the vertices ``si`` after the
    trace and the gather, for the lanes ``hit`` (live, hit, front-facing):
    :func:`emission`, Russian roulette (Q6), the light strategy and
    :func:`brdf_step`, every draw from fold(``kd``, purpose), ``kd`` the
    depth-folded key (fold(lane key, depth), per lane or scalar, whose
    draws start at ``row_offset``). ``depth`` and ``prev`` as in
    :func:`emission`, ``via_point`` as in :func:`light_pdf_along`.

    - brdf: RR gates the bounce.
    - split: the direct term for every hit lane, then RR gates only the
      continuation (main.cpp:321-329); its shadow rays are never culled.
    - mis: RR gates both strategies (main.cpp:429-437), then NEE with its
      shadow rays culled as ``cull`` says, or ``nee(si, ls, alive, tp)``,
      which returns the radiance the light strategy adds (the regen loop's
      blocker queue).

    On CUDA tensors where :func:`takes_fused` holds (the regen loop's MIS
    / Arvo step on the card) :func:`vertex_fused` computes it, and
    :func:`vertex_plain`, the same math in torch, everywhere else."""
    if si.p.is_cuda and takes_fused(c, si, tp, L, kd, depth, prev, nee):
        return vertex_fused(c, si, hit, tp, L, nrays, kd, depth, prev, cull)
    return vertex_plain(c, si, hit, tp, L, nrays, kd, depth, prev, row_offset, cull, via_point,
                        nee)


def vertex_plain(c: SceneContext, si, hit, tp, L, nrays, kd, depth, prev=None, row_offset=0,
                 cull=None, via_point=False,
                 nee: Callable[..., torch.Tensor] | None = None) -> Vertex:
    """:func:`vertex` in torch ops, on any device and under autograd: the
    plain version of :func:`vertex_fused`."""
    cfg, est = c.cfg, c.cfg.estimator
    L = emission(c, si, hit, tp, L, depth, prev)
    alive = hit & ~si.is_light
    survive, w_rr = common.russian_roulette(rng.fold_in(kd, rng.P_RR), hit.shape[0],
                                            cfg.rr_prob, row_offset)
    if est == EST_MIS:
        alive = alive & survive
        tp = torch.where(alive[:, None], tp * w_rr, tp)
    wsum = None
    if est != EST_BRDF:
        ls, wsum = sample_light(rng.fold_in(kd, rng.P_LIGHT_SELECT), c.scene, cfg, si,
                                consts=c.consts, table=c.table, row_offset=row_offset)
        nrays = nrays + alive.sum()                      # shadow rays
        if est == EST_SPLIT:
            L = L + tp * direct_term(c.scene, cfg, c.accel, si, ls, alive)
        elif nee is None:
            L = L + tp * nee_term(c.scene, cfg, c.accel, si, ls, wsum, alive, cull=cull)
        else:
            L = L + nee(si, ls, alive, tp)
    if est != EST_MIS:
        alive = alive & survive
    bs, alive, tp = brdf_step(c, kd, si, alive, tp, 1.0 if est == EST_MIS else w_rr, wsum,
                              row_offset, via_point)
    return Vertex(L, alive, tp, bs, wsum, nrays)


def vertex_fused(c: SceneContext, si, hit, tp, L, nrays, kd, depth, prev, cull=None) -> Vertex:
    """:func:`vertex` of the MIS estimator with the spherical sampler, per-lane
    keys and depths, on CUDA tensors, as three kernels (``ops/vertex_cuda.py``)
    around K3's light pick and K2 / K5's shadow test: :func:`vertex_plain`'s
    values bit for bit, its 12 draws made inside the kernels."""
    pb, prev_p, prev_ns, prev_w = prev
    e = vertex_cuda.emit_rr(hit, si.is_light, si.light_idx, si.emission, tp, L, depth, pb, prev_p,
                            prev_ns, prev_w, c.table, kd, nrays, c.cfg.rr_prob)
    lidx, wsum = arvo_cuda.arvo_select(c.consts, si.p, si.ns, e.u)                   # K3
    s = vertex_cuda.light_brdf(kd, lidx, wsum, si.p, si.ns, si.wo, si.kd, si.ks, si.ns_exp,
                               e.alive, e.tp, c.table, e.nrays, c.cfg.branch_pdf_compat)
    blocked = ops_intersect.occluded(c.accel, si.p, s.wl, s.dist, si.tri_id, cull=cull)  # K2 / K5
    L = vertex_cuda.nee_add(e.L, e.tp, s.contrib, blocked)
    bs = phong.BsdfSample(wi=s.wi, pdf=s.pdf, is_specular=s.spec)
    return Vertex(L, s.alive, s.tp, bs, wsum, e.nrays)
