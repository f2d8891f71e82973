"""Wavefront radiance estimators: the fixed-depth, differentiable path.

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/wavefront.py``.
The reference's three recursive estimators (SURVEY.md §3.2-3.3):

  - ``shade_with_brdf`` (main.cpp:348-399) -> :func:`_bounce_brdf`
  - ``shade``           (main.cpp:269-344) -> :func:`_bounce_split`
  - ``shade_with_mis``  (main.cpp:402-494) -> :func:`_bounce_mis`

as a bounded wavefront: all N rays advance one bounce per step, over at
most ``cfg.max_depth`` bounces (JAX's ``fori_loop``), with termination as
masks (miss, backface, emissive stop, Russian roulette) over [N] tensors.
A bounce maps a dict of [N] state tensors to the next. The loop stops
early once no lane is alive (a host read of the live mask before each
bounce after the first), which changes no value and no ray count. Per
bounce it runs K1 (extension rays), K3 (Arvo light pick, spherical
sampler) and K2 (shadow rays) on CUDA tensors, their plain versions on CPU
tensors; nothing here culls.

:func:`render_rays` runs the loop eagerly. :class:`RayRenderer`, which
``render_image`` calls once per batch, runs it in place over state
buffers (:func:`bounce_loop`) where autograd is off, on the triangle
accel and CUDA tensors, captured once as a CUDA graph and replayed
across the batches of a render (``integrator/graph.py``; the bounce
index is a device scalar). Gradients and the grid run the eager loop.

MIS is the restructured next-event estimation of the JAX package (quirk
Q11): an unoccluded light ray contributes its emission, an occluded one
nothing, and the BRDF continuation divides by the BRDF pdf alone. With
``cfg.ref_mis_weights`` the reference's weighting is reproduced instead:
each continuation's denominator adds the sampler pdf of the nearest light
triangle along the ray (closet_ray_intersect_light_triangle,
Myobj.cpp:476-622), traced against a lights-only accel (K1 on CUDA
tensors), and emission counts with weight 1. The occluded-blocker
recursion (``mis_blocker_compat``) belongs to the regeneration renderer.
``estimator="shoot"`` dispatches to ``integrator/legacy_shoot.py``;
``cfg.accel == "grid"`` traces through the uniform grid (``ops/grid.py``).

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

import functools
from typing import NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.integrator import graph as graph_mod
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, grid as grid_mod
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import (
    EST_BRDF, EST_MIS, EST_SHOOT, EST_SPLIT, LS_SPHERICAL, LS_UNIFORM_AREA, RenderConfig,
)


def render_rays(scene: Scene, cfg: RenderConfig, key: torch.Tensor, ro: torch.Tensor,
                rd: torch.Tensor, with_stats: bool = False, accel=None, row_offset: int = 0):
    """Radiance [N,3] arriving at the ray origins along -rd, one path per
    ray, on the device of the scene's tensors. ``key`` holds the [N,2]
    lane keys (``rng.lane_keys``); every draw is
    fold(fold(lane key, bounce), purpose), as in the JAX package. A scalar
    [2] key draws each (bounce, purpose) over the N rays at once; then
    ``row_offset`` r0 makes the rays rows [r0, r0 + N) of a larger batch,
    whose draws they take bit for bit (``parallel.render_rays_sharded``).

    ``with_stats=True`` also returns {"rays": int64 tensor, the extension
    and shadow rays of lanes live at each trace; "nonfinite": lanes whose
    radiance is not finite}. ``accel`` injects a prebuilt
    ``ops.intersect.TriAccel`` or ``ops.grid.GridAccel``; without one, a
    grid is built when ``cfg.accel == "grid"``. Differentiable in the
    scene's materials, except through a grid (ValueError, as JAX's
    reverse mode refuses its loop).

    The bounce loop runs eagerly: :class:`RayRenderer`, which
    ``render_image`` calls once per batch, is where the bounce is
    captured as a CUDA graph."""
    return RayRenderer(scene, cfg, accel=accel, row_offset=row_offset, graph=False)(
        key, ro, rd, with_stats=with_stats)


def _use_bounce_graph(graph: bool | None, device: torch.device, grad: bool, grid: bool,
                      shoot: bool) -> bool:
    """Whether :class:`RayRenderer` captures the bounce (its ``graph``)."""
    if graph is False:
        return False
    if grad or grid or shoot:
        if graph:
            raise ValueError("graph=True captures the no-grad bounce over the triangle accel: "
                             f"gradients {grad}, grid {grid}, shoot estimator {shoot}")
        return False
    return graph_mod.use_graph(graph, device)


def _bounces(max_depth: int, active):
    """The depths the bounce loop runs: at most ``max_depth``, and before
    each after the first a lane alive (``active()``, the live mask: one
    host read). Stopping early changes no value and no ray count."""
    for d in range(max_depth):
        if d and not bool(active().any()):
            return
        yield d


class RayRenderer:
    """:func:`render_rays` (same arguments) for one scene and configuration,
    called once per batch of rays. ``graph``: ``None`` captures the bounce
    as a CUDA graph where it can (CUDA tensors, autograd off or no material
    requiring grad, the triangle accel, estimator mis / split / brdf) and
    runs it eagerly elsewhere; ``False`` runs it eagerly; ``True``
    captures, and raises where it cannot. Both give the same radiance and
    rays. Captured, the first batch's bounce 0 is the warm-up and its
    bounce 1 is captured; every later bounce of every batch is one replay,
    each batch copying its rays and keys into the step's input buffers.
    Every batch of a captured renderer has the first one's ray count and
    key shape. The capture is decided at each call, from whether autograd
    records there."""

    def __init__(self, scene: Scene, cfg: RenderConfig, accel=None, row_offset: int = 0,
                 graph: bool | None = None):
        if cfg.mis_blocker_compat:
            raise NotImplementedError(
                "mis_blocker_compat (the reference's occluded-blocker recursion) "
                "is a work-queue feature of the regeneration renderer — use "
                "render_image_regen / integrator.regen.render_regen"
            )
        if cfg.estimator not in (EST_SHOOT, *_BOUNCES):
            raise ValueError(f"unknown estimator {cfg.estimator!r}")
        if accel is None and cfg.estimator != EST_SHOOT:
            accel = (grid_mod.build_grid(scene, n0=cfg.grid_n0) if cfg.accel == "grid"
                     else ops_intersect.build_accel(scene))
        self.scene, self.cfg, self.accel = scene, cfg, accel
        self.row_offset, self.graph = row_offset, graph
        self.loop = None   # (state, load, GraphedLoop) once a batch is captured

    def __call__(self, key: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
                 with_stats: bool = False):
        scene, cfg = self.scene, self.cfg
        key = key.to(ro.device)
        m = scene.materials
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (m.kd, m.ks, m.ns, m.emission))
        grid = isinstance(self.accel, grid_mod.GridAccel)
        shoot = cfg.estimator == EST_SHOOT
        captured = _use_bounce_graph(self.graph, scene.device, grad, grid, shoot)
        if shoot:
            # The legacy C17 estimator (dead code in the reference) has its
            # own module and its own accel.
            from monte_carlo_path_tracing_tpu_torch.integrator import legacy_shoot

            L, stats = legacy_shoot.render_rays_shoot(scene, cfg, key, ro, rd, with_stats=True,
                                                      row_offset=self.row_offset)
            if with_stats:
                return L, {"rays": stats["rays"],
                           "nonfinite": (~torch.isfinite(L).all(dim=-1)).sum()}
            return L
        if grid and grad:
            # JAX's grid is a lax.while_loop, which reverse mode refuses.
            raise ValueError("reverse-mode differentiation does not run through the grid's "
                             "3D-DDA loop, as in the JAX package: use accel 'auto' or "
                             "'all_pairs'")
        if captured:
            L, nrays = self._replayed(key, ro, rd)
        else:
            ctx = _context(scene, cfg, self.accel, self.row_offset)
            st = _init(ro, rd, cfg.estimator == EST_MIS)
            bounce = _BOUNCES[cfg.estimator]
            for d in _bounces(cfg.max_depth, lambda: st["active"]):
                st = bounce(ctx, st, key, d)
            L, nrays = st["L"], st["nrays"]
        nonfinite = (~torch.isfinite(L).all(dim=-1)).sum()
        if cfg.debug_checks:
            # Tripwire (the reference's printf style, main.cpp:110 / Myobj.cpp:465).
            print(f"[tripwire] non-finite radiance lanes: {int(nonfinite)}", flush=True)
        if with_stats:
            return L, {"rays": nrays, "nonfinite": nonfinite}
        return L

    def _replayed(self, key, ro, rd):
        """The batch through the captured bounce: (radiance, rays), copies
        of the step's buffers, which the next batch overwrites."""
        if self.loop is None:
            state, load, iterate = bounce_loop(self.scene, self.cfg, self.accel, ro.shape[0],
                                               tuple(key.shape), self.row_offset)
            step = graph_mod.GraphedLoop(functools.partial(iterate, state), self.scene.device)
            self.loop = (state, load, step)
        state, load, step = self.loop
        if ro.shape[0] != state["ro"].shape[0] or key.shape != state["key"].shape:
            raise ValueError(f"a captured renderer takes batches of {state['ro'].shape[0]} rays "
                             f"and keys {tuple(state['key'].shape)}: got {ro.shape[0]} rays, "
                             f"keys {tuple(key.shape)}")
        load(key, ro, rd)
        for _ in _bounces(self.cfg.max_depth, lambda: state["active"]):
            step()
        return state["L"].clone(), state["nrays"].clone()


def bounce_loop(scene: Scene, cfg: RenderConfig, accel, n: int, key_shape=(2,),
                row_offset: int = 0):
    """The bounce loop of :func:`render_rays` for batches of ``n`` rays, as
    (state, load, iterate):

    - ``state``: a dict of tensors, each its own buffer: the lanes
      (``active``, ``ro``, ``rd``, ``excl``, ``tp``, ``L``; with mis the
      previous vertex ``prev_*``), ``nrays`` (rays traced), the keys
      ``key`` (of ``key_shape``) and the bounce index ``d``;
    - ``load(key, ro, rd)``: copy a batch's keys and rays in and reset the
      rest to depth 0;
    - ``iterate(state)``: one bounce at depth ``state["d"]``, which reads
      ``state`` and writes every tensor of it in place and touches nothing
      else, so that it can be captured as a CUDA graph and replayed
      (``integrator/graph.py``).

    The loop's condition stays with the caller (:func:`_bounces`)."""
    ctx = _context(scene, cfg, accel, row_offset)
    bounce = _BOUNCES[cfg.estimator]
    mis = cfg.estimator == EST_MIS
    dev = scene.device
    zero = torch.zeros((n, 3), device=dev)
    state = {k: v.clone() for k, v in _init(zero, zero, mis).items()}
    state["key"] = torch.zeros(tuple(key_shape), dtype=torch.int64, device=dev)
    state["d"] = torch.zeros((), dtype=torch.int64, device=dev)

    def load(key, ro, rd) -> None:
        for k, v in _init(ro, rd, mis).items():
            state[k].copy_(v)
        state["key"].copy_(key)
        state["d"].zero_()

    def iterate(st) -> None:
        out = bounce(ctx, st, st["key"], st["d"])
        out["d"] = st["d"] + 1
        for k, v in out.items():
            st[k].copy_(v)

    return state, load, iterate


def _trace(accel, ro, rd, exclude):
    """Nearest hit of the extension rays: K1 on CUDA tensors."""
    return ops_intersect.intersect(accel, ro, rd, exclude)


def _init(ro, rd, mis: bool) -> dict:
    """The state at depth 0: every lane active, nothing excluded, unit
    throughput, no radiance, no rays; with mis the previous vertex (pdf 1,
    the camera ray, no Arvo weights)."""
    N, dev = ro.shape[0], ro.device
    st = {"active": torch.ones(N, dtype=torch.bool, device=dev), "ro": ro, "rd": rd,
          "excl": torch.full((N,), ops_intersect.NO_HIT, dtype=torch.int32, device=dev),
          "tp": torch.ones((N, 3), device=dev), "L": torch.zeros((N, 3), device=dev),
          "nrays": torch.zeros((), dtype=torch.int64, device=dev)}
    if mis:
        st.update(prev_pb=torch.ones(N, device=dev), prev_p=ro, prev_ns=rd,
                  prev_wsum=torch.zeros(N, device=dev))
    return st


class _Ctx(NamedTuple):
    """What every bounce of one call reads besides its state."""

    scene: Scene
    cfg: RenderConfig
    accel: object
    tri_to_light: torch.Tensor
    r0: int
    consts: object
    table: object
    light_accel: object


def _context(scene, cfg, accel, row_offset) -> _Ctx:
    """The bounce's constants, built once per call (the light table
    carries the emission's gradient)."""
    consts, table = _light_tables(scene, cfg)
    light_accel = (ops_intersect.build_light_accel(scene)
                   if cfg.estimator == EST_MIS and cfg.ref_mis_weights else None)
    return _Ctx(scene, cfg, accel, common.light_index_table(scene), row_offset, consts, table,
                light_accel)


def _brdf_step(cfg, key, d, si, alive, tp, w_rr=1.0, row_offset=0, pdf_along=None):
    """Sample the BRDF continuation and weight the throughput: (bs, alive,
    tp). The denominator is the BRDF pdf, plus ``pdf_along(wi)`` where
    given (ref_mis_weights), and is detached."""
    bs = phong.sample_brdf(rng.bounce_key(key, d, rng.P_BSDF), si.ns, si.wo, si.kd, si.ks,
                           si.ns_exp, branch_pdf_compat=cfg.branch_pdf_compat,
                           row_offset=row_offset)
    cos_i = vm.dot(bs.wi, si.ns)
    alive = alive & (cos_i > 0.0) & (bs.pdf > 1e-12)
    pdf = bs.pdf if pdf_along is None else bs.pdf + pdf_along(bs.wi)
    f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
    scale = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf, min=1e-12).detach() * w_rr
    return bs, alive, torch.where(alive[:, None], tp * f * scale[:, None], tp)


# Each bounce maps (context, state, keys, depth d: an int, or a device
# scalar in the captured step) to the next state, reading and never
# writing ``st``.

# ---------------------------------------------------------------------------
# BRDF-only estimator (shade_with_brdf, main.cpp:348-399)
# ---------------------------------------------------------------------------

def _bounce_brdf(c: _Ctx, st: dict, key, d) -> dict:
    N = st["ro"].shape[0]
    active, tp = st["active"], st["tp"]
    hit = _trace(c.accel, st["ro"], st["rd"], st["excl"])
    nrays = st["nrays"] + active.sum()
    si = common.gather_interaction(c.scene, hit, st["rd"], c.tri_to_light)
    alive = active & hit.valid & si.front            # backface => 0 (Q9)

    # An emissive hit ends the path with its radiance at any depth
    # (main.cpp:362-366, 392-396).
    emit_now = alive & si.is_light
    L = st["L"] + torch.where(emit_now[:, None], tp * si.emission, 0.0)
    alive = alive & ~si.is_light

    # Russian roulette (main.cpp:375-380), then the BRDF bounce.
    survive, w_rr = common.russian_roulette(rng.bounce_key(key, d, rng.P_RR), N,
                                            c.cfg.rr_prob, c.r0)
    bs, alive, tp = _brdf_step(c.cfg, key, d, si, alive & survive, tp, w_rr, c.r0)
    return dict(active=alive, ro=si.p, rd=bs.wi, excl=hit.tri_id, tp=tp, L=L, nrays=nrays)


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


def _light_pdf_along(scene, cfg, light_accel, tri_to_light, si, wi, wsum, table=None,
                     via_point=False):
    """ref_mis_weights (quirk Q11, main.cpp:484-491): the solid-angle pdf
    with which the light sampler at ``si`` would pick the nearest light
    triangle along ``wi`` (closet_ray_intersect_light_triangle,
    Myobj.cpp:476-622), traced against the lights-only accel with ``si``'s
    triangle excluded (K1 on CUDA tensors); 0 where the ray meets no light.
    The uniform sampler's squared distance is each JAX call site's own:
    |(p + t wi) - p|^2 in the fixed-depth MIS (``via_point``), t^2 in the
    regen loop and the prepass."""
    lh = _trace(light_accel, si.p, wi, si.tri_id)
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


def _sample_light(key, scene, cfg, si, consts=None, table=None, row_offset=0):
    """The configured light sampler: (LightSample, weights_sum or None)."""
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.sample(key, scene, si.p, si.ns, consts=consts, table=table,
                                      row_offset=row_offset)
    return light_uniform.sample(key, scene, si.p.shape[0], row_offset), None


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

def _bounce_split(c: _Ctx, st: dict, key, d) -> dict:
    N = st["ro"].shape[0]
    active, tp = st["active"], st["tp"]
    hit = _trace(c.accel, st["ro"], st["rd"], st["excl"])
    nrays = st["nrays"] + active.sum()
    si = common.gather_interaction(c.scene, hit, st["rd"], c.tri_to_light)
    alive = active & hit.valid & si.front

    # Lights are pure emitters (Q5): they count only when a primary ray
    # hits them; the direct term owns BRDF-sampled light hits
    # (main.cpp:283-288, 338).
    emit_now = alive & si.is_light & (d == 0)
    L = st["L"] + torch.where(emit_now[:, None], tp * si.emission, 0.0)
    alive = alive & ~si.is_light

    # Direct light through the configured sampler (main.cpp:298-314).
    ls, _ = _sample_light(rng.bounce_key(key, d, rng.P_LIGHT_SELECT), c.scene, c.cfg, si,
                          consts=c.consts, table=c.table, row_offset=c.r0)
    nrays = nrays + alive.sum()                      # shadow rays
    L = L + tp * _direct_term(c.scene, c.cfg, c.accel, si, ls, alive)

    # RR gates only the indirect continuation (main.cpp:321-329).
    survive, w_rr = common.russian_roulette(rng.bounce_key(key, d, rng.P_RR), N,
                                            c.cfg.rr_prob, c.r0)
    bs, alive, tp = _brdf_step(c.cfg, key, d, si, alive & survive, tp, w_rr, c.r0)
    return dict(active=alive, ro=si.p, rd=bs.wi, excl=hit.tri_id, tp=tp, L=L, nrays=nrays)


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

def _emit_weight(c: _Ctx, st: dict, si, d) -> torch.Tensor:
    """The weight of an emissive hit: primary rays get the full emission
    (main.cpp:416-421), BRDF-continued ones the balance-heuristic weight
    p_b / (p_b + p_light) of the previous vertex, unless ref_mis_weights
    already put the light pdf into the throughput there. A device-scalar
    ``d`` (the captured bounce) selects with a tensor op."""
    pb = st["prev_pb"]
    ones = torch.ones_like(pb)
    if c.light_accel is not None or (not torch.is_tensor(d) and d == 0):
        return ones
    p_l = _light_pdf_of_hit(c.scene, c.cfg, si, st["prev_p"], st["prev_ns"], st["prev_wsum"],
                            table=c.table)
    w = pb / torch.clamp(pb + p_l, min=1e-20).detach()
    return torch.where(d > 0, w, ones) if torch.is_tensor(d) else w


def _bounce_mis(c: _Ctx, st: dict, key, d) -> dict:
    N = st["ro"].shape[0]
    scene, cfg = c.scene, c.cfg
    active, tp = st["active"], st["tp"]
    hit = _trace(c.accel, st["ro"], st["rd"], st["excl"])
    nrays = st["nrays"] + active.sum()
    si = common.gather_interaction(scene, hit, st["rd"], c.tri_to_light)
    alive = active & hit.valid & si.front            # backface => 0 (main.cpp:410-413)

    is_emit = alive & si.is_light
    w_emit = _emit_weight(c, st, si, d)
    L = st["L"] + torch.where(is_emit[:, None], tp * si.emission * w_emit[:, None], 0.0)
    alive = alive & ~si.is_light

    # RR gates both strategies (main.cpp:429-437).
    survive, w_rr = common.russian_roulette(rng.bounce_key(key, d, rng.P_RR), N,
                                            cfg.rr_prob, c.r0)
    alive = alive & survive
    tp = torch.where(alive[:, None], tp * w_rr, tp)

    # Light strategy: NEE with the MIS weight.
    k_light = rng.bounce_key(key, d, rng.P_LIGHT_SELECT)
    if cfg.light_sampler == LS_SPHERICAL:
        ls, wsum = light_spherical.sample(k_light, scene, si.p, si.ns, consts=c.consts,
                                          table=c.table, row_offset=c.r0)
    else:
        ls = light_uniform.sample(k_light, scene, N, c.r0)
        wsum = torch.zeros(N, device=tp.device)
    nrays = nrays + alive.sum()                      # shadow rays
    L = L + tp * _nee_term(scene, cfg, c.accel, si, ls, wsum, alive)

    # BRDF strategy: sample, weight, continue (main.cpp:471-491); the
    # reference's weighting adds the light pdf along wi (main.cpp:484-491).
    along = None
    if c.light_accel is not None:
        along = lambda wi: _light_pdf_along(  # noqa: E731
            scene, cfg, c.light_accel, c.tri_to_light, si, wi, wsum, table=c.table,
            via_point=True)
    bs, alive, tp = _brdf_step(cfg, key, d, si, alive, tp, row_offset=c.r0, pdf_along=along)
    return dict(active=alive, ro=si.p, rd=bs.wi, excl=hit.tri_id, tp=tp, L=L, nrays=nrays,
                prev_pb=bs.pdf.detach(), prev_p=si.p, prev_ns=si.ns, prev_wsum=wsum)


_BOUNCES = {EST_BRDF: _bounce_brdf, EST_SPLIT: _bounce_split, EST_MIS: _bounce_mis}
