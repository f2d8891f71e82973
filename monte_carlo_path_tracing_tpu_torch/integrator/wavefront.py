"""Wavefront radiance estimators: the fixed-depth, differentiable path.

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/wavefront.py``:
``render_rays`` and the loops of ``_run_brdf``, ``_run_split`` and
``_run_mis``. The reference's three recursive estimators (SURVEY.md
§3.2-3.3) run as a bounded wavefront: all N rays advance one bounce per
step, over at most ``cfg.max_depth`` bounces (JAX's ``fori_loop``), with
termination as masks (miss, backface, emissive stop, Russian roulette)
over [N] tensors. A bounce (:func:`_bounce`) maps a dict of [N] state
tensors to the next: it traces, gathers and hands the vertex to
``integrator/shading.py`` (``shading.vertex``), which holds every
estimator's per-vertex math and the light terms (JAX's bounce bodies,
``_sample_light``, ``_direct_term``, ``_light_pdf_of_hit`` and
``_nee_term``), as it does for the regeneration renderer. The loop stops
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
index is a device scalar). Gradients and the grid run the eager loop,
:func:`run_loop`, which ``diff.inverse.StepRenders`` captures under
autograd with every bounce run.

The occluded-blocker recursion (``mis_blocker_compat``) belongs to the
regeneration renderer. ``estimator="shoot"`` dispatches to
``integrator/legacy_shoot.py``; ``cfg.accel == "grid"`` traces through the
uniform grid (``ops/grid.py``).

Differentiability: the scene context, whose light table carries the
emission's gradient, is built inside each call. K1-K3 run outside
autograd: their inputs (rays, points, normals, the packed light
constants) carry no gradient; the detach sites are ``shading``'s.
"""

from __future__ import annotations

import functools

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import common, shading
from monte_carlo_path_tracing_tpu_torch.integrator import graph as graph_mod
from monte_carlo_path_tracing_tpu_torch.ops import grid as grid_mod
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import (
    EST_BRDF, EST_MIS, EST_SHOOT, EST_SPLIT, RenderConfig,
)
from monte_carlo_path_tracing_tpu_torch.utils.profiling import span


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
    host read, a ``wavefront.sync`` span). Stopping early changes no value
    and no ray count."""
    for d in range(max_depth):
        if d:
            with span("wavefront.sync"):
                live = bool(active().any())
            if not live:
                return
        yield d


def run_loop(ctx: shading.SceneContext, key: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
             row_offset: int = 0, early_exit: bool = True) -> dict:
    """The eager bounce loop of :func:`render_rays` through ``ctx``
    (``shading.scene_context``): the state after its last bounce, whose
    ``L`` is the radiance and ``nrays`` the rays traced. With
    ``early_exit`` False it runs every one of ``cfg.max_depth`` bounces and
    reads nothing on the host, as a capture of the loop under autograd
    (``diff.inverse.StepRenders``) needs; the values are the same."""
    st = _init(ro, rd, ctx.cfg.estimator == EST_MIS)
    depths = (_bounces(ctx.cfg.max_depth, lambda: st["active"]) if early_exit
              else range(ctx.cfg.max_depth))
    for d in depths:
        st = _bounce(ctx, st, key, d, row_offset)
    return st


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
        if cfg.estimator not in (EST_SHOOT, EST_MIS, EST_SPLIT, EST_BRDF):
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
            st = run_loop(shading.scene_context(scene, cfg, self.accel), key, ro, rd,
                          self.row_offset)
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
    ctx = shading.scene_context(scene, cfg, accel)
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
        out = _bounce(ctx, st, st["key"], st["d"], row_offset)
        out["d"] = st["d"] + 1
        for k, v in out.items():
            st[k].copy_(v)

    return state, load, iterate


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


def _bounce(c: shading.SceneContext, st: dict, key, d, row_offset: int) -> dict:
    """One bounce at depth ``d`` (an int, or a device scalar in the captured
    step): trace, gather and :func:`shading.vertex` (JAX's ``body`` of
    ``_run_brdf`` / ``_run_split`` / ``_run_mis``). Maps the state to the
    next, reading and never writing ``st``."""
    active = st["active"]
    hit = ops_intersect.intersect(c.accel, st["ro"], st["rd"], st["excl"])   # K1
    si = common.gather_interaction(c.scene, hit, st["rd"], c.tri_to_light)
    mis = c.cfg.estimator == EST_MIS
    prev = (st["prev_pb"], st["prev_p"], st["prev_ns"], st["prev_wsum"]) if mis else None
    # backface => 0 (Q9, main.cpp:410-413)
    v = shading.vertex(c, si, active & hit.valid & si.front, st["tp"], st["L"],
                       st["nrays"] + active.sum(), rng.fold_in(key, d), d, prev,
                       row_offset=row_offset, via_point=True)
    out = dict(active=v.alive, ro=si.p, rd=v.bs.wi, excl=hit.tri_id, tp=v.tp, L=v.L,
               nrays=v.nrays)
    if mis:
        out.update(prev_pb=v.bs.pdf.detach(), prev_p=si.p, prev_ns=si.ns,
                   prev_wsum=st["prev_wsum"] if v.wsum is None else v.wsum)
    return out
