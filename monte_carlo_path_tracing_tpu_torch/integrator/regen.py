"""Path-regeneration wavefront renderer (forward fast path).

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/regen.py``
(``render_regen``, ``render_regen_cached``, ``primary_prepass``), whose
per-vertex math lives in ``integrator/shading.py``: the loop's bounce is
``shading.vertex``, the prepass's depth-0 stage calls its light terms and
``shading.brdf_step``, and both read one ``shading.SceneContext`` a job.
What stays here is the regeneration itself. Every lane of a fixed-width
wavefront traces one path; when the path ends, its radiance is
scatter-added into the framebuffer and the lane pulls the next (pixel,
spp) sample from a global counter and restarts. Draws follow the
core/rng.py contract exactly — each lane's keys are
fold(fold(fold(fold(base, spp index), global pixel id), depth), purpose) —
so the estimate is a function of the seed alone, invariant to lane count
and launch splitting, and consumes the same streams as the JAX package.

- :func:`render_regen`: the loop. The JAX ``lax.while_loop`` becomes a
  Python loop whose iteration (:func:`regen_loop`) writes a dict of [C]
  tensors in place; on CUDA it is captured once as a CUDA graph and
  replayed (``integrator/graph.py``, what ``jax.jit`` gives JAX's loop).
  It stops when no sample is left and no lane is alive. Per bounce it
  draws through K6 (threefry) and runs K1 (extension rays), K3 (Arvo
  light pick) and K2 (shadow rays) when the scene's tensors are on CUDA,
  their plain versions on the CPU. Lanes restart as camera rays, or, with
  ``seed_mode``, resume at depth 1 from the pre-pass's seeds. With
  ``accel="auto"`` on scenes of ``AUTO_CULL_MIN_TRIS`` triangles or more
  (or ``ray_sort=True``) the lanes are sorted each iteration by
  (direction, origin Morton code), and with auto the loop's traces cull:
  K4 / K5 instead of K1 / K2.
- :func:`primary_prepass`: with jitter off every spp of a pixel re-traces
  one camera ray, so the pre-pass traces each pixel once (K4, culled),
  picks a light for every spp round of it in one K3 launch (the point's
  Arvo weights evaluated once), and runs the depth-0 shading densely for
  all spp rounds (shadow rays through K5), leaving continuation seeds. As in
  JAX, each pixel chunk shades a fixed prefix of its partitioned
  survivors and runs the overflow tail only when they exceed it, so a
  chunk (:class:`PrepassLoop`) is one CUDA graph replay on the card.
- :func:`render_regen_cached`: the pre-pass, then the seeded loop — the
  default route whenever :func:`primary_cache_eligible` holds.
- :class:`RegenJob`: what a job keeps from launch to launch. Each of the
  calls above renders one launch of a job: ``render_image_regen`` passes
  one job to all its launches (``job=``), and the renderer of
  ``parallel.sharded.make_regen_sharded`` one job a rank to all its
  calls, so that the scene context, the state buffers and the captured
  steps are built and captured once and every later launch rewrites the
  state in place (its key too) and replays; any other call is a job of
  one launch.

Estimators: Veach MIS, split and BRDF-only, with either light sampler.
``mis_blocker_compat`` (uncached only) reproduces the reference's full MIS
recursion: the light ray of NEE is a nearest-hit trace, and a non-emissive
occluder it meets becomes a queued continuation path (a blocker chain)
that free lanes pull, last in first out, before new samples. With
``accel="grid"`` the loop runs all pairs, as the JAX loop does.
Forward-only, like the JAX loop.

Spans (``utils.profiling.span``, recorded only under a torch profiler):
``regen.prepass`` and ``regen.loop`` cover a :func:`primary_prepass` and
a :func:`render_regen` call, ``regen.context`` in each the job's first
build of accel, light tables, constants and state buffers, or in a later
launch the copy of its key, the in-place reset of that state and the
launch's scalar writes,
``regen.prepass_tail`` an overflow tail, and ``regen.sync`` each host
read of a device value: the loop's condition, a chunk's overflow
predicate and the counts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import common, shading
from monte_carlo_path_tracing_tpu_torch.integrator import graph as graph_mod
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import (
    camera_basis, pixel_len, primary_dirs,
)
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import (
    EST_BRDF, EST_MIS, EST_SPLIT, LS_SPHERICAL, RenderConfig,
)
from monte_carlo_path_tracing_tpu_torch.utils.profiling import span


#: Fold level reserved for blocker-chain streams: real streams fold (spp
#: index, pixel) directly off the base key and never this tag, so chain
#: streams are disjoint from every launch's real streams (the JAX value).
_CHAIN_TAG = 0x5EED_CA1


class RegenStats(NamedTuple):
    """Scalar diagnostics of one regen launch. ``spilled`` (chains dropped
    on queue overflow) and ``chains`` (chains enqueued) belong to the
    blocker-chain queue (``mis_blocker_compat``; 0 otherwise);
    ``rays_physical`` (set by :func:`render_regen_cached`: the primary ray
    counted once per pixel) 0 means "same as the logical count"."""

    spilled: int = 0
    chains: int = 0
    rays_physical: int = 0


class SeedMode(NamedTuple):
    """What the seeded loop resumes from (JAX's ``seed_mode`` 5-tuple of
    1-D arrays, as [..., 3] rows here): the pre-pass's continuation seeds,
    in sample order, and its per-pixel cache."""

    sample: torch.Tensor      # [S] int64 sample id (round * n_pix + local pixel)
    wi: torch.Tensor          # [S, 3] depth-0 BRDF direction
    tp: torch.Tensor          # [S, 3] throughput after depth 0
    pdf: torch.Tensor         # [S] BRDF pdf of wi (the next vertex's MIS weight)
    cache_p: torch.Tensor     # [n_pix, 3] primary hit point
    cache_ns: torch.Tensor    # [n_pix, 3] its shading normal
    cache_wsum: torch.Tensor  # [n_pix] its Arvo weights_sum
    cache_tri: torch.Tensor   # [n_pix] int32 primary hit triangle (-1: none)
    fb_pre: torch.Tensor      # [n_pix, 3] depth-0 radiance summed over rounds


def primary_cache_eligible(cfg: RenderConfig) -> bool:
    """Configurations whose depth-0 work is per-pixel deterministic (no
    jitter, no blocker compat; estimator mis, brdf or split)."""
    return (
        not cfg.pixel_jitter
        and not cfg.mis_blocker_compat
        and cfg.estimator in (EST_MIS, EST_BRDF, EST_SPLIT)
    )


def _check_supported(cfg: RenderConfig) -> None:
    """Raise for the options the loop does not run: ``ray_sort_every > 1``
    (not ported, by decision) and the shoot estimator (as JAX's loop)."""
    if cfg.ray_sort_every > 1:
        raise NotImplementedError(
            'ray_sort_every > 1 is not ported (ROADMAP queue 1, "Do not port"): '
            "the lanes are sorted every iteration")
    if cfg.estimator not in (EST_MIS, EST_BRDF, EST_SPLIT):
        raise ValueError(f"render_regen does not run estimator {cfg.estimator!r}")


def _nee_full(ctx: shading.SceneContext, si, ls, alive):
    """The reference's MIS light strategy with occluder shading
    (main.cpp:450-464): the light ray's nearest hit (K1 on CUDA tensors,
    never culled) is shaded whatever it is. An emissive front hit adds its
    radiance inline (the common case, equal to NEE); a non-emissive front
    hit becomes a blocker chain, traced as a continuation path through the
    queue. Returns (contrib [N,3], spawn [N], wl [N,3], w_chain [N,3] =
    f cos / (p_light + p_brdf), the denominator detached)."""
    wl, _, dist2, cos_x, cos_l = shading.shadow_ray(si, ls)
    ok = alive & ls.valid & (cos_x > 0.0)
    lh = ops_intersect.intersect(ctx.accel, si.p, wl, si.tri_id)
    si2 = common.gather_interaction(ctx.scene, lh, wl, ctx.tri_to_light)
    if ctx.cfg.light_sampler == LS_SPHERICAL:
        p_light = ls.pdf
    else:
        p_light = common.area_pdf_to_solid_angle(ls.pdf, dist2, cos_l)
    f, p_b = phong.eval_and_pdf_brdf(si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp)
    w_chain = f * (cos_x / torch.clamp(p_light + p_b, min=1e-20).detach())[:, None]
    front = ok & lh.valid & si2.front
    contrib = torch.where((front & si2.is_light)[:, None], w_chain * si2.emission,
                          torch.zeros_like(w_chain))
    return contrib, front & ~si2.is_light, wl, w_chain


def chain_key(base_key: torch.Tensor, spp0: int = 0) -> torch.Tensor:
    """The root of a launch's blocker-chain streams:
    fold(fold(base, _CHAIN_TAG), spp0)."""
    return rng.fold_in(rng.fold_in(base_key, _CHAIN_TAG), spp0)


def lane_keys(base_key, sample, pixel, n_pix: int, spp0=0, pixel_stride: int = 1,
              pixel_offset: int = 0, chain_base=None) -> torch.Tensor:
    """[C, 2] stream keys of the (sample, local pixel) each lane traces:
    fold(fold(base, spp0 + sample // n_pix), global pixel id), ``spp0`` an
    int or a 0-dim int64 tensor on the lanes' device. With
    ``chain_base`` (:func:`chain_key`; blocker mode), a negative sample is
    chain -1 - sample and takes fold(chain_base, -1 - sample); the
    division then uses 0 for it, as JAX's ``where(is_chain, 0, sample)``
    does."""
    real = sample if chain_base is None else torch.clamp(sample, min=0)
    k = rng.fold_in(base_key, spp0 + torch.div(real, n_pix, rounding_mode="floor"))
    k = rng.fold_in(k, pixel * pixel_stride + pixel_offset)
    if chain_base is None:
        return k
    return torch.where((sample < 0)[:, None], rng.fold_in(chain_base, -1 - sample), k)


#: Per-lane tensors of the loop state: what the lane sort permutes (JAX
#: ``_LANE_ARRAYS``).
LANE_ARRAYS = ("alive", "pixel", "sample", "depth", "ro", "rd", "excl", "tp", "L",
               "prev_pb", "prev_p", "prev_ns", "prev_w")


def _spread5(x: torch.Tensor) -> torch.Tensor:  # 5 bits -> every 3rd bit of 15
    x = (x | (x << 8)) & 0x0100F
    x = (x | (x << 4)) & 0x010C3
    x = (x | (x << 2)) & 0x09249
    return x


def scene_bounds(accel) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo [3], 1 / extent [3]) of the accel's finite triangle AABBs (the
    padding rows' +-inf sentinels masked out): the frame of the lane sort's
    origin key."""
    inf = float("inf")
    lo = torch.where(torch.isfinite(accel.aabb_lo), accel.aabb_lo, inf).amin(dim=0)
    hi = torch.where(torch.isfinite(accel.aabb_hi), accel.aabb_hi, -inf).amax(dim=0)
    return lo, 1.0 / torch.clamp(hi - lo, min=1e-20)


def lane_sort_key(ro, rd, alive, scene_lo, scene_inv) -> torch.Tensor:
    """[C] int32 sort key of each lane (JAX ``sort_lanes``): 3 bits a
    direction axis above a 15-bit Morton code of the origin over the scene's
    bounds; dead lanes (1 << 24) - 1, so they sort to the back. Values are
    clamped in f32 before the integer conversion, which for in-range values
    truncates as XLA's does and keeps out-of-range origins defined."""
    q = torch.clamp((ro - scene_lo) * scene_inv * 31.0, 0.0, 31.0).to(torch.int32)
    morton = _spread5(q[:, 0]) | (_spread5(q[:, 1]) << 1) | (_spread5(q[:, 2]) << 2)
    dq = torch.clamp((rd * 0.5 + 0.5) * 7.0, 0.0, 7.0).to(torch.int32)
    dkey = (dq[:, 0] << 6) | (dq[:, 1] << 3) | dq[:, 2]
    return torch.where(alive, (dkey << 15) | morton, (1 << 24) - 1)


def sort_lanes(st: dict, scene_lo, scene_inv) -> dict:
    """The loop state with its lanes stably sorted by :func:`lane_sort_key`,
    so that each ray tile of the culled kernels is coherent in origin and
    direction. A pure permutation: every draw is keyed by the lane's
    (sample, pixel, depth), so values and ray counts do not change."""
    order = torch.argsort(lane_sort_key(st["ro"], st["rd"], st["alive"], scene_lo, scene_inv),
                          stable=True)
    return {k: v[order] if k in LANE_ARRAYS else v for k, v in st.items()}


def _prefix_rows(S: int, cfg: RenderConfig) -> int:
    """The fixed survivor prefix P of a prepass chunk's S samples (JAX
    regen.py:390-391): every sample for split (no RR gate before its direct
    term), else rr_prob + 2.5% of S rounded up to 256 rows, which the
    Binomial(S, rr_prob) survivors essentially never exceed; the overflow
    tail keeps the prepass exact when they do."""
    if cfg.estimator == EST_SPLIT:
        return S
    return min(S, -(-int(S * min(1.0, cfg.rr_prob + 0.025)) // 256) * 256)


class PrepassLoop:
    """The chunk loop of :func:`primary_prepass` (same arguments), JAX's
    ``fori_loop`` over pixel chunks (regen.py:624-630 of the JAX package):

    - ``state``: the outputs being filled (``fb_pre``, ``cache_*``,
      ``seeds_*``, ``count``, ``n_shadow``), the chunk index ``c``, the
      chunk's survivor count ``n_live`` and the launch's values that a
      chunk reads (``rounds``, its spp rounds, and ``k_r``, the [spp_cap,
      2] keys of rounds spp0, spp0 + 1, ...), each its own device buffer;
    - :meth:`reset`: rewrite ``state`` in place for a launch of
      ``spp_rounds`` rounds from ``spp0`` (the constructor's values);
    - :meth:`chunk`: chunk ``c`` of JAX's body: trace, prepare and draw,
      stably partition the survivors to the front, shade the fixed prefix
      ``order[:P]`` (its dead rows masked), write the chunk's rows and
      advance ``c``. No host read: it writes ``state`` in place and leaves
      its intermediates (``last``, which :meth:`tail` reads) where a CUDA
      graph replay rewrites them, so that it can be captured and replayed;
    - :meth:`over`: JAX's ``lax.cond`` predicate ``n_live > P``, one host
      read of the chunk just run;
    - :meth:`tail`: shade that chunk's overflow ``order[P:]`` and rewrite
      its radiance rows, eagerly: the sums and seeds of an unsplit pass;
    - :meth:`result`: :func:`primary_prepass`'s return value, with one
      host read of (count, n_shadow); its seeds are views of ``state``.

    ``ctx``: the job's ``shading.SceneContext`` (None: built here)."""

    def __init__(self, scene: Scene, cfg: RenderConfig, base_key: torch.Tensor, n_pix: int,
                 spp_cap: int, spp_rounds: int, pixel_offset: int = 0, pixel_stride: int = 1,
                 spp0: int = 0, pix_chunk: int = 1 << 15,
                 ctx: shading.SceneContext | None = None):
        _check_supported(cfg)
        self.scene, self.cfg = scene, cfg
        self.n_pix, self.pixel_stride, self.pixel_offset = n_pix, pixel_stride, pixel_offset
        dev = scene.device
        self.base_key = base_key.to(dev)
        self.ctx = shading.scene_context(scene, cfg) if ctx is None else ctx
        self.spherical = cfg.light_sampler == LS_SPHERICAL
        self.is_mis = cfg.estimator == EST_MIS
        self.is_split = cfg.estimator == EST_SPLIT
        self.picks = (self.is_mis or self.is_split) and self.spherical
        u_ax, v_ax, n_ax, dist = camera_basis(scene.camera)
        self.camera = (scene.camera, u_ax, v_ax, n_ax, dist, pixel_len(scene.camera, dist))

        # The flattened batch of a chunk is chunk * spp_cap samples: ~256k
        # rows whatever the spp (the JAX formula, so seed order and sums
        # follow it). Every chunk has this shape: the last one's rows past
        # n_pix are masked.
        R = spp_cap
        self.pix_chunk = min(pix_chunk, n_pix, max(4096, (1 << 18) // max(spp_cap, 1)))
        self.n_chunks = -(-n_pix // self.pix_chunk)
        self.S = R * self.pix_chunk
        self.P = _prefix_rows(self.S, cfg)
        self.total = n_pix * spp_cap
        self.w_rr = 1.0 / cfg.rr_prob
        f32 = dict(device=dev, dtype=torch.float32)
        i64 = dict(device=dev, dtype=torch.int64)
        npad = self.n_chunks * self.pix_chunk
        total = self.total
        self.state = {
            "fb_pre": torch.zeros((npad, 3), **f32),
            "cache_p": torch.zeros((npad, 3), **f32),
            "cache_ns": torch.zeros((npad, 3), **f32),
            "cache_wsum": torch.zeros(npad, **f32),
            "cache_tri": torch.full((npad,), ops_intersect.NO_HIT, dtype=torch.int32,
                                    device=dev),
            # Seed records; row ``total`` is the sink of masked writes.
            "seeds_sample": torch.zeros(total + 1, **i64),
            "seeds_wi": torch.zeros((total + 1, 3), **f32),
            "seeds_tp": torch.zeros((total + 1, 3), **f32),
            "seeds_pdf": torch.zeros(total + 1, **f32),
            "count": torch.zeros((), **i64),
            "n_shadow": torch.zeros((), **i64),
            "c": torch.zeros((), **i64),
            "n_live": torch.zeros((), **i64),
            "rounds": torch.zeros((), **i64),
            "k_r": torch.zeros((R, 2), **i64),
        }
        st = self.state
        self.seeds = SeedMode(
            sample=st["seeds_sample"], wi=st["seeds_wi"], tp=st["seeds_tp"],
            pdf=st["seeds_pdf"], cache_p=st["cache_p"][:n_pix], cache_ns=st["cache_ns"][:n_pix],
            cache_wsum=st["cache_wsum"][:n_pix], cache_tri=st["cache_tri"][:n_pix],
            fb_pre=st["fb_pre"][:n_pix],
        )
        self.r_ids = torch.arange(R, device=dev)[:, None]
        self.lane = torch.arange(self.pix_chunk, device=dev)
        self.last: dict = {}
        self.reset(spp0, spp_rounds)

    def reset(self, spp0: int, spp_rounds: int) -> None:
        """A launch's start: the counts and the chunk index zeroed, its
        rounds (clamped to spp_cap) and round keys written, the latter from
        the key as it is now (a job's key buffer, which each launch
        rewrites). Every other
        buffer is written before it is read: ``fb_pre`` and the cache row
        by row by the chunks, the seeds up to the count."""
        st = self.state
        self.spp_rounds = min(int(spp_rounds), self.r_ids.shape[0])   # the host's copy
        for k in ("count", "n_shadow", "c", "n_live"):
            st[k].zero_()
        st["rounds"].fill_(self.spp_rounds)
        st["k_r"].copy_(rng.fold_in(self.base_key, spp0 + self.r_ids[:, 0]))

    def chunk(self) -> None:
        scene, cfg, st, chunk, S = self.scene, self.cfg, self.state, self.pix_chunk, self.S
        ctx = self.ctx
        pix_local = st["c"] * chunk + self.lane
        gpix = pix_local * self.pixel_stride + self.pixel_offset
        ro, rd = primary_dirs(*self.camera, gpix)
        hit = ops_intersect.intersect(ctx.accel, ro, rd, cull=True)
        si = common.gather_interaction(scene, hit, rd, ctx.tri_to_light)
        hitok = (pix_local < self.n_pix) & hit.valid & si.front
        # Depth-0 emission: tp = 1 and weight 1 for every estimator, the
        # same for every sample of the pixel.
        em_add = torch.where((hitok & si.is_light)[:, None],
                             si.emission * st["rounds"].to(si.emission.dtype),
                             torch.zeros_like(si.emission))
        shade0 = hitok & ~si.is_light
        ck = {"pix_local": pix_local, "si": si, "em_add": em_add, "lidx": None}

        # All rounds of the chunk as one [S] batch, row-major (round, pixel).
        lk0 = rng.fold_in(rng.fold_in(st["k_r"][:, None, :], gpix[None, :]).reshape(S, 2), 0)
        survive, _ = common.russian_roulette(rng.fold_in(lk0, rng.P_RR), S, cfg.rr_prob)
        if self.picks:
            # rng.pick_weighted's draw for every round, all picked against
            # the pixel's one cdf: K3 with a row of uniforms a round, so no
            # [chunk, L] field is made (the plain version on the CPU).
            u_d = rng.uniform(rng.fold_in(rng.fold_in(lk0, rng.P_LIGHT_SELECT), 0), (S,))
            lidx, ck["wsum"] = arvo_cuda.arvo_select(ctx.consts, si.p.contiguous(),
                                                     si.ns.contiguous(), u_d.view(-1, chunk))
            ck["lidx"] = lidx.reshape(S)
        else:
            ck["wsum"] = torch.zeros(chunk, device=scene.device)
        hit_live = (shade0[None, :] & (self.r_ids < st["rounds"])).reshape(S)
        # mis: RR gates both strategies; brdf: the continuation; split: only
        # the continuation (its direct term runs for every hit sample).
        part = hit_live if self.is_split else hit_live & survive
        # Stable partition: survivors first in sample order, so seed order
        # is the unpartitioned order's.
        ck.update(lk0=lk0, survive=survive, part=part,
                  order=torch.argsort((~part).to(torch.int32), stable=True),
                  sample=(self.r_ids * self.n_pix + pix_local[None, :]).reshape(S),
                  fb_acc=torch.zeros((chunk, 3), device=scene.device))
        self.last = ck
        st["n_live"].copy_(part.sum())
        self._stage(ck["order"][:self.P])      # a 0-round launch has no live row
        st["fb_pre"].index_copy_(0, pix_local, em_add + ck["fb_acc"])
        st["cache_p"].index_copy_(0, pix_local, si.p)
        st["cache_ns"].index_copy_(0, pix_local, si.ns)
        st["cache_wsum"].index_copy_(0, pix_local, ck["wsum"])
        st["cache_tri"].index_copy_(0, pix_local, hit.tri_id)
        st["c"].add_(1)

    def over(self) -> bool:
        if self.P >= self.S:
            return False
        with span("regen.sync"):
            return bool(self.state["n_live"] > self.P)

    def tail(self) -> None:
        ck = self.last
        self._stage(ck["order"][self.P:])
        self.state["fb_pre"].index_copy_(0, ck["pix_local"], ck["em_add"] + ck["fb_acc"])

    def _stage(self, rows: torch.Tensor) -> None:
        """Depth-0 shading of the samples at flat rows ``rows`` of the last
        chunk: NEE or direct light with culled shadow rays (K5 on CUDA)
        added into its ``fb_acc``, then the BRDF sample that becomes a seed
        (``shading.brdf_step``; with ``ref_mis_weights``, its weight's
        denominator adds the light pdf along it: K1 on the lights-only
        accel). Rows outside the partition add nothing, count no ray and
        write their seed to the sink row."""
        scene, cfg, st, ck, ctx = self.scene, self.cfg, self.state, self.last, self.ctx
        live = ck["part"][rows]
        pix = rows % self.pix_chunk
        si = ck["si"]
        si_c = common.SurfaceInteraction(
            **{f.name: getattr(si, f.name)[pix] for f in dataclasses.fields(si)})
        wsum_c = ck["wsum"][pix]
        lk0_c = ck["lk0"][rows]
        if self.is_mis or self.is_split:
            st["n_shadow"].add_(live.sum())
            kstep = rng.fold_in(lk0_c, rng.P_LIGHT_SELECT)
            if self.spherical:
                ls = light_spherical.sample_from_pick(
                    rng.fold_in(kstep, 1), scene, si_c.p, si_c.ns, ck["lidx"][rows], wsum_c,
                    table=ctx.table)
            else:
                ls = light_uniform.sample(kstep, scene, rows.shape[0])
            if self.is_split:
                ck["fb_acc"].index_add_(0, pix, shading.direct_term(scene, cfg, ctx.accel, si_c,
                                                                    ls, live, cull=True))
                live = live & ck["survive"][rows]
            else:
                nee = shading.nee_term(scene, cfg, ctx.accel, si_c, ls, wsum_c, live, cull=True)
                ck["fb_acc"].index_add_(0, pix, self.w_rr * nee)

        bs, cont, tp_next = shading.brdf_step(ctx, lk0_c, si_c, live, w_rr=self.w_rr,
                                              wsum=wsum_c)
        count = st["count"]
        slot = torch.where(cont, count + torch.cumsum(cont.to(torch.int64), 0) - 1, self.total)
        st["seeds_sample"][slot] = ck["sample"][rows]
        st["seeds_wi"][slot] = bs.wi
        st["seeds_tp"][slot] = tp_next
        st["seeds_pdf"][slot] = bs.pdf
        count.add_(cont.sum())

    def result(self):
        st, n_pix = self.state, self.n_pix
        with span("regen.sync"):
            count, n_shadow = torch.stack([st["count"], st["n_shadow"]]).tolist()
        return self.seeds, count, self.spp_rounds * n_pix + n_shadow, n_pix + n_shadow


def primary_prepass(
    scene: Scene,
    cfg: RenderConfig,
    base_key: torch.Tensor,
    n_pix: int,
    spp_cap: int,
    spp_rounds: int,
    pixel_offset: int = 0,
    pixel_stride: int = 1,
    spp0: int = 0,
    pix_chunk: int = 1 << 15,
    graph: bool | None = None,
    job: RegenJob | None = None,
):
    """Per-pixel primary hit and dense depth-0 shading for ``spp_rounds``
    rounds (clamped to ``spp_cap``, which sizes the seed buffer), pixel
    chunk by pixel chunk (:class:`PrepassLoop`):

    1. trace each pixel's camera ray once, culled (K4 on CUDA);
    2. Arvo ``prepare`` and its CDF once per pixel (mis/split, spherical);
    3. draw RR and the light pick densely over (round, pixel) — the same
       fold(fold(fold(base, spp0 + round), pixel), 0) streams and purposes
       as the uncached loop's depth 0;
    4. stably partition the survivors to the front (seed order is sample
       order), and shade JAX's fixed prefix of P rows, dead rows masked:
       NEE or direct light with culled shadow rays (K5 on CUDA), then the
       BRDF sample that becomes a seed; survivors past P (the overflow
       tail, which JAX runs under ``lax.cond``) are shaded after the
       chunk when the host read of ``n_live > P`` says so.

    ``graph`` as in :func:`render_regen`: on CUDA tensors (``None``) the
    job's first chunk runs eagerly, its second is captured as a CUDA graph,
    and every later chunk of every launch is one replay and the one
    predicate read; ``False`` runs every chunk eagerly; ``True`` on CPU
    tensors raises. ``job`` (:class:`RegenJob`) as in :func:`render_regen`.

    Returns (seed_mode, seed_count, nrays_logical, nrays_physical):
    logical rays count the primary once per sample (comparable with the
    uncached loop), physical ones once per pixel. The seeds are the job's
    buffers, which its next launch overwrites."""
    job = RegenJob() if job is None else job
    with span("regen.prepass"):
        with span("regen.context"):
            key = job.key(base_key, scene.device)
            loop = job.part(
                "prepass",
                (id(scene), cfg, n_pix, spp_cap, pixel_offset, pixel_stride, pix_chunk),
                lambda: PrepassLoop(scene, cfg, key, n_pix, spp_cap, spp_rounds,
                                    pixel_offset=pixel_offset, pixel_stride=pixel_stride,
                                    spp0=spp0, pix_chunk=pix_chunk,
                                    ctx=job.context(scene, cfg)))
            loop.reset(spp0, spp_rounds)
        step = job.step("prepass", loop.chunk, graph, scene.device)
        for _ in range(loop.n_chunks):
            step()
            if loop.over():
                with span("regen.prepass_tail"):
                    loop.tail()
        return loop.result()


def render_regen_cached(
    scene: Scene,
    cfg: RenderConfig,
    base_key: torch.Tensor,
    n_pix: int,
    spp_cap: int,
    spp_rounds: int,
    lanes: int = 1 << 16,
    pixel_offset: int = 0,
    pixel_stride: int = 1,
    spp0: int = 0,
    graph: bool | None = None,
    job: RegenJob | None = None,
):
    """Primary-cache render: :func:`primary_prepass`, then the loop over
    its seeds (depth >= 1 only; ``graph`` and ``job`` as in
    :func:`render_regen`, for the prepass's chunks and the loop's
    iterations, which share the job's scene context). The
    same estimate and streams as :func:`render_regen` over ``n_pix *
    spp_rounds`` samples; returns the same (fb, nrays, iters, stats) with
    logical rays, the physical count in ``stats.rays_physical``."""
    job = RegenJob() if job is None else job
    seeds, seed_count, n_log, n_phys = primary_prepass(
        scene, cfg, base_key, n_pix, spp_cap, spp_rounds,
        pixel_offset=pixel_offset, pixel_stride=pixel_stride, spp0=spp0, graph=graph, job=job,
    )
    fb, nrays_loop, iters, stats = render_regen(
        scene, cfg, base_key, n_pix, seed_count, lanes=lanes, pixel_offset=pixel_offset,
        pixel_stride=pixel_stride, spp0=spp0, seed_mode=seeds, graph=graph, job=job,
    )
    with span("regen.sync"):
        stats = stats._replace(rays_physical=n_phys + int(nrays_loop))
    return fb, n_log + nrays_loop, iters, stats


def regen_loop(
    scene: Scene,
    cfg: RenderConfig,
    base_key: torch.Tensor,
    n_pix: int,
    total_samples: int,
    lanes: int = 1 << 16,
    pixel_offset: int = 0,
    pixel_stride: int = 1,
    spp0: int = 0,
    seed_mode: SeedMode | None = None,
):
    """The loop of :func:`render_regen` (same arguments) as (state, iterate,
    more):

    - ``state``: a dict of tensors, the lanes (``LANE_ARRAYS``), the
      blocker queue (``buf_*``, ``buf_count``, ``chain_counter``,
      ``spilled``) when it runs, ``counter`` (samples pulled), ``nrays``
      (logical rays) and ``fb`` [n_pix + lanes, 3] (rows past n_pix: the
      live lanes' dummy rows);
    - ``iterate(state)``: one iteration, which reads ``state`` and writes
      every tensor of it in place and touches nothing else, so that it can
      be captured as a CUDA graph and replayed (``integrator/graph.py``);
    - ``more(state)``: the loop's condition (a sample left, a lane alive or
      a chain queued), one host read.

    The launch's own values are device scalars of ``state`` that
    ``iterate`` reads: ``spp0``, ``total`` (``total_samples``) and, with
    the blocker queue, ``chain_base`` (:func:`chain_key`). ``base_key``
    (on the scene's device) is read in place, by ``iterate`` and by the
    reset: a job builds the loop on its key buffer (:meth:`RegenJob.key`)."""
    state, iterate, more, reset = _loop(scene, cfg, base_key, n_pix, lanes, pixel_offset,
                                        pixel_stride, seed_mode,
                                        shading.scene_context(scene, cfg))
    reset(spp0, total_samples)
    return state, iterate, more


def _loop(scene: Scene, cfg: RenderConfig, base_key: torch.Tensor, n_pix: int, lanes: int,
          pixel_offset: int, pixel_stride: int, seed_mode: SeedMode | None,
          ctx: shading.SceneContext):
    """:func:`regen_loop`'s (state, iterate, more) before a launch, and
    ``reset(spp0, total_samples)``, which rewrites ``state`` in place to
    that launch's start: every buffer to its first value (``fb`` to the
    seeds' ``fb_pre``) and the launch's scalars."""
    _check_supported(cfg)
    blocker = bool(cfg.mis_blocker_compat) and cfg.estimator == EST_MIS
    if blocker and seed_mode is not None:
        raise ValueError("the primary-hit cache excludes mis_blocker_compat")
    dev = scene.device
    base_key = base_key.to(dev)
    accel, tri_to_light = ctx.accel, ctx.tri_to_light
    # accel="auto": in-loop culling and the lane sort from the triangle
    # count (JAX regen.py:717-722); an explicit ray_sort sorts either way.
    loop_cull, do_sort = False, cfg.ray_sort
    if cfg.accel == "auto":
        policy = ops_intersect.auto_policy(scene.num_tris)
        loop_cull, do_sort = policy["cull"], do_sort or policy["ray_sort"]
    if do_sort:
        scene_lo, scene_inv = scene_bounds(accel)
    cam = scene.camera
    u_ax, v_ax, n_ax, dist = camera_basis(cam)
    plen = pixel_len(cam, dist)
    C = int(lanes)
    lane_ids = torch.arange(C, dtype=torch.int64, device=dev)

    def lane_stream(st, sample, pixel):
        return lane_keys(base_key, sample, pixel, n_pix, st["spp0"], pixel_stride, pixel_offset,
                         st["chain_base"] if blocker else None)

    def primary_rays(st, sample, pixel):
        """Camera rays of (sample, local pixel); the jitter draw, when on,
        comes from the sample's stream at depth 0."""
        jitter = None
        if cfg.pixel_jitter:
            lk = lane_stream(st, sample, pixel)
            jitter = rng.uniform(rng.bounce_key(lk, 0, rng.P_PIXEL_JITTER), (C, 2), -0.5, 0.5)
        return primary_dirs(cam, u_ax, v_ax, n_ax, dist, plen,
                            pixel * pixel_stride + pixel_offset, jitter)

    def pull(st, new_sample):
        """(pixel, sample, depth, ro, rd, ns, excl, tp, pdf, wsum) of the
        samples lanes pull: camera rays at depth 0, or seeds at depth 1."""
        if seed_mode is None:
            pixel = new_sample % n_pix
            ro, rd = primary_rays(st, new_sample, pixel)
            return (pixel, new_sample, 0, ro, rd, rd, ops_intersect.NO_HIT, 1.0, 1.0, 0.0)
        sidx = torch.clamp(new_sample, 0, seed_mode.sample.shape[0] - 1)
        sample = seed_mode.sample[sidx]
        pixel = sample % n_pix
        return (pixel, sample, 1, seed_mode.cache_p[pixel], seed_mode.wi[sidx],
                seed_mode.cache_ns[pixel], seed_mode.cache_tri[pixel], seed_mode.tp[sidx],
                seed_mode.pdf[sidx], seed_mode.cache_wsum[pixel])

    # name: (shape, dtype, value at a launch's start). Every entry its own
    # buffer: iterate() writes them in place.
    i64, f32, i32, no_hit = torch.int64, torch.float32, torch.int32, ops_intersect.NO_HIT
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    fills = {
        "alive": ((C,), torch.bool, False),
        "pixel": ((C,), i64, 0), "sample": ((C,), i64, 0), "depth": ((C,), i64, 0),
        "ro": ((C, 3), f32, 0.0), "rd": ((C, 3), f32, up), "excl": ((C,), i32, no_hit),
        "tp": ((C, 3), f32, 1.0), "L": ((C, 3), f32, 0.0),
        "prev_pb": ((C,), f32, 1.0), "prev_p": ((C, 3), f32, 0.0),
        "prev_ns": ((C, 3), f32, up), "prev_w": ((C,), f32, 0.0),
    }
    if blocker:
        # The chain queue: C + 1 rows, row C the sink of spilled writes.
        fills.update({
            "buf_ro": ((C + 1, 3), f32, 0.0), "buf_rd": ((C + 1, 3), f32, 0.0),
            "buf_tp": ((C + 1, 3), f32, 0.0), "buf_pixel": ((C + 1,), i64, 0),
            "buf_excl": ((C + 1,), i32, no_hit), "buf_sample": ((C + 1,), i64, 0),
            "buf_depth": ((C + 1,), i64, 0), "buf_count": ((), i64, 0),
            "chain_counter": ((), i64, 0), "spilled": ((), i64, 0),
        })
    # Dead lanes write their pixel row, live lanes their own dummy row
    # n_pix + lane, which is dropped at the end.
    fills.update(counter=((), i64, 0), nrays=((), i64, 0), fb=((n_pix + C, 3), f32, 0.0))
    state = {k: torch.empty(shape, dtype=dt, device=dev) for k, (shape, dt, _) in fills.items()}
    # The launch's own values, read by the (captured) iteration.
    state.update(spp0=torch.zeros((), dtype=i64, device=dev),
                 total=torch.zeros((), dtype=i64, device=dev))
    if blocker:
        state["chain_base"] = torch.zeros(2, dtype=i64, device=dev)
    zero = torch.zeros(C, device=dev)

    def reset(spp0: int, total_samples: int) -> None:
        for k, (_, _, v) in fills.items():
            if torch.is_tensor(v):
                state[k].copy_(v)
            else:
                state[k].fill_(v)
        if seed_mode is not None:
            state["fb"][:n_pix].copy_(seed_mode.fb_pre)
        state["spp0"].fill_(spp0)
        state["total"].fill_(total_samples)
        if blocker:
            state["chain_base"].copy_(chain_key(base_key, spp0))

    def more(st) -> bool:
        with span("regen.sync"):
            m = (st["counter"] < st["total"]) | st["alive"].any()
            return bool(m | (st["buf_count"] > 0)) if blocker else bool(m)

    def iterate(state) -> None:
        st = sort_lanes(state, scene_lo, scene_inv) if do_sort else state
        alive, depth = st["alive"], st["depth"]
        counter, fb = st["counter"], st["fb"]
        lk_d = rng.fold_in(lane_stream(st, st["sample"], st["pixel"]), depth)

        # ---- one bounce for live lanes (shading.vertex) ----
        hit = ops_intersect.intersect(accel, st["ro"], st["rd"], st["excl"], cull=loop_cull)
        si = common.gather_interaction(scene, hit, st["rd"], tri_to_light)
        chain = {}

        def nee_blocker(si, ls, alive, tp):   # MIS's light strategy with the blocker queue
            contrib, chain["spawn"], chain["rd"], w_chain = _nee_full(ctx, si, ls, alive)
            chain["tp"] = tp * w_chain
            return tp * contrib

        v = shading.vertex(ctx, si, alive & hit.valid & si.front, st["tp"], st["L"], alive.sum(),
                           lk_d, depth, (st["prev_pb"], st["prev_p"], st["prev_ns"], st["prev_w"]),
                           cull=loop_cull, nee=nee_blocker if blocker else None)
        cont, tp, L, bs = v.alive, v.tp, v.L, v.bs
        wsum = zero if v.wsum is None else v.wsum

        # ---- scatter finished paths & regenerate ----
        died = alive & ~cont
        tgt = torch.where(died, st["pixel"], n_pix + lane_ids)
        fb.index_add_(0, tgt, torch.where(died[:, None], L, torch.zeros_like(L)))

        free = died | ~alive
        out = {}
        if blocker:
            # Enqueue this bounce's chains, ranked by the cumulative count
            # of spawning lanes; those past the capacity C go to the sink.
            spawn = chain["spawn"]
            rank_s = torch.cumsum(spawn.to(torch.int64), 0) - 1
            slot = st["buf_count"] + rank_s
            can = spawn & (slot < C)
            idx_w = torch.where(can, slot, C)
            for k, x in (("ro", si.p), ("rd", chain["rd"]), ("tp", chain["tp"]),
                         ("pixel", st["pixel"]), ("excl", si.tri_id),
                         ("sample", -1 - (st["chain_counter"] + rank_s)), ("depth", depth + 1)):
                st["buf_" + k][idx_w] = x
            n_spawn = can.sum()
            buf_count = st["buf_count"] + n_spawn
            out["chain_counter"] = st["chain_counter"] + n_spawn
            out["spilled"] = st["spilled"] + (spawn & ~can).sum()

        rank = torch.cumsum(free.to(torch.int64), 0) - 1
        if blocker:
            # Dequeue: free lanes pull queued chains (LIFO) first, from the
            # buffers after this iteration's enqueue.
            take_chain = free & (rank < buf_count)
            src = torch.clamp(buf_count - 1 - rank, 0, C)
            rank = rank - buf_count
            out["buf_count"] = buf_count - take_chain.sum()
        take = free & (rank < st["total"] - counter)
        if blocker:
            take = take & ~take_chain
        pixel_new, sample_new, depth_new, ro_new, rd_new, ns_new, excl_new, tp_new, pb_new, \
            wsum_new = pull(st, counter + rank)

        def sel(new, queued, cur):
            """take -> new sample, take_chain -> queued chain, else cur."""
            tk = take if cur.dim() == 1 else take[:, None]
            if blocker:
                tc = take_chain if cur.dim() == 1 else take_chain[:, None]
                cur = torch.where(tc, st["buf_" + queued][src], cur)
            return torch.where(tk, new, cur)

        t1 = take[:, None]
        restart = take if not blocker else take | take_chain
        out.update({
            "alive": cont | restart,
            "pixel": sel(pixel_new, "pixel", st["pixel"]),
            "sample": sel(sample_new, "sample", st["sample"]),
            "depth": sel(depth_new, "depth", depth + 1),
            "ro": sel(ro_new, "ro", si.p),
            "rd": sel(rd_new, "rd", bs.wi),
            "excl": sel(excl_new, "excl", hit.tri_id),
            "tp": sel(tp_new, "tp", tp),
            "L": torch.where(restart[:, None], 0.0, L),
            # prev_* feed the balance heuristic, which the blocker queue
            # (ref_mis_weights) never reads: chains keep stale values.
            "prev_pb": torch.where(take, pb_new, bs.pdf),
            "prev_p": torch.where(t1, ro_new, si.p),
            "prev_ns": torch.where(t1, ns_new, si.ns),
            "prev_w": torch.where(take, wsum_new, wsum),
            "counter": counter + take.sum(),
            "nrays": st["nrays"] + v.nrays,
        })
        for k, v in out.items():
            state[k].copy_(v)

    return state, iterate, more, reset


def render_regen(
    scene: Scene,
    cfg: RenderConfig,
    base_key: torch.Tensor,
    n_pix: int,
    total_samples: int,
    lanes: int = 1 << 16,
    pixel_offset: int = 0,
    pixel_stride: int = 1,
    spp0: int = 0,
    seed_mode: SeedMode | None = None,
    on_iter: Callable[[dict], None] | None = None,
    graph: bool | None = None,
    job: RegenJob | None = None,
):
    """Render ``total_samples`` paths distributed round-robin over
    ``n_pix`` local pixels (local pixel i is global pixel
    i * pixel_stride + pixel_offset; local sample s is spp round
    spp0 + s // n_pix). Runs on the scene's device.

    With ``seed_mode`` (set by :func:`render_regen_cached`) free lanes pull
    the pre-pass's continuation seeds instead of camera samples — resuming
    at depth 1 with the cached per-pixel interaction — ``total_samples`` is
    the seed count and the framebuffer starts at the pre-pass's depth-0
    radiance.

    With ``cfg.mis_blocker_compat`` (MIS) the loop also keeps the
    blocker-chain queue: ``lanes + 1`` rows, the last one the sink of
    spilled writes. Chains enqueued in an iteration are ranked by the
    cumulative count of spawning lanes; free lanes then pull chains from the
    top of the queue (last in, first out, from the buffers as this
    iteration's enqueue left them) before new samples, and the loop runs
    until no sample, live lane or queued chain is left. Chain ``k`` of the
    launch has sample id ``-1 - k`` and draws from
    fold(fold(fold(base, _CHAIN_TAG), spp0), k), disjoint from every real
    stream.

    ``graph``: ``None`` (the default) captures the iteration as a CUDA
    graph on CUDA tensors and replays it (``integrator/graph.py``: the
    job's first iteration eager, its second captured, one replay each
    after) and runs it eagerly on the CPU; ``False`` runs it eagerly;
    ``True`` on CPU tensors raises. Both give the same iterations, rays and
    framebuffer up to the order of ``index_add_``'s atomic additions.

    ``job``: the :class:`RegenJob` this call is a launch of (None: a job of
    this one launch). Its first launch builds the loop's state and its
    graph; a later one resets the state in place and replays. Its calls
    keep every argument but ``base_key``, ``spp0`` and ``total_samples``,
    and the cached route's seeds are its prepass's.

    ``on_iter(state)``, when given, sees the loop state (the dict of
    :func:`regen_loop`) before the first iteration and after each one. Its
    tensors are the loop's own buffers, which the next iteration (or
    replay) overwrites: a caller that keeps them clones them.

    Returns (framebuffer_sum [n_pix, 3] f32, a view of the job's buffer
    that its next launch overwrites; logical rays traced (int64 tensor:
    extension + shadow rays of live lanes); iterations; stats)."""
    job = RegenJob() if job is None else job
    with span("regen.loop"):
        with span("regen.context"):
            key = job.key(base_key, scene.device)
            st, iterate, more, reset = job.part(
                "loop",
                (id(scene), cfg, n_pix, lanes, pixel_offset, pixel_stride, id(seed_mode)),
                lambda: _loop(scene, cfg, key, n_pix, lanes, pixel_offset, pixel_stride,
                              seed_mode, job.context(scene, cfg)))
            reset(spp0, total_samples)
        step = job.step("loop", functools.partial(iterate, st), graph, scene.device)
        iters = 0
        if on_iter is not None:
            on_iter(st)
        while more(st):
            iters += 1
            step()
            if on_iter is not None:
                on_iter(st)
        stats = RegenStats()
        if "spilled" in st:                           # the blocker queue's counts
            with span("regen.sync"):
                stats = RegenStats(spilled=int(st["spilled"]), chains=int(st["chain_counter"]))
        return st["fb"][:n_pix], st["nrays"].clone(), iters, stats


class RegenJob:
    """What a job keeps from launch to launch, built at its first launch:
    the key buffer, the scene context (``shading.SceneContext``), the
    prepass's and the loop's state (:class:`PrepassLoop`,
    :func:`regen_loop`) and their captured steps (one
    ``graph.GraphedLoop`` each, in one memory pool).

    ``render_image_regen`` makes one for its call and passes it to every
    launch (``job=`` of :func:`render_regen_cached` / :func:`render_regen`);
    the renderer of ``parallel.sharded.make_regen_sharded`` keeps one for
    its lifetime; any other call makes its own for its one launch. A later
    launch copies its key into the key buffer (:meth:`key`), rewrites the
    state in place and writes its ``spp0``, rounds and samples into device
    scalars that the captured steps read, so it builds, warms up, captures
    and allocates nothing, and each step is one replay. A launch may bring
    a new key; one that changes an argument its part was built from
    (scene, configuration, sizes, lanes, pixel offset or stride) raises.
    :meth:`close` (or the end of a ``with`` block) frees it all; nothing
    is kept across jobs."""

    def __init__(self):
        self.parts: dict = {}       # name -> (the arguments it was built from, the part)
        self.pool = None
        self.key_buf: torch.Tensor | None = None

    def __enter__(self) -> RegenJob:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self.parts.clear()
        self.pool = None
        self.key_buf = None

    def key(self, base_key: torch.Tensor, device: torch.device) -> torch.Tensor:
        """The job's key buffer on ``device`` with ``base_key`` copied into
        it: allocated at the job's first launch with the key's shape and
        dtype, and read by every part built on it (the captured steps and
        the eager resets), so that each launch renders its own key."""
        if self.key_buf is None:
            self.key_buf = torch.empty_like(base_key, device=device)
        self.key_buf.copy_(base_key)
        return self.key_buf

    def part(self, name: str, fixed: tuple, build: Callable[[], object]):
        """The part ``name``, ``build()`` at its first call; raises where
        ``fixed`` differs from that call's."""
        have = self.parts.get(name)
        if have is None:
            have = self.parts[name] = (fixed, build())
        elif have[0] != fixed:
            raise ValueError(f"a launch of this job changed what its {name} was built from: "
                             f"{fixed} against {have[0]}")
        return have[1]

    def context(self, scene: Scene, cfg: RenderConfig) -> shading.SceneContext:
        return self.part("context", (id(scene), cfg), lambda: shading.scene_context(scene, cfg))

    def step(self, name: str, fn: Callable[[], None], graph: bool | None,
             device: torch.device) -> Callable[[], None]:
        """``fn``, a step of the job's loop ``name``, as its launch runs it:
        the job's one GraphedLoop of it where ``graph`` captures on
        ``device`` (``graph.use_graph``), else ``fn`` itself."""
        if not graph_mod.use_graph(graph, device):
            return fn
        if self.pool is None and device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()     # the steps never run at once
        return self.part("graph." + name, (), lambda: graph_mod.GraphedLoop(fn, device,
                                                                            pool=self.pool))
