"""Path-regeneration wavefront renderer (forward fast path).

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/regen.py``. Every
lane of a fixed-width wavefront traces one path; when the path ends, its
radiance is scatter-added into the framebuffer and the lane pulls the next
(pixel, spp) sample from a global counter and restarts. Draws follow the
core/rng.py contract exactly — each lane's keys are
fold(fold(fold(fold(base, spp index), global pixel id), depth), purpose) —
so the estimate is a function of the seed alone, invariant to lane count
and launch splitting, and consumes the same streams as the JAX package.

- :func:`render_regen`: the loop. The JAX ``lax.while_loop`` becomes a
  Python loop over a dict of [C] tensors; it stops when no sample is left
  and no lane is alive. Per bounce it runs K1 (extension rays), K3 (Arvo
  light pick) and K2 (shadow rays) when the scene's tensors are on CUDA,
  their plain versions on the CPU. Lanes restart as camera rays, or, with
  ``seed_mode``, resume at depth 1 from the pre-pass's seeds. With
  ``accel="auto"`` on scenes of ``AUTO_CULL_MIN_TRIS`` triangles or more
  (or ``ray_sort=True``) the lanes are sorted each iteration by
  (direction, origin Morton code), and with auto the loop's traces cull:
  K4 / K5 instead of K1 / K2.
- :func:`primary_prepass`: with jitter off every spp of a pixel re-traces
  one camera ray, so the pre-pass traces each pixel once (K4, culled),
  prepares its Arvo CDF once, and runs the depth-0 shading densely for all
  spp rounds (shadow rays through K5), leaving continuation seeds.
- :func:`render_regen_cached`: the pre-pass, then the seeded loop — the
  default route whenever :func:`primary_cache_eligible` holds.

Estimators: Veach MIS, split and BRDF-only, with the spherical-triangle or
the uniform-area light sampler. ``ref_mis_weights`` adds the reference's
nearest-light pdf to every BRDF continuation's denominator (a K1 trace
against the lights-only accel, in the loop and the pre-pass).
``mis_blocker_compat`` (uncached only) reproduces the reference's full MIS
recursion: the light ray of NEE is a nearest-hit trace, and a non-emissive
occluder it meets becomes a queued continuation path (a blocker chain)
that free lanes pull, last in first out, before new samples. With
``accel="grid"`` the loop runs all pairs, as the JAX loop does.
Forward-only, like the JAX loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.integrator.wavefront import (
    _direct_term, _light_pdf_along, _light_pdf_of_hit, _nee_term, _sample_light, _shadow_ray,
)
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


def _nee_full(scene, cfg, accel, tri_to_light, si, ls, alive):
    """The reference's MIS light strategy with occluder shading
    (main.cpp:450-464): the light ray's nearest hit (K1 on CUDA tensors,
    never culled) is shaded whatever it is. An emissive front hit adds its
    radiance inline (the common case, equal to NEE); a non-emissive front
    hit becomes a blocker chain, traced as a continuation path through the
    queue. Returns (contrib [N,3], spawn [N], wl [N,3], w_chain [N,3] =
    f cos / (p_light + p_brdf), the denominator detached)."""
    wl, _, dist2, cos_x, cos_l = _shadow_ray(si, ls)
    ok = alive & ls.valid & (cos_x > 0.0)
    lh = ops_intersect.intersect(accel, si.p, wl, si.tri_id)
    si2 = common.gather_interaction(scene, lh, wl, tri_to_light)
    if cfg.light_sampler == LS_SPHERICAL:
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


def lane_keys(base_key, sample, pixel, n_pix: int, spp0: int = 0, pixel_stride: int = 1,
              pixel_offset: int = 0, chain_base=None) -> torch.Tensor:
    """[C, 2] stream keys of the (sample, local pixel) each lane traces:
    fold(fold(base, spp0 + sample // n_pix), global pixel id). With
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
):
    """Per-pixel primary hit and dense depth-0 shading for ``spp_rounds``
    rounds (clamped to ``spp_cap``, which sizes the seed buffer), pixel
    chunk by pixel chunk:

    1. trace each pixel's camera ray once, culled (K4 on CUDA);
    2. Arvo ``prepare`` and its CDF once per pixel (mis/split, spherical);
    3. draw RR and the light pick densely over (round, pixel) — the same
       fold(fold(fold(base, spp0 + round), pixel), 0) streams and purposes
       as the uncached loop's depth 0;
    4. stably partition the survivors to the front (seed order is sample
       order), and shade only them: NEE or direct light with culled shadow
       rays (K5 on CUDA), then the BRDF sample that becomes a seed (with
       ``ref_mis_weights``, its weight's denominator adds the light pdf
       along it: K1 on the lights-only accel).

    Returns (seed_mode, seed_count, nrays_logical, nrays_physical):
    logical rays count the primary once per sample (comparable with the
    uncached loop), physical ones once per pixel. One host sync per chunk
    (the survivor count) replaces the JAX survivor prefix and its
    ``lax.cond`` tail; the values are the same."""
    _check_supported(cfg)
    spp_rounds = min(int(spp_rounds), int(spp_cap))
    dev = scene.device
    base_key = base_key.to(dev)
    accel = ops_intersect.build_accel(scene)
    tri_to_light = common.light_index_table(scene)
    consts = arvo_cuda.pack_consts(scene)
    table = light_spherical.light_table(scene)
    spherical = cfg.light_sampler == LS_SPHERICAL
    is_mis = cfg.estimator == EST_MIS
    light_accel = (ops_intersect.build_light_accel(scene) if is_mis and cfg.ref_mis_weights
                   else None)
    is_split = cfg.estimator == EST_SPLIT
    picks = (is_mis or is_split) and spherical
    cam = scene.camera
    u_ax, v_ax, n_ax, dist = camera_basis(cam)
    plen = pixel_len(cam, dist)

    # The flattened batch of a chunk is chunk * spp_cap samples: ~256k rows
    # whatever the spp (the JAX formula, so seed order and sums follow it).
    chunk = min(pix_chunk, n_pix, max(4096, (1 << 18) // max(spp_cap, 1)))
    n_chunks = -(-n_pix // chunk)
    total = n_pix * spp_cap
    w_rr = 1.0 / cfg.rr_prob
    R = spp_cap
    S = R * chunk
    f32 = dict(device=dev, dtype=torch.float32)

    npad = n_chunks * chunk
    fb_pre = torch.zeros((npad, 3), **f32)
    cache_p = torch.zeros((npad, 3), **f32)
    cache_ns = torch.zeros((npad, 3), **f32)
    cache_wsum = torch.zeros(npad, **f32)
    cache_tri = torch.full((npad,), ops_intersect.NO_HIT, dtype=torch.int32, device=dev)
    # Seed records; row ``total`` is the sink of masked writes.
    seeds_sample = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    seeds_wi = torch.zeros((total + 1, 3), **f32)
    seeds_tp = torch.zeros((total + 1, 3), **f32)
    seeds_pdf = torch.zeros(total + 1, **f32)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    n_shadow = 0

    r_ids = torch.arange(R, device=dev)[:, None]
    k_r = rng.fold_in(base_key, spp0 + torch.arange(R, device=dev))     # [R, 2]
    for c in range(n_chunks):
        pix_local = c * chunk + torch.arange(chunk, device=dev)
        gpix = pix_local * pixel_stride + pixel_offset
        ro, rd = primary_dirs(cam, u_ax, v_ax, n_ax, dist, plen, gpix)
        hit = ops_intersect.intersect(accel, ro, rd, cull=True)
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        hitok = (pix_local < n_pix) & hit.valid & si.front
        # Depth-0 emission: tp = 1 and weight 1 for every estimator, the
        # same for every sample of the pixel.
        em_add = torch.where((hitok & si.is_light)[:, None], si.emission * float(spp_rounds),
                             torch.zeros_like(si.emission))
        shade0 = hitok & ~si.is_light
        if picks:
            weights, wsum = light_spherical.prepare(scene, si.p, si.ns, consts=consts)
            cdf = torch.cumsum(weights, dim=-1)
        else:
            wsum = torch.zeros(chunk, **f32)

        # All rounds of the chunk as one [S] batch, row-major (round, pixel).
        lk0 = rng.fold_in(rng.fold_in(k_r[:, None, :], gpix[None, :]).reshape(S, 2), 0)
        survive, _ = common.russian_roulette(rng.fold_in(lk0, rng.P_RR), S, cfg.rr_prob)
        if picks:
            # rng.pick_weighted against the cached CDF, densely: the CDF is
            # non-decreasing, so searchsorted(right) = count(cdf <= u wsum).
            u_d = rng.uniform(rng.fold_in(rng.fold_in(lk0, rng.P_LIGHT_SELECT), 0), (S,))
            thresh = (u_d.view(R, chunk) * wsum[None, :]).t().contiguous()
            lidx_d = torch.clamp(torch.searchsorted(cdf, thresh, right=True),
                                 max=weights.shape[-1] - 1).t().reshape(S).to(torch.int32)
        hit_live = (shade0[None, :] & (r_ids < spp_rounds)).reshape(S)
        # mis: RR gates both strategies; brdf: the continuation; split: only
        # the continuation (its direct term runs for every hit sample).
        part = hit_live if is_split else hit_live & survive
        n_live = int(part.sum())
        if n_live:
            rows = torch.argsort((~part).to(torch.int32), stable=True)[:n_live]
            pix = rows % chunk
            si_c = common.SurfaceInteraction(
                **{f.name: getattr(si, f.name)[pix] for f in dataclasses.fields(si)})
            wsum_c = wsum[pix]
            lk0_c = lk0[rows]
            live = torch.ones(n_live, dtype=torch.bool, device=dev)
            fb_acc = torch.zeros((chunk, 3), **f32)
            if is_mis or is_split:
                n_shadow += n_live
                kstep = rng.fold_in(lk0_c, rng.P_LIGHT_SELECT)
                if spherical:
                    ls = light_spherical.sample_from_pick(
                        rng.fold_in(kstep, 1), scene, si_c.p, si_c.ns, lidx_d[rows], wsum_c,
                        table=table)
                else:
                    ls = light_uniform.sample(kstep, scene, n_live)
                if is_split:
                    fb_acc.index_add_(0, pix, _direct_term(scene, cfg, accel, si_c, ls, live,
                                                           cull=True))
                    live = survive[rows]
                else:
                    nee = _nee_term(scene, cfg, accel, si_c, ls, wsum_c, live, cull=True)
                    fb_acc.index_add_(0, pix, w_rr * nee)

            bs = phong.sample_brdf(rng.fold_in(lk0_c, rng.P_BSDF), si_c.ns, si_c.wo, si_c.kd,
                                   si_c.ks, si_c.ns_exp, branch_pdf_compat=cfg.branch_pdf_compat)
            cos_i = vm.dot(bs.wi, si_c.ns)
            cont = live & (cos_i > 0.0) & (bs.pdf > 1e-12)
            pdf = bs.pdf
            if light_accel is not None:
                pdf = pdf + _light_pdf_along(scene, cfg, light_accel, tri_to_light, si_c, bs.wi,
                                             wsum_c, table=table)
            f = phong.eval_brdf(si_c.ns, bs.wi, si_c.wo, si_c.kd, si_c.ks, si_c.ns_exp)
            tp_next = f * (torch.clamp(cos_i, min=0.0) / torch.clamp(pdf, min=1e-12)
                           * w_rr)[:, None]
            slot = torch.where(cont, count + torch.cumsum(cont.to(torch.int64), 0) - 1, total)
            seeds_sample[slot] = (r_ids * n_pix + pix_local[None, :]).reshape(S)[rows]
            seeds_wi[slot] = bs.wi
            seeds_tp[slot] = tp_next
            seeds_pdf[slot] = bs.pdf
            count = count + cont.sum()
            em_add = em_add + fb_acc
        sl = slice(c * chunk, (c + 1) * chunk)
        fb_pre[sl] = em_add
        cache_p[sl] = si.p
        cache_ns[sl] = si.ns
        cache_wsum[sl] = wsum
        cache_tri[sl] = hit.tri_id

    seeds = SeedMode(
        sample=seeds_sample, wi=seeds_wi, tp=seeds_tp, pdf=seeds_pdf,
        cache_p=cache_p[:n_pix], cache_ns=cache_ns[:n_pix], cache_wsum=cache_wsum[:n_pix],
        cache_tri=cache_tri[:n_pix], fb_pre=fb_pre[:n_pix],
    )
    return seeds, int(count), spp_rounds * n_pix + n_shadow, n_pix + n_shadow


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
):
    """Primary-cache render: :func:`primary_prepass`, then the loop over
    its seeds (depth >= 1 only). The same estimate and streams as
    :func:`render_regen` over ``n_pix * spp_rounds`` samples; returns the
    same (fb, nrays, iters, stats) with logical rays, the physical count in
    ``stats.rays_physical``."""
    seeds, seed_count, n_log, n_phys = primary_prepass(
        scene, cfg, base_key, n_pix, spp_cap, spp_rounds,
        pixel_offset=pixel_offset, pixel_stride=pixel_stride, spp0=spp0,
    )
    fb, nrays_loop, iters, stats = render_regen(
        scene, cfg, base_key, n_pix, seed_count, lanes=lanes, pixel_offset=pixel_offset,
        pixel_stride=pixel_stride, spp0=spp0, seed_mode=seeds,
    )
    stats = stats._replace(rays_physical=n_phys + int(nrays_loop))
    return fb, n_log + nrays_loop, iters, stats


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

    ``on_iter(state)``, when given, sees the loop state (a dict of
    tensors, the queue's included) before the first iteration and after
    each one.

    Returns (framebuffer_sum [n_pix, 3] f32, logical rays traced (int64
    tensor: extension + shadow rays of live lanes), iterations, stats)."""
    _check_supported(cfg)
    blocker = bool(cfg.mis_blocker_compat) and cfg.estimator == EST_MIS
    if blocker and seed_mode is not None:
        raise ValueError("the primary-hit cache excludes mis_blocker_compat")
    dev = scene.device
    base_key = base_key.to(dev)
    accel = ops_intersect.build_accel(scene)
    tri_to_light = common.light_index_table(scene)
    consts = arvo_cuda.pack_consts(scene)
    table = light_spherical.light_table(scene)
    est = cfg.estimator
    light_accel = (ops_intersect.build_light_accel(scene) if est == EST_MIS and cfg.ref_mis_weights
                   else None)
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
    w_rr = 1.0 / cfg.rr_prob
    lane_ids = torch.arange(C, dtype=torch.int64, device=dev)
    chain_base = chain_key(base_key, spp0) if blocker else None

    def lane_stream(sample, pixel):
        return lane_keys(base_key, sample, pixel, n_pix, spp0, pixel_stride, pixel_offset,
                         chain_base)

    def primary_rays(sample, pixel):
        """Camera rays of (sample, local pixel); the jitter draw, when on,
        comes from the sample's stream at depth 0."""
        jitter = None
        if cfg.pixel_jitter:
            lk = lane_stream(sample, pixel)
            jitter = rng.uniform(rng.bounce_key(lk, 0, rng.P_PIXEL_JITTER), (C, 2), -0.5, 0.5)
        return primary_dirs(cam, u_ax, v_ax, n_ax, dist, plen,
                            pixel * pixel_stride + pixel_offset, jitter)

    def pull(new_sample):
        """(pixel, sample, depth, ro, rd, ns, excl, tp, pdf, wsum) of the
        samples lanes pull: camera rays at depth 0, or seeds at depth 1."""
        if seed_mode is None:
            pixel = new_sample % n_pix
            ro, rd = primary_rays(new_sample, pixel)
            return (pixel, new_sample, 0, ro, rd, rd, ops_intersect.NO_HIT, 1.0, 1.0, 0.0)
        sidx = torch.clamp(new_sample, 0, seed_mode.sample.shape[0] - 1)
        sample = seed_mode.sample[sidx]
        pixel = sample % n_pix
        return (pixel, sample, 1, seed_mode.cache_p[pixel], seed_mode.wi[sidx],
                seed_mode.cache_ns[pixel], seed_mode.cache_tri[pixel], seed_mode.tp[sidx],
                seed_mode.pdf[sidx], seed_mode.cache_wsum[pixel])

    zero3 = torch.zeros((C, 3), device=dev)
    z_up = torch.zeros((C, 3), device=dev)
    z_up[:, 2] = 1.0
    zero = torch.zeros(C, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    st = {
        "alive": torch.zeros(C, dtype=torch.bool, device=dev),
        "pixel": torch.zeros(C, **i64), "sample": torch.zeros(C, **i64),
        "depth": torch.zeros(C, **i64),
        "ro": zero3, "rd": z_up,
        "excl": torch.full((C,), ops_intersect.NO_HIT, dtype=torch.int32, device=dev),
        "tp": torch.ones((C, 3), device=dev), "L": zero3,
        "prev_pb": torch.ones(C, device=dev), "prev_p": zero3, "prev_ns": z_up,
        "prev_w": zero,
    }
    if blocker:
        # The chain queue: C + 1 rows, row C the sink of spilled writes.
        st.update({
            "buf_ro": torch.zeros((C + 1, 3), device=dev),
            "buf_rd": torch.zeros((C + 1, 3), device=dev),
            "buf_tp": torch.zeros((C + 1, 3), device=dev),
            "buf_pixel": torch.zeros(C + 1, **i64),
            "buf_excl": torch.full((C + 1,), ops_intersect.NO_HIT, dtype=torch.int32,
                                   device=dev),
            "buf_sample": torch.zeros(C + 1, **i64),
            "buf_depth": torch.zeros(C + 1, **i64),
            "buf_count": torch.zeros((), **i64),
            "chain_counter": torch.zeros((), **i64),
            "spilled": torch.zeros((), **i64),
        })
    counter = torch.zeros((), **i64)
    nrays = torch.zeros((), **i64)
    # Dead lanes write their pixel row, live lanes their own dummy row
    # n_pix + lane, which is dropped at the end.
    fb = torch.zeros((n_pix + C, 3), device=dev)
    if seed_mode is not None:
        fb[:n_pix] = seed_mode.fb_pre
    iters = 0
    if on_iter is not None:
        on_iter(st)

    def more():
        m = (counter < total_samples) | st["alive"].any()
        return bool(m | (st["buf_count"] > 0)) if blocker else bool(m)

    while more():
        iters += 1
        if do_sort:
            st = sort_lanes(st, scene_lo, scene_inv)
        alive, depth, tp, L = st["alive"], st["depth"], st["tp"], st["L"]
        lk_d = rng.fold_in(lane_stream(st["sample"], st["pixel"]), depth)

        # ---- one bounce for live lanes (wavefront._run_mis / _run_split /
        #      _run_brdf semantics) ----
        hit = ops_intersect.intersect(accel, st["ro"], st["rd"], st["excl"], cull=loop_cull)
        nrays += alive.sum()
        si = common.gather_interaction(scene, hit, st["rd"], tri_to_light)
        cont = alive & hit.valid & si.front

        # Emission: full weight on primary hits; then MIS the balance
        # heuristic (1 under ref_mis_weights, whose light pdf went into the
        # throughput), BRDF-only full weight, split none (its direct term
        # owns the light).
        if est == EST_MIS and light_accel is None:
            p_l = _light_pdf_of_hit(scene, cfg, si, st["prev_p"], st["prev_ns"],
                                    st["prev_w"], table=table)
            pb = st["prev_pb"]
            w_emit = torch.where(depth == 0, torch.ones_like(pb),
                                 pb / torch.clamp(pb + p_l, min=1e-20))
        elif est == EST_SPLIT:
            w_emit = (depth == 0).to(torch.float32)
        else:
            w_emit = torch.ones(C, device=dev)
        is_emit = cont & si.is_light
        L = L + torch.where(is_emit[:, None], tp * si.emission * w_emit[:, None],
                            torch.zeros_like(L))
        cont = cont & ~si.is_light

        # Russian roulette (Q6): mis gates both strategies, split only the
        # continuation, brdf the bounce.
        survive, _ = common.russian_roulette(rng.fold_in(lk_d, rng.P_RR), C, cfg.rr_prob)
        wsum = zero
        tp_rr = w_rr
        if est == EST_MIS:
            cont = cont & survive
            tp = torch.where(cont[:, None], tp * w_rr, tp)
            tp_rr = 1.0

        # Light strategy (mis: NEE with the MIS weight, or the reference's
        # light ray with occluder chains) or direct term (split).
        if est in (EST_MIS, EST_SPLIT):
            ls, ws = _sample_light(rng.fold_in(lk_d, rng.P_LIGHT_SELECT), scene, cfg, si,
                                   consts=consts, table=table)
            nrays += cont.sum()
            if est == EST_MIS:
                wsum = zero if ws is None else ws
                if blocker:
                    nee, spawn, wl_sp, w_chain = _nee_full(scene, cfg, accel, tri_to_light, si,
                                                           ls, cont)
                    L = L + tp * nee
                    chain_tp = tp * w_chain
                else:
                    L = L + tp * _nee_term(scene, cfg, accel, si, ls, wsum, cont,
                                           cull=loop_cull)
            else:
                L = L + tp * _direct_term(scene, cfg, accel, si, ls, cont)
        if est != EST_MIS:
            cont = cont & survive

        # BRDF strategy: sample, weight, continue (main.cpp:471-491); the
        # reference's weighting adds the light pdf along wi (main.cpp:484-491).
        bs = phong.sample_brdf(
            rng.fold_in(lk_d, rng.P_BSDF), si.ns, si.wo, si.kd, si.ks, si.ns_exp,
            branch_pdf_compat=cfg.branch_pdf_compat,
        )
        cos_i = vm.dot(bs.wi, si.ns)
        cont = cont & (cos_i > 0.0) & (bs.pdf > 1e-12)
        pdf = bs.pdf
        if light_accel is not None:
            pdf = pdf + _light_pdf_along(scene, cfg, light_accel, tri_to_light, si, bs.wi, wsum,
                                         table=table)
        f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
        scale = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf, min=1e-12) * tp_rr
        tp = torch.where(cont[:, None], tp * f * scale[:, None], tp)

        # ---- scatter finished paths & regenerate ----
        died = alive & ~cont
        tgt = torch.where(died, st["pixel"], n_pix + lane_ids)
        fb.index_add_(0, tgt, torch.where(died[:, None], L, torch.zeros_like(L)))

        free = died | ~alive
        out = {}
        if blocker:
            # Enqueue this bounce's chains, ranked by the cumulative count
            # of spawning lanes; those past the capacity C go to the sink.
            rank_s = torch.cumsum(spawn.to(torch.int64), 0) - 1
            slot = st["buf_count"] + rank_s
            can = spawn & (slot < C)
            idx_w = torch.where(can, slot, C)
            for k, v in (("ro", si.p), ("rd", wl_sp), ("tp", chain_tp), ("pixel", st["pixel"]),
                         ("excl", si.tri_id), ("sample", -1 - (st["chain_counter"] + rank_s)),
                         ("depth", depth + 1)):
                buf = st["buf_" + k].clone()
                buf[idx_w] = v
                out["buf_" + k] = buf
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
        take = free & (rank < total_samples - counter)
        if blocker:
            take = take & ~take_chain
        pixel_new, sample_new, depth_new, ro_new, rd_new, ns_new, excl_new, tp_new, pb_new, \
            wsum_new = pull(counter + rank)

        def sel(new, queued, cur):
            """take -> new sample, take_chain -> queued chain, else cur."""
            tk = take if cur.dim() == 1 else take[:, None]
            if blocker:
                tc = take_chain if cur.dim() == 1 else take_chain[:, None]
                cur = torch.where(tc, out["buf_" + queued][src], cur)
            return torch.where(tk, new, cur)

        t1 = take[:, None]
        restart = take if not blocker else take | take_chain
        st = {
            **out,
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
        }
        counter = counter + take.sum()
        if on_iter is not None:
            on_iter(st)

    stats = (RegenStats(spilled=int(st["spilled"]), chains=int(st["chain_counter"])) if blocker
             else RegenStats())
    return fb[:n_pix], nrays, iters, stats
