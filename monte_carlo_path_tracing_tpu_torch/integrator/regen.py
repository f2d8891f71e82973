"""Path-regeneration wavefront renderer (forward fast path).

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/regen.py::
render_regen``. Every lane of a fixed-width wavefront traces one path; when
the path ends, its radiance is scatter-added into the framebuffer and the
lane pulls the next (pixel, spp) sample from a global counter and restarts
as a camera ray. Draws follow the core/rng.py contract exactly — each
lane's keys are fold(fold(fold(fold(base, spp index), global pixel id),
depth), purpose) — so the estimate is a function of the seed alone,
invariant to lane count and launch splitting, and consumes the same
streams as the JAX package.

The JAX ``lax.while_loop`` becomes a Python loop over a dict of [C]
tensors; it stops when no sample is left and no lane is alive. Per bounce
it runs K1 (extension rays), K3 (Arvo light pick) and K2 (NEE shadow rays)
when the scene's tensors are on CUDA, their plain versions on the CPU.

This slice ports the estimator of the main path: Veach MIS with Arvo
spherical-triangle NEE. Forward-only, like the JAX loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.integrator.wavefront import (
    _light_pdf_of_hit, _nee_term,
)
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import (
    camera_basis, pixel_len, primary_dirs,
)
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, phong
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import (
    EST_BRDF, EST_MIS, EST_SPLIT, LS_SPHERICAL, RenderConfig,
)


class RegenStats(NamedTuple):
    """Scalar diagnostics of one regen launch. ``spilled`` and ``chains``
    belong to the blocker-chain queue (not ported: always 0);
    ``rays_physical`` 0 means "same as the logical count"."""

    spilled: int = 0
    chains: int = 0
    rays_physical: int = 0


def primary_cache_eligible(cfg: RenderConfig) -> bool:
    """Configurations whose depth-0 work is per-pixel deterministic (no
    jitter, no blocker compat; estimator mis, brdf or split)."""
    return (
        not cfg.pixel_jitter
        and not cfg.mis_blocker_compat
        and cfg.estimator in (EST_MIS, EST_BRDF, EST_SPLIT)
    )


def _check_supported(cfg: RenderConfig, seed_mode) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what this
    slice of the port does not run yet."""
    todo = [
        (seed_mode is not None,
         "seed_mode (primary-hit cache: ROADMAP queue 1, item 11)"),
        (cfg.estimator in (EST_BRDF, EST_SPLIT),
         f"estimator {cfg.estimator!r} in regen (ROADMAP queue 1, item 16)"),
        (cfg.light_sampler != LS_SPHERICAL,
         "uniform-area light sampling in regen (ROADMAP queue 1, item 16)"),
        (cfg.mis_blocker_compat,
         "mis_blocker_compat / blocker-chain queue (ROADMAP queue 1, item 16)"),
        (cfg.ref_mis_weights,
         "ref_mis_weights light-accel MIS (ROADMAP queue 1, item 16)"),
        (cfg.ray_sort, "ray_sort lane sorting (ROADMAP queue 1, item 16)"),
        (cfg.accel == "grid", "accel='grid' (ROADMAP queue 1, item 16)"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")
    if cfg.estimator != EST_MIS:
        raise ValueError(f"render_regen does not run estimator {cfg.estimator!r}")


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
    seed_mode=None,
):
    """Render ``total_samples`` paths distributed round-robin over
    ``n_pix`` local pixels (local pixel i is global pixel
    i * pixel_stride + pixel_offset; local sample s is spp round
    spp0 + s // n_pix). Runs on the scene's device.

    Returns (framebuffer_sum [n_pix, 3] f32, logical rays traced (int64
    tensor: extension + shadow rays of live lanes), iterations, stats)."""
    _check_supported(cfg, seed_mode)
    dev = scene.device
    base_key = base_key.to(dev)
    accel = ops_intersect.build_accel(scene)
    tri_to_light = common.light_index_table(scene)
    consts = arvo_cuda.pack_consts(scene)
    table = light_spherical.light_table(scene)
    cam = scene.camera
    u_ax, v_ax, n_ax, dist = camera_basis(cam)
    plen = pixel_len(cam, dist)
    C = int(lanes)
    w_rr = 1.0 / cfg.rr_prob
    lane_ids = torch.arange(C, dtype=torch.int64, device=dev)

    def lane_stream(sample, pixel):
        """fold(fold(base, spp0 + sample // n_pix), global pixel id)."""
        k = rng.fold_in(base_key, spp0 + torch.div(sample, n_pix, rounding_mode="floor"))
        return rng.fold_in(k, pixel * pixel_stride + pixel_offset)

    def primary_rays(sample, pixel):
        """Camera rays of (sample, local pixel); the jitter draw, when on,
        comes from the sample's stream at depth 0."""
        jitter = None
        if cfg.pixel_jitter:
            lk = lane_stream(sample, pixel)
            jitter = rng.uniform(rng.bounce_key(lk, 0, rng.P_PIXEL_JITTER), (C, 2), -0.5, 0.5)
        return primary_dirs(cam, u_ax, v_ax, n_ax, dist, plen,
                            pixel * pixel_stride + pixel_offset, jitter)

    zero3 = torch.zeros((C, 3), device=dev)
    z_up = torch.zeros((C, 3), device=dev)
    z_up[:, 2] = 1.0
    st = {
        "alive": torch.zeros(C, dtype=torch.bool, device=dev),
        "pixel": torch.zeros(C, dtype=torch.int64, device=dev),
        "sample": torch.zeros(C, dtype=torch.int64, device=dev),
        "depth": torch.zeros(C, dtype=torch.int64, device=dev),
        "ro": zero3, "rd": z_up,
        "excl": torch.full((C,), ops_intersect.NO_HIT, dtype=torch.int32, device=dev),
        "tp": torch.ones((C, 3), device=dev), "L": zero3,
        "prev_pb": torch.ones(C, device=dev), "prev_p": zero3, "prev_ns": z_up,
        "prev_w": torch.zeros(C, device=dev),
    }
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    # Dead lanes write their pixel row, live lanes their own dummy row
    # n_pix + lane, which is dropped at the end.
    fb = torch.zeros((n_pix + C, 3), device=dev)
    iters = 0

    while bool((counter < total_samples) | st["alive"].any()):
        iters += 1
        alive, depth, tp, L = st["alive"], st["depth"], st["tp"], st["L"]
        lk_d = rng.fold_in(lane_stream(st["sample"], st["pixel"]), depth)

        # ---- one bounce for live lanes (wavefront._run_mis semantics) ----
        hit = ops_intersect.intersect(accel, st["ro"], st["rd"], st["excl"])
        nrays += alive.sum()
        si = common.gather_interaction(scene, hit, st["rd"], tri_to_light)
        cont = alive & hit.valid & si.front

        # Emission: full weight on primary hits, else the balance heuristic.
        p_l = _light_pdf_of_hit(scene, cfg, si, st["prev_p"], st["prev_ns"],
                                st["prev_w"], table=table)
        pb = st["prev_pb"]
        w_emit = torch.where(depth == 0, torch.ones_like(pb),
                             pb / torch.clamp(pb + p_l, min=1e-20))
        is_emit = cont & si.is_light
        L = L + torch.where(is_emit[:, None], tp * si.emission * w_emit[:, None],
                            torch.zeros_like(L))
        cont = cont & ~si.is_light

        # Russian roulette gates both strategies (main.cpp:429-437).
        survive = rng.uniform(rng.fold_in(lk_d, rng.P_RR), (C,)) < cfg.rr_prob
        cont = cont & survive
        tp = torch.where(cont[:, None], tp * w_rr, tp)

        # Light strategy: Arvo NEE with the MIS weight.
        ls, wsum = light_spherical.sample(
            rng.fold_in(lk_d, rng.P_LIGHT_SELECT), scene, si.p, si.ns,
            consts=consts, table=table,
        )
        nrays += cont.sum()
        L = L + tp * _nee_term(scene, cfg, accel, si, ls, wsum, cont)

        # BRDF strategy: sample, weight, continue (main.cpp:471-491).
        bs = phong.sample_brdf(
            rng.fold_in(lk_d, rng.P_BSDF), si.ns, si.wo, si.kd, si.ks, si.ns_exp,
            branch_pdf_compat=cfg.branch_pdf_compat,
        )
        cos_i = vm.dot(bs.wi, si.ns)
        cont = cont & (cos_i > 0.0) & (bs.pdf > 1e-12)
        f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
        scale = torch.clamp(cos_i, min=0.0) / torch.clamp(bs.pdf, min=1e-12)
        tp = torch.where(cont[:, None], tp * f * scale[:, None], tp)

        # ---- scatter finished paths & regenerate ----
        died = alive & ~cont
        tgt = torch.where(died, st["pixel"], n_pix + lane_ids)
        fb.index_add_(0, tgt, torch.where(died[:, None], L, torch.zeros_like(L)))

        free = died | ~alive
        rank = torch.cumsum(free.to(torch.int64), 0) - 1
        take = free & (rank < total_samples - counter)
        new_sample = counter + rank
        pixel_new = new_sample % n_pix
        ro_new, rd_new = primary_rays(new_sample, pixel_new)
        t1 = take[:, None]
        st = {
            "alive": cont | take,
            "pixel": torch.where(take, pixel_new, st["pixel"]),
            "sample": torch.where(take, new_sample, st["sample"]),
            "depth": torch.where(take, 0, depth + 1),
            "ro": torch.where(t1, ro_new, si.p),
            "rd": torch.where(t1, rd_new, bs.wi),
            "excl": torch.where(take, ops_intersect.NO_HIT, hit.tri_id),
            "tp": torch.where(t1, 1.0, tp),
            "L": torch.where(t1, 0.0, L),
            "prev_pb": torch.where(take, 1.0, bs.pdf),
            "prev_p": torch.where(t1, ro_new, si.p),
            "prev_ns": torch.where(t1, rd_new, si.ns),
            "prev_w": torch.where(take, 0.0, wsum),
        }
        counter = counter + take.sum()

    return fb[:n_pix], nrays, iters, RegenStats()
