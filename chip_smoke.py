"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Usage (from the repository root, on a machine with an NVIDIA Hopper GPU):

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, and the process
exits non-zero without printing a result:

1. device: the GPU's name and power limit; TF32 off;
2. build: compile the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a);
3. kernels: K1 (nearest hit), K2 (any hit) and K3 (Arvo light pick)
   against their plain torch versions on the card, at the loop's shapes
   (Veach MIS; 65,536 rays / shading points, the cached loop's lanes, and
   32,768, the uncached loop's), with median times and bounds; K1 / K2 also
   with separately rounded dots (bit-equal to the plain versions); K1's
   lowest-index tie rule on the real triangles twice over, the copy shifted
   so that each triangle and its copy fall to different threads;
4. culled kernels: K4 (culled nearest hit) and K5 (culled any hit) on the
   batches one primary-prepass chunk hands them (the camera fan of rows
   480-511 of the 1024^2 camera, and its 8 rounds of depth-0 shadow rays),
   against their plain versions and against K1 / K2 on the same rays, with
   median times and bounds (K4: ids, K5: flags as counted fringes against
   both, the separately rounded instances bit-equal to the plain versions
   and timed, and K1's / K2's time on the same rays); K5 also on that
   shadow batch with t_max moved
   past each ray's first hit, so that its flags are a mix and some ray
   tiles are all blocked;
5. end to end, uncached: the Veach MIS render at the bench's uncached
   configuration (1024^2, 8 spp, MIS + spherical-triangle NEE, depth 16,
   seed 0, 32,768 lanes) through ``render_image_regen`` with
   ``primary_cache=False``; K1-K3 must launch; checksum and ray count are
   held against the values recorded for the same streams;
6. end to end, cached (the main path): the same render with the default
   ``primary_cache``, which routes to the primary-hit cache; all five
   kernels must launch; checksum and ray count held as in 5;
7. two devices: the same entry point renders Veach at 64^2, 4 spp on the
   card and on the CPU, uncached and cached; ray counts and images agree;
8. end to end, fixed depth (the CLI's default render and the gradient
   path): ``render_image`` at 1024^2, 2 spp, MIS + spherical-triangle NEE,
   depth 32, ray_chunk 65,536, seed 0; K1-K3 must launch and K4 / K5 must
   not; the image is held against the cached regeneration render of the
   same configuration in the same phase (the same streams: no path reaches
   depth 32);
9. gradient: ``pixel_grad`` through K1-K3 on Veach 64^2 (MIS, depth 4) on
   the card against the same call on the CPU (finite, cosine per material
   field); then one full 65,536-ray chunk of the 1024^2 camera forward and
   backward at depth 32 on the card, with time and peak memory;
10. auto cull: bathroom (29,596 triangles) at its own 1280x720, 4 spp, MIS +
   spherical-triangle NEE, depth 16, seed 0, 65,536 lanes, through
   ``render_image_regen`` with the default ``accel="auto"``: the loop sorts
   its lanes and traces through K4 / K5, never K1 / K2; then the same render
   with ``accel="all_pairs"`` (K1 / K2 in the loop): equal ray counts, a
   bounded checksum gap; seconds, iterations and the sort's share of the
   loop; K4 / K5 timed on one recorded sorted loop batch beside K1 / K2 on
   the same rays;
11. cli: ``python -m monte_carlo_path_tracing_tpu_torch.cli`` as a
   subprocess: the Veach ``--regen`` render (1280x720, 8 spp, depth 16,
   65,536 lanes) against the same command run in-process (``cli.main``,
   whose kernel launches are read); a fixed-depth render of 2 spp
   checkpointed every spp, resumed to 3 spp, against the uninterrupted 3 spp
   command in-process;
12. inverse: the CLI's ``inverse`` on cornell at its own 256^2 (depth 3,
   4,096 rays a step, 30 steps, all four families): finite losses, kd error
   below its start; one step timed in-process (forward, backward, peak
   memory); ``recover_materials`` for 3 steps on cornell 32^2 on the card
   against the CPU.

The last lines are a JSON object of per-kernel results (time, plain
version's time, bound — the larger of the operations this run's inputs
need over the f32 peak and the bytes moved over the memory rate — and
share of the bound, launches on the cached render and, as
``launches_fixed_depth``, on the fixed-depth render; K4 also ``k1_ms`` and
K5 ``k2_ms``, the all-pairs kernel on the same rays, and both ``sep_ms``,
the separately rounded instance; K4 / K5 also ``launches_auto`` on
bathroom's auto render and, on its recorded loop batch, ``loop_ms``,
``loop_k1_ms`` / ``loop_k2_ms`` and ``loop_bound_ms``), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch import cli
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.diff import inverse
from monte_carlo_path_tracing_tpu_torch.diff.grad import pixel_grad
from monte_carlo_path_tracing_tpu_torch.integrator import common, regen, render_rays
from monte_carlo_path_tracing_tpu_torch.ops import _build, arvo_cuda, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import (
    camera_basis, generate_rays, pixel_len, primary_dirs,
)
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image, render_image_regen
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, phong
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

ROOT = os.path.dirname(os.path.abspath(__file__))
VEACH = os.path.join(ROOT, "scenes", "veach-mis", "veach-mis.obj")
BATHROOM = os.path.join(ROOT, "scenes", "bathroom", "bathroom.obj")
CORNELL = os.path.join(ROOT, "scenes", "cornell", "cornell.obj")
#: Where the CLI phases write their images and checkpoints.
WORK = os.path.join(ROOT, "build", "chip_smoke")

#: The bench's configuration (bench.py:74-103): uncached with its lanes
#: (bench.py:150-153), and cached with the lane count chosen on an H100:
#: 65,536 (16.3 s, 10.5 s and 5.9 s at 16,384 / 32,768 / 65,536; the
#: loop is host-bound, so fewer iterations win; PERF.md).
RES, SPP, LANES, LANES_CACHED = 1024, 8, 1 << 15, 1 << 16
#: fb_checksum and total_rays recorded for seed 0 at that configuration,
#: uncached (BENCH_r03.json) and cached (BENCH_r04.json); both are
#: properties of the threefry streams. Those TPU runs used bf16x3 dots and
#: another pick order, so the port lands near, not on, them: measured gaps
#: on an H100 +6.3e-4 and +2.0e-5 uncached, +6.32e-4 and +1.97e-5 cached;
#: bounds 3x the first measured gaps.
REF_CHECKSUM, REF_RAYS = 40655356.0, 21374288
CHECKSUM_GAP, RAYS_GAP = 2e-3, 1e-4
REF_CHECKSUM_CACHED, REF_RAYS_CACHED = 40655352.0, 21374290
CHECKSUM_GAP_CACHED, RAYS_GAP_CACHED = 1.9e-3, 5.91e-5
#: Batches of the main path: rays per extension / shadow trace and points
#: per NEE pick, at the uncached loop's lanes and at the cached loop's (where
#: K1-K3 run 107 times per render); the kernels' JSON entries are at the
#: latter.
N_MAIN, N_CACHED = LANES, LANES_CACHED
#: Rows put between the triangles and their copy in the tie check. K1 deals
#: the rows of a tile to its RB_G = 4 threads by index mod 4
#: (csrc/intersect.cu); with a shift that keeps the copy off its
#: original's residue, the shuffle merge, not one thread's strict '<',
#: settles every tie.
TIE_SHIFT, RB_G = 1, 4
#: Operations per unit of work, for each kernel's bound (the least time
#: the card could take for the work this run's inputs need):
OPS = {
    # K1 / K4 per (ray, triangle): four 10-term dots (40 multiplies, 36
    # adds), the sign fix and the margin test (~14).
    "pair": 90,
    # K2 / K5: the same and t' < tmax |det|.
    "anyhit_pair": 92,
    # K3 per (point, light): the culls, front and above (four 3-term dots
    # 20, four subtractions and compares 8, two ORs). Every pair needs them.
    "arvo_cull": 30,
    # K3 per pair that passes the culls: its weight (four 3-term dots 20,
    # ab / bc / ca 9, three clamped lengths 15, det and the denominator 9,
    # sA and the weight 3, the validity tests 4; square roots and atan2f
    # one operation each). A pair that fails has weight 0 and needs none.
    "arvo_weight": 60,
}
#: f32 peak outside the tensor cores and memory rate of an H100 SXM at
#: 700 W (NVIDIA data sheet).
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
#: The prepass chunk whose batches the culled kernels are checked on:
#: pixel rows [480, 512) of the 1024^2 camera (one 32,768-pixel chunk).
FAN_ROW0, FAN_ROWS = 480, 32
#: Rays a K4 CTA walks the schedule for (csrc/intersect.cu: RB_SLOTS x RB_R).
K4_CTA_RAYS = 128
#: The fixed-depth phase: render_image at RES^2 with the configuration's
#: defaults (max_depth 32, ray_chunk 65,536) at FD_SPP spp; its image
#: against the cached regen render: checksum gap and the share of pixels
#: beyond rtol 1e-2 / atol 1e-3.
FD_SPP, FD_CHECKSUM_GAP, FD_PIXEL_SHARE = 2, 1e-3, 0.01
#: The gradient phase: Veach at GRAD_RES^2, MIS, depth GRAD_DEPTH, card
#: against CPU (cosine per material field at least GRAD_COS); then the
#: GRAD_CHUNK-th 65,536-pixel chunk of the RES^2 camera at depth 32.
GRAD_RES, GRAD_DEPTH, GRAD_COS, GRAD_CHUNK = 64, 4, 0.999, 8
#: The auto-cull phase: bathroom at its own 1280x720, AUTO_SPP spp, depth 16,
#: LANES_CACHED lanes; the bound on the checksum gap between its auto and
#: all-pairs renders: the first gap measured on an H100 was +2.2e-11, the
#: framebuffer's summation order alone, whose size varies from run to run;
#: one path that diverged would move the ~1.5e7 sum by ~1e-7 or more; the
#: loop iteration whose extension and shadow batches K4 / K5 are timed on.
AUTO_SPP, AUTO_CHECKSUM_GAP, AUTO_BATCH_ITER = 4, 1e-9, 5
#: The CLI phase: the Veach --regen render (CLI_SPP spp) against the same
#: render in-process (index_add_ sums in another order: rtol / atol); the
#: fixed-depth render checkpointed at CLI_FD_SPP spp and resumed to one more.
CLI_SPP, CLI_RTOL, CLI_ATOL, CLI_FD_SPP = 8, 2e-4, 1e-5, 2
#: The inverse phase: the CLI's inverse demo on cornell at its 256^2
#: (INV_STEPS steps of INV_RAYS rays at depth 3, lr 0.06); then
#: recover_materials for 3 steps on cornell INV_RES^2, card against CPU:
#: losses to INV_LOSS_RTOL, latents to INV_LATENT_ATOL, about 3x the first
#: gaps measured on an H100 (2.8e-7 and 9.5e-7).
INV_STEPS, INV_RAYS, INV_RES, INV_LOSS_RTOL, INV_LATENT_ATOL = 30, 4096, 32, 1e-6, 3e-6


def log(*a):
    print(*a, flush=True)


def with_res(scene, w, h):
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w, height=h))


def time_ms(fn, reps=20, warm=3) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    lib = _build.load()
    log(f"[build] {lib.path} in {lib.build_seconds:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: int):
    """(bound ms, what bounds it): the larger of ``ops`` f32 operations over
    the f32 peak and ``moved`` bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32, moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def anyhit_pairs(g, W, ids, excl, tmax, order=None, te=None,
                 t_eps: float = ops_intersect.T_EPS) -> int:
    """(ray, triangle) pairs an any-hit call needs on these inputs: each ray
    tests the real triangles (id >= 0) in visit order up to and including
    its first blocker, or all of them when none blocks it. The visit order
    is accel order (K2: ``order`` None), or for each ray tile the triangle
    tiles of ``order`` whose te < BIG_T / 2, in that order (K5). Plain
    torch, in pieces of a few million pairs."""
    N, T = g.shape[0], W.shape[0]
    if order is None:
        order = torch.zeros((1, 1), dtype=torch.int32, device=g.device)
        te = torch.zeros((1, 1), device=g.device)
    nrt, nb = order.shape
    rt, tile = N // nrt, T // nb
    gt, ex, tm = g.view(nrt, rt, 10), excl.view(nrt, rt), tmax.view(nrt, rt)
    Wt, idt = W.view(nb, tile, 10, 4), ids.view(nb, tile)
    real_upto = torch.cumsum((idt >= 0).long(), dim=1)       # [nb, tile]
    need = torch.zeros((nrt, rt), dtype=torch.int64, device=g.device)
    done = torch.zeros((nrt, rt), dtype=torch.bool, device=g.device)
    sub = max(1, min(rt, (1 << 22) // tile))
    for k in range(nb):
        rows = torch.nonzero(te[:, k] < ops_intersect.BIG_T / 2).flatten()
        for r in rows.split(max(1, (1 << 22) // (sub * tile))):
            b = order[r, k].long()
            for s0 in range(0, rt, sub):
                sl = slice(s0, s0 + sub)
                ok, tp, adet = intersect_cuda._accept(gt[r, sl], Wt[b], idt[b], ex[r, sl], t_eps)
                hit = ok & (tp < tm[r, sl][..., None] * adet)           # [m, s, tile]
                blocked = hit.any(dim=-1)
                first = torch.where(blocked, hit.int().argmax(dim=-1), tile - 1)
                counted = torch.gather(real_upto[b], 1, first)
                need[r, sl] += torch.where(done[r, sl], 0, counted)
                done[r, sl] |= blocked
    return int(need.sum())


def nearest_culled_pairs(c, best_t, n: int, group: int = 1) -> int:
    """(ray, triangle) pairs a culled nearest-hit call (K4) needs: for each
    of its first ``n`` rays, the real triangles of the tiles whose te is at
    most the ray's final best t (``best_t``: its hit t, or the scene-exit
    cap where it misses) — the tiles that could hold a nearer hit. With
    ``group`` > 1 each ray takes the largest final best t of its group of
    consecutive rays: the pairs that groups walking whole tiles together
    compute at least."""
    nrt, nb = c.order.shape
    rt, tile = c.g.shape[0] // nrt, c.W.shape[0] // nb
    real = (c.tri_ids >= 0).view(nb, tile).sum(dim=1)[c.order.long()]   # [nrt, nb]
    bt = best_t.view(-1, group).amax(dim=1, keepdim=True).expand(-1, group).reshape(nrt, rt)
    visit = c.te[:, None, :] <= bt[:, :, None]                          # [nrt, rt, nb]
    mine = (torch.arange(nrt * rt, device=bt.device) < n).view(nrt, rt, 1)
    return int((visit & mine).long().mul(real[:, None, :]).sum())


def main_path_inputs(scene, accel, n: int):
    """``n`` rays of the main path (half camera rays of the bench's 1024^2
    camera, half BRDF bounces leaving their hit points), and the shading
    points where those rays land — traced with the plain version."""
    dev = scene.device
    half = n // 2
    gen = np.random.default_rng(0)
    cam = scene.camera
    u, v, nrm, dist = camera_basis(cam)
    gpix = torch.as_tensor(gen.integers(0, cam.width * cam.height, half), device=dev)
    ro0, rd0 = primary_dirs(cam, u, v, nrm, dist, pixel_len(cam, dist), gpix)
    excl0 = torch.full((half,), -1, dtype=torch.int32, device=dev)
    tri_to_light = common.light_index_table(scene)
    W, ids = accel.real_rows()
    h0 = intersect_cuda.nearest_hit_plain(ops_intersect.ray_features(ro0, rd0), W, ids, excl0)
    si0 = common.gather_interaction(scene, h0, rd0, tri_to_light)
    key = rng.fold_in(rng.base_key(1, device=dev), torch.arange(half, device=dev))
    bs = phong.sample_brdf(key, si0.ns, si0.wo, si0.kd, si0.ks, si0.ns_exp)
    ro = torch.cat([ro0, si0.p]).contiguous()
    rd = torch.cat([rd0, bs.wi]).contiguous()
    excl = torch.cat([excl0, h0.tri_id]).contiguous()
    hit = intersect_cuda.nearest_hit_plain(ops_intersect.ray_features(ro, rd), W, ids, excl)
    si = common.gather_interaction(scene, hit, rd, tri_to_light)
    return ro, rd, excl, hit, si


def arvo_seen_pairs(C, x1, nrm, eps: float = 1e-6) -> int:
    """(point, light) pairs that pass K3's culls, front and above, in
    plain torch on the constants ``C`` (csrc/arvo.cu ``sees``): the pairs
    whose weight the function has to evaluate."""
    def xdot(v, j):
        return (v[:, 0:1] * C[None, :, j] + v[:, 1:2] * C[None, :, j + 1]
                + v[:, 2:3] * C[None, :, j + 2])

    nx = (nrm * x1).sum(dim=1, keepdim=True)
    front = (xdot(x1, 12) - C[None, :, 21]) > eps
    above = ((xdot(nrm, 0) - nx) > eps) | ((xdot(nrm, 3) - nx) > eps) | ((xdot(nrm, 6) - nx) > eps)
    return int((front & above).sum())


def arvo_inputs(si, n: int):
    """K3's inputs at the shading points ``si`` of :func:`main_path_inputs`:
    points, shading normals and one uniform each (seeded stream)."""
    dev = si.p.device
    u = rng.uniform(rng.fold_in(rng.base_key(2, device=dev), torch.arange(n, device=dev)), (n,))
    return si.p.contiguous(), si.ns.contiguous(), u


def _entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by):
    return dict(name=name, route="cuda", source=f"monte_carlo_path_tracing_tpu_torch/csrc/{source}",
                replaces=f"monte_carlo_path_tracing_tpu/ops/{replaces}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                library_ms=None)


def _k1(g, W, ids, excl, n):
    """K1 against its plain version and across its instances; times."""
    hk = intersect_cuda.nearest_hit(g, W, ids, excl)
    hp = intersect_cuda.nearest_hit_plain(g, W, ids, excl)
    hs = intersect_cuda.nearest_hit(g, W, ids, excl, fma=False)
    torch.cuda.synchronize()
    n_diff, err = _compare_hits(hk, hp)
    same = hs.tri_id == hp.tri_id
    n_sep = int((~same).sum())
    exact = all(torch.equal(a[same], b[same]) for a, b in ((hs.t, hp.t), (hs.u, hp.u), (hs.v, hp.v)))
    log(f"[kernels] K1 at {n} rays: ids differ from plain on {n_diff} (fused dots; fringe bound "
        f"0.1%), max |dt|,|du|,|dv| on equal ids {err:.3g} (rtol 1e-5); separately rounded: "
        f"{n_sep} differ, t/u/v bit-equal {exact}")
    assert n_diff <= n // 1000, "K1 disagrees with its plain version"
    assert n_sep == 0 and exact, "K1 with separately rounded dots is not the plain version"
    ms = time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl))
    sep_ms = time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl, fma=False))
    pms = time_ms(lambda: intersect_cuda.nearest_hit_plain(g, W, ids, excl), reps=5)
    bms, by = bound(n * W.shape[0] * OPS["pair"], nbytes(g, W, ids, excl) + n * 16)
    log(f"[kernels] K1 at {n} rays x {W.shape[0]} triangles: {ms:.3f} ms, plain {pms:.3f} ms, "
        f"bound {bms:.3f} ms ({by}), share {bms / ms:.3f}; separately rounded dots "
        f"{sep_ms:.3f} ms")
    return hk, _entry("K1 nearest_hit", "intersect.cu", "intersect_pallas.py:299", err, ms, pms,
                      bms, by)


def _k2(gs, W, ids, sexcl, tmax, n):
    """K2 against its plain version and across its instances; times."""
    bk = intersect_cuda.occluded(gs, W, ids, sexcl, tmax)
    bp = intersect_cuda.occluded_plain(gs, W, ids, sexcl, tmax)
    bs = intersect_cuda.occluded(gs, W, ids, sexcl, tmax, fma=False)
    torch.cuda.synchronize()
    n_diff, n_sep = int((bk != bp).sum()), int((bs != bp).sum())
    log(f"[kernels] K2 at {n} shadow rays: flags differ from plain on {n_diff} (fused dots; "
        f"bound 0.1%), separately rounded on {n_sep}; {float(bp.float().mean()):.3f} blocked")
    assert n_diff <= n // 1000, "K2 disagrees with its plain version"
    assert n_sep == 0, "K2 with separately rounded dots is not the plain version"
    ms = time_ms(lambda: intersect_cuda.occluded(gs, W, ids, sexcl, tmax))
    sep_ms = time_ms(lambda: intersect_cuda.occluded(gs, W, ids, sexcl, tmax, fma=False))
    pms = time_ms(lambda: intersect_cuda.occluded_plain(gs, W, ids, sexcl, tmax), reps=5)
    pairs = anyhit_pairs(gs, W, ids, sexcl, tmax)
    bms, by = bound(pairs * OPS["anyhit_pair"], nbytes(gs, W, ids, sexcl, tmax) + n * 4)
    log(f"[kernels] K2 at {n} rays: {ms:.3f} ms, plain {pms:.3f} ms, {pairs} pairs needed "
        f"({pairs / (n * W.shape[0]):.3f} of all), bound {bms:.3f} ms ({by}), share "
        f"{bms / ms:.3f}; separately rounded dots {sep_ms:.3f} ms")
    return _entry("K2 occluded", "intersect.cu", "intersect_pallas.py:328",
                  float((bk.float() - bp.float()).abs().max()), ms, pms, bms, by)


def _k3(C, x1, nrm, u, n):
    ik, wk = arvo_cuda.arvo_select(C, x1, nrm, u)
    ip, wp = arvo_cuda.arvo_select_plain(C, x1, nrm, u)
    torch.cuda.synchronize()
    n_diff = int((ik != ip).sum())
    err = float((wk - wp).abs().max())
    log(f"[kernels] K3 at {n} points: picks differ on {n_diff} (CDF-boundary fringe, bound "
        f"0.1%); wsum max abs err {err:.3g} (rtol 1e-5)")
    assert n_diff <= n // 1000, "K3 disagrees with its plain version"
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-6)
    ms = time_ms(lambda: arvo_cuda.arvo_select(C, x1, nrm, u))
    pms = time_ms(lambda: arvo_cuda.arvo_select_plain(C, x1, nrm, u), reps=5)
    L = C.shape[0]
    seen = arvo_seen_pairs(C, x1, nrm)                   # weights the function needs
    bms, by = bound(n * L * OPS["arvo_cull"] + seen * OPS["arvo_weight"],
                    nbytes(C, x1, nrm, u) + n * 8)
    log(f"[kernels] K3 at {n} points x {L} lights: {ms:.3f} ms, plain {pms:.3f} ms, {n * L} "
        f"pairs culled, {seen} weights needed ({seen / (n * L):.4f} of pairs pass the culls), "
        f"bound {bms:.4f} ms ({by}), share {bms / ms:.3f}")
    return _entry("K3 arvo_select", "arvo.cu", "arvo_pallas.py:111", err, ms, pms, bms, by)


def _tie_check(g, W, ids, excl):
    """K1 on the real rows twice over (the copy's ids + 2**20), the copy
    shifted by TIE_SHIFT rows of copies: every hit must be the first
    copy's, as K1 on the rows once gives it."""
    n = W.shape[0]
    assert (n + TIE_SHIFT) % RB_G, "the copy would fall to its original's thread"
    W2 = torch.cat([W, W[:TIE_SHIFT], W]).contiguous()
    ids2 = torch.cat([ids, ids[:TIE_SHIFT] + (1 << 20), ids + (1 << 20)]).contiguous()
    once = intersect_cuda.nearest_hit(g, W, ids, excl)
    twice = intersect_cuda.nearest_hit(g, W2, ids2, excl)
    plain = intersect_cuda.nearest_hit_plain(g, W2, ids2, excl)
    torch.cuda.synchronize()
    n_dup = int((twice.tri_id >= (1 << 20)).sum())
    n_once = int((twice.tri_id != once.tri_id).sum())
    n_plain = int((twice.tri_id != plain.tri_id).sum())
    log(f"[kernels] tie rule: {g.shape[0]} camera rays against {n} triangles twice over "
        f"(copy shifted {TIE_SHIFT} row): {int(twice.valid.sum())} hit, {n_dup} on the copy, {n_once} differ from K1 on "
        f"the rows once, {n_plain} from plain (fringe bound 0.1%)")
    assert n_dup == 0 and n_once == 0, "K1 broke the lowest-index tie rule"
    assert n_plain <= g.shape[0] // 1000, "K1 disagrees with its plain version on ties"


def phase_kernels(scene):
    """K1-K3 against their plain versions on the card at the loop's shapes,
    65,536 rays (cached) and 32,768 (uncached), with median times, bounds
    and K1 / K2 with separately rounded dots; the lowest-index tie rule of
    K1. The
    entries are the 65,536-ray ones, each with its 32,768-ray numbers."""
    dev = scene.device
    accel = ops_intersect.build_accel(scene)
    W, ids = accel.real_rows()
    C = arvo_cuda.pack_consts(scene)
    log(f"[kernels] veach: {scene.num_tris} triangles ({accel.W.shape[0]} padded; K1 / K2 "
        f"take the {W.shape[0]} real rows), {scene.num_lights} lights")
    entries = {}
    for n in (N_CACHED, N_MAIN):
        ro, rd, excl, hit, si = main_path_inputs(scene, accel, n)
        g = ops_intersect.ray_features(ro, rd).contiguous()
        log(f"[kernels] {n} main-path rays, {int(hit.valid.sum())} hit")
        hk, k1 = _k1(g, W, ids, excl, n)
        if n == N_CACHED:
            _tie_check(g[:n // 2].contiguous(), W, ids, excl[:n // 2].contiguous())
        # K3: Arvo light pick at the shading points where those rays landed.
        x1, nrm, u = arvo_inputs(si, n)
        k3 = _k3(C, x1, nrm, u, n)
        # K2: NEE shadow rays from those points to Arvo-sampled light points.
        ls, _ = light_spherical.sample(
            rng.fold_in(rng.base_key(3, device=dev), torch.arange(n, device=dev)), scene, x1,
            nrm, consts=C)
        wl_raw = ls.coord - si.p
        dist = torch.sqrt(torch.clamp((wl_raw * wl_raw).sum(-1), min=1e-20))
        wl = (wl_raw / dist[:, None]).contiguous()
        gs = ops_intersect.ray_features(x1, wl).contiguous()
        tmax = (dist * (1.0 - ops_intersect.OCCLUSION_MARGIN)).contiguous()
        k2 = _k2(gs, W, ids, si.tri_id.contiguous(), tmax, n)
        for e in (k1, k2, k3):
            if n == N_CACHED:
                entries[e["name"]] = e
            else:
                entries[e["name"]]["at_32768"] = {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                   "share")}
    return list(entries.values())


def main_cfg(**kw) -> RenderConfig:
    return RenderConfig(width=RES, height=RES, spp=SPP, estimator="mis",
                        light_sampler="spherical_triangle", max_depth=16, seed=0, **kw)


def prepass_batches(scene, cfg):
    """The camera fan and the depth-0 shadow batch that one prepass chunk
    of the main path hands the culled kernels: the prepass is run on pixel
    rows [FAN_ROW0, FAN_ROW0 + FAN_ROWS) alone (its streams are keyed by
    global pixel id, so they are the full render's), and the arguments of
    its culled traces are recorded."""
    rec = {}
    orig_i, orig_o = ops_intersect.intersect, ops_intersect.occluded

    def intersect(*a, **kw):
        if kw.get("cull"):
            rec["fan"] = a[1:3]
        return orig_i(*a, **kw)

    def occluded(*a, **kw):
        if kw.get("cull"):
            rec["shadow"] = a[1:5]
        return orig_o(*a, **kw)

    n = FAN_ROWS * scene.camera.width
    ops_intersect.intersect, ops_intersect.occluded = intersect, occluded
    try:
        regen.primary_prepass(scene, cfg, rng.base_key(cfg.seed, device=scene.device), n,
                              cfg.spp, cfg.spp, pixel_offset=FAN_ROW0 * scene.camera.width)
    finally:
        ops_intersect.intersect, ops_intersect.occluded = orig_i, orig_o
    return rec["fan"], rec["shadow"]


def _compare_hits(a, b):
    """(ids differing, max |dt|,|du|,|dv| over rays with equal ids)."""
    same = a.tri_id == b.tri_id
    m = same & a.valid
    err = max((float((x - y)[m].abs().max()) if bool(m.any()) else 0.0)
              for x, y in ((a.t, b.t), (a.u, b.u), (a.v, b.v)))
    for x, y in ((a.t, b.t), (a.u, b.u), (a.v, b.v)):
        torch.testing.assert_close(x[m], y[m], rtol=1e-5, atol=1e-6)
    return int((~same).sum()), err


def _check_k5(accel, ro, rd, excl, scaled, tag):
    """K5 (fused dots) against its plain version and against K2 on one
    shadow batch, as counted fringes; K5 with separately rounded dots bit
    for bit the plain version. Returns (flags differing from plain, blocked
    share, per-ray-tile flags, args and real rows of the call)."""
    W, ids = accel.real_rows()
    n = ro.shape[0]
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl, scaled)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    bk = intersect_cuda.occluded_culled(*args, rows=c.rows)
    bs = intersect_cuda.occluded_culled(*args, rows=c.rows, fma=False)
    bp = intersect_cuda.occluded_culled_plain(*args, rows=c.rows)
    b2 = intersect_cuda.occluded(ops_intersect.ray_features(ro, rd).contiguous(), W, ids,
                                 excl, scaled)
    torch.cuda.synchronize()
    n_diff, n_sep = int((bk != bp).sum()), int((bs != bp).sum())
    n_k2 = int((bk[:n] != b2).sum())
    tiles = torch.cat([b2, b2.new_zeros(c.g.shape[0] - n)]).view(c.order.shape[0], -1)
    share = float(b2.float().mean())
    log(f"[culled] K5 {tag}: {n} shadow rays, {share:.3f} blocked, "
        f"{int(tiles.all(dim=1).sum())} of {tiles.shape[0]} ray tiles all blocked; "
        f"{float((c.te < 1.5e38).float().mean()):.3f} of tile pairs not culled; {c.rows} real "
        f"of {c.W.shape[0]} rows; flags differ from plain on {n_diff} (fused dots; bound 0.1%), "
        f"from K2 on {n_k2} (bound 0.1%); separately rounded on {n_sep} (must be 0)")
    assert n_diff <= c.g.shape[0] // 1000, f"K5 disagrees with its plain version ({tag})"
    assert n_k2 <= n // 1000, f"K5 disagrees with K2 ({tag})"
    assert n_sep == 0, f"K5 with separately rounded dots is not the plain version ({tag})"
    return n_diff, share, tiles, args, c.rows


def phase_culled(scene):
    """K4 / K5 against their plain versions and K1 / K2 on one prepass
    chunk's batches; median times and bounds."""
    accel = ops_intersect.build_accel(scene)
    W, ids = accel.real_rows()
    (ro, rd), (sp, wl, dist, sexcl) = prepass_batches(scene, main_cfg())
    out = []

    # K4 on the camera fan.
    n = ro.shape[0]
    excl = torch.full((n,), ops_intersect.NO_HIT, dtype=torch.int32, device=ro.device)
    g = ops_intersect.ray_features(ro, rd).contiguous()
    h1 = intersect_cuda.nearest_hit(g, W, ids, excl)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    hk = intersect_cuda.nearest_hit_culled(*args, rows=c.rows)
    hs = intersect_cuda.nearest_hit_culled(*args, rows=c.rows, fma=False)
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows)
    torch.cuda.synchronize()
    n_diff, err = _compare_hits(hk, hp)
    exact = all(torch.equal(a, b) for a, b in ((hs.tri_id, hp.tri_id), (hs.t, hp.t),
                                                (hs.u, hp.u), (hs.v, hp.v)))
    hk = ops_intersect.Hit(*(x[:n] for x in (hk.t, hk.tri_id, hk.u, hk.v, hk.valid)))
    n_k1, err_k1 = _compare_hits(hk, h1)
    log(f"[culled] K4: {n} fan rays, {c.order.shape[0]} x {c.order.shape[1]} tiles, "
        f"{float((c.te < 1.5e38).float().mean()):.3f} not culled; {c.rows} real of "
        f"{c.W.shape[0]} rows; ids differ from plain on {n_diff} (fused dots; bound 0.1%), "
        f"max err {err:.3g}; from K1 on {n_k1} (bound 0.1%), max err {err_k1:.3g}; separately "
        f"rounded: ids, t, u, v bit-equal to plain {exact}")
    assert n_diff <= c.g.shape[0] // 1000, "K4 disagrees with its plain version"
    assert n_k1 <= n // 1000, "K4 disagrees with K1"
    assert exact, "K4 with separately rounded dots is not the plain version"
    ms = time_ms(lambda: intersect_cuda.nearest_hit_culled(*args, rows=c.rows))
    sep_ms = time_ms(lambda: intersect_cuda.nearest_hit_culled(*args, rows=c.rows, fma=False))
    k1ms = time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl))
    pms = time_ms(lambda: intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows), reps=5)
    best_t = torch.where(hp.valid, hp.t, c.bound)
    pairs = nearest_culled_pairs(c, best_t, n)
    walked = nearest_culled_pairs(c, best_t, n, group=K4_CTA_RAYS)
    bms, by = bound(pairs * OPS["pair"], nbytes(*args) + c.g.shape[0] * 16)
    log(f"[culled] K4 {ms:.3f} ms, separately rounded dots {sep_ms:.3f} ms; K1 on the same "
        f"rays {k1ms:.3f} ms; plain {pms:.3f} ms; {pairs} pairs needed "
        f"({pairs / (n * W.shape[0]):.3f} of all), at least {walked} computed by "
        f"{K4_CTA_RAYS}-ray CTAs; bound {bms:.4f} ms ({by}), share {bms / ms:.3f}")
    e = _entry("K4 nearest_hit_culled", "intersect.cu", "intersect_pallas.py:175", err, ms, pms,
               bms, by)
    e.update(k1_ms=k1ms, sep_ms=sep_ms)
    out.append(e)

    # K5 on the chunk's depth-0 shadow batch, as the prepass hands it over.
    # No ray of it is blocked (Veach's lights see the plates unobstructed),
    # so K5 is also held on the same origins and directions with t_max
    # moved past the first hit along the ray (K1's t): x2 in even ray
    # tiles, which blocks every ray that hits anything and so takes K5's
    # all-blocked exit, and x U[0, 2) in odd ones, a mix of both answers.
    sexcl = sexcl.to(torch.int32).contiguous()
    scaled = (dist * (1.0 - ops_intersect.OCCLUSION_MARGIN)).to(torch.float32).contiguous()
    gs = ops_intersect.ray_features(sp, wl).contiguous()
    d_main, _, _, args, rows = _check_k5(accel, sp, wl, sexcl, scaled, "prepass batch")
    n = sp.shape[0]
    t_hit = intersect_cuda.nearest_hit(gs, W, ids, sexcl)
    f = torch.as_tensor(np.random.default_rng(5).uniform(0.0, 2.0, n), dtype=torch.float32,
                        device=sp.device)
    f = torch.where((torch.arange(n, device=sp.device) // intersect_cuda.RAY_TILE) % 2 == 0,
                    2.0, f)
    moved = torch.where(t_hit.valid, t_hit.t * f, scaled).contiguous()
    d_moved, share, tiles, _, _ = _check_k5(accel, sp, wl, sexcl, moved, "t_max past the hit")
    assert 0.05 <= share <= 0.95, f"moved-t_max batch blocked share {share:.3f}, want a mix"
    assert bool(tiles.all(dim=1).any()), "no ray tile all blocked: K5's exit never ran"
    ms = time_ms(lambda: intersect_cuda.occluded_culled(*args, rows=rows))
    sep_ms = time_ms(lambda: intersect_cuda.occluded_culled(*args, rows=rows, fma=False))
    pms = time_ms(lambda: intersect_cuda.occluded_culled_plain(*args, rows=rows), reps=5)
    k2ms = time_ms(lambda: intersect_cuda.occluded(gs, W, ids, sexcl, scaled))
    pairs = anyhit_pairs(*args[:5], order=args[5], te=args[6])
    bms, by = bound(pairs * OPS["anyhit_pair"], nbytes(*args) + args[0].shape[0] * 4)
    log(f"[culled] K5 (prepass batch) {ms:.3f} ms, plain {pms:.3f} ms; K2 on the same rays "
        f"{k2ms:.3f} ms; {pairs} pairs needed ({pairs / (n * W.shape[0]):.3f} of all), bound "
        f"{bms:.4f} ms ({by}), share {bms / ms:.3f}; separately rounded dots {sep_ms:.3f} ms")
    e = _entry("K5 occluded_culled", "intersect.cu", "intersect_pallas.py:229",
               float(d_main + d_moved > 0), ms, pms, bms, by)
    e.update(k2_ms=k2ms, sep_ms=sep_ms)
    out.append(e)
    return out


KERNELS = {
    "K1 nearest_hit": intersect_cuda.nearest_hit,
    "K2 occluded": intersect_cuda.occluded,
    "K3 arvo_select": arvo_cuda.arvo_select,
    "K4 nearest_hit_culled": intersect_cuda.nearest_hit_culled,
    "K5 occluded_culled": intersect_cuda.occluded_culled,
}


def reset_counters():
    for fn in KERNELS.values():
        fn.launches = 0


def counters():
    return {name: fn.launches for name, fn in KERNELS.items()}


def phase_end_to_end(scene, cached: bool):
    """One render of the bench's configuration through render_image_regen:
    uncached (``primary_cache=False``) or with the default routing, which
    takes the primary-hit cache; launches of the path's kernels must rise."""
    tag = "e2e cached" if cached else "e2e"
    cfg = main_cfg() if cached else main_cfg(primary_cache=False)
    lanes = LANES_CACHED if cached else LANES
    ref_c, ref_r = (REF_CHECKSUM_CACHED, REF_RAYS_CACHED) if cached else (REF_CHECKSUM, REF_RAYS)
    bound_c, bound_r = (CHECKSUM_GAP_CACHED, RAYS_GAP_CACHED) if cached else (CHECKSUM_GAP,
                                                                              RAYS_GAP)
    want = list(KERNELS) if cached else list(KERNELS)[:3]
    reset_counters()
    res = render_image_regen(with_res(scene, RES, RES), cfg, lanes=lanes)
    launches = counters()
    img = res.image
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all(), "non-finite image"
    checksum = float((img.astype(np.float64) * SPP).sum())
    assert checksum > 0.0, f"checksum {checksum}"
    paths = RES * RES * SPP
    gap_c = checksum / ref_c - 1.0
    gap_r = res.rays_traced / ref_r - 1.0
    log(f"[{tag}] veach {RES}^2 x {SPP} spp, {lanes} lanes: {res.seconds:.2f} s, "
        f"{res.rays_traced} rays, {res.rays_traced / res.seconds / 1e6:.3f} Mrays/s, "
        f"{paths / res.seconds:.0f} paths/s, fb_checksum {checksum:.1f}")
    log(f"[{tag}] gap to the stream-determined values: fb_checksum {gap_c:+.3e} "
        f"(bound {bound_c:g}), total_rays {gap_r:+.3e} (bound {bound_r:g}); "
        f"launches {launches}")
    assert all(launches[k] > 0 for k in want), f"a kernel of the path never launched: {launches}"
    assert abs(gap_c) <= bound_c and abs(gap_r) <= bound_r, \
        "render drifted from the reference streams"
    return launches, dict(seconds=res.seconds, rays=res.rays_traced, checksum=checksum)


def fixed_depth_cfg() -> RenderConfig:
    return RenderConfig(width=RES, height=RES, spp=FD_SPP, estimator="mis",
                        light_sampler="spherical_triangle", max_depth=32, seed=0,
                        ray_chunk=1 << 16)


def phase_fixed_depth(scene, kernels):
    """render_image (the fixed-depth wavefront) at the full width; K1-K3
    launch, K4 / K5 do not; the image agrees with the cached regen render
    of the same configuration, rendered after it. The wall time is split
    into bounces (one K1 launch each) and the kernels' share, launches x
    their time at 65,536 rays from ``kernels``."""
    sc = with_res(scene, RES, RES)
    cfg = fixed_depth_cfg()
    reset_counters()
    res = render_image(sc, cfg)
    launches = counters()
    ref = render_image_regen(sc, cfg, lanes=LANES_CACHED)
    a, b = res.image, ref.image
    assert a.shape == (RES, RES, 3) and np.isfinite(a).all(), "non-finite image"
    checksum = float((a.astype(np.float64) * FD_SPP).sum())
    ref_checksum = float((b.astype(np.float64) * FD_SPP).sum())
    gap = checksum / ref_checksum - 1.0
    n_fine = int((~np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)).sum())
    n_div = int((~np.isclose(a, b, rtol=1e-2, atol=1e-3).all(-1)).sum())
    paths = RES * RES * FD_SPP
    log(f"[e2e fixed-depth] veach {RES}^2 x {FD_SPP} spp, depth {cfg.max_depth}, ray_chunk "
        f"{cfg.ray_chunk}: {res.seconds:.2f} s, {paths / res.seconds:.0f} paths/s, fb_checksum "
        f"{checksum:.1f}; launches {launches}")
    log(f"[e2e fixed-depth] cached regen of the same configuration: {ref.seconds:.2f} s, "
        f"fb_checksum {ref_checksum:.1f}; checksum gap {gap:+.3e} (bound {FD_CHECKSUM_GAP:g}); "
        f"of {RES * RES} pixels {n_fine} beyond rtol 1e-4 / atol 1e-5, {n_div} beyond rtol "
        f"1e-2 / atol 1e-3 (bound {FD_PIXEL_SHARE:.0%})")
    assert all(launches[k] > 0 for k in list(KERNELS)[:3]), f"K1-K3 did not launch: {launches}"
    assert all(launches[k] == 0 for k in list(KERNELS)[3:]), f"a culled kernel ran: {launches}"
    chunks = RES * RES * FD_SPP // cfg.ray_chunk
    bounces = launches["K1 nearest_hit"]
    kernel_s = sum(launches[e["name"]] * e["ms"] for e in kernels) / 1e3
    log(f"[e2e fixed-depth] {bounces} bounces in {chunks} chunks ({bounces / chunks:.2f} a "
        f"chunk), {res.seconds / bounces * 1e3:.1f} ms a bounce; K1-K3 launches x their ms at "
        f"65,536 rays: {kernel_s:.3f} s ({kernel_s / res.seconds:.1%} of the wall)")
    assert abs(gap) <= FD_CHECKSUM_GAP, "fixed-depth and regen checksums disagree"
    assert n_div <= FD_PIXEL_SHARE * RES * RES, "fixed-depth and regen images disagree"
    return launches


def _pixel_grad(scene, cfg, idx):
    """pixel_grad of the plain sum of radiance over camera rays ``idx``:
    (gradients by field as float64 on the CPU, seconds, launches)."""
    dev = scene.device
    ro, rd = generate_rays(scene.camera, idx)
    key = rng.lane_keys(rng.sample_key(rng.base_key(cfg.seed, device=dev), 0), idx)
    sel = torch.ones(idx.shape[0], 3, device=dev)
    reset_counters()
    t0 = time.perf_counter()
    g = pixel_grad(scene, cfg, key, ro, rd, sel)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fields = {f: getattr(g, f).detach().cpu().double().flatten()
              for f in ("kd", "ks", "ns", "emission")}
    return fields, dt, counters()


def phase_gradient(scene_cpu):
    """pixel_grad through K1-K3 on the card against the CPU at GRAD_RES^2;
    then one full chunk of the main camera forward and backward."""
    small = with_res(scene_cpu, GRAD_RES, GRAD_RES)
    cfg = RenderConfig(width=GRAD_RES, height=GRAD_RES, spp=1, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=GRAD_DEPTH, seed=0)
    n = GRAD_RES * GRAD_RES
    card, t_card, launches = _pixel_grad(small.to("cuda"), cfg, torch.arange(n, device="cuda"))
    cpu, t_cpu, _ = _pixel_grad(small, cfg, torch.arange(n))
    cosines = {}
    for f, a in cpu.items():
        b = card[f]
        assert bool(torch.isfinite(b).all()), f"non-finite {f} gradient on the card"
        na, nb = float(a.norm()), float(b.norm())
        cosines[f] = 1.0 if na == nb == 0.0 else float(a @ b) / max(na * nb, 1e-300)
        gap = float((a - b).norm()) / max(na, 1e-300)
        log(f"[gradient] veach {GRAD_RES}^2 MIS depth {GRAD_DEPTH}, d sum / d {f}: cosine card vs "
            f"cpu {cosines[f]:.7f} (bound {GRAD_COS}), relative gap {gap:.3e}, |g| {na:.4g}")
    log(f"[gradient] card {t_card:.2f} s, cpu {t_cpu:.2f} s; launches on the card {launches}")
    assert all(launches[k] > 0 for k in list(KERNELS)[:3]), f"K1-K3 did not launch: {launches}"
    assert all(c >= GRAD_COS for c in cosines.values()), "card and CPU gradients disagree"

    sc = with_res(scene_cpu, RES, RES).to("cuda")
    cfg = fixed_depth_cfg()
    idx = GRAD_CHUNK * cfg.ray_chunk + torch.arange(cfg.ray_chunk, device="cuda")
    ro, rd = generate_rays(sc.camera, idx)
    key = rng.lane_keys(rng.sample_key(rng.base_key(0, device="cuda"), 0), idx)
    with torch.no_grad():
        render_rays(sc, cfg, key, ro, rd)                    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_rays(sc, cfg, key, ro, rd)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads, t_grad, launches = _pixel_grad(sc, cfg, idx)
    peak = torch.cuda.max_memory_allocated() - base
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    log(f"[gradient] one {cfg.ray_chunk}-ray chunk of the {RES}^2 camera, depth {cfg.max_depth}: "
        f"forward {t_fwd:.3f} s, forward + backward {t_grad:.3f} s, peak memory above the "
        f"scene {peak / 2**20:.1f} MiB; gradients finite {finite}; launches {launches}")
    assert finite, "non-finite gradient on the full chunk"


def phase_two_devices(scene_cpu):
    small = with_res(scene_cpu, 64, 64)
    for cache in (False, None):
        cfg = RenderConfig(width=64, height=64, spp=4, estimator="mis",
                           light_sampler="spherical_triangle", max_depth=16, seed=0,
                           primary_cache=cache)
        tag = "uncached" if cache is False else "cached"
        t0 = time.perf_counter()
        gpu = render_image_regen(small.to("cuda"), cfg, lanes=2048)
        t1 = time.perf_counter()
        cpu = render_image_regen(small, cfg, lanes=2048)
        t2 = time.perf_counter()
        a, b = gpu.image, cpu.image
        n_fine = int((~np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1)).sum())
        n_div = int((~np.isclose(a, b, rtol=1e-2, atol=1e-3).all(-1)).sum())
        mean_gap = float(a.mean() / b.mean() - 1.0)
        log(f"[2dev] veach 64^2 x 4 spp {tag}: card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s; "
            f"rays {gpu.rays_traced} vs {cpu.rays_traced} (bound 0.1%); of "
            f"{a.shape[0] * a.shape[1]} pixels {n_fine} beyond rtol 1e-3 / atol 1e-4, {n_div} "
            f"beyond rtol 1e-2 / atol 1e-3 (bound 1%); mean gap {mean_gap:+.2e} (bound 1e-3)")
        assert abs(gpu.rays_traced - cpu.rays_traced) <= cpu.rays_traced // 1000, \
            "ray counts differ"
        assert n_div <= a.shape[0] * a.shape[1] // 100, "card and CPU images disagree"
        assert abs(mean_gap) <= 1e-3, "card and CPU image means disagree"


def record_loop(fn):
    """Run ``fn()`` with the regeneration loop instrumented: returns (its
    result, loop iterations, host seconds spent in the lane sort, and the
    arguments of the loop's culled extension and shadow traces at loop
    iteration AUTO_BATCH_ITER of the first launch: {"ext": (ro, rd, excl),
    "shadow": (ro, rd, t_max, excl)})."""
    rec = {"iters": 0, "sort_s": 0.0, "sorts": 0, "in_loop": False, "batch": {}}
    orig = (regen.render_regen, regen.sort_lanes, ops_intersect.intersect,
            ops_intersect.occluded)

    def loop(*a, **kw):
        rec["in_loop"] = True
        try:
            out = orig[0](*a, **kw)
        finally:
            rec["in_loop"] = False
        rec["iters"] += out[2]
        return out

    def sort(*a):
        t0 = time.perf_counter()
        out = orig[1](*a)
        rec["sort_s"] += time.perf_counter() - t0
        rec["sorts"] += 1
        return out

    def at_batch(kw):
        return rec["in_loop"] and kw.get("cull") and rec["sorts"] == AUTO_BATCH_ITER

    def intersect(*a, **kw):
        if at_batch(kw):
            rec["batch"].setdefault("ext", a[1:4])
        return orig[2](*a, **kw)

    def occluded(*a, **kw):
        if at_batch(kw):
            rec["batch"].setdefault("shadow", a[1:5])
        return orig[3](*a, **kw)

    regen.render_regen, regen.sort_lanes = loop, sort
    ops_intersect.intersect, ops_intersect.occluded = intersect, occluded
    try:
        out = fn()
    finally:
        (regen.render_regen, regen.sort_lanes, ops_intersect.intersect,
         ops_intersect.occluded) = orig
    return out, rec["iters"], rec["sort_s"], rec["batch"]


def _loop_batch_k4(accel, ro, rd, excl):
    """K4 on a recorded loop extension batch against its plain version and
    against K1 on the same rays; (K4 ms, K1 ms, K4 bound ms, K1 bound ms)."""
    W, ids = accel.real_rows()
    n = ro.shape[0]
    excl = excl.to(torch.int32).contiguous()
    g = ops_intersect.ray_features(ro, rd).contiguous()
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    hk = intersect_cuda.nearest_hit_culled(*args, rows=c.rows)
    hp = intersect_cuda.nearest_hit_culled_plain(*args, rows=c.rows)
    h1 = intersect_cuda.nearest_hit(g, W, ids, excl)
    torch.cuda.synchronize()
    n_diff, err = _compare_hits(hk, hp)
    n_k1, err_k1 = _compare_hits(
        ops_intersect.Hit(*(x[:n] for x in (hk.t, hk.tri_id, hk.u, hk.v, hk.valid))), h1)
    ms = time_ms(lambda: intersect_cuda.nearest_hit_culled(*args, rows=c.rows))
    k1ms = time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl))
    best_t = torch.where(hp.valid, hp.t, c.bound)
    pairs = nearest_culled_pairs(c, best_t, n)
    bms, by = bound(pairs * OPS["pair"], nbytes(*args) + c.g.shape[0] * 16)
    b1, _ = bound(n * W.shape[0] * OPS["pair"], nbytes(g, W, ids, excl) + n * 16)
    log(f"[auto cull] K4 on loop iteration {AUTO_BATCH_ITER}'s sorted extension batch: {n} rays "
        f"({int(hp.valid[:n].sum())} hit), {float((c.te < 1.5e38).float().mean()):.3f} of tile "
        f"pairs not culled; ids differ from plain on {n_diff} (bound 0.1%), max err {err:.3g}; "
        f"from K1 on {n_k1} (bound 0.1%), max err {err_k1:.3g}")
    log(f"[auto cull] K4 {ms:.3f} ms, K1 on the same rays {k1ms:.3f} ms; {pairs} pairs needed "
        f"({pairs / (n * W.shape[0]):.3f} of all), bound {bms:.4f} ms ({by}), share "
        f"{bms / ms:.3f}; K1's bound {b1:.4f} ms, share {b1 / k1ms:.3f}")
    assert n_diff <= c.g.shape[0] // 1000, "K4 disagrees with its plain version on a loop batch"
    assert n_k1 <= n // 1000, "K4 disagrees with K1 on a loop batch"

    # Why the schedule culls what it does: each ray tile's origin extent
    # (largest axis, as a share of the scene's) and the axes on which its
    # directions straddle zero (no constraint there). Then K4 on the same
    # rays in origin-major order (the Morton code above the direction
    # bits), a key the port does not use: what compact origins would cull.
    lo, inv = regen.scene_bounds(accel)
    live = torch.ones(n, dtype=torch.bool, device=ro.device)
    key = regen.lane_sort_key(ro, rd, live, lo, inv)
    perm = torch.argsort(((key & 0x7FFF) << 9) | (key >> 15), stable=True)
    for tag, p in (("JAX's key (direction-major)", None), ("origin-major", perm)):
        o, d = (ro, rd) if p is None else (ro[p], rd[p])
        ot, dt = (x.view(-1, intersect_cuda.RAY_TILE, 3) for x in (o, d))
        ext = ((ot.amax(dim=1) - ot.amin(dim=1)) * inv).amax(dim=1)
        straddle = ((dt.amin(dim=1) <= 0.0) & (dt.amax(dim=1) >= 0.0)).sum(dim=1).float()
        c2 = ops_intersect.culled_call(accel, slice(None), o, d, excl if p is None else excl[p])
        a2 = (c2.g, c2.W, c2.tri_ids, c2.excl, c2.bound, c2.order, c2.te)
        ms2 = time_ms(lambda: intersect_cuda.nearest_hit_culled(*a2, rows=c2.rows))
        log(f"[auto cull] loop batch in {tag} order: ray tiles' origin extent median "
            f"{float(ext.median()):.3f} of the scene's, {float(straddle.mean()):.2f} direction "
            f"axes straddling zero a tile; {float((c2.te < 1.5e38).float().mean()):.3f} of tile "
            f"pairs not culled; K4 {ms2:.3f} ms")
    return ms, k1ms, bms, b1


def _loop_batch_k5(accel, ro, rd, t_max, excl):
    """K5 on a recorded loop shadow batch against its plain version and K2
    (``_check_k5``); (K5 ms, K2 ms, K5 bound ms, K2 bound ms)."""
    W, ids = accel.real_rows()
    n = ro.shape[0]
    excl = excl.to(torch.int32).contiguous()
    scaled = (t_max * (1.0 - ops_intersect.OCCLUSION_MARGIN)).to(torch.float32).contiguous()
    _, _, _, args, rows = _check_k5(accel, ro, rd, excl, scaled, "loop batch")
    gs = ops_intersect.ray_features(ro, rd).contiguous()
    ms = time_ms(lambda: intersect_cuda.occluded_culled(*args, rows=rows))
    k2ms = time_ms(lambda: intersect_cuda.occluded(gs, W, ids, excl, scaled))
    pairs = anyhit_pairs(*args[:5], order=args[5], te=args[6])
    bms, by = bound(pairs * OPS["anyhit_pair"], nbytes(*args) + args[0].shape[0] * 4)
    pairs2 = anyhit_pairs(gs, W, ids, excl, scaled)
    b2, _ = bound(pairs2 * OPS["anyhit_pair"], nbytes(gs, W, ids, excl, scaled) + n * 4)
    log(f"[auto cull] K5 {ms:.3f} ms, K2 on the same rays {k2ms:.3f} ms; {pairs} pairs needed on "
        f"K5's schedule ({pairs / (n * W.shape[0]):.3f} of all), bound {bms:.4f} ms ({by}), "
        f"share {bms / ms:.3f}; K2 needs {pairs2} pairs, bound {b2:.4f} ms, share {b2 / k2ms:.3f}")
    return ms, k2ms, bms, b2


def phase_auto_cull():
    """Bathroom with accel="auto" (sorted lanes, K4 / K5 in the loop)
    against accel="all_pairs" (K1 / K2 in the loop); K4 / K5 timed on one
    recorded sorted loop batch beside K1 / K2."""
    sc = load_scene(BATHROOM)
    cam = sc.camera
    n_pix = cam.width * cam.height
    cfg = RenderConfig(width=cam.width, height=cam.height, spp=AUTO_SPP, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=16, seed=0)
    assert ops_intersect.auto_policy(sc.num_tris)["cull"], "bathroom outside the cull window"
    # Prepass chunks of one launch (integrator/regen.primary_prepass): each
    # traces its camera fan once through K4 (in the warm-up too) and its
    # shadow rays once through K5.
    spp_cap = max(1, min(AUTO_SPP, (16 << 20) // n_pix))
    n_chunks = -(-n_pix // min(1 << 15, n_pix, max(4096, (1 << 18) // spp_cap)))
    out, seconds = {}, {"auto": [], "all_pairs": []}
    for accel in ("auto", "all_pairs", "all_pairs", "auto"):     # in turns: host time spreads
        reset_counters()
        res, iters, sort_s, batch = record_loop(
            lambda: render_image_regen(sc, cfg.replace(accel=accel), lanes=LANES_CACHED))
        launches = counters()
        img = res.image
        assert img.shape == (cam.height, cam.width, 3) and np.isfinite(img).all(), "bad image"
        checksum = float((img.astype(np.float64) * AUTO_SPP).sum())
        log(f"[auto cull] bathroom {cam.width}x{cam.height} x {AUTO_SPP} spp, accel={accel}: "
            f"{res.seconds:.2f} s, {iters} loop iterations ({res.seconds / iters * 1e3:.1f} ms "
            f"each, prepass included), {res.rays_traced} rays, "
            f"{res.rays_traced / res.seconds / 1e6:.3f} Mrays/s, fb_checksum {checksum:.1f}; "
            f"lane sort {sort_s:.3f} s on the host ({sort_s / res.seconds:.1%} of the render, "
            f"{sort_s / max(iters, 1) * 1e3:.2f} ms an iteration); launches {launches}")
        seconds[accel].append(res.seconds)
        out.setdefault(accel, dict(res=res, iters=iters, checksum=checksum, launches=launches,
                                   batch=batch, sort_s=sort_s))
        assert res.rays_traced == out[accel]["res"].rays_traced, "a repeat traced other rays"
    auto, ap = out["auto"], out["all_pairs"]
    la = auto["launches"]
    assert la["K1 nearest_hit"] == la["K2 occluded"] == 0, f"K1 / K2 ran with auto: {la}"
    assert la["K4 nearest_hit_culled"] >= 2 * n_chunks + auto["iters"], \
        f"K4 did not run in the loop: {la}, {n_chunks} prepass chunks"
    assert la["K5 occluded_culled"] >= n_chunks + auto["iters"], \
        f"K5 did not run in the loop: {la}"
    lp = ap["launches"]
    assert lp["K1 nearest_hit"] >= ap["iters"] and lp["K2 occluded"] >= ap["iters"], \
        f"K1 / K2 did not run in the all-pairs loop: {lp}"
    gap = auto["checksum"] / ap["checksum"] - 1.0
    log(f"[auto cull] auto against all-pairs: rays {auto['res'].rays_traced} vs "
        f"{ap['res'].rays_traced} (must be equal), checksum gap {gap:+.3e} (bound "
        f"{AUTO_CHECKSUM_GAP:g}); seconds in turns auto {seconds['auto']} vs all-pairs "
        f"{seconds['all_pairs']}")
    assert auto["res"].rays_traced == ap["res"].rays_traced, "sorting changed the ray count"
    assert abs(gap) <= AUTO_CHECKSUM_GAP, "auto and all-pairs checksums disagree"

    accel = ops_intersect.build_accel(sc)
    k4 = _loop_batch_k4(accel, *auto["batch"]["ext"])
    k5 = _loop_batch_k5(accel, *auto["batch"]["shadow"])
    return {
        "seconds": seconds, "iters": auto["iters"], "sort_s": auto["sort_s"],
        "K4 nearest_hit_culled": dict(launches_auto=la["K4 nearest_hit_culled"], loop_ms=k4[0],
                                      loop_k1_ms=k4[1], loop_bound_ms=k4[2],
                                      loop_k1_bound_ms=k4[3]),
        "K5 occluded_culled": dict(launches_auto=la["K5 occluded_culled"], loop_ms=k5[0],
                                   loop_k2_ms=k5[1], loop_bound_ms=k5[2], loop_k2_bound_ms=k5[3]),
    }


def run_cli(*args, timeout: float = 900.0):
    """``python -m monte_carlo_path_tracing_tpu_torch.cli`` with ``args`` on
    the card: (its last-line JSON, stdout, stderr, wall seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "monte_carlo_path_tracing_tpu_torch.cli", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"cli {' '.join(args[:2])} exited {r.returncode}:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stdout, r.stderr, wall


def cli_in_process(*args):
    """``cli.main(args)`` in this process, its output kept off stdout: (its
    last-line JSON, stdout, host seconds, kernel launches)."""
    buf = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    assert rc == 0, f"cli {' '.join(args[:2])} returned {rc}"
    return json.loads(buf.getvalue().strip().splitlines()[-1]), buf.getvalue(), seconds, launches


def phase_cli():
    """The CLI's --regen Veach render as a subprocess against the same
    command in-process; its fixed-depth render checkpointed and resumed as
    subprocesses against the uninterrupted command in-process. The
    in-process runs read the kernels' launches."""
    os.makedirs(WORK, exist_ok=True)
    out, ref_out = os.path.join(WORK, "v.npy"), os.path.join(WORK, "v_in_process.npy")
    argv = ("render", VEACH, "--regen", "--spp", str(CLI_SPP), "--max-depth", "16", "--lanes",
            str(LANES_CACHED))
    stats, _, _, wall = run_cli(*argv, "--out", out)
    ref, _, ref_wall, launches = cli_in_process(*argv, "--out", ref_out)
    a, b = np.load(out), np.load(ref_out)
    n_off = int((~np.isclose(a, b, rtol=CLI_RTOL, atol=CLI_ATOL)).sum())
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), CLI_ATOL)))
    log(f"[cli] render --regen veach {a.shape[1]}x{a.shape[0]} x {CLI_SPP} spp, depth 16: "
        f"subprocess {wall:.1f} s wall, the CLI's seconds {stats['seconds']:.2f}; in-process "
        f"{ref_wall:.1f} s wall, {ref['seconds']:.2f} s; {n_off} values beyond rtol "
        f"{CLI_RTOL:g} / atol {CLI_ATOL:g}, max relative gap {rel:.3e}; mean radiance "
        f"{stats['mean_radiance']:.6f}; launches in-process {launches}")
    assert a.shape == b.shape and np.isfinite(a).all(), "bad CLI image"
    assert all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}"
    assert n_off == 0, "the CLI's regen render differs from the in-process one"

    ck = os.path.join(WORK, "ck.npz")
    if os.path.exists(ck):
        os.remove(ck)
    s2, _, _, wall2 = run_cli("render", VEACH, "--spp", str(CLI_FD_SPP), "--checkpoint", ck,
                              "--checkpoint-every", "1")
    fd, ref_fd = os.path.join(WORK, "fd.npy"), os.path.join(WORK, "fd_in_process.npy")
    s3, stdout, _, wall3 = run_cli("render", VEACH, "--spp", str(CLI_FD_SPP + 1), "--checkpoint",
                                   ck, "--resume", "--out", fd)
    assert "resuming" in stdout, "the CLI did not resume from its checkpoint"
    ref, _, ref_wall, launches = cli_in_process("render", VEACH, "--spp", str(CLI_FD_SPP + 1),
                                                "--out", ref_fd)
    a, b = np.load(fd), np.load(ref_fd)
    n_off = int((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
    log(f"[cli] render (fixed depth 32) veach {a.shape[1]}x{a.shape[0]}: {CLI_FD_SPP} spp "
        f"checkpointed every spp {wall2:.1f} s wall (the CLI's seconds {s2['seconds']:.2f}), "
        f"resumed to {CLI_FD_SPP + 1} spp {wall3:.1f} s wall ({s3['seconds']:.2f}); "
        f"uninterrupted {CLI_FD_SPP + 1} spp in-process {ref_wall:.1f} s wall "
        f"({ref['seconds']:.2f}); {n_off} values beyond rtol 1e-5 / atol 1e-6; launches "
        f"in-process {launches}")
    assert all(launches[k] > 0 for k in list(KERNELS)[:3]), f"K1-K3 did not launch: {launches}"
    assert all(launches[k] == 0 for k in list(KERNELS)[3:]), f"a culled kernel ran: {launches}"
    assert np.isfinite(a).all() and n_off == 0, "the resumed image differs from the uninterrupted one"


def _timed_inverse_step(sc, cfg, lm, i):
    """One step of the inverse loop in-process: (forward s, backward s,
    peak bytes above the scene)."""
    n_pix = sc.camera.width * sc.camera.height
    k_step, idx = inverse.step_keys(0, i, INV_RAYS, n_pix, sc.device)
    ro, rd = generate_rays(sc.camera, idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = inverse.two_stream_loss(sc, lm, cfg, k_step, ro, rd)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for p in dgrad.latent_leaves(lm):
        p.grad = None
    return t1 - t0, t2 - t1, torch.cuda.max_memory_allocated() - base


def phase_inverse():
    """The CLI's inverse demo on cornell 256^2; one step timed in-process;
    recover_materials for 3 steps on the card against the CPU."""
    fams = inverse.FAMILIES
    stats, _, stderr, wall = run_cli("inverse", CORNELL, "--max-depth", "3", "--rays-per-step",
                                     str(INV_RAYS), "--steps", str(INV_STEPS), "--lr", "0.06",
                                     "--optimize", ",".join(fams))
    losses = [float(line.split()[-1]) for line in stderr.splitlines() if line.startswith("step ")]
    sc = load_scene(CORNELL)
    start = dgrad.from_latent(dgrad.to_latent(cli.perturb_materials(sc.materials, 0.2, fams)))
    kd0 = cli.material_errors(start, sc.materials)["kd_mae"]
    log(f"[inverse] cli inverse cornell 256^2, depth 3, {INV_RAYS} rays x {INV_STEPS} steps: "
        f"{wall:.1f} s wall; losses at steps 0, 10, 20: {losses}; {json.dumps(stats)}; kd_mae "
        f"at the perturbed start {kd0:.5f}")
    assert len(losses) == -(-INV_STEPS // 10) and all(np.isfinite(losses + [stats["final_loss"]]))
    assert stats["kd_mae"] < kd0, "the CLI's inverse demo did not lower kd_mae"

    cfg = RenderConfig(width=sc.camera.width, height=sc.camera.height, max_depth=3)
    lm = dgrad.LatentMaterials(*(x.clone().requires_grad_(True)
                                 for x in dgrad.latent_leaves(dgrad.to_latent(start))))
    steps = [_timed_inverse_step(sc, cfg, lm, i) for i in range(4)][1:]     # first: warm-up
    fwd, bwd = (statistics.median(x) * 1e3 for x in list(zip(*steps))[:2])
    peak = max(s[2] for s in steps)
    log(f"[inverse] one step in-process ({INV_RAYS} rays, three depth-3 renders, two under "
        f"autograd): forward {fwd:.1f} ms, backward {bwd:.1f} ms, {fwd + bwd:.1f} ms a step "
        f"(median of 3 after a warm-up); peak memory above the scene {peak / 2**20:.1f} MiB")

    small = with_res(load_scene(CORNELL, device="cpu"), INV_RES, INV_RES)
    init = cli.perturb_materials(small.materials, 0.2, fams)
    cfg = RenderConfig(width=INV_RES, height=INV_RES, max_depth=3)
    kw = dict(steps=3, lr=0.06, rays_per_step=INV_RES * INV_RES // 2, seed=1)
    reset_counters()
    t0 = time.perf_counter()
    card = inverse.recover_materials(small.to("cuda"), init, cfg, **kw)
    t1 = time.perf_counter()
    launches = counters()
    cpu = inverse.recover_materials(small, init, cfg, **kw)
    t2 = time.perf_counter()
    loss_gap = max(abs(a / b - 1.0) for a, b in zip(card.losses, cpu.losses))
    lat_gap = max(float((x.cpu() - y).abs().max()) for x, y in zip(
        dgrad.latent_leaves(dgrad.to_latent(card.materials)),
        dgrad.latent_leaves(dgrad.to_latent(cpu.materials))))
    log(f"[inverse] recover_materials cornell {INV_RES}^2, 3 steps: card {t1 - t0:.2f} s, cpu "
        f"{t2 - t1:.2f} s; losses {card.losses} vs {cpu.losses}, largest relative gap "
        f"{loss_gap:.3e} (bound {INV_LOSS_RTOL:g}); latents max abs gap {lat_gap:.3e} (bound "
        f"{INV_LATENT_ATOL:g}); launches on the card {launches}")
    assert all(launches[k] > 0 for k in list(KERNELS)[:3]), f"K1-K3 did not launch: {launches}"
    assert loss_gap <= INV_LOSS_RTOL and lat_gap <= INV_LATENT_ATOL, "card and CPU disagree"


def main():
    name, smi = phase_device()
    phase_build()
    scene_cpu = load_scene(VEACH, device="cpu")
    scene = with_res(scene_cpu, RES, RES).to("cuda")
    kernels = phase_kernels(scene) + phase_culled(scene)
    phase_end_to_end(scene, cached=False)
    launches, _ = phase_end_to_end(scene, cached=True)
    phase_two_devices(scene_cpu)
    fixed = phase_fixed_depth(scene, kernels)
    phase_gradient(scene_cpu)
    auto = phase_auto_cull()
    phase_cli()
    phase_inverse()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_fixed_depth"] = fixed[k["name"]]
        k.update(auto.get(k["name"], {}))
    kernels.sort(key=lambda k: k["name"])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
