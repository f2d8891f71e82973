"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Usage (from the repository root, on a machine with an NVIDIA Hopper GPU):

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, and the process
exits non-zero without printing a result:

1. device: the GPU's name and power limit; TF32 off;
2. build: compile the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a);
3. kernels: K1 (nearest hit), K2 (any hit) and K3 (Arvo light pick)
   against their plain torch versions on the card, at the loop's shapes
   (Veach MIS, 32,768 rays / shading points), with median times;
4. culled kernels: K4 (culled nearest hit) and K5 (culled any hit) on the
   batches one primary-prepass chunk hands them (the camera fan of rows
   480-511 of the 1024^2 camera, and its 8 rounds of depth-0 shadow rays),
   against their plain versions and against K1 / K2 on the same rays, with
   median times; K5 also on that shadow batch with t_max moved past each
   ray's first hit, so that its flags are a mix and some ray tiles are all
   blocked;
5. end to end, uncached: the Veach MIS render at the bench's uncached
   configuration (1024^2, 8 spp, MIS + spherical-triangle NEE, depth 16,
   seed 0, 32,768 lanes) through ``render_image_regen`` with
   ``primary_cache=False``; K1-K3 must launch; checksum and ray count are
   held against the values recorded for the same streams;
6. end to end, cached (the main path): the same render with the default
   ``primary_cache``, which routes to the primary-hit cache; all five
   kernels must launch; checksum and ray count held as in 5;
7. two devices: the same entry point renders Veach at 64^2, 4 spp on the
   card and on the CPU, uncached and cached; ray counts and images agree.

The last lines are a JSON object of per-kernel results, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import common, regen
from monte_carlo_path_tracing_tpu_torch.ops import _build, arvo_cuda, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.render.camera import (
    camera_basis, pixel_len, primary_dirs,
)
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.sampling import light_spherical, phong
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

ROOT = os.path.dirname(os.path.abspath(__file__))
VEACH = os.path.join(ROOT, "scenes", "veach-mis", "veach-mis.obj")

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
#: Main-path batch: rays per extension / shadow trace, points per NEE pick.
N_MAIN = 1 << 15
#: The prepass chunk whose batches the culled kernels are checked on:
#: pixel rows [480, 512) of the 1024^2 camera (one 32,768-pixel chunk).
FAN_ROW0, FAN_ROWS = 480, 32


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


def main_path_inputs(scene, accel):
    """32,768 rays of the main path (half camera rays of the bench's 1024^2
    camera, half BRDF bounces leaving their hit points), and the shading
    points where those rays land — traced with the plain version."""
    dev = scene.device
    half = N_MAIN // 2
    gen = np.random.default_rng(0)
    cam = scene.camera
    u, v, n, dist = camera_basis(cam)
    gpix = torch.as_tensor(gen.integers(0, cam.width * cam.height, half), device=dev)
    ro0, rd0 = primary_dirs(cam, u, v, n, dist, pixel_len(cam, dist), gpix)
    excl0 = torch.full((half,), -1, dtype=torch.int32, device=dev)
    tri_to_light = common.light_index_table(scene)
    W, ids = accel.W, accel.tri_ids
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


def phase_kernels(scene):
    """K1-K3 against their plain versions on the card at main-path shapes."""
    dev = scene.device
    accel = ops_intersect.build_accel(scene)
    ro, rd, excl, hit, si = main_path_inputs(scene, accel)
    W, ids = accel.W, accel.tri_ids
    g = ops_intersect.ray_features(ro, rd).contiguous()
    ok = hit.valid
    log(f"[kernels] veach: {scene.num_tris} triangles ({W.shape[0]} padded), "
        f"{scene.num_lights} lights; {g.shape[0]} rays, {int(ok.sum())} hit")
    out = []

    # K1: nearest hit.
    hk = intersect_cuda.nearest_hit(g, W, ids, excl)
    hp = intersect_cuda.nearest_hit_plain(g, W, ids, excl)
    torch.cuda.synchronize()
    same = hk.tri_id == hp.tri_id
    n_diff = int((~same).sum())
    m = same & hk.valid
    err = max(float((hk.t - hp.t)[m].abs().max()), float((hk.u - hp.u)[m].abs().max()),
              float((hk.v - hp.v)[m].abs().max()))
    log(f"[kernels] K1 ids differ on {n_diff} of {g.shape[0]} rays (fringe bound 0.1%); "
        f"max |dt|,|du|,|dv| on equal ids {err:.3g} (bound 1e-5 rel)")
    assert n_diff <= g.shape[0] // 1000, "K1 disagrees with its plain version"
    for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)):
        torch.testing.assert_close(a[m], b[m], rtol=1e-5, atol=1e-6)
    ms = time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl))
    pms = time_ms(lambda: intersect_cuda.nearest_hit_plain(g, W, ids, excl), reps=5)
    log(f"[kernels] K1 {ms:.3f} ms, plain {pms:.3f} ms")
    out.append(dict(name="K1 nearest_hit", route="cuda",
                    source="monte_carlo_path_tracing_tpu_torch/csrc/intersect.cu",
                    replaces="monte_carlo_path_tracing_tpu/ops/intersect_pallas.py:299",
                    max_abs_err=err, ms=ms, plain_ms=pms))

    # K3: Arvo light pick at the shading points where those rays landed.
    C = arvo_cuda.pack_consts(scene)
    x1, nrm = si.p.contiguous(), si.ns.contiguous()
    u = rng.uniform(rng.fold_in(rng.base_key(2, device=dev), torch.arange(N_MAIN, device=dev)),
                    (N_MAIN,))
    ik, wk = arvo_cuda.arvo_select(C, x1, nrm, u)
    ip, wp = arvo_cuda.arvo_select_plain(C, x1, nrm, u)
    torch.cuda.synchronize()
    n_diff = int((ik != ip).sum())
    err = float((wk - wp).abs().max())
    log(f"[kernels] K3 picks differ on {n_diff} of {N_MAIN} points (CDF-boundary fringe, "
        f"bound 0.1%); wsum max abs err {err:.3g} (rtol 1e-5)")
    assert n_diff <= N_MAIN // 1000, "K3 disagrees with its plain version"
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-6)
    ms = time_ms(lambda: arvo_cuda.arvo_select(C, x1, nrm, u))
    pms = time_ms(lambda: arvo_cuda.arvo_select_plain(C, x1, nrm, u), reps=5)
    log(f"[kernels] K3 {ms:.3f} ms, plain {pms:.3f} ms")
    k3 = dict(name="K3 arvo_select", route="cuda",
              source="monte_carlo_path_tracing_tpu_torch/csrc/arvo.cu",
              replaces="monte_carlo_path_tracing_tpu/ops/arvo_pallas.py:111",
              max_abs_err=err, ms=ms, plain_ms=pms)

    # K2: NEE shadow rays from those points to Arvo-sampled light points.
    ls, _ = light_spherical.sample(rng.fold_in(rng.base_key(3, device=dev), torch.arange(N_MAIN, device=dev)),
                                   scene, x1, nrm, consts=C)
    wl_raw = ls.coord - si.p
    dist = torch.sqrt(torch.clamp((wl_raw * wl_raw).sum(-1), min=1e-20))
    wl = (wl_raw / dist[:, None]).contiguous()
    gs = ops_intersect.ray_features(x1, wl).contiguous()
    tmax = (dist * (1.0 - ops_intersect.OCCLUSION_MARGIN)).contiguous()
    sexcl = si.tri_id.contiguous()
    bk = intersect_cuda.occluded(gs, W, ids, sexcl, tmax)
    bp = intersect_cuda.occluded_plain(gs, W, ids, sexcl, tmax)
    torch.cuda.synchronize()
    n_diff = int((bk != bp).sum())
    log(f"[kernels] K2 flags differ on {n_diff} of {N_MAIN} shadow rays (bound 0.1%); "
        f"{float(bp.float().mean()):.3f} blocked")
    assert n_diff <= N_MAIN // 1000, "K2 disagrees with its plain version"
    ms = time_ms(lambda: intersect_cuda.occluded(gs, W, ids, sexcl, tmax))
    pms = time_ms(lambda: intersect_cuda.occluded_plain(gs, W, ids, sexcl, tmax), reps=5)
    log(f"[kernels] K2 {ms:.3f} ms, plain {pms:.3f} ms")
    out.append(dict(name="K2 occluded", route="cuda",
                    source="monte_carlo_path_tracing_tpu_torch/csrc/intersect.cu",
                    replaces="monte_carlo_path_tracing_tpu/ops/intersect_pallas.py:328",
                    max_abs_err=float((bk.float() - bp.float()).abs().max()), ms=ms, plain_ms=pms))
    out.append(k3)
    return out


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
    """K5 against its plain version and against K2 on one shadow batch;
    returns (flags differing from plain, blocked share, args of the call)."""
    W, ids = accel.W, accel.tri_ids
    n = ro.shape[0]
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl, scaled)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    bk = intersect_cuda.occluded_culled(*args)
    bp = intersect_cuda.occluded_culled_plain(*args)
    b2 = intersect_cuda.occluded(ops_intersect.ray_features(ro, rd).contiguous(), W, ids,
                                 excl, scaled)
    torch.cuda.synchronize()
    n_diff = int((bk != bp).sum())
    n_k2 = int((bk[:n] != b2).sum())
    tiles = torch.cat([b2, b2.new_zeros(c.g.shape[0] - n)]).view(c.order.shape[0], -1)
    share = float(b2.float().mean())
    log(f"[culled] K5 {tag}: {n} shadow rays, {share:.3f} blocked, "
        f"{int(tiles.all(dim=1).sum())} of {tiles.shape[0]} ray tiles all blocked; "
        f"{float((c.te < 1.5e38).float().mean()):.3f} of tile pairs not culled; flags differ "
        f"from plain on {n_diff} (bound 0.1%), from K2 on {n_k2} (bound 0.1%)")
    assert n_diff <= c.g.shape[0] // 1000, f"K5 disagrees with its plain version ({tag})"
    assert n_k2 <= n // 1000, f"K5 disagrees with K2 ({tag})"
    return n_diff, share, tiles, args


def phase_culled(scene):
    """K4 / K5 against their plain versions and K1 / K2 on one prepass
    chunk's batches; median times."""
    accel = ops_intersect.build_accel(scene)
    W, ids = accel.W, accel.tri_ids
    (ro, rd), (sp, wl, dist, sexcl) = prepass_batches(scene, main_cfg())
    out = []

    # K4 on the camera fan.
    n = ro.shape[0]
    excl = torch.full((n,), ops_intersect.NO_HIT, dtype=torch.int32, device=ro.device)
    g = ops_intersect.ray_features(ro, rd).contiguous()
    h1 = intersect_cuda.nearest_hit(g, W, ids, excl)
    c = ops_intersect.culled_call(accel, slice(None), ro, rd, excl)
    args = (c.g, c.W, c.tri_ids, c.excl, c.bound, c.order, c.te)
    hk = intersect_cuda.nearest_hit_culled(*args)
    hp = intersect_cuda.nearest_hit_culled_plain(*args)
    torch.cuda.synchronize()
    n_diff, err = _compare_hits(hk, hp)
    hk = ops_intersect.Hit(*(x[:n] for x in (hk.t, hk.tri_id, hk.u, hk.v, hk.valid)))
    n_k1, err_k1 = _compare_hits(hk, h1)
    log(f"[culled] K4: {n} fan rays, {c.order.shape[0]} x {c.order.shape[1]} tiles, "
        f"{float((c.te < 1.5e38).float().mean()):.3f} not culled; ids differ from plain on "
        f"{n_diff} (bound 0.1%), max err {err:.3g}; from K1 on {n_k1} (bound 0.1%), "
        f"max err {err_k1:.3g}")
    assert n_diff <= c.g.shape[0] // 1000, "K4 disagrees with its plain version"
    assert n_k1 <= n // 1000, "K4 disagrees with K1"
    ms = time_ms(lambda: intersect_cuda.nearest_hit_culled(*args))
    pms = time_ms(lambda: intersect_cuda.nearest_hit_culled_plain(*args), reps=5)
    k1ms = time_ms(lambda: intersect_cuda.nearest_hit(g, W, ids, excl))
    log(f"[culled] K4 {ms:.3f} ms, plain {pms:.3f} ms; K1 on the same rays {k1ms:.3f} ms")
    out.append(dict(name="K4 nearest_hit_culled", route="cuda",
                    source="monte_carlo_path_tracing_tpu_torch/csrc/intersect.cu",
                    replaces="monte_carlo_path_tracing_tpu/ops/intersect_pallas.py:175",
                    max_abs_err=err, ms=ms, plain_ms=pms))

    # K5 on the chunk's depth-0 shadow batch, as the prepass hands it over.
    # No ray of it is blocked (Veach's lights see the plates unobstructed),
    # so K5 is also held on the same origins and directions with t_max
    # moved past the first hit along the ray (K1's t): x2 in even ray
    # tiles, which blocks every ray that hits anything and so takes K5's
    # all-blocked exit, and x U[0, 2) in odd ones, a mix of both answers.
    sexcl = sexcl.to(torch.int32).contiguous()
    scaled = (dist * (1.0 - ops_intersect.OCCLUSION_MARGIN)).to(torch.float32).contiguous()
    gs = ops_intersect.ray_features(sp, wl).contiguous()
    d_main, _, _, args = _check_k5(accel, sp, wl, sexcl, scaled, "prepass batch")
    n = sp.shape[0]
    t_hit = intersect_cuda.nearest_hit(gs, W, ids, sexcl)
    f = torch.as_tensor(np.random.default_rng(5).uniform(0.0, 2.0, n), dtype=torch.float32,
                        device=sp.device)
    f = torch.where((torch.arange(n, device=sp.device) // intersect_cuda.RAY_TILE) % 2 == 0,
                    2.0, f)
    moved = torch.where(t_hit.valid, t_hit.t * f, scaled).contiguous()
    d_moved, share, tiles, _ = _check_k5(accel, sp, wl, sexcl, moved, "t_max past the hit")
    assert 0.05 <= share <= 0.95, f"moved-t_max batch blocked share {share:.3f}, want a mix"
    assert bool(tiles.all(dim=1).any()), "no ray tile all blocked: K5's exit never ran"
    ms = time_ms(lambda: intersect_cuda.occluded_culled(*args))
    pms = time_ms(lambda: intersect_cuda.occluded_culled_plain(*args), reps=5)
    k2ms = time_ms(lambda: intersect_cuda.occluded(gs, W, ids, sexcl, scaled))
    log(f"[culled] K5 (prepass batch) {ms:.3f} ms, plain {pms:.3f} ms; K2 on the same rays "
        f"{k2ms:.3f} ms")
    out.append(dict(name="K5 occluded_culled", route="cuda",
                    source="monte_carlo_path_tracing_tpu_torch/csrc/intersect.cu",
                    replaces="monte_carlo_path_tracing_tpu/ops/intersect_pallas.py:229",
                    max_abs_err=float(d_main + d_moved > 0), ms=ms, plain_ms=pms))
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


def main():
    name, smi = phase_device()
    phase_build()
    scene_cpu = load_scene(VEACH)
    scene = with_res(scene_cpu, RES, RES).to("cuda")
    kernels = phase_kernels(scene) + phase_culled(scene)
    phase_end_to_end(scene, cached=False)
    launches, _ = phase_end_to_end(scene, cached=True)
    phase_two_devices(scene_cpu)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    kernels.sort(key=lambda k: k["name"])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
