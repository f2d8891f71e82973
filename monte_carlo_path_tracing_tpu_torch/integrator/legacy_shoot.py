"""Legacy ``shoot`` estimator (reference main.cpp:96-265, component C17).

Counterpart of ``monte_carlo_path_tracing_tpu/integrator/legacy_shoot.py``.
The reference's first estimator design: a path tracer that accumulates the
path pdf into an out-parameter ``px`` and shades with Blinn-Phong
(``kd (N.L) + ks (H.N)^ns``, main.cpp:250-254), importance-sampling the
bounce direction from the joint diffuse + specular CDF ``F(theta)``
inverted by Newton iteration (inverse_F_theta, main.cpp:32-55) with a
Simpson-rule normalisation ``M`` (cal_M, main.cpp:75-86) and horizon
rejection (main.cpp:215-222). All its call sites are commented out in the
reference; it is kept for inventory parity as ``estimator="shoot"``.

One sample is ``shoot(eye, dir, px=1)`` and its value ``I / px``
(main.cpp:522-536, 571). Per vertex: trace (miss or backface -> 0); q, the
mean of the six Kd / Ks channels clamped to 1; with probability 1 - q
terminate on a uniform-area light sample (px *= its pdf; the light counts
when it is above the horizon and the shadow ray's nearest hit is the
sampled triangle), else continue along a joint-CDF direction (px *= its
pdf, throughput *= Blinn-Phong factor / q). The recursion is a chain, so
it runs as a bounded wavefront like the other estimators; the rejection
loop is capped at ``_MAX_REJECT`` draws and Newton runs ``_NEWTON_ITERS``
iterations with a convergence freeze. Both traces per vertex (extension
and shadow) are nearest hits: K1 on CUDA tensors, its plain version on CPU
tensors.
"""

from __future__ import annotations

import math

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.integrator import common
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.sampling import light_uniform
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

_NEWTON_ITERS = 24
_MAX_REJECT = 16
_SIMPSON_N = 100        # intervals (cal_M, main.cpp:77)
_EPS = 1e-8             # the reference's eps (vec.h:7, main.cpp:59)

# Purpose tags past core/rng.py's, as in the JAX package.
_P_Q = 16               # continue-or-terminate draw (main.cpp:131)
_P_THETA = 17           # ksi1, its rejection redraws included (171, 219)
_P_PHI = 18             # ksi2 (175)


def _inverse_F_theta(x, y, n, ksi):
    """Newton inversion of the joint CDF (inverse_F_theta, main.cpp:32-55):
    F(th) = 1 - [x (n+1) cos th + y cos^(n+1) th] / (x (n+1) + y) = ksi,
    from th = pi/4, with each lane frozen once |F| < 1e-7 and th clamped
    into [1e-6, pi/2]; ksi <= 0 gives 0 and ksi >= 1 gives pi/2."""
    denom = torch.clamp(x * (n + 1.0) + y, min=1e-20)
    th = torch.full_like(ksi, 0.25 * math.pi)
    for _ in range(_NEWTON_ITERS):
        # f32 cos(pi/2) is a tiny negative number, NaN under a fractional
        # power: clamp.
        c = torch.clamp(torch.cos(th), min=0.0)
        F = 1.0 - ksi - (x * (n + 1.0) * c + y * c ** (n + 1.0)) / denom
        f = (n + 1.0) * torch.sin(th) * (x + y * c ** n) / denom
        step = F / torch.clamp(f, min=1e-12)
        th_new = torch.clamp(th - step, 1e-6, 0.5 * math.pi)
        th = torch.where(torch.abs(F) < 1e-7, th, th_new)
    th = torch.where(ksi <= 0.0, torch.zeros_like(th), th)
    return torch.where(ksi >= 1.0, torch.full_like(th, 0.5 * math.pi), th)


def _theta0(a1, a2, a3, phi):
    """Horizon angle in the R frame (cal_theta0, main.cpp:57-64)."""
    d = a1 * torch.cos(phi) + a2 * torch.sin(phi)
    degenerate = (torch.abs(a1) < _EPS) & (torch.abs(a2) < _EPS)
    th0 = torch.atan(-a3 / torch.where(torch.abs(d) < 1e-20, torch.full_like(d, 1e-20), d))
    return torch.where(degenerate, torch.full_like(th0, 0.5 * math.pi), th0)


def _cal_M(x, y, n, a1, a2, a3):
    """Simpson normalisation (cal_M, main.cpp:75-86): M = 1 / (1 - c2 S),
    c2 = 1 / (2 pi (x + y / (n+1))), S = int_0^pi [x cos th0(phi) +
    y cos^(n+1) th0(phi) / (n+1)] dphi, over [N] lanes x 3 * _SIMPSON_N
    nodes (left, middle, right of each interval, weights h/6, 4h/6, h/6)."""
    h = math.pi / _SIMPSON_N
    i = torch.arange(_SIMPSON_N, dtype=torch.float32, device=x.device)
    phis = torch.cat([i * h, (i + 0.5) * h, (i + 1.0) * h])
    wts = torch.cat([torch.full_like(i, h / 6.0), torch.full_like(i, 4.0 * h / 6.0),
                     torch.full_like(i, h / 6.0)])
    th0 = _theta0(a1[:, None], a2[:, None], a3[:, None], phis[None, :])
    c0 = torch.clamp(torch.cos(th0), min=0.0)
    f = x[:, None] * c0 + y[:, None] * c0 ** (n[:, None] + 1.0) / (n[:, None] + 1.0)
    S = (f * wts[None, :]).sum(dim=-1)
    c2 = 1.0 / torch.clamp(2.0 * math.pi * (x + y / (n + 1.0)), min=1e-20)
    return 1.0 / torch.clamp(1.0 - c2 * S, min=1e-6)


def _r_frame(ns, l):
    """The frame about the mirror direction R (main.cpp:185-206): columns
    (N x l)^, (R x (N x l)^)^ and R; where l is parallel to N, the
    reference's ad-hoc N frame (tmp = N + (5, 0, 0), main.cpp:189-197).
    The test |N x l| < 1e-5 sits above f32's rounding floor (the reference
    tests 1e-8 in f64)."""
    nxl = vm.cross(ns, l)
    degen = (vm.norm(nxl) < 1e-5)[:, None]
    r = vm.normalize(2.0 * vm.dot(ns, l)[:, None] * ns - l)
    tmp = ns + torch.tensor([5.0, 0.0, 0.0], device=ns.device)
    yv_d = vm.normalize(vm.cross(ns, tmp))
    xv_d = vm.normalize(vm.cross(yv_d, ns))
    r_safe = torch.where(degen, ns, r)
    xcol = torch.where(degen, xv_d, vm.normalize(nxl))
    ycol = torch.where(degen, yv_d, vm.normalize(vm.cross(r_safe, xcol)))
    return xcol, ycol, r_safe


def render_rays_shoot(scene: Scene, cfg: RenderConfig, key: torch.Tensor, ro: torch.Tensor,
                      rd: torch.Tensor, with_stats: bool = False, row_offset: int = 0):
    """Radiance [N,3] per ray by the legacy shoot estimator: ``I / px``
    (main.cpp:571). ``key`` is [N,2] lane keys or a scalar [2] key, whose
    draws start at row ``row_offset`` (as in ``wavefront.render_rays``).
    ``with_stats=True`` also returns {"rays": traced rays (int64 tensor),
    "px": the accumulated path pdf, "steps": each chain's length}."""
    accel = ops_intersect.build_accel(scene)
    tri_to_light = common.light_index_table(scene)
    N, dev = ro.shape[0], ro.device
    r0 = row_offset

    def uniform(k):
        return rng.uniform(k, (N,), row_offset=r0)

    active = torch.ones(N, dtype=torch.bool, device=dev)
    excl = torch.full((N,), ops_intersect.NO_HIT, dtype=torch.int32, device=dev)
    tp = torch.ones((N, 3), device=dev)
    px = torch.ones(N, device=dev)
    L = torch.zeros((N, 3), device=dev)
    steps = torch.zeros(N, dtype=torch.int32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(cfg.max_depth):
        if d and not bool(active.any()):
            break
        hit = ops_intersect.intersect(accel, ro, rd, excl)
        nrays = nrays + active.sum()
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front       # miss / backface -> 0 (100-112)
        steps = steps + alive.to(torch.int32)

        # q: the clamped mean of the six Kd / Ks channels (main.cpp:124-125).
        q = torch.clamp((si.kd.sum(-1) + si.ks.sum(-1)) / 6.0, max=1.0)
        terminate = uniform(rng.bounce_key(key, d, _P_Q)) >= q    # ksi >= q (134)

        # ---- terminal branch: uniform-area light sample (main.cpp:136-159)
        ls = light_uniform.sample(rng.bounce_key(key, d, rng.P_LIGHT_SELECT), scene, N, r0)
        wl_raw = ls.coord - si.p
        dist = torch.clamp(vm.norm(wl_raw), min=1e-12)
        wl = wl_raw / dist[:, None]
        cos_l = vm.dot(wl, si.ns)
        # Visible when the shadow ray's nearest hit is the sampled triangle (151).
        sh = ops_intersect.intersect(accel, si.p, wl, si.tri_id)
        term_now = alive & terminate
        nrays = nrays + term_now.sum()
        vis = (cos_l >= 0.0) & sh.valid & (sh.tri_id == ls.tri_id)
        Ii = torch.where(vis[:, None], ls.emission, torch.zeros_like(ls.emission))
        # Blinn-Phong at this vertex with L = the light direction (250-254),
        # unclamped as in the reference.
        h_t = vm.normalize(wl + si.wo)
        fac_term = si.kd * cos_l[:, None] + si.ks * (
            torch.clamp(vm.dot(h_t, si.ns), min=0.0) ** si.ns_exp)[:, None]
        L = L + torch.where(term_now[:, None], tp * fac_term * Ii, torch.zeros_like(L))
        px = torch.where(term_now, px * torch.clamp(ls.pdf, min=1e-30).detach(), px)

        # ---- continue branch: joint-CDF direction (main.cpp:163-241)
        l = si.wo
        x = si.kd.sum(-1) * vm.dot(si.ns, l)                      # (167)
        y = si.ks.sum(-1)                                           # (168)
        n_exp = si.ns_exp
        xcol, ycol, zcol = _r_frame(si.ns, l)
        # na = T^T N (main.cpp:206): the rows of T^T are T's columns.
        a1, a2, a3 = vm.dot(xcol, si.ns), vm.dot(ycol, si.ns), vm.dot(zcol, si.ns)
        phi = 2.0 * math.pi * uniform(rng.bounce_key(key, d, _P_PHI))
        th0 = _theta0(a1, a2, a3, phi)

        # theta, redrawn while theta > theta0 when phi is in (0, pi)
        # (212-222), at most _MAX_REJECT draws; draw t folds t into k_th.
        reject_applies = (phi > 0.0) & (phi < math.pi)
        k_th = rng.bounce_key(key, d, _P_THETA)
        theta = torch.zeros(N, device=dev)
        settled = torch.zeros(N, dtype=torch.bool, device=dev)
        for t in range(_MAX_REJECT):
            cand = _inverse_F_theta(x, y, n_exp, uniform(rng.fold_in(k_th, t)))
            theta = torch.where(settled, theta, cand)
            settled = settled | ~(reject_applies & (theta > th0))

        M = _cal_M(x, y, n_exp, a1, a2, a3)
        cos_t = torch.clamp(torch.cos(theta), min=0.0)
        sin_t = torch.sin(theta)
        prob = ((x + y * cos_t ** n_exp) * sin_t
                / torch.clamp(2.0 * math.pi * (x + y / (n_exp + 1.0)), min=1e-20) * M)
        local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
        v = vm.normalize(vm.from_local(local, xcol, ycol, zcol))

        cont = alive & ~terminate & (prob > 1e-12) & (q > 1e-6)
        px = torch.where(cont, px * torch.clamp(prob, min=1e-12).detach(), px)
        # The vertex factor with L = v, and the 1/q weight (238, 250-254).
        h_c = vm.normalize(v + si.wo)
        fac_cont = si.kd * vm.dot(si.ns, v)[:, None] + si.ks * (
            torch.clamp(vm.dot(h_c, si.ns), min=0.0) ** n_exp)[:, None]
        tp = torch.where(cont[:, None],
                         tp * fac_cont / torch.clamp(q, min=1e-6).detach()[:, None], tp)
        active, ro, rd, excl = cont, si.p, v, hit.tri_id

    out = L / torch.clamp(px, min=1e-30)[:, None]
    if with_stats:
        return out, {"rays": nrays, "px": px, "steps": steps}
    return out
