"""The plain reference path tracer: Veach MIS with Arvo spherical-triangle
next-event estimation, Phong BRDF sampling and Russian roulette.

Plain PyTorch, in one float dtype throughout (float32 for the check,
bfloat16 for its control). It traces each (spp round, pixel) path on its
own, depth by depth, until Russian roulette, a miss, a back face or a light
ends it, with no lanes, regeneration, caches or kernels. Every draw comes
from the path's own stream,

    fold(fold(fold(fold(round key, pixel), depth), purpose), 0 or 1),

so the reference and the program trace the same paths and an image they
agree on is the same estimate, not two estimates of one integral.

Intersection is Moller-Trumbore, each ray-triangle test four bilinear
forms of the ray's features [o, d, o x d, 1]: one matrix product of the
rays' features and the triangles' coefficients (TF32 off), then the
accept rules |det| > 1e-9, u, v >= 0, u + v <= |det|, t > 1e-4 |det| and
the excluded triangle id. A shadow ray is blocked by an accepted hit below
its length times (1 - 1e-3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import threefry as tf
from benchmark.reference.scene import RefScene

DET_EPS, T_EPS, BIG_T = 1e-9, 1e-4, 3.0e38
OCCLUSION_MARGIN = 1e-3
ARVO_EPS = 1e-6
_CLAMP = 1.0 - 1e-7


# --------------------------------------------------------------- vectors

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def normalize(a, eps=1e-20):
    sq = dot(a, a)[..., None]
    inv = torch.reciprocal(torch.sqrt(torch.clamp(sq, min=eps)))
    return a * torch.where(sq > eps, inv, torch.zeros_like(inv))


def reflect(w, n):
    return 2.0 * dot(w, n)[..., None] * n - w


# ----------------------------------------------------------- intersection

class Accel(NamedTuple):
    """Triangle coefficients in blocks: each [10, 4 * nb], columns det, u,
    v and t numerators of nb triangles, and their first id."""

    blocks: list
    starts: list


def build_accel(sc: RefScene, block: int = 8192) -> Accel:
    v0, e1, e2 = sc.v0, sc.e1, sc.e2
    W = torch.zeros((sc.num_tris, 10, 4), dtype=v0.dtype, device=v0.device)
    n = cross(e1, e2)
    W[:, 3:6, 0] = cross(e2, e1)
    W[:, 3:6, 1] = cross(v0, e2)
    W[:, 6:9, 1] = e2
    W[:, 3:6, 2] = cross(e1, v0)
    W[:, 6:9, 2] = -e1
    W[:, 0:3, 3] = n
    W[:, 9, 3] = -dot(v0, n)
    blocks, starts = [], []
    for b0 in range(0, sc.num_tris, block):
        Wb = W[b0:b0 + block]                               # [nb, 10, 4]
        blocks.append(Wb.permute(1, 2, 0).reshape(10, -1).contiguous())
        starts.append(b0)
    return Accel(blocks, starts)


def _features(ro, rd):
    one = torch.ones_like(ro[:, :1])
    return torch.cat([ro, rd, cross(ro, rd), one], dim=1)


def _accepted(g, Wb, b0, excl):
    """(det, u and v numerators, sign-fixed t numerator, |det|, accepted) of
    rays g against one block."""
    nb = Wb.shape[1] // 4
    Y = g @ Wb
    det, un, vn, tn = Y[:, :nb], Y[:, nb:2 * nb], Y[:, 2 * nb:3 * nb], Y[:, 3 * nb:]
    s = torch.sign(det)
    adet = det.abs()
    up, vp = un * s, vn * s
    ids = torch.arange(b0, b0 + nb, device=g.device)
    ok = ((adet > DET_EPS) & (up >= 0.0) & (vp >= 0.0) & (up + vp <= adet)
          & (tn * s > T_EPS * adet) & (ids[None, :] != excl[:, None]))
    return det, un, vn, tn * s, adet, ok


def nearest(acc: Accel, ro, rd, excl, rows: int = 8192):
    """(t, tri id (-1: miss), u, v) of the nearest accepted hit of each ray."""
    n, dev, dt = ro.shape[0], ro.device, ro.dtype
    t_out = torch.full((n,), BIG_T, dtype=dt, device=dev)
    i_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_out = torch.zeros(n, dtype=dt, device=dev)
    v_out = torch.zeros(n, dtype=dt, device=dev)
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        g = _features(ro[sl], rd[sl])
        bt = torch.full((g.shape[0],), BIG_T, dtype=dt, device=dev)
        bi = torch.full((g.shape[0],), -1, dtype=torch.int64, device=dev)
        bu, bv = torch.zeros_like(bt), torch.zeros_like(bt)
        for Wb, b0 in zip(acc.blocks, acc.starts):
            det, un, vn, tp, adet, ok = _accepted(g, Wb, b0, excl[sl])
            t = torch.where(ok, tp / torch.where(ok, adet, torch.ones_like(adet)),
                            torch.full_like(tp, BIG_T))
            tmin, col = t.min(dim=1)
            better = tmin < bt
            d = det.gather(1, col[:, None])[:, 0]
            inv = 1.0 / torch.where(d.abs() > 0, d, torch.ones_like(d))
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, b0 + col, bi)
            bu = torch.where(better, un.gather(1, col[:, None])[:, 0] * inv, bu)
            bv = torch.where(better, vn.gather(1, col[:, None])[:, 0] * inv, bv)
        t_out[sl], i_out[sl], u_out[sl], v_out[sl] = bt, bi, bu, bv
    return t_out, i_out, u_out, v_out


def occluded(acc: Accel, ro, rd, t_max, excl, rows: int = 8192):
    """[N] bool: an accepted hit lies below t_max (1 - margin)."""
    out = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    lim = t_max * (1.0 - OCCLUSION_MARGIN)
    for r0 in range(0, ro.shape[0], rows):
        sl = slice(r0, r0 + rows)
        g = _features(ro[sl], rd[sl])
        for Wb, b0 in zip(acc.blocks, acc.starts):
            _, _, _, tp, adet, ok = _accepted(g, Wb, b0, excl[sl])
            out[sl] |= (ok & (tp < lim[sl, None] * adet)).any(dim=1)
    return out


# ------------------------------------------------------------------ Phong

def _lobe_probs(kd, ks):
    wd = (kd[..., 0] + kd[..., 1] + kd[..., 2]) / 3.0
    ws = (ks[..., 0] + ks[..., 1] + ks[..., 2]) / 3.0
    tot = wd + ws
    pd = torch.where(tot > 0, wd / torch.where(tot > 0, tot, torch.ones_like(tot)),
                     torch.ones_like(tot))
    return pd, 1.0 - pd


def _pow(x, n):
    """x**n for x >= 0, with 0**n = 0."""
    return torch.where(x > 0.0, torch.exp(n * torch.log(torch.clamp(x, min=1e-30))),
                       torch.zeros_like(x))


def _spec(n, w, r, ns):
    return (ns + 1.0) * (1.0 / (2.0 * math.pi)) * _pow(torch.clamp(dot(w, r), min=0.0), ns)


def brdf(n, wi, wo, kd, ks, ns):
    """Phong f_r = Kd / pi + Ks (Ns + 1) / (2 pi) max(wo . reflect(wi), 0)^Ns."""
    return kd * (1.0 / math.pi) + ks * _spec(n, wo, reflect(wi, n), ns)[..., None]


def brdf_pdf(n, wi, wo, kd, ks, ns):
    """The two-lobe mixture density of wi given wo."""
    pd, ps = _lobe_probs(kd, ks)
    return (pd * torch.clamp(dot(wi, n), min=0.0) * (1.0 / math.pi)
            + ps * _spec(n, wi, reflect(wo, n), ns))


def _basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1),
            torch.stack([b, s + ny * ny * a, -ny], dim=-1))


def sample_brdf(key, n, wo, kd, ks, ns, dt):
    """(wi, pdf): the lobe by mean(Kd) : mean(Ks), then a cosine-hemisphere
    or a Phong-lobe warp about the mirror direction."""
    xi_lobe = tf.uniform(tf.fold_in(key, 0))[:, 0].to(dt)
    xi = tf.uniform(tf.fold_in(key, 1), 2).to(dt)
    pd, _ = _lobe_probs(kd, ks)
    spec = xi_lobe >= pd
    cos_d = torch.sqrt(torch.clamp(1.0 - xi[:, 0], min=0.0))
    sin_d = torch.sqrt(torch.clamp(xi[:, 0], min=0.0))
    cos_s = _pow(xi[:, 0], 1.0 / (ns + 1.0))
    sin_s = torch.sqrt(torch.clamp(1.0 - cos_s * cos_s, min=0.0))
    phi = 2.0 * math.pi * xi[:, 1]
    cos_t, sin_t = torch.where(spec, cos_s, cos_d), torch.where(spec, sin_s, sin_d)
    axis = torch.where(spec[:, None], reflect(wo, n), n)
    t, b = _basis(axis)
    wi = ((sin_t * torch.cos(phi))[:, None] * t + (sin_t * torch.sin(phi))[:, None] * b
          + cos_t[:, None] * axis)
    return wi, brdf_pdf(n, wi, wo, kd, ks, ns)


# --------------------------------------------------- Arvo light sampling

class Lights(NamedTuple):
    pa: torch.Tensor       # [L, 3]
    pb: torch.Tensor
    pc: torch.Tensor
    nl: torch.Tensor       # [L, 3]
    em: torch.Tensor       # [L, 3]
    l_sum: torch.Tensor    # [L] R + G + B


def lights_of(sc: RefScene) -> Lights:
    i = sc.light_tri
    pa = sc.v0[i]
    em = sc.emission[i]
    return Lights(pa, pa + sc.e1[i], pa + sc.e2[i], sc.gn[i], em,
                  em[:, 0] + em[:, 1] + em[:, 2])


def _solid_angle(x, n, pa, pb, pc, nl):
    """(sA, seen): Van Oosterom-Strackee solid angle of the triangles from
    x, and the culls: x strictly in front of the light, some vertex above
    the tangent plane of n."""
    A, B, C = normalize(pa - x), normalize(pb - x), normalize(pc - x)
    det = dot(A, cross(B, C)).abs()
    sA = 2.0 * torch.atan2(det, 1.0 + dot(A, B) + dot(B, C) + dot(C, A))
    seen = (dot(nl, x - pa) > ARVO_EPS) & ((dot(n, pa - x) > ARVO_EPS)
                                           | (dot(n, pb - x) > ARVO_EPS)
                                           | (dot(n, pc - x) > ARVO_EPS))
    return sA, seen & (sA > ARVO_EPS) & torch.isfinite(sA)


def pick_light(lt: Lights, x, n, u, rows: int = 16384):
    """(light index, weights sum) per point: every light weighted by its
    solid angle times R + G + B, one drawn by inverse CDF with uniform u:
    count(cdf <= u * sum), at most L - 1."""
    idx = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    wsum = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    L = lt.pa.shape[0]
    for r0 in range(0, x.shape[0], rows):
        sl = slice(r0, r0 + rows)
        xs, ns_ = x[sl, None, :], n[sl, None, :]
        sA, ok = _solid_angle(xs, ns_, lt.pa[None], lt.pb[None], lt.pc[None], lt.nl[None])
        w = torch.where(ok, sA * lt.l_sum[None], torch.zeros_like(sA))
        w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
        ws = w.sum(dim=1)
        cdf = torch.cumsum(w, dim=1)
        k = (cdf <= (u[sl] * ws)[:, None]).sum(dim=1)
        idx[sl] = torch.clamp(k, max=L - 1)
        wsum[sl] = ws
    return idx, wsum


def _acos(x):
    return torch.acos(torch.clamp(x, -_CLAMP, _CLAMP))


def _oriented(x, n, pa, pb, pc):
    A, B0, C0 = normalize(pa - x), normalize(pb - x), normalize(pc - x)
    swap = dot(cross(C0 - A, B0 - A), n) < 0.0
    return A, torch.where(swap[..., None], C0, B0), torch.where(swap[..., None], B0, C0)


def sample_light(key, lt: Lights, x, n, lidx, wsum, dt):
    """(point, light normal, emission, solid-angle pdf, valid): Arvo's
    uniform sample of the picked triangle's spherical projection, landed
    on the flat triangle."""
    pa, pb, pc, nl = lt.pa[lidx], lt.pb[lidx], lt.pc[lidx], lt.nl[lidx]
    A, B, C = _oriented(x, n, pa, pb, pc)
    alpha = _acos(-dot(normalize(cross(B, A)), normalize(cross(A, C))))
    cos_c = dot(A, B)
    sA = 2.0 * torch.atan2(dot(A, cross(B, C)).abs(), 1.0 + dot(A, B) + dot(B, C) + dot(C, A))
    xi = tf.uniform(key, 2).to(dt)
    sA1 = xi[:, 0] * sA
    s, t = torch.sin(sA1 - alpha), torch.cos(sA1 - alpha)
    uu = t - torch.cos(alpha)
    vv = s + torch.sin(alpha) * cos_c
    den = (vv * s + uu * t) * torch.sin(alpha)
    den = torch.where(den.abs() > 1e-20, den, torch.sign(den) * 1e-20 + 1e-30)
    q = torch.clamp(((vv * t - uu * s) * torch.cos(alpha) - vv) / den, -1.0, 1.0)
    C1 = (q[:, None] * A + torch.sqrt(torch.clamp(1.0 - q * q, min=0.0))[:, None]
          * normalize(C - dot(C, A)[:, None] * A))
    z = torch.clamp(1.0 - xi[:, 1] * (1.0 - dot(C1, B)), -1.0, 1.0)
    P = normalize(z[:, None] * B + torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))[:, None]
                  * normalize(C1 - dot(C1, B)[:, None] * B))
    den = dot(nl, P)
    tt = torch.clamp(dot(nl, pa - x) / torch.where(den.abs() > 1e-12, den, torch.ones_like(den)),
                     min=0.0)
    has = wsum > ARVO_EPS
    pdf = torch.where(has, lt.l_sum[lidx] / torch.clamp(wsum, min=1e-30), torch.ones_like(wsum))
    point = torch.where(has[:, None], x + P * tt[:, None], x - n)
    em = torch.where(has[:, None], lt.em[lidx], torch.zeros_like(pa))
    return point, nl, em, pdf, has


def light_pdf(lt: Lights, x, n, lidx, wsum):
    """The solid-angle density with which the sampler at (x, n) picks
    directions toward light ``lidx`` (-1: none, density 0)."""
    safe = torch.clamp(lidx, min=0)
    _, ok = _solid_angle(x, n, lt.pa[safe], lt.pb[safe], lt.pc[safe], lt.nl[safe])
    ok = ok & (lidx >= 0) & (wsum > ARVO_EPS)
    return torch.where(ok, lt.l_sum[safe] / torch.clamp(wsum, min=1e-30), torch.zeros_like(wsum))


# ------------------------------------------------------------------ paths

def camera_rays(sc: RefScene, gpix):
    """Pinhole rays (eye, unit direction) through the centres of pixels
    ``gpix`` (row-major ids, row 0 at the top)."""
    w = sc.lookat - sc.eye
    dist = torch.sqrt(dot(w, w))
    nn = w / dist
    v = normalize(cross(nn, sc.up))
    u = normalize(cross(v, nn))
    fovy = torch.tensor(sc.fovy_deg, dtype=torch.float32, device=gpix.device).to(w.dtype)
    plen = torch.tan(fovy * (math.pi / 360.0)) * dist / (sc.height / 2.0)
    i = torch.div(gpix, sc.width, rounding_mode="floor").to(w.dtype)
    j = (gpix % sc.width).to(w.dtype)
    dx = -plen * (i - (sc.height - 1) / 2.0)
    dy = plen * (j - (sc.width - 1) / 2.0)
    rd = normalize(dx[:, None] * u[None] + dy[:, None] * v[None] + dist * nn[None])
    return sc.eye.expand(rd.shape), rd


def trace(sc: RefScene, acc: Accel, lt: Lights, lane_key, gpix, rr_prob: float):
    """Radiance [N, 3] of the paths with stream keys ``lane_key`` [N, 2]
    through pixels ``gpix`` [N], and their logical rays: each path's
    extension rays and the shadow rays of its vertices that survive
    Russian roulette."""
    dt, dev = sc.v0.dtype, sc.v0.device
    N = gpix.shape[0]
    L = torch.zeros((N, 3), dtype=dt, device=dev)
    ro, rd = camera_rays(sc, gpix)
    ids = torch.arange(N, device=dev)
    key = lane_key
    excl = torch.full((N,), -1, dtype=torch.int64, device=dev)
    tp = torch.ones((N, 3), dtype=dt, device=dev)
    prev = None                    # (bsdf pdf, point, normal, weights sum)
    rays, depth, w_rr = 0, 0, 1.0 / rr_prob
    while ids.numel():
        kd_ = tf.fold_in(key, depth)
        _, tri, bu, bv = nearest(acc, ro, rd, excl)
        rays += ids.numel()
        hit = tri >= 0
        t_ = torch.clamp(tri, min=0)
        bu_, bv_ = bu[:, None], bv[:, None]
        p = sc.v0[t_] + bu_ * sc.e1[t_] + bv_ * sc.e2[t_]
        vn = sc.vn[t_]
        ns = normalize((1.0 - bu_ - bv_) * vn[:, 0] + bu_ * vn[:, 1] + bv_ * vn[:, 2])
        wo = -rd
        kd, ks, nexp = sc.kd[t_], sc.ks[t_], sc.ns[t_]
        cont = hit & (dot(ns, wo) > 0.0)
        is_light = sc.is_light[t_] & hit
        lidx = torch.where(hit, sc.tri_light[t_], torch.full_like(t_, -1))

        # Emission: full weight at depth 0, then the balance heuristic
        # against the light sampler's density at the previous vertex.
        if prev is None:
            w_em = torch.ones_like(tp[:, 0])
        else:
            pb, pp, pn, pw = prev
            w_em = pb / torch.clamp(pb + light_pdf(lt, pp, pn, lidx, pw), min=1e-20)
        emit = cont & is_light
        L.index_add_(0, ids, torch.where(emit[:, None], tp * sc.emission[t_] * w_em[:, None],
                                         torch.zeros_like(tp)))
        cont = cont & ~is_light

        # Russian roulette gates both strategies.
        cont = cont & (tf.uniform(tf.fold_in(kd_, tf.P_RR))[:, 0] < rr_prob)
        tp = torch.where(cont[:, None], tp * w_rr, tp)

        # Light strategy: Arvo NEE with the MIS weight.
        k_ls = tf.fold_in(kd_, tf.P_LIGHT_SELECT)
        u_pick = tf.uniform(tf.fold_in(k_ls, 0))[:, 0].to(dt)
        pick, wsum = pick_light(lt, p, ns, u_pick)
        point, nl, em, p_l, valid = sample_light(tf.fold_in(k_ls, 1), lt, p, ns, pick, wsum, dt)
        rays += int(cont.sum())
        wl_raw = point - p
        dist = torch.sqrt(torch.clamp(dot(wl_raw, wl_raw), min=1e-20))
        wl = wl_raw / dist[:, None]
        cos_x, cos_l = dot(wl, ns), -dot(wl, nl)
        ok = cont & valid & (cos_x > 0.0) & (cos_l > 0.0)
        sel = torch.nonzero(ok)[:, 0]
        if sel.numel():
            vis = ~occluded(acc, p[sel], wl[sel], dist[sel], tri[sel])
            f = brdf(ns[sel], wl[sel], wo[sel], kd[sel], ks[sel], nexp[sel])
            den = torch.clamp(p_l[sel] + brdf_pdf(ns[sel], wl[sel], wo[sel], kd[sel], ks[sel],
                                                  nexp[sel]), min=1e-20)
            c = em[sel] * f * (cos_x[sel] / den)[:, None]
            L.index_add_(0, ids[sel], torch.where(vis[:, None], tp[sel] * c, torch.zeros_like(c)))

        # BRDF strategy: sample, weight, continue.
        wi, pdf = sample_brdf(tf.fold_in(kd_, tf.P_BSDF), ns, wo, kd, ks, nexp, dt)
        cos_i = dot(wi, ns)
        cont = cont & (cos_i > 0.0) & (pdf > 1e-12)
        f = brdf(ns, wi, wo, kd, ks, nexp)
        scale = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf, min=1e-12)
        tp = torch.where(cont[:, None], tp * f * scale[:, None], tp)
        keep = torch.nonzero(cont)[:, 0]
        ids, key, tp, excl = ids[keep], key[keep], tp[keep], tri[keep]
        ro, rd = p[keep], wi[keep]
        prev = (pdf[keep], p[keep], ns[keep], wsum[keep])
        depth += 1
    return L, rays


def render_pixels(sc: RefScene, round_keys, gpix, rr_prob: float = 0.6,
                  batch: int = 1 << 17):
    """Radiance summed over the rounds [P, 3] (float64, on the host) of
    pixels ``gpix`` [P], round r's paths keyed fold(round_keys[r], pixel),
    and the logical rays of all those paths."""
    acc, lt = build_accel(sc), lights_of(sc)
    dev = sc.v0.device
    gpix = gpix.to(dev)
    R, P = round_keys.shape[0], gpix.shape[0]
    out = torch.zeros((P, 3), dtype=torch.float64, device=dev)
    rays = 0
    flat_pix = torch.arange(P, device=dev).repeat(R)
    flat_round = torch.arange(R, device=dev).repeat_interleave(P)
    for b0 in range(0, R * P, batch):
        pi, ri = flat_pix[b0:b0 + batch], flat_round[b0:b0 + batch]
        lane = tf.fold_in(round_keys.to(dev)[ri], gpix[pi])
        L, n = trace(sc, acc, lt, lane, gpix[pi], rr_prob)
        out.index_add_(0, pi, L.double())
        rays += n
    return out.cpu(), rays
