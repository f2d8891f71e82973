"""The plain reference of an inverse-rendering step: the fixed-depth MIS +
Arvo estimator under autograd, and the two-stream loss and its latent
gradients.

Plain PyTorch in one float dtype (float32 for the check, bfloat16 for its
control), TF32 off. It takes intersection, Phong, the Arvo pick and the
light pdf from ``tracer.py`` and the scene from ``scene.py``; it imports
nothing of either package. What it computes, given the scene file, a seed,
a step index and latent materials, is what one step of the CLI's
``inverse`` computes:

1. the step's keys and pixels: ``split(fold_in(key(seed), i), 3)`` gives
   (-, k_step, k_pix), the pixels are ``randint(k_pix, (N,), 0, n_pix)``,
   the target's stream is ``split(k_step)[0]`` and the two latent streams
   ``split(split(k_step)[1])``;
2. the target from the scene file's materials, and r1, r2 from the
   latents' materials (kd, ks = sigmoid; ns, emission = exp), each by the
   fixed-depth estimator below: all N rays advance one bounce a depth for
   ``max_depth`` bounces, ended by masks (miss, back face, a light,
   Russian roulette, a sample below the surface);
3. ``mean((r1 - t) * (r2 - t))``, after the squash x / (1 + x / clip)
   where ``loss_clip`` is given;
4. the latents' gradients by ``torch.autograd``, in blocks of rays: the
   loss is a sum over rays, and a block of rows [r0, r1) draws what those
   rows draw in the whole batch;
5. the step's update (:func:`adam_replay`): plain Adam under a cosine
   decay, replayed from the job's start latents with zero moments over a
   job's gradients, one list a step.

Streams. A depth's key is ``fold_in(stream key, depth)`` and a purpose's
``fold_in(depth key, purpose)``; a draw of k values for each of the N rows
from one such scalar key is JAX's partitionable ``random_bits``: the
counts of row r are r * k .. r * k + k - 1 (high and low words), the bits
the xor of threefry's two outputs. Roulette draws one value from
(depth, 4); the light from (depth, 2): the pick's uniform from its fold 0,
the warp's two from its fold 1; the BRDF from (depth, 1): the lobe's from
its fold 0, the direction's two from its fold 1.

Where gradients stop. The estimator detaches where the JAX package's
fixed-depth estimator and its samplers call ``stop_gradient``
(monte_carlo_path_tracing_tpu/...):

- ``integrator/wavefront.py:342``: the NEE denominator p_light + p_brdf;
- ``integrator/wavefront.py:370``: the denominator of the emission's
  balance weight, p_brdf(prev) + p_light (its numerator is the next site);
- ``integrator/wavefront.py:405``: the BRDF continuation's pdf;
- ``integrator/wavefront.py:436``: the BRDF pdf carried to the next vertex;
- ``sampling/phong.py:157``: the sampled direction;
- ``sampling/light_spherical.py:319``: the sampled point on the light;
- ``ops/intersect.py:150``: the triangles' coefficients (here: the
  geometry requires no gradient).

Discrete events (the lobe, the light picked, roulette, visibility, the
masks) carry none. The light pick's weights and their sum reach only
detached pdfs, so the pick reads the light table detached. Gradients flow
through BRDF values, emission (at hits and in the light table) and the
throughput.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch

from benchmark.reference import scene as ref_scene
from benchmark.reference import threefry as tf
from benchmark.reference import tracer as tr

#: The latent families, in the order of the program's latents.
FAMILIES = ("kd", "ks", "ns", "emission")
#: Rays a block of the gradient's autograd pass.
BLOCK = 16384
#: Adam's moments and epsilon (optax.adam's defaults) and the cosine
#: decay's floor as a fraction of the learning rate: the JAX package's
#: ``optax.adam(optax.cosine_decay_schedule(lr, max(steps, 1), 0.02))``
#: (monte_carlo_path_tracing_tpu/diff/inverse.py:97).
ADAM_BETAS, ADAM_EPS, COSINE_ALPHA = (0.9, 0.999), 1e-8, 0.02

M32 = tf.M32


# --------------------------------------------------------------- streams

def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """[n, 2] keys: JAX's ``split``, threefry of (0, i) for i < n."""
    return tf.fold_in(key, torch.arange(n, dtype=torch.int64, device=key.device))


def row_bits(key: torch.Tensor, n: int, k: int = 1, row_offset: int = 0) -> torch.Tensor:
    """[n, k] 32-bit words of a scalar key's draw over rows row_offset ..
    row_offset + n - 1: row r takes the counts r * k + j."""
    count = torch.arange(row_offset * k, (row_offset + n) * k, dtype=torch.int64,
                         device=key.device).reshape(n, k)
    y0, y1 = tf.threefry2x32(key[0], key[1], count >> 32, count & M32)
    return y0 ^ y1


def row_uniform(key: torch.Tensor, n: int, k: int = 1, row_offset: int = 0) -> torch.Tensor:
    """[n, k] float32 uniforms in [0, 1) of :func:`row_bits`."""
    bits = (row_bits(key, n, k, row_offset) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """[n] int64 draws in [lo, hi): JAX's ``randint`` for int32 bounds, two
    32-bit draws from the halves of ``split(key)`` combined modulo the span
    with the multiplier 2**32 mod span."""
    k1, k2 = split(key)
    higher, lower = row_bits(k1, n)[:, 0], row_bits(k2, n)[:, 0]
    span = (hi - lo) & M32 if hi > lo else 1
    multiplier = ((((1 << 16) % span) ** 2) & M32) % span
    offset = ((((higher % span) * multiplier) & M32) + lower % span) & M32
    return lo + offset % span


# ---------------------------------------------------------- the materials

def material_table(obj_path: str, device="cpu", dtype=torch.float32):
    """(materials, triangle -> material id [T]) of the scene file: the
    materials a dict of kd [M, 3], ks [M, 3], ns [M], emission [M, 3] in the
    order the OBJ first names them, by ``scene.load``'s rules."""
    _, _, _, _, fmat, names, mats = ref_scene._parse_obj(obj_path)
    lights, _ = ref_scene._parse_xml(os.path.splitext(obj_path)[0] + ".xml")
    names = names or [""]
    get = lambda n, k, d: mats[n][k] if n in mats else d  # noqa: E731
    table = {"kd": [get(n, "kd", (0.5,) * 3) for n in names],
             "ks": [get(n, "ks", (0.0,) * 3) for n in names],
             "ns": [max(get(n, "ns", 1.0), 1.0) for n in names],
             "emission": [lights.get(n, (0.0,) * 3) for n in names]}
    out = {k: torch.tensor(v, dtype=torch.float32, device=device).to(dtype)
           for k, v in table.items()}
    tri_mat = torch.as_tensor(fmat, device=device).clamp(min=0)
    return out, tri_mat


def from_latents(latents) -> dict:
    """Materials of latents in :data:`FAMILIES` order: kd, ks = sigmoid,
    ns, emission = exp."""
    kd, ks, ns, em = latents
    return {"kd": torch.sigmoid(kd), "ks": torch.sigmoid(ks), "ns": torch.exp(ns),
            "emission": torch.exp(em)}


def start_latents(materials: dict, perturb: float, optimize) -> list:
    """The CLI ``inverse``'s start as latents: each optimised family moved
    off its true value (kd + perturb, a non-zero ks - perturb, both clamped
    to [0.02, 0.95] and [0, 0.95]; ns x 0.4; emission x 0.5), then logit
    (clamped to [1e-4, 1 - 1e-4]) and log (ns clamped to 1e-3, emission
    to 1e-6)."""
    m = dict(materials)
    if "kd" in optimize:
        m["kd"] = torch.clamp(m["kd"] + perturb, 0.02, 0.95)
    if "ks" in optimize:
        m["ks"] = torch.clamp(m["ks"] - perturb * (m["ks"] > 0), 0.0, 0.95)
    if "ns" in optimize:
        m["ns"] = m["ns"] * 0.4
    if "emission" in optimize:
        m["emission"] = m["emission"] * 0.5

    def logit(p):
        p = torch.clamp(p, 1e-4, 1.0 - 1e-4)
        return torch.log(p) - torch.log1p(-p)

    return [logit(m["kd"]), logit(m["ks"]), torch.log(torch.clamp(m["ns"], min=1e-3)),
            torch.log(torch.clamp(m["emission"], min=1e-6))]


def with_materials(sc: ref_scene.RefScene, materials: dict, tri_mat) -> ref_scene.RefScene:
    """``sc`` with each triangle's Phong fields and emission from the
    material table ``materials``."""
    return dataclasses.replace(sc, **{k: v[tri_mat] for k, v in materials.items()})


# -------------------------------------------------------------- samplers

def sample_brdf(xi_lobe, xi, n, wo, kd, ks, ns):
    """(wi, pdf): ``tracer.sample_brdf``'s lobe choice and warps from the
    given uniforms, the direction detached (phong.py:157)."""
    pd, _ = tr._lobe_probs(kd, ks)
    spec = xi_lobe >= pd
    cos_d = torch.sqrt(torch.clamp(1.0 - xi[:, 0], min=0.0))
    sin_d = torch.sqrt(torch.clamp(xi[:, 0], min=0.0))
    cos_s = tr._pow(xi[:, 0], 1.0 / (ns + 1.0))
    sin_s = torch.sqrt(torch.clamp(1.0 - cos_s * cos_s, min=0.0))
    phi = 2.0 * math.pi * xi[:, 1]
    cos_t, sin_t = torch.where(spec, cos_s, cos_d), torch.where(spec, sin_s, sin_d)
    axis = torch.where(spec[:, None], tr.reflect(wo, n), n)
    t, b = tr._basis(axis)
    wi = ((sin_t * torch.cos(phi))[:, None] * t + (sin_t * torch.sin(phi))[:, None] * b
          + cos_t[:, None] * axis).detach()
    return wi, tr.brdf_pdf(n, wi, wo, kd, ks, ns)


def sample_light(xi, lt: tr.Lights, x, n, lidx, wsum):
    """(point, light normal, emission, solid-angle pdf, valid):
    ``tracer.sample_light``'s Arvo warp from the given uniforms, the point
    detached (light_spherical.py:319)."""
    pa, pb, pc, nl = lt.pa[lidx], lt.pb[lidx], lt.pc[lidx], lt.nl[lidx]
    A, B, C = tr._oriented(x, n, pa, pb, pc)
    alpha = tr._acos(-tr.dot(tr.normalize(tr.cross(B, A)), tr.normalize(tr.cross(A, C))))
    cos_c = tr.dot(A, B)
    sA = 2.0 * torch.atan2(tr.dot(A, tr.cross(B, C)).abs(),
                           1.0 + tr.dot(A, B) + tr.dot(B, C) + tr.dot(C, A))
    sA1 = xi[:, 0] * sA
    s, t = torch.sin(sA1 - alpha), torch.cos(sA1 - alpha)
    uu = t - torch.cos(alpha)
    vv = s + torch.sin(alpha) * cos_c
    den = (vv * s + uu * t) * torch.sin(alpha)
    den = torch.where(den.abs() > 1e-20, den, torch.sign(den) * 1e-20 + 1e-30)
    q = torch.clamp(((vv * t - uu * s) * torch.cos(alpha) - vv) / den, -1.0, 1.0)
    C1 = (q[:, None] * A + torch.sqrt(torch.clamp(1.0 - q * q, min=0.0))[:, None]
          * tr.normalize(C - tr.dot(C, A)[:, None] * A))
    z = torch.clamp(1.0 - xi[:, 1] * (1.0 - tr.dot(C1, B)), -1.0, 1.0)
    P = tr.normalize(z[:, None] * B + torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))[:, None]
                     * tr.normalize(C1 - tr.dot(C1, B)[:, None] * B))
    den = tr.dot(nl, P)
    tt = torch.clamp(tr.dot(nl, pa - x) / torch.where(den.abs() > 1e-12, den,
                                                     torch.ones_like(den)), min=0.0)
    has = wsum > tr.ARVO_EPS
    pdf = torch.where(has, lt.l_sum[lidx] / torch.clamp(wsum, min=1e-30), torch.ones_like(wsum))
    point = torch.where(has[:, None], x + P * tt[:, None], x - n).detach()
    em = torch.where(has[:, None], lt.em[lidx], torch.zeros_like(pa))
    return point, nl, em, pdf, has


# ------------------------------------------------------------- estimator

def radiance(sc: ref_scene.RefScene, acc: tr.Accel, key, ro, rd, max_depth: int,
             rr_prob: float, row_offset: int = 0):
    """Radiance [N, 3] of rays (ro, rd), rows ``row_offset`` .. of a batch,
    by the fixed-depth MIS + Arvo estimator on stream ``key`` [2], and the
    extension and shadow rays of the lanes live at each trace."""
    dt, dev = sc.v0.dtype, sc.v0.device
    N = ro.shape[0]
    lt = tr.lights_of(sc)
    lt_pick = tr.Lights(*(x.detach() for x in lt))
    L = torch.zeros((N, 3), dtype=dt, device=dev)
    tp = torch.ones((N, 3), dtype=dt, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    excl = torch.full((N,), -1, dtype=torch.int64, device=dev)
    prev = None                      # (BRDF pdf, point, normal, weights sum)
    rays, w_rr = 0, 1.0 / rr_prob

    def draw(k, *folds, width=1):
        for f in folds:
            k = tf.fold_in(k, f)
        return row_uniform(k, N, width, row_offset)

    for d in range(max_depth):
        kd_ = tf.fold_in(key, d)
        rays += int(active.sum())
        _, tri, bu, bv = tr.nearest(acc, ro, rd, excl)
        hit = tri >= 0
        t_ = torch.clamp(tri, min=0)
        bu_, bv_ = bu[:, None], bv[:, None]
        p = sc.v0[t_] + bu_ * sc.e1[t_] + bv_ * sc.e2[t_]
        vn = sc.vn[t_]
        ns = tr.normalize((1.0 - bu_ - bv_) * vn[:, 0] + bu_ * vn[:, 1] + bv_ * vn[:, 2])
        wo = -rd
        kd, ks, nexp = sc.kd[t_], sc.ks[t_], sc.ns[t_]
        alive = active & hit & (tr.dot(ns, wo) > 0.0)
        is_light = sc.is_light[t_] & hit
        lidx = torch.where(hit, sc.tri_light[t_], torch.full_like(t_, -1))

        # Emission: weight 1 at depth 0, then the balance heuristic against
        # the light sampler's density at the previous vertex.
        em_hit = tp * sc.emission[t_]
        if prev is not None:
            pb, pp, pn, pw = prev
            w = pb / torch.clamp(pb + tr.light_pdf(lt, pp, pn, lidx, pw), min=1e-20).detach()
            em_hit = em_hit * w[:, None]
        L = L + torch.where((alive & is_light)[:, None], em_hit, torch.zeros_like(em_hit))
        alive = alive & ~is_light

        # Russian roulette gates both strategies.
        alive = alive & (draw(kd_, tf.P_RR)[:, 0] < rr_prob)
        tp = torch.where(alive[:, None], tp * w_rr, tp)

        # Light strategy: Arvo NEE, weighted against the BRDF's density.
        pick, wsum = tr.pick_light(lt_pick, p.detach(), ns.detach(),
                                   draw(kd_, tf.P_LIGHT_SELECT, 0)[:, 0].to(dt))
        xi_l = draw(kd_, tf.P_LIGHT_SELECT, 1, width=2).to(dt)
        point, nl, em, p_l, valid = sample_light(xi_l, lt, p, ns, pick, wsum)
        rays += int(alive.sum())
        wl_raw = point - p
        dist = torch.sqrt(torch.clamp(tr.dot(wl_raw, wl_raw), min=1e-20))
        wl = wl_raw / dist[:, None]
        cos_x, cos_l = tr.dot(wl, ns), -tr.dot(wl, nl)
        ok = alive & valid & (cos_x > 0.0) & (cos_l > 0.0)
        sel = torch.nonzero(ok)[:, 0]
        visible = torch.zeros_like(ok)
        if sel.numel():
            visible[sel] = ~tr.occluded(acc, p[sel], wl[sel], dist[sel], tri[sel])
        f = tr.brdf(ns, wl, wo, kd, ks, nexp)
        den = torch.clamp(p_l + tr.brdf_pdf(ns, wl, wo, kd, ks, nexp), min=1e-20).detach()
        c = em * f * (cos_x / den)[:, None]
        L = L + tp * torch.where(visible[:, None], c, torch.zeros_like(c))

        # BRDF strategy: sample, weight, continue.
        wi, pdf = sample_brdf(draw(kd_, tf.P_BSDF, 0)[:, 0].to(dt),
                              draw(kd_, tf.P_BSDF, 1, width=2).to(dt), ns, wo, kd, ks, nexp)
        cos_i = tr.dot(wi, ns)
        alive = alive & (cos_i > 0.0) & (pdf > 1e-12)
        scale = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf, min=1e-12).detach()
        f = tr.brdf(ns, wi, wo, kd, ks, nexp)
        tp = torch.where(alive[:, None], tp * f * scale[:, None], tp)
        active, ro, rd, excl = alive, p, wi, tri
        prev = (pdf.detach(), p, ns, wsum)
    return L, rays


# ------------------------------------------------------------------ step

@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def step_keys(seed: int, i: int, n_rays: int, n_pix: int, device):
    """(target key, the two latent streams' keys, pixel ids [n_rays]) of step i."""
    _, k_step, k_pix = split(tf.fold_in(tf.base_key(seed, device), i), 3)
    k_t, k_r = split(k_step)
    k1, k2 = split(k_r)
    return k_t, k1, k2, randint(k_pix, n_rays, 0, n_pix)


def step(obj_path: str, width: int, height: int, seed: int, i: int, latents, n_rays: int,
         max_depth: int = 3, rr_prob: float = 0.6, loss_clip: float | None = None,
         device="cpu", dtype=torch.float32) -> dict:
    """One inverse-rendering step at ``latents`` (kd, ks, ns, emission
    latents in the scene's material order): {"target", "r1", "r2"} [N, 3]
    radiance before the squash, "loss", "loss_abs_mean" (the mean of |(r1 -
    t)(r2 - t)| after the squash), "grads" (d loss / d each latent, in
    :data:`FAMILIES` order) and "rays" (the three renders' extension and
    shadow rays), all detached, the floats in ``dtype``. Gradients are
    taken over :data:`BLOCK` rays at a time."""
    with no_tf32():
        sc = ref_scene.load(obj_path, width, height, device=device, dtype=dtype)
        _, tri_mat = material_table(obj_path, device, dtype)
        acc = tr.build_accel(sc)
        n_pix = width * height
        n = min(n_rays, n_pix)
        k_t, k1, k2, pix = step_keys(seed, i, n, n_pix, device)
        ro, rd = tr.camera_rays(sc, pix)
        squash = (lambda x: x) if loss_clip is None else (lambda x: x / (1.0 + x / loss_clip))
        leaves = [x.detach().to(device=device, dtype=dtype).requires_grad_(True)
                  for x in latents]
        out = {k: [] for k in ("target", "r1", "r2")}
        loss = torch.zeros((), dtype=torch.float64, device=device)
        abs_sum = torch.zeros((), dtype=torch.float64, device=device)
        rays = 0
        for r0 in range(0, n, BLOCK):
            sl = slice(r0, min(r0 + BLOCK, n))
            with torch.no_grad():
                t, nr = radiance(sc, acc, k_t, ro[sl], rd[sl], max_depth, rr_prob, r0)
            with torch.enable_grad():
                sc_l = with_materials(sc, from_latents(leaves), tri_mat)
                r1, n1 = radiance(sc_l, acc, k1, ro[sl], rd[sl], max_depth, rr_prob, r0)
                r2, n2 = radiance(sc_l, acc, k2, ro[sl], rd[sl], max_depth, rr_prob, r0)
                ts = squash(t)
                prod = (squash(r1) - ts) * (squash(r2) - ts)
                part = prod.sum() / (3 * n)
                part.backward()
            loss += part.detach().double()
            abs_sum += prod.detach().abs().double().sum()
            rays += nr + n1 + n2
            for k, v in (("target", t), ("r1", r1), ("r2", r2)):
                out[k].append(v.detach())
        res = {k: torch.cat(v) for k, v in out.items()}
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves]
        res.update(loss=loss.to(dtype), loss_abs_mean=(abs_sum / (3 * n)).to(dtype),
                   grads=[g.detach() for g in grads], rays=rays)
    return res


# ---------------------------------------------------------------- update

def cosine_lr(lr: float, decay_steps: int, count: int) -> float:
    """The learning rate of step ``count``: ``lr`` times a cosine from 1
    down to :data:`COSINE_ALPHA` over ``decay_steps`` steps, then flat."""
    c = min(count, decay_steps) / decay_steps
    return lr * ((1.0 - COSINE_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * c)) + COSINE_ALPHA)


def adam_replay(start, grads, lr: float, decay_steps: int, dtype=torch.float64):
    """(latents before, latents after) the last of the steps of ``grads``
    (one list of the latents' gradients a step, from a job's step 0), by
    plain Adam under :func:`cosine_lr` from ``start`` with zero moments:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and the latents move by
    -lr_t (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), in ``dtype``."""
    b1, b2 = ADAM_BETAS
    p = [x.detach().to(dtype) for x in start]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    before = p
    for t, gs in enumerate(grads):
        before, a = p, cosine_lr(lr, decay_steps, t)
        nxt = []
        for j, g in enumerate(gs):
            g = g.detach().to(dtype)
            m[j] = b1 * m[j] + (1.0 - b1) * g
            v[j] = b2 * v[j] + (1.0 - b2) * g * g
            m_hat = m[j] / (1.0 - b1 ** (t + 1))
            v_hat = v[j] / (1.0 - b2 ** (t + 1))
            nxt.append(p[j] - a * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        p = nxt
    return before, p
