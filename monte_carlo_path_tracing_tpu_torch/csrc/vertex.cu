// The regeneration loop's MIS vertex with Arvo light sampling, fused: three
// kernels around K3 (the light pick) and K2 / K5 (the shadow test).
//
// Not the counterpart of a Pallas kernel: on the TPU, XLA fused the JAX
// package's per-vertex math (monte_carlo_path_tracing_tpu/integrator/
// regen.py's loop body: _light_pdf_of_hit, russian_roulette, the Arvo warp
// of sampling/light_spherical.py, _nee_term, sampling/phong.py's sample and
// eval) into a few generated kernels. The port's plain version is
// integrator/shading.py::vertex_plain, ~700 torch kernels a call at about
// the launch floor each (1.6-1.8 us at 65,536 lanes). These kernels compute
// the same values, bit for bit, in three launches a call (ops/vertex_cuda.py
// wraps them; shading.vertex decides which path a call takes):
//
//   - mis_vertex_emit, after the trace and the gather: the emission of
//     emissive hits under the balance heuristic of the previous vertex (the
//     Van Oosterom-Strackee solid angle of the hit light from the previous
//     point: light_spherical.pdf_of_tri), Russian roulette and its
//     throughput scaling, the live mask, and K3's uniform;
//   - mis_vertex_light_brdf, after K3: the Arvo warp inside the picked light
//     triangle and the landing point (light_spherical.sample_from_pick), the
//     shadow ray to it (shading.shadow_ray), the NEE contribution
//     emission * f * cos_x / (p_light + p_brdf) with one specular pow
//     (phong.eval_and_pdf_brdf), and the BRDF continuation (shading.brdf_step:
//     lobe pick, warp, pdf, f, cos and the throughput); it adds the shadow
//     rays (the live lanes) to the ray count;
//   - mis_vertex_nee_add, after the shadow test: the unblocked NEE radiance,
//     times the throughput, added to L in place.
//
// Numerics. Each value is the plain version's, operation for operation: a
// dot is ((a0 b0 + a1 b1) + a2 b2), normalize multiplies by
// 1 / sqrt(max(|a|^2, 1e-20)), every clamp and where guard is kept (clamps
// pass NaN through, as torch's do), the build's -fmad=false keeps every
// multiply and add separately rounded, and sqrtf, sinf, cosf, acosf, atan2f,
// expf and logf are the single-precision functions torch's CUDA kernels
// call. Python scalars enter as torch passes them to its CUDA kernels: cast
// to float, and a division by one (lobe_probs' / 3) as a multiplication by
// its float reciprocal; x / tensor is reciprocal(tensor) * x. The 12 draws a
// vertex are threefry.cuh's, so each is K6's uniform of the same key and
// count.
//
// What bounds it on this card. Per lane the three kernels read 180 bytes
// and write 99 (emit 42 / 29: the hit and light flags, throughput,
// radiance and key, and for an emissive hit up to 56 more of its emission,
// depth and previous vertex; light_brdf 101 / 58: the key, K3's pick, the
// gathered vertex, mask and throughput, out the shadow ray, NEE term, BRDF
// sample, mask and throughput; nee_add 37 / 12), with the light table (20
// KB for Veach's 320 lights) read from cache: at 65,536 lanes 18 MB, 5.5
// us at 3.35 TB/s, each kernel at or below the launch floor. The
// arithmetic, ~1,200 float operations a lane with some twenty
// transcendentals, takes ~1.2 us at 67 TFLOP/s, so the bound is the bytes.
// What the three kernels save is the plain version's ~700 launches, not
// device time: mis_vertex_light_brdf runs at about a third of its bound,
// paced by one lane's dependent chain of transcendentals with ~15 warps an
// SM at 65,536 lanes (PERF.md). Design: a thread a lane, no shared memory;
// the ray count is a block count (__syncthreads_count) and one 64-bit
// atomic a block, an exact integer sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float EPS = 1e-6f;                          // light_spherical.EPS
constexpr float ACOS_CLAMP = (float)(1.0 - 1e-7);     // light_spherical._CLAMP
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr float INV_2PI = (float)(1.0 / (2.0 * 3.14159265358979323846));
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);
constexpr float THIRD = 1.0f / 3.0f;                  // torch's x / 3.0 on CUDA: x * (1 / 3)
// Purpose tags of core/rng.py.
constexpr uint32_t P_BSDF = 1, P_LIGHT_SELECT = 2, P_RR = 4;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void st3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

//! vecmath.dot: ((a0 b0 + a1 b1) + a2 b2).
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

//! vecmath.cross.
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

//! torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

//! vecmath.normalize: a * (1 / sqrt(max(|a|^2, 1e-20))), or 0 where |a|^2 <= 1e-20.
__device__ __forceinline__ V3 normalize(V3 a) {
  const float sq = dot(a, a);
  const float inv = 1.0f / sqrtf(clamp_min(sq, 1e-20f));
  return a * (sq > 1e-20f ? inv : 0.0f);
}

//! vecmath.reflect(w, n): (2 (w . n)) n - w.
__device__ __forceinline__ V3 reflect(V3 w, V3 n) { return (2.0f * dot(w, n)) * n - w; }

//! phong._powfast: x^e as exp(e log x), 0 where x <= 0.
__device__ __forceinline__ float powfast(float x, float e) {
  return x > 0.0f ? expf(e * logf(clamp_min(x, 1e-30f))) : 0.0f;
}

//! phong.lobe_probs: P(diffuse) by mean(Kd) : mean(Ks), diffuse for a black material.
__device__ __forceinline__ float lobe_pd(V3 kd, V3 ks) {
  const float wd = ((kd.x + kd.y) + kd.z) * THIRD;
  const float ws = ((ks.x + ks.y) + ks.z) * THIRD;
  const float tot = wd + ws;
  return tot > 0.0f ? wd / tot : 1.0f;
}

//! The Phong lobe (ns + 1) / (2 pi) cos^ns.
__device__ __forceinline__ float phong_lobe(float c, float ns) {
  return ((ns + 1.0f) * INV_2PI) * powfast(c, ns);
}

__device__ __forceinline__ ThreefryKey lane_key(const long long* keys, int i) {
  return {static_cast<uint32_t>(keys[2 * i]), static_cast<uint32_t>(keys[2 * i + 1])};
}

//! A light record of light_spherical.light_table: pa pb pc nl emission l_sum.
struct LightRec {
  V3 pa, pb, pc, nl, em;
  float l_sum;
};

__device__ __forceinline__ LightRec light_rec(const float* table, int num_lights, int li) {
  const float* r = table + 16 * min(max(li, 0), num_lights - 1);
  return {{r[0], r[1], r[2]},    {r[3], r[4], r[5]},    {r[6], r[7], r[8]},
          {r[9], r[10], r[11]}, {r[12], r[13], r[14]}, r[15]};
}

//! light_spherical.pdf_of_tri: the solid-angle pdf with which the sampler at
//! (x1, n) with weights_sum ``wsum`` picks a direction toward light ``li``.
__device__ float pdf_of_tri(const LightRec& L, V3 x1, V3 n, int li, float wsum) {
  // solid_angle_fast
  const V3 A = normalize(L.pa - x1), B = normalize(L.pb - x1), C = normalize(L.pc - x1);
  const float det = fabsf(dot(A, cross(B, C)));
  const float denom = ((1.0f + dot(A, B)) + dot(B, C)) + dot(C, A);
  const float sA = 2.0f * atan2f(det, denom);
  // _seen
  const bool front = dot(L.nl, x1 - L.pa) > EPS;
  const bool above =
      (dot(n, L.pa - x1) > EPS) | (dot(n, L.pb - x1) > EPS) | (dot(n, L.pc - x1) > EPS);
  const bool ok = front && above && sA > EPS && isfinite(sA) && li >= 0 && wsum > EPS;
  return ok ? L.l_sum / clamp_min(wsum, 1e-30f) : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
mis_vertex_emit(const uint8_t* __restrict__ hit, const uint8_t* __restrict__ is_light,
                const int* __restrict__ light_idx, const float* __restrict__ emission,
                const float* __restrict__ tp, const float* __restrict__ L,
                const long long* __restrict__ depth, const float* __restrict__ prev_pb,
                const float* __restrict__ prev_p, const float* __restrict__ prev_ns,
                const float* __restrict__ prev_w, const float* __restrict__ table,
                int num_lights, const long long* __restrict__ keys,
                const long long* __restrict__ nrays_in, float rr_prob, float w_rr, int n,
                float* __restrict__ L_out, float* __restrict__ tp_out,
                uint8_t* __restrict__ alive_out, float* __restrict__ u_out,
                long long* __restrict__ nrays_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) *nrays_out = *nrays_in;   // mis_vertex_light_brdf adds the shadow rays
  if (i >= n) return;
  const bool h = hit[i] != 0, light = is_light[i] != 0;
  V3 t = ld3(tp, i), l = ld3(L, i);

  // shading.emission: L + where(hit & is_light, tp * emission * w, 0), the
  // balance heuristic w = pb / max(pb + p_light, 1e-20), 1 at depth 0.
  V3 add = {0.0f, 0.0f, 0.0f};
  if (h && light) {
    add = t * ld3(emission, i);
    if (depth[i] != 0) {
      const int li = light_idx[i];
      const float pb = prev_pb[i];
      const float p_l = pdf_of_tri(light_rec(table, num_lights, li), ld3(prev_p, i),
                                   ld3(prev_ns, i), li, prev_w[i]);
      add = add * (pb / clamp_min(pb + p_l, 1e-20f));
    }
  }
  st3(L_out, i, l + add);

  // Russian roulette gates both strategies; K3's uniform.
  const ThreefryKey kd = lane_key(keys, i);
  const bool survive = threefry_uniform(threefry_fold(kd, P_RR), 0) < rr_prob;
  const bool alive = h && !light && survive;
  st3(tp_out, i, alive ? t * w_rr : t);
  alive_out[i] = alive;
  u_out[i] = threefry_uniform(threefry_fold(threefry_fold(kd, P_LIGHT_SELECT), 0), 0);
}

__global__ void __launch_bounds__(THREADS)
mis_vertex_light_brdf(const long long* __restrict__ keys, const int* __restrict__ lidx,
                      const float* __restrict__ wsum, const float* __restrict__ p,
                      const float* __restrict__ ns, const float* __restrict__ wo,
                      const float* __restrict__ kd_, const float* __restrict__ ks_,
                      const float* __restrict__ ns_exp, const uint8_t* __restrict__ alive_in,
                      const float* __restrict__ tp, const float* __restrict__ table,
                      int num_lights, int branch_pdf_compat, int n, float* __restrict__ wl_out,
                      float* __restrict__ dist_out, float* __restrict__ contrib_out,
                      float* __restrict__ wi_out, float* __restrict__ pdf_out,
                      uint8_t* __restrict__ spec_out, uint8_t* __restrict__ alive_out,
                      float* __restrict__ tp_out, unsigned long long* __restrict__ nrays) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool alive = i < n && alive_in[i] != 0;
  // The shadow rays: one a live lane (shading.vertex's nrays + alive.sum()).
  const int shadow = __syncthreads_count(alive);
  if (threadIdx.x == 0 && shadow > 0) atomicAdd(nrays, static_cast<unsigned long long>(shadow));
  if (i >= n) return;

  const ThreefryKey kd = lane_key(keys, i);
  const V3 x1 = ld3(p, i), nrm = ld3(ns, i), w_o = ld3(wo, i);
  const V3 Kd = ld3(kd_, i), Ks = ld3(ks_, i);
  const float nse = ns_exp[i];
  const float ws = wsum[i];
  const LightRec rec = light_rec(table, num_lights, lidx[i]);
  const bool has = ws > EPS;

  // light_spherical._project_for_warp: oriented unit directions, alpha, cos c, sA.
  const V3 A = normalize(rec.pa - x1), B0 = normalize(rec.pb - x1), C0 = normalize(rec.pc - x1);
  const bool swap = dot(cross(C0 - A, B0 - A), nrm) < 0.0f;
  const V3 B = sel(swap, C0, B0), C = sel(swap, B0, C0);
  const V3 n_ba = normalize(cross(B, A)), n_ac = normalize(cross(A, C));
  const float alpha = acosf(clamp2(-dot(n_ba, n_ac), -ACOS_CLAMP, ACOS_CLAMP));
  const float cos_c = dot(A, B);
  const float det = fabsf(dot(A, cross(B, C)));
  const float sA = 2.0f * atan2f(det, ((1.0f + dot(A, B)) + dot(B, C)) + dot(C, A));

  // light_spherical._arvo_warp (Arvo 1995, section 5.2).
  const ThreefryKey kw = threefry_fold(threefry_fold(kd, P_LIGHT_SELECT), 1);
  const float xi0 = threefry_uniform(kw, 0), xi1 = threefry_uniform(kw, 1);
  const float sA1 = xi0 * sA;
  const float s = sinf(sA1 - alpha), t = cosf(sA1 - alpha);
  const float u = t - cosf(alpha);
  const float v = s + sinf(alpha) * cos_c;
  float den = (v * s + u * t) * sinf(alpha);
  if (!(fabsf(den) > 1e-20f)) den = (float)((0.0f < den) - (den < 0.0f)) * 1e-20f + 1e-30f;
  const float q = clamp2(((v * t - u * s) * cosf(alpha) - v) / den, -1.0f, 1.0f);
  const V3 c_perp = normalize(C - dot(C, A) * A);
  const V3 C1 = q * A + sqrtf(clamp_min(1.0f - q * q, 0.0f)) * c_perp;
  const float z = clamp2(1.0f - xi1 * (1.0f - dot(C1, B)), -1.0f, 1.0f);
  const V3 b_perp = normalize(C1 - dot(C1, B) * B);
  const V3 P = normalize(z * B + sqrtf(clamp_min(1.0f - z * z, 0.0f)) * b_perp);

  // Land on the flat triangle (light_spherical.sample_from_pick).
  const float dn = dot(rec.nl, P);
  const float tl = clamp_min(dot(rec.nl, rec.pa - x1) / (fabsf(dn) > 1e-12f ? dn : 1.0f), 0.0f);
  const float p_light = has ? rec.l_sum / clamp_min(ws, 1e-30f) : 1.0f;
  const V3 coord = has ? x1 + P * tl : x1 - nrm;
  const V3 em = has ? rec.em : V3{0.0f, 0.0f, 0.0f};

  // shading.shadow_ray and nee_term with phong.eval_and_pdf_brdf's one pow.
  const V3 wr = coord - x1;
  const float dist = sqrtf(clamp_min(dot(wr, wr), 1e-20f));
  const V3 wl = wr / dist;
  const float cos_x = dot(wl, nrm), cos_l = -dot(wl, rec.nl);
  const bool ok = alive && has && cos_x > 0.0f && cos_l > 0.0f;
  const float pd = lobe_pd(Kd, Ks), ps = 1.0f - pd;
  const float spec_l = phong_lobe(clamp_min(dot(w_o, reflect(wl, nrm)), 0.0f), nse);
  const V3 f_l = Kd * INV_PI + Ks * spec_l;
  const float p_brdf = pd * (clamp_min(dot(wl, nrm), 0.0f) * INV_PI) + ps * spec_l;
  const float g = cos_x / clamp_min(p_light + p_brdf, 1e-20f);
  st3(wl_out, i, wl);
  dist_out[i] = dist;
  st3(contrib_out, i, ok ? (em * f_l) * g : V3{0.0f, 0.0f, 0.0f});

  // shading.brdf_step: phong.sample_brdf from fold(kd, P_BSDF), then f cos / pdf.
  const ThreefryKey kb = threefry_fold(kd, P_BSDF);
  const float xi_lobe = threefry_uniform(threefry_fold(kb, 0), 0);
  const ThreefryKey kx = threefry_fold(kb, 1);
  const float x0 = threefry_uniform(kx, 0), x1u = threefry_uniform(kx, 1);
  const bool pick_spec = xi_lobe >= pd;
  const float cos_t_d = sqrtf(clamp_min(1.0f - x0, 0.0f));
  const float sin_t_d = sqrtf(clamp_min(x0, 0.0f));
  const float cos_t_s = powfast(x0, (1.0f / (nse + 1.0f)) * 1.0f);
  const float sin_t_s = sqrtf(clamp_min(1.0f - cos_t_s * cos_t_s, 0.0f));
  const float phi = TWO_PI * x1u;
  const float cphi = cosf(phi), sphi = sinf(phi);
  const float cos_t = pick_spec ? cos_t_s : cos_t_d, sin_t = pick_spec ? sin_t_s : sin_t_d;
  const V3 r = reflect(w_o, nrm);
  const V3 axis = sel(pick_spec, r, nrm);
  // vecmath.orthonormal_basis (Duff et al.), then from_local.
  const float sg = axis.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (sg + axis.z)) * -1.0f;
  const float b = (axis.x * axis.y) * a;
  const V3 T = {((sg * axis.x) * axis.x) * a + 1.0f, sg * b, (-sg) * axis.x};
  const V3 Bt = {b, sg + (axis.y * axis.y) * a, -axis.y};
  const V3 wi = ((sin_t * cphi) * T + (sin_t * sphi) * Bt) + cos_t * axis;
  float pdf;
  if (branch_pdf_compat) {
    const float pdf_s = ((nse + 1.0f) * INV_2PI) * powfast(x0, nse / (nse + 1.0f));
    pdf = pick_spec ? ps * pdf_s : pd * (cos_t_d * INV_PI);
  } else {
    pdf = pd * (clamp_min(dot(wi, nrm), 0.0f) * INV_PI)
        + ps * phong_lobe(clamp_min(dot(wi, r), 0.0f), nse);
  }
  const float cos_i = dot(wi, nrm);
  const bool go_on = alive && cos_i > 0.0f && pdf > 1e-12f;
  const float spec_b = phong_lobe(clamp_min(dot(w_o, reflect(wi, nrm)), 0.0f), nse);
  const V3 f_b = Kd * INV_PI + Ks * spec_b;
  const float scale = (clamp_min(cos_i, 0.0f) / clamp_min(pdf, 1e-12f)) * 1.0f;
  const V3 t_in = ld3(tp, i);
  st3(wi_out, i, wi);
  pdf_out[i] = pdf;
  spec_out[i] = pick_spec;
  alive_out[i] = go_on;
  st3(tp_out, i, go_on ? (t_in * f_b) * scale : t_in);
}

__global__ void __launch_bounds__(THREADS)
mis_vertex_nee_add(float* __restrict__ L, const float* __restrict__ tp,
                   const float* __restrict__ contrib, const uint8_t* __restrict__ blocked, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const V3 c = blocked[i] ? V3{0.0f, 0.0f, 0.0f} : ld3(contrib, i);
  st3(L, i, ld3(L, i) + ld3(tp, i) * c);
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

//! After the trace and the gather: L with the emission, tp after roulette,
//! the live mask, K3's uniform and the ray count's start.
extern "C" int mcpt_vertex_emit(const void* hit, const void* is_light, const void* light_idx,
                                const void* emission, const void* tp, const void* L,
                                const void* depth, const void* prev_pb, const void* prev_p,
                                const void* prev_ns, const void* prev_w, const void* table,
                                int num_lights, const void* keys, const void* nrays_in,
                                float rr_prob, float w_rr, int n, void* L_out, void* tp_out,
                                void* alive_out, void* u_out, void* nrays_out, void* stream) {
  if (n < 0 || num_lights <= 0) return (int)cudaErrorInvalidValue;
  // At least one block: thread 0 starts the ray count.
  mis_vertex_emit<<<blocks_for(n > 0 ? n : 1), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(hit), static_cast<const uint8_t*>(is_light),
      static_cast<const int*>(light_idx), static_cast<const float*>(emission),
      static_cast<const float*>(tp), static_cast<const float*>(L),
      static_cast<const long long*>(depth), static_cast<const float*>(prev_pb),
      static_cast<const float*>(prev_p), static_cast<const float*>(prev_ns),
      static_cast<const float*>(prev_w), static_cast<const float*>(table), num_lights,
      static_cast<const long long*>(keys), static_cast<const long long*>(nrays_in), rr_prob,
      w_rr, n, static_cast<float*>(L_out), static_cast<float*>(tp_out),
      static_cast<uint8_t*>(alive_out), static_cast<float*>(u_out),
      static_cast<long long*>(nrays_out));
  return (int)cudaGetLastError();
}

//! After K3: the light sample's shadow ray and masked NEE contribution, the
//! BRDF sample, the continuation's mask and throughput; the shadow rays
//! added to ``nrays``.
extern "C" int mcpt_vertex_light_brdf(const void* keys, const void* lidx, const void* wsum,
                                      const void* p, const void* ns, const void* wo,
                                      const void* kd, const void* ks, const void* ns_exp,
                                      const void* alive, const void* tp, const void* table,
                                      int num_lights, int branch_pdf_compat, int n, void* wl,
                                      void* dist, void* contrib, void* wi, void* pdf,
                                      void* spec, void* alive_out, void* tp_out, void* nrays,
                                      void* stream) {
  if (n <= 0) return 0;
  if (num_lights <= 0) return (int)cudaErrorInvalidValue;
  mis_vertex_light_brdf<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(lidx),
      static_cast<const float*>(wsum), static_cast<const float*>(p),
      static_cast<const float*>(ns), static_cast<const float*>(wo),
      static_cast<const float*>(kd), static_cast<const float*>(ks),
      static_cast<const float*>(ns_exp), static_cast<const uint8_t*>(alive),
      static_cast<const float*>(tp), static_cast<const float*>(table), num_lights,
      branch_pdf_compat, n, static_cast<float*>(wl), static_cast<float*>(dist),
      static_cast<float*>(contrib), static_cast<float*>(wi), static_cast<float*>(pdf),
      static_cast<uint8_t*>(spec), static_cast<uint8_t*>(alive_out),
      static_cast<float*>(tp_out), static_cast<unsigned long long*>(nrays));
  return (int)cudaGetLastError();
}

//! After the shadow test: L += tp * (blocked ? 0 : contrib), in place.
extern "C" int mcpt_vertex_nee_add(void* L, const void* tp, const void* contrib,
                                   const void* blocked, int n, void* stream) {
  if (n <= 0) return 0;
  mis_vertex_nee_add<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<float*>(L), static_cast<const float*>(tp), static_cast<const float*>(contrib),
      static_cast<const uint8_t*>(blocked), n);
  return (int)cudaGetLastError();
}
