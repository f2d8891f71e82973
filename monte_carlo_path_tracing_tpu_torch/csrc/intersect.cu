// K1 (nearest hit) and K2 (any hit / shadow test) for Hopper.
//
// Replaces the streamed Pallas TPU kernels of
// monte_carlo_path_tracing_tpu/ops/intersect_pallas.py:
//   K1  _kernel_nearest_s  (accept math in _tile_accepts_s/_accept_epilogue,
//                           winner recovery in _call_nearest)
//   K2  _kernel_occluded_s
//
// What they compute. A ray is the feature row g = [ro, rd, ro x rd, 1] and a
// triangle the packed [10][4] matrix W of ops/intersect_ref.pack_tri_matrix;
// g . W[:, c] gives det, u*det, v*det and t*det. After sign correction by
// sign(det) a triangle is accepted iff u', v', |det|-u'-v', t'-t_eps|det|
// and |det|-DET_EPS are all >= 0 and its id is not the ray's excluded id
// (quirk Q8). K1 keeps the running minimum of t = t'/|det| with strict '<'
// over triangles in accel (Morton) order, so ties keep the lowest index as
// the Pallas argmin does, then re-evaluates the winner's t, u, v. K2 asks
// whether any accepted triangle has t' < tmax |det| (tmax pre-scaled by
// the caller's occlusion margin).
//
// What bounds it on this card. Every (ray, triangle) pair costs ~40 f32
// multiplies, ~36 adds and the accept test, and reads 40 floats of W that
// all rays share: at the main path's 32k rays x 3.1k triangles the kernels
// are bound by f32 issue rate, not by memory. What matters, as on the TPU,
// is that the [rays, triangles] candidate field never reaches device
// memory. Design:
//   - W and the ids are staged through shared memory in tiles of
//     TILE triangles; every thread reads them as broadcasts;
//   - GROUP threads share one ray and take interleaved triangles of each
//     tile, which keeps enough warps resident at 32k rays; their partial
//     (t, index) results are merged with shuffles (min t, then lowest
//     index), which equals the sequential strict-'<' order;
//   - K2 leaves a tile loop once every ray of the block is blocked.
//
// Exact f32: the dot products are the ordered sums k = 0..9 of the plain
// torch version (ops/intersect_cuda.py), built with -fmad=false so nvcc
// contracts no multiply-add; division and comparisons are IEEE. No tensor
// cores and no library kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;              // triangles staged per step
constexpr int GROUP = 4;               // threads per ray
constexpr int BLOCK = 256;             // threads per block
constexpr int RAYS = BLOCK / GROUP;    // rays per block
constexpr float BIG_T = 3.0e38f;
constexpr float DET_EPS = 1e-9f;

__device__ __forceinline__ float dot10(const float* g, const float* w, int c) {
  float acc = g[0] * w[c];
#pragma unroll
  for (int k = 1; k < 10; ++k) acc = acc + g[k] * w[k * 4 + c];
  return acc;
}

// Sign-corrected (tp, adet) and the accept decision of one pair.
__device__ __forceinline__ bool accept(const float* g, const float* w, int id,
                                       int excl, float t_eps, float* tp_out,
                                       float* adet_out) {
  const float det = dot10(g, w, 0);
  const float un = dot10(g, w, 1);
  const float vn = dot10(g, w, 2);
  const float tn = dot10(g, w, 3);
  const float s = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  const float adet = det * s;
  const float up = un * s;
  const float vp = vn * s;
  const float tp = tn * s;
  *tp_out = tp;
  *adet_out = adet;
  return up >= 0.0f && vp >= 0.0f && adet - (up + vp) >= 0.0f &&
         tp - t_eps * adet >= 0.0f && adet - DET_EPS >= 0.0f && id != excl;
}

__device__ __forceinline__ void stage(float* sW, int* sId, const float* W,
                                      const int* ids, int base, int n) {
  for (int i = threadIdx.x; i < n * 40; i += BLOCK) sW[i] = W[base * 40 + i];
  for (int i = threadIdx.x; i < n; i += BLOCK) sId[i] = ids[base + i];
}

__global__ void __launch_bounds__(BLOCK)
nearest_kernel(const float* __restrict__ g, const float* __restrict__ W,
               const int* __restrict__ ids, const int* __restrict__ excl,
               int N, int T, float t_eps, float* __restrict__ t_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               int* __restrict__ id_out) {
  __shared__ float sW[TILE * 40];
  __shared__ int sId[TILE];
  const int ray = blockIdx.x * RAYS + threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const bool active = ray < N;
  float gr[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) gr[k] = active ? g[ray * 10 + k] : 0.0f;
  const int ex = active ? excl[ray] : -1;

  float best_t = BIG_T;
  int best_i = -1;
  for (int base = 0; base < T; base += TILE) {
    const int n = min(TILE, T - base);
    __syncthreads();
    stage(sW, sId, W, ids, base, n);
    __syncthreads();
    for (int k = lane; k < n; k += GROUP) {
      float tp, adet;
      if (accept(gr, &sW[k * 40], sId[k], ex, t_eps, &tp, &adet)) {
        const float t = tp / adet;
        if (t < best_t) {
          best_t = t;
          best_i = base + k;
        }
      }
    }
  }
  // Merge the GROUP partial results: min t, ties to the lowest index.
#pragma unroll
  for (int off = 1; off < GROUP; off <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ot < best_t || (ot == best_t && oi < best_i)) {
      best_t = ot;
      best_i = oi;
    }
  }
  if (!active || lane != 0) return;
  if (best_i < 0) {
    t_out[ray] = BIG_T;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
    id_out[ray] = -1;
    return;
  }
  // Winner recovery: the same ordered dots, t/u/v = numerator * (1/det).
  const float* w = W + (size_t)best_i * 40;
  const float det = dot10(gr, w, 0);
  const float inv = 1.0f / (fabsf(det) > 0.0f ? det : 1.0f);
  u_out[ray] = dot10(gr, w, 1) * inv;
  v_out[ray] = dot10(gr, w, 2) * inv;
  t_out[ray] = dot10(gr, w, 3) * inv;
  id_out[ray] = ids[best_i];
}

__global__ void __launch_bounds__(BLOCK)
occluded_kernel(const float* __restrict__ g, const float* __restrict__ W,
                const int* __restrict__ ids, const int* __restrict__ excl,
                const float* __restrict__ tmax, int N, int T, float t_eps,
                int* __restrict__ out) {
  __shared__ float sW[TILE * 40];
  __shared__ int sId[TILE];
  const int ray = blockIdx.x * RAYS + threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const bool active = ray < N;
  float gr[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) gr[k] = active ? g[ray * 10 + k] : 0.0f;
  const int ex = active ? excl[ray] : -1;
  const float tm = active ? tmax[ray] : 0.0f;
  const unsigned group_mask = ((1u << GROUP) - 1u) << ((threadIdx.x % 32) & ~(GROUP - 1));

  bool blocked = false;
  for (int base = 0; base < T; base += TILE) {
    // Every ray of the block settled: nothing left to prove.
    if (__syncthreads_and(blocked || !active)) break;
    const int n = min(TILE, T - base);
    stage(sW, sId, W, ids, base, n);
    __syncthreads();
    if (!blocked) {
      for (int k = lane; k < n; k += GROUP) {
        float tp, adet;
        if (accept(gr, &sW[k * 40], sId[k], ex, t_eps, &tp, &adet) &&
            tp < tm * adet) {
          blocked = true;
          break;
        }
      }
    }
    // Share the verdict inside the ray's group.
    blocked = (__ballot_sync(0xffffffffu, blocked) & group_mask) != 0u;
  }
  if (active && lane == 0) out[ray] = blocked ? 1 : 0;
}

}  // namespace

extern "C" int mcpt_nearest(const float* g, const float* W, const int* ids,
                            const int* excl, int N, int T, float t_eps,
                            float* t, float* u, float* v, int* tri_id,
                            void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + RAYS - 1) / RAYS;
  nearest_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      g, W, ids, excl, N, T, t_eps, t, u, v, tri_id);
  return (int)cudaGetLastError();
}

extern "C" int mcpt_occluded(const float* g, const float* W, const int* ids,
                             const int* excl, const float* tmax, int N, int T,
                             float t_eps, int* blocked, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + RAYS - 1) / RAYS;
  occluded_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      g, W, ids, excl, tmax, N, T, t_eps, blocked);
  return (int)cudaGetLastError();
}
