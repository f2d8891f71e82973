// K1 / K2 (all-pairs nearest hit / any hit) and K4 / K5 (their culled
// forms) for Hopper.
//
// Replaces the Pallas TPU kernels of
// monte_carlo_path_tracing_tpu/ops/intersect_pallas.py:
//   K1  _kernel_nearest_s  (accept math in _tile_accepts_s/_accept_epilogue,
//                           winner recovery in _call_nearest)
//   K2  _kernel_occluded_s
//   K4  _kernel_nearest  with cull=True (see the K4 / K5 section below)
//   K5  _kernel_occluded with cull=True
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

// Winner recovery of ray `ray` (triangle idx, or -1 for a miss): the same
// ordered dots, t/u/v = numerator * (1/det).
__device__ __forceinline__ void recover(const float* gr, const float* W,
                                        const int* ids, int idx, int ray,
                                        float* t_out, float* u_out,
                                        float* v_out, int* id_out) {
  if (idx < 0) {
    t_out[ray] = BIG_T;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
    id_out[ray] = -1;
    return;
  }
  const float* w = W + (size_t)idx * 40;
  const float det = dot10(gr, w, 0);
  const float inv = 1.0f / (fabsf(det) > 0.0f ? det : 1.0f);
  u_out[ray] = dot10(gr, w, 1) * inv;
  v_out[ray] = dot10(gr, w, 2) * inv;
  t_out[ray] = dot10(gr, w, 3) * inv;
  id_out[ray] = ids[idx];
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
  recover(gr, W, ids, best_i, ray, t_out, u_out, v_out, id_out);
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


// ---------------------------------------------------------------------------
// K4 / K5: culled nearest hit and any hit on a visit schedule.
//
// The schedule comes from ops/intersect_cuda.cull_schedule (plain torch, as
// the JAX package computes it in XLA): rays are cut into tiles of
// CULL_RAYS rays; for ray tile r, order[r][k] is the k-th triangle tile to
// visit and te[r][k] its conservative entry distance, ascending (tiles the ray tile
// cannot touch have te = BIG_T). One CTA runs one ray tile, CULL_G threads
// per ray taking interleaved triangles of each tile; each visited triangle
// tile (tile <= TILE triangles, 40 floats + id each, ~41 KB) is staged through
// shared memory as in K1.
//
// K4 visits tile k iff the largest best t of the CTA's rays is >= te[k];
// te ascends and best t only falls, so the first tile that fails ends the
// walk (exactly as the Pallas kernel's skipped tail). The best-t carry
// starts at the ray's scene-exit cap, not at BIG_T, so rays that miss stop
// forcing far tiles. Updates are strict '<' in visit order; the partial
// results merge on (t, visit position, in-tile index), which reproduces the
// schedule's tie rule: the first visited tile wins, then the lowest index.
// K5 visits tile k iff te[k] < BIG_T / 2 and some ray of the CTA is not yet
// blocked; an any-hit result does not depend on the order.
//
// What bounds them: the same per-pair f32 issue rate as K1 / K2 on the
// tiles visited; culling cuts the number of tiles. With few ray tiles
// (32k rays / 512) only 64 of the 132 SMs get a CTA; 128-ray tiles made
// K4 + K5 of a prepass chunk slower on an H100 (PERF.md), so the ray tile
// is fixed at JAX's 512.

constexpr int CULL_RAYS = 512;         // rays per tile (JAX RAY_TILE)
constexpr int CULL_G = 2;              // threads per ray
constexpr int CULL_BLOCK = CULL_RAYS * CULL_G;
constexpr float SKIP_TE = 1.5e38f;     // te at or above: never visited

__device__ __forceinline__ void stage_n(float* sW, int* sId, const float* W,
                                        const int* ids, int base, int n) {
  for (int i = threadIdx.x; i < n * 40; i += CULL_BLOCK) sW[i] = W[base * 40 + i];
  for (int i = threadIdx.x; i < n; i += CULL_BLOCK) sId[i] = ids[base + i];
}

__global__ void __launch_bounds__(CULL_BLOCK)
nearest_culled_kernel(const float* __restrict__ g, const float* __restrict__ W,
                      const int* __restrict__ ids, const int* __restrict__ excl,
                      const float* __restrict__ cap, const int* __restrict__ order,
                      const float* __restrict__ te, int nb, int tile,
                      float t_eps, float* __restrict__ t_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ id_out) {
  __shared__ float sW[TILE * 40];
  __shared__ int sId[TILE];
  const int ray = blockIdx.x * CULL_RAYS + threadIdx.x / CULL_G;
  const int lane = threadIdx.x % CULL_G;
  const int* ord = order + (size_t)blockIdx.x * nb;
  const float* tev = te + (size_t)blockIdx.x * nb;
  float gr[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) gr[k] = g[ray * 10 + k];
  const int ex = excl[ray];

  float best_t = cap[ray];
  int best_pos = -1;                   // visit position * tile + in-tile index
  for (int k = 0; k < nb; ++k) {
    float ray_t = best_t;              // this ray's best over its threads
#pragma unroll
    for (int off = 1; off < CULL_G; off <<= 1)
      ray_t = fminf(ray_t, __shfl_xor_sync(0xffffffffu, ray_t, off));
    // Barrier too: the previous tile is consumed before it is overwritten.
    if (!__syncthreads_or(ray_t >= tev[k])) break;
    stage_n(sW, sId, W, ids, ord[k] * tile, tile);
    __syncthreads();
    for (int j = lane; j < tile; j += CULL_G) {
      float tp, adet;
      if (accept(gr, &sW[j * 40], sId[j], ex, t_eps, &tp, &adet)) {
        const float t = tp / adet;
        if (t < best_t) {
          best_t = t;
          best_pos = k * tile + j;
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < CULL_G; off <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    const int op = __shfl_xor_sync(0xffffffffu, best_pos, off);
    if (ot < best_t || (ot == best_t && op < best_pos)) {
      best_t = ot;
      best_pos = op;
    }
  }
  if (lane != 0) return;
  const int idx = best_pos < 0 ? -1 : ord[best_pos / tile] * tile + best_pos % tile;
  recover(gr, W, ids, idx, ray, t_out, u_out, v_out, id_out);
}

__global__ void __launch_bounds__(CULL_BLOCK)
occluded_culled_kernel(const float* __restrict__ g, const float* __restrict__ W,
                       const int* __restrict__ ids, const int* __restrict__ excl,
                       const float* __restrict__ tmax, const int* __restrict__ order,
                       const float* __restrict__ te, int nb, int tile,
                       float t_eps, int* __restrict__ out) {
  __shared__ float sW[TILE * 40];
  __shared__ int sId[TILE];
  const int ray = blockIdx.x * CULL_RAYS + threadIdx.x / CULL_G;
  const int lane = threadIdx.x % CULL_G;
  const int* ord = order + (size_t)blockIdx.x * nb;
  const float* tev = te + (size_t)blockIdx.x * nb;
  float gr[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) gr[k] = g[ray * 10 + k];
  const int ex = excl[ray];
  const float tm = tmax[ray];
  const unsigned group_mask = ((1u << CULL_G) - 1u) << ((threadIdx.x % 32) & ~(CULL_G - 1));

  bool blocked = false;
  for (int k = 0; k < nb; ++k) {
    if (!(tev[k] < SKIP_TE)) break;    // te ascends: the rest are culled too
    if (!__syncthreads_or(!blocked)) break;
    stage_n(sW, sId, W, ids, ord[k] * tile, tile);
    __syncthreads();
    if (!blocked) {
      for (int j = lane; j < tile; j += CULL_G) {
        float tp, adet;
        if (accept(gr, &sW[j * 40], sId[j], ex, t_eps, &tp, &adet) &&
            tp < tm * adet) {
          blocked = true;
          break;
        }
      }
    }
    blocked = (__ballot_sync(0xffffffffu, blocked) & group_mask) != 0u;
  }
  if (lane == 0) out[ray] = blocked ? 1 : 0;
}

inline bool culled_args_ok(int nrt, int nb, int tile) {
  return nrt > 0 && nb > 0 && tile > 0 && tile <= TILE;
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

extern "C" int mcpt_nearest_culled(const float* g, const float* W, const int* ids,
                                   const int* excl, const float* cap,
                                   const int* order, const float* te, int nrt,
                                   int nb, int tile, float t_eps, float* t, float* u,
                                   float* v, int* tri_id, void* stream) {
  if (!culled_args_ok(nrt, nb, tile)) return (int)cudaErrorInvalidValue;
  nearest_culled_kernel<<<nrt, CULL_BLOCK, 0, (cudaStream_t)stream>>>(
      g, W, ids, excl, cap, order, te, nb, tile, t_eps, t, u, v, tri_id);
  return (int)cudaGetLastError();
}

extern "C" int mcpt_occluded_culled(const float* g, const float* W, const int* ids,
                                    const int* excl, const float* tmax,
                                    const int* order, const float* te, int nrt,
                                    int nb, int tile, float t_eps, int* blocked,
                                    void* stream) {
  if (!culled_args_ok(nrt, nb, tile)) return (int)cudaErrorInvalidValue;
  occluded_culled_kernel<<<nrt, CULL_BLOCK, 0, (cudaStream_t)stream>>>(
      g, W, ids, excl, tmax, order, te, nb, tile, t_eps, blocked);
  return (int)cudaGetLastError();
}
