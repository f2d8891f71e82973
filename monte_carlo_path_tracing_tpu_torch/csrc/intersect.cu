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
// What bounds K1 / K2 on this card. Every (ray, triangle) pair costs about
// 90 f32 operations (four 10-term dots: 40 multiplies and 36 adds; the sign
// fix and the margin test about 14) and reads the triangle's 40 floats of
// W, which all rays share. At the loop's 32,768-65,536 rays x 3,136
// triangles a call moves a few MB, under a microsecond at 3.35 TB/s, and
// needs ~0.14-0.28 ms at the 67 TFLOP/s f32 peak: compute-bound. As on the
// TPU, the [rays, triangles] candidate field never reaches device memory.
// Design, against what held the first design back:
//   - register-blocked rays: each thread holds R = RB_R = 4 rays (10
//     features, best t, best index, excluded id each) and applies every
//     triangle it reads to all R, so a triangle costs 10 float4 shared loads
//     per R pairs (40 scalar loads per pair before) and a thread has 4R
//     independent multiply-add chains to issue. R = 4 beat 2 and 8 at both
//     65,536 and 32,768 rays on an H100 (PERF.md);
//   - fused multiply-adds: the dots are __fmaf_rn chains in the order
//     k = 0..9 (10 instructions per dot, not 19). The intrinsic holds under
//     the library's -fmad=false, which keeps the rest of the library (the
//     margin test, winner recovery, K3-K5) separately rounded. For an equal
//     winner, t, u and v are bit-equal to the plain version; only pairs
//     whose margin lies within an ulp of zero can decide differently. The
//     separately rounded dots stay as an instance (fma = 0) for comparison;
//   - RB_G = 4 threads share a block of rays and take interleaved
//     triangles of each tile (rows 160 bytes apart: the four float4 loads of
//     a warp hit distinct banks); their partial (t, index) results merge by
//     shuffles, min t then lowest index, which equals the sequential
//     strict-'<' order. A CTA of 128 threads holds 128 rays, so
//     32,768 and 65,536 rays give 256 and 512 CTAs for 132 SMs;
//   - asynchronous staging: tiles of RB_TILE triangles of W (contiguous,
//     rows 16-byte aligned) arrive by one Hopper bulk copy each
//     (cp.async.bulk, completion on an mbarrier, issued by one thread) into
//     a ring of RB_STAGES stages, so tile k+1 lands while tile k is
//     computed. The ragged last tile is a shorter copy (160 bytes a row).
//     Triangle ids are not staged: the excluded-id test runs only for pairs
//     that pass the margin test, reading the id through the read-only cache;
//   - padding rows: the caller hands over the accel's real rows only
//     (ops/intersect.py), so the 448 never-accepted rows of Veach's padded
//     accel cost nothing;
//   - one branch for R rays: the margin tests of a triangle's R pairs are
//     predicates ORed together, and only when one passes does the thread
//     divide, read the id and update; the pair loop is unrolled twice so
//     one triangle's shared loads overlap the other's arithmetic;
//   - K2 ORs in place of the running minimum; a thread stops computing once
//     its R rays are blocked, and the CTA leaves the tile loop once all its
//     rays are (__syncthreads_and), after waiting for the bulk copies still
//     in flight into its shared memory.
// What is left: the common path issues ~55 instructions per pair (K1 at
// R = 4: 36 FFMA and 5 FMUL, ~11 for the sign fix and margin test, 2.5
// shared loads; K2 ~59; chip_sass.py counts them), against the ~45 issue
// slots per pair the bound allows, so at best ~80% of it.
// Not used: the four dots are a [rays, 10] x [10, 4 x triangles] product,
// but tensor cores reach f32 only as TF32, which drops 13 mantissa bits; the
// margin test then flips (a ~0.4% coefficient error once moved the
// framebuffer checksum by 11%, ROADMAP.md). The kernels stay exact f32 on
// the CUDA cores. No library kernels.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;              // largest schedule tile (K4 / K5)
constexpr float BIG_T = 3.0e38f;
constexpr float DET_EPS = 1e-9f;

__device__ __forceinline__ float dot10(const float* g, const float* w, int c) {
  float acc = g[0] * w[c];
#pragma unroll
  for (int k = 1; k < 10; ++k) acc = acc + g[k] * w[k * 4 + c];
  return acc;
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

// ---------------------------------------------------------------------------
// K1 / K2: register-blocked rays, fused dots, bulk-copied triangle tiles.

constexpr int RB_R = 4;                        // rays per thread
constexpr int RB_G = 4;                        // threads per block of rays
constexpr int RB_THREADS = 128;                // threads per CTA
constexpr int RB_SLOTS = RB_THREADS / RB_G;    // blocks of rays per CTA
constexpr int RB_TILE = 128;                   // triangles per staged tile
constexpr int RB_STAGES = 2;                   // tiles in flight
constexpr int RB_ROW_BYTES = 40 * 4;           // one triangle's W
constexpr int RB_SMEM = RB_STAGES * RB_TILE * RB_ROW_BYTES;   // 40,960 bytes

// Hopper's asynchronous bulk copy and shared-memory barrier (PTX). A barrier
// here counts one arrival per phase: the thread that issues the copy of a
// phase arrives once, announcing the bytes it will bring; the phase
// completes when that arrival and all those bytes are in.
__device__ __forceinline__ uint32_t ptx_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ptx_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(ptx_smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The phase's one arrival, announcing `bytes` still to land (0: none). The
// proxy fence orders the CTA's earlier reads of the shared memory the
// copies will overwrite before the copies.
__device__ __forceinline__ void ptx_mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(ptx_smem(bar)), "r"(bytes) : "memory");
}

// One copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory whose bytes count towards `bar`'s phase.
__device__ __forceinline__ void ptx_bulk_load(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(ptx_smem(dst)), "l"(src), "r"(bytes), "r"(ptx_smem(bar)) : "memory");
}

// Block until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void ptx_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(ptx_smem(bar)), "r"(parity) : "memory");
}

// Where tile k of a walk comes from: rows(k) rows of W from row first(k).
// K1 / K2 walk W in accel order, RB_TILE rows a tile.
struct FlatFeed {
  int T;
  __device__ int first(int k) const { return k * RB_TILE; }
  __device__ int rows(int k) const { return min(RB_TILE, T - k * RB_TILE); }
};

// The staging ring: tile k of a walk goes into stage k % RB_STAGES by one
// bulk copy that thread 0 issues (an empty tile by a bare arrival);
// full[stage] completes when its bytes landed.
template <class Feed>
struct Ring {
  const float* W;
  float4* tiles;                       // RB_STAGES x RB_TILE rows of W
  uint64_t* full;
  Feed feed;
  int ntiles;

  __device__ float4* tile(int k) const { return tiles + (k % RB_STAGES) * (RB_TILE * 10); }
  __device__ uint64_t* bar(int k) const { return &full[k % RB_STAGES]; }
  __device__ void issue(int k) const {
    const uint32_t bytes = max(feed.rows(k), 0) * RB_ROW_BYTES;
    ptx_mbar_arrive_tx(bar(k), bytes);
    if (bytes) ptx_bulk_load(tile(k), W + (size_t)feed.first(k) * 40, bytes, bar(k));
  }
  // Thread 0 sets up the barriers and issues the walk's first tiles; every
  // thread passes the CTA barrier after it.
  __device__ void start() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < RB_STAGES; ++s) ptx_mbar_init(&full[s]);
      for (int k = 0; k < min(RB_STAGES, ntiles); ++k) issue(k);
    }
    __syncthreads();
  }
  __device__ void wait(int k) const { ptx_mbar_wait(bar(k), (k / RB_STAGES) & 1); }
  // After every thread is done with tile k: refill its stage.
  __device__ void advance(int k) const {
    if (threadIdx.x == 0 && k + RB_STAGES < ntiles) issue(k + RB_STAGES);
  }
  // Leaving after tile k: wait for the copies still in flight.
  __device__ void drain(int k) const {
    for (int j = k + 1; j < min(k + RB_STAGES, ntiles); ++j) wait(j);
  }
};

template <bool FMA>
__device__ __forceinline__ float madd(float a, float b, float acc) {
  return FMA ? __fmaf_rn(a, b, acc) : __fadd_rn(acc, __fmul_rn(a, b));
}

// acc[r][c] = g[r] . W[:, c] for one triangle (rows w[0..9]), in the order
// k = 0..9: fused (FMA) or separately rounded, as the plain version.
template <bool FMA>
__device__ __forceinline__ void dots(const float (&g)[RB_R][10], const float4* w,
                                     float (&acc)[RB_R][4]) {
  const float4 w0 = w[0];
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    acc[r][0] = __fmul_rn(g[r][0], w0.x);
    acc[r][1] = __fmul_rn(g[r][0], w0.y);
    acc[r][2] = __fmul_rn(g[r][0], w0.z);
    acc[r][3] = __fmul_rn(g[r][0], w0.w);
  }
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    const float4 wk = w[k];
#pragma unroll
    for (int r = 0; r < RB_R; ++r) {
      acc[r][0] = madd<FMA>(g[r][k], wk.x, acc[r][0]);
      acc[r][1] = madd<FMA>(g[r][k], wk.y, acc[r][1]);
      acc[r][2] = madd<FMA>(g[r][k], wk.z, acc[r][2]);
      acc[r][3] = madd<FMA>(g[r][k], wk.w, acc[r][3]);
    }
  }
}

// The accept test without the id test, on the dots (det, u', v', t') of
// one pair: the plain version's sign fix (multiply by sign(det)) and its
// margins "a - b >= 0". Here the sign fix flips sign bits (det != 0
// wherever it matters) and each margin is "a >= b", both exact in IEEE
// f32, so the decision, tp and adet equal the plain version's bit for bit
// on the same dots.
__device__ __forceinline__ bool margin_ok(const float (&a)[4], float t_eps,
                                          float& tp, float& adet) {
  const uint32_t sb = __float_as_uint(a[0]) & 0x80000000u;
  adet = fabsf(a[0]);
  const float up = __uint_as_float(__float_as_uint(a[1]) ^ sb);
  const float vp = __uint_as_float(__float_as_uint(a[2]) ^ sb);
  tp = __uint_as_float(__float_as_uint(a[3]) ^ sb);
  return (up >= 0.0f) & (vp >= 0.0f) & (adet >= up + vp) & (tp >= t_eps * adet) &
         (adet >= DET_EPS);
}

// Ray r of thread slot `slot` in block of rays `blk` (K1 / K2: the CTA).
__device__ __forceinline__ int rb_ray(int slot, int r, int blk = blockIdx.x) {
  return blk * (RB_SLOTS * RB_R) + r * RB_SLOTS + slot;
}

__device__ __forceinline__ void load_rays(const float* g, const int* excl, int N,
                                          int slot, float (&gr)[RB_R][10], int (&ex)[RB_R],
                                          int blk = blockIdx.x) {
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    const int ray = rb_ray(slot, r, blk);
    const bool active = ray < N;
#pragma unroll
    for (int k = 0; k < 10; ++k) gr[r][k] = active ? g[(size_t)ray * 10 + k] : 0.0f;
    ex[r] = active ? excl[ray] : -1;
  }
}

// The nearest-hit walk of K1 and K4 over one staged tile (rows [tile, end)
// of W): this thread takes rows lane, lane + RB_G, ... and keeps, for each
// of its R rays, the least t with strict '<' and its key, key0 + row; the
// tile's ids (`ids`, row 0 first) are read only on an accepted pair. Keys
// rise along a walk, so equal t keep the lowest key.
template <bool FMA>
__device__ __forceinline__ void nearest_tile(const float4* tile, const float4* end,
                                             const float (&gr)[RB_R][10], const int (&ex)[RB_R],
                                             const int* __restrict__ ids, int key0, float t_eps,
                                             float (&best_t)[RB_R], int (&best_k)[RB_R]) {
  const int lane = threadIdx.x % RB_G;
#pragma unroll 2                     // two triangles a pass: loads overlap
  for (const float4* w = tile + lane * 10; w < end; w += RB_G * 10) {
    float acc[RB_R][4], tp[RB_R], adet[RB_R];
    bool ok[RB_R], any = false;
    dots<FMA>(gr, w, acc);
#pragma unroll
    for (int r = 0; r < RB_R; ++r) {
      ok[r] = margin_ok(acc[r], t_eps, tp[r], adet[r]);
      any |= ok[r];
    }
    if (!any) continue;                // most pairs: one branch for R rays
    const int row = static_cast<int>(w - tile) / 10;
    const int id = __ldg(ids + row);
#pragma unroll
    for (int r = 0; r < RB_R; ++r) {
      if (!ok[r]) continue;
      const float t = tp[r] / adet[r];
      if (t < best_t[r] && id != ex[r]) {
        best_t[r] = t;
        best_k[r] = key0 + row;
      }
    }
  }
}

// Merge the RB_G partial results of each ray: min t, ties to the lowest
// key, which is the sequential strict-'<' walk's answer.
__device__ __forceinline__ void merge_lanes(float (&best_t)[RB_R], int (&best_k)[RB_R]) {
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
#pragma unroll
    for (int off = 1; off < RB_G; off <<= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, best_t[r], off);
      const int ov = __shfl_xor_sync(0xffffffffu, best_k[r], off);
      if (ot < best_t[r] || (ot == best_t[r] && ov < best_k[r])) {
        best_t[r] = ot;
        best_k[r] = ov;
      }
    }
  }
}

template <bool FMA>
__global__ void __launch_bounds__(RB_THREADS)
nearest_kernel(const float* __restrict__ g, const float* __restrict__ W,
               const int* __restrict__ ids, const int* __restrict__ excl,
               int N, int T, float t_eps, float* __restrict__ t_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               int* __restrict__ id_out) {
  extern __shared__ float4 rb_tiles[];
  __shared__ uint64_t full[RB_STAGES];
  const int slot = threadIdx.x / RB_G;
  float gr[RB_R][10];
  int ex[RB_R];
  load_rays(g, excl, N, slot, gr, ex);
  float best_t[RB_R];
  int best_i[RB_R];                    // key: the index in accel order
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    best_t[r] = BIG_T;
    best_i[r] = -1;
  }

  const Ring<FlatFeed> ring{W, rb_tiles, full, {T}, (T + RB_TILE - 1) / RB_TILE};
  ring.start();
  for (int k = 0; k < ring.ntiles; ++k) {
    ring.wait(k);
    const float4* tile = ring.tile(k);
    const int first = ring.feed.first(k);
    nearest_tile<FMA>(tile, tile + ring.feed.rows(k) * 10, gr, ex, ids + first, first, t_eps,
                      best_t, best_i);
    __syncthreads();                   // every thread is done with tile k
    ring.advance(k);
  }
  merge_lanes(best_t, best_i);
  if (threadIdx.x % RB_G != 0) return;
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    const int ray = rb_ray(slot, r);
    if (ray < N) recover(gr[r], W, ids, best_i[r], ray, t_out, u_out, v_out, id_out);
  }
}

// The any-hit walk of K2 and K5 over the tiles of a started ring: ORs
// (accepted, t' < tmax |det|, id not excluded) into `blocked` for this
// thread's R rays; leaves once every ray of the CTA is blocked, after the
// copies still in flight landed.
template <bool FMA, class Feed>
__device__ __forceinline__ void anyhit_walk(const Ring<Feed>& ring,
                                           const float (&gr)[RB_R][10], const int (&ex)[RB_R],
                                           const float (&tm)[RB_R], bool (&blocked)[RB_R],
                                           const int* __restrict__ ids, float t_eps) {
  const int lane = threadIdx.x % RB_G;
  const unsigned group_mask = ((1u << RB_G) - 1u) << ((threadIdx.x % 32) & ~(RB_G - 1));
  for (int k = 0; k < ring.ntiles; ++k) {
    ring.wait(k);
    const float4* tile = ring.tile(k);
    const float4* end = tile + max(ring.feed.rows(k), 0) * 10;
    bool settled = true;
#pragma unroll
    for (int r = 0; r < RB_R; ++r) settled = settled && blocked[r];
#pragma unroll 2
    for (const float4* w = tile + lane * 10; w < end && !settled; w += RB_G * 10) {
      float acc[RB_R][4];
      bool hit[RB_R], any = false;
      dots<FMA>(gr, w, acc);
#pragma unroll
      for (int r = 0; r < RB_R; ++r) {
        float tp, adet;
        const bool ok = margin_ok(acc[r], t_eps, tp, adet);
        hit[r] = ok & (tp < tm[r] * adet);
        any |= hit[r];
      }
      if (!any) continue;              // most pairs: one branch for R rays
      const int id = __ldg(ids + ring.feed.first(k) + static_cast<int>(w - tile) / 10);
      settled = true;
#pragma unroll
      for (int r = 0; r < RB_R; ++r) {
        blocked[r] |= hit[r] & (id != ex[r]);
        settled &= blocked[r];
      }
    }
    // Share the verdicts inside each ray's group of RB_G threads.
    settled = true;
#pragma unroll
    for (int r = 0; r < RB_R; ++r) {
      blocked[r] = (__ballot_sync(0xffffffffu, blocked[r]) & group_mask) != 0u;
      settled = settled && blocked[r];
    }
    // Every thread is done with tile k; leave once every ray is blocked.
    if (__syncthreads_and(settled)) {
      ring.drain(k);
      return;
    }
    ring.advance(k);
  }
}

template <bool FMA>
__global__ void __launch_bounds__(RB_THREADS)
occluded_kernel(const float* __restrict__ g, const float* __restrict__ W,
                const int* __restrict__ ids, const int* __restrict__ excl,
                const float* __restrict__ tmax, int N, int T, float t_eps,
                int* __restrict__ out) {
  extern __shared__ float4 rb_tiles[];
  __shared__ uint64_t full[RB_STAGES];
  const int slot = threadIdx.x / RB_G;
  float gr[RB_R][10];
  int ex[RB_R];
  load_rays(g, excl, N, slot, gr, ex);
  float tm[RB_R];
  bool blocked[RB_R];                  // rays past N count as settled
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    const int ray = rb_ray(slot, r);
    tm[r] = ray < N ? tmax[ray] : 0.0f;
    blocked[r] = ray >= N;
  }

  const Ring<FlatFeed> ring{W, rb_tiles, full, {T}, (T + RB_TILE - 1) / RB_TILE};
  ring.start();
  anyhit_walk<FMA>(ring, gr, ex, tm, blocked, ids, t_eps);
  if (threadIdx.x % RB_G != 0) return;
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    const int ray = rb_ray(slot, r);
    if (ray < N) out[ray] = blocked[r] ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K4 / K5: culled nearest hit and any hit on a visit schedule.
//
// The schedule comes from ops/intersect_cuda.cull_schedule (plain torch, as
// the JAX package computes it in XLA): rays are cut into tiles of
// CULL_RAYS rays; for ray tile r, order[r][k] is the k-th triangle tile to
// visit and te[r][k] its conservative entry distance, ascending (tiles the
// ray tile cannot touch have te = BIG_T). Schedule tile order[r][k] is
// `tile` (256) contiguous rows of W, fed to the two-stage ring as `sub`
// stages of RB_TILE rows (128: the ring stays 40 KB and five CTAs fit an
// SM).
//
// Both are the all-pairs kernels' walks on that schedule (register-blocked
// rays, fused dots, one branch per R rays, bulk-copied tiles), so what
// bounds them is K1's / K2's per-pair issue rate on the pairs the visited
// tiles hold. Design:
//   - CULL_CTAS CTAs of 128 rays (RB_SLOTS blocks of RB_R rays) per ray
//     tile, each walking that tile's schedule row for its own rays: a
//     prepass camera fan of 32,768 rays gives 256 CTAs and a shadow batch
//     of 157,462 rays 1,232, where one CTA per ray tile would give 64 and
//     308 for 132 SMs;
//   - padding rows cost nothing: the Morton-ordered accel puts them last
//     (192 in Veach's last real tile), so the caller passes the count of
//     real rows and a stage copies and computes only rows below it; ids
//     are read only on an accepted pair.
//
// K4 visits schedule tile k iff the largest best t among the CTA's rays
// (a ray's best t: the min over its RB_G threads) is >= te[k]; te ascends
// and best t only falls, so the first tile that fails ends the walk, as
// the Pallas kernel's skipped tail. Breaking per CTA is exact: te of the
// ray tile bounds every hit of any subset of its rays from below. The test
// falls at schedule-tile boundaries, one __syncthreads_or per tile, which
// also ends every thread's use of the stage before; a walk that ends
// waits for the copies still in flight. The best-t carry starts at the
// ray's scene-exit cap, not at BIG_T, so rays that miss stop forcing far
// tiles. Updates are strict '<' in visit order on the key visit position
// x tile + in-tile index, and the threads' results merge on (t, key), so
// the first visited tile wins a tie, then the lowest index in it (JAX's
// b * tile + lane with strict '<' across tiles; K1's lowest accel index
// would be the wrong rule here). The winner's key maps back through order
// to its row of W for recovery.
//
// K5 visits every tile with te[k] < BIG_T / 2 (a prefix: te ascends) until
// all its rays are blocked; an any-hit answer depends neither on the order
// nor on which rays share a CTA, and each CTA takes the all-blocked exit on
// its own.

constexpr int CULL_RAYS = 512;         // rays per tile (JAX RAY_TILE)
constexpr float SKIP_TE = 1.5e38f;     // te at or above: never visited

constexpr int CULL_CTAS = CULL_RAYS / (RB_SLOTS * RB_R);   // CTAs per ray tile

// Schedule tile order[k / sub] as `sub` stages of RB_TILE rows, the rows at
// or above `real` (padding) left out.
struct ScheduleFeed {
  const int* ord;
  int tile, sub, real;
  __device__ int first(int k) const {
    return __ldg(ord + k / sub) * tile + (k % sub) * RB_TILE;
  }
  __device__ int rows(int k) const {
    return min(min(RB_TILE, tile - (k % sub) * RB_TILE), real - first(k));
  }
};

// K4's visit test, by every thread of the CTA (also a CTA barrier): does
// some ray's best t reach `te`?
__device__ __forceinline__ bool cta_reaches(const float (&best_t)[RB_R], float te) {
  bool reach = false;
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    float t = best_t[r];
#pragma unroll
    for (int off = 1; off < RB_G; off <<= 1) t = fminf(t, __shfl_xor_sync(0xffffffffu, t, off));
    reach |= t >= te;
  }
  return __syncthreads_or(reach) != 0;
}

// K4: CTA q takes block of rays q of ray tile q / CULL_CTAS.
template <bool FMA>
__global__ void __launch_bounds__(RB_THREADS)
nearest_culled_kernel(const float* __restrict__ g, const float* __restrict__ W,
                      const int* __restrict__ ids, const int* __restrict__ excl,
                      const float* __restrict__ cap, const int* __restrict__ order,
                      const float* __restrict__ te, int nb, int tile, int real,
                      float t_eps, float* __restrict__ t_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ id_out) {
  extern __shared__ float4 rb_tiles[];
  __shared__ uint64_t full[RB_STAGES];
  const int q = blockIdx.x;
  const int* ord = order + (size_t)(q / CULL_CTAS) * nb;
  const float* tev = te + (size_t)(q / CULL_CTAS) * nb;
  const int slot = threadIdx.x / RB_G;
  float gr[RB_R][10];
  int ex[RB_R];
  load_rays(g, excl, INT_MAX, slot, gr, ex, q);
  float best_t[RB_R];
  int best_k[RB_R];                    // key: visit position * tile + in-tile index
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    best_t[r] = cap[rb_ray(slot, r, q)];
    best_k[r] = -1;
  }

  const int sub = (tile + RB_TILE - 1) / RB_TILE;
  const Ring<ScheduleFeed> ring{W, rb_tiles, full, {ord, tile, sub, real}, nb * sub};
  if (cta_reaches(best_t, __ldg(tev))) {   // else the CTA visits no tile
    ring.start();
    for (int k = 0; k < ring.ntiles; ++k) {
      if (k > 0 && k % sub == 0) {     // first stage of schedule tile k / sub
        if (!cta_reaches(best_t, __ldg(tev + k / sub))) {
          ring.drain(k - 1);
          break;
        }
        ring.advance(k - 1);
      }
      ring.wait(k);
      const float4* stage = ring.tile(k);
      const int first = ring.feed.first(k);
      nearest_tile<FMA>(stage, stage + max(ring.feed.rows(k), 0) * 10, gr, ex, ids + first,
                        (k / sub) * tile + (k % sub) * RB_TILE, t_eps, best_t, best_k);
      if ((k + 1) % sub) {             // a stage inside the tile: refill it now
        __syncthreads();
        ring.advance(k);
      }
    }
  }
  merge_lanes(best_t, best_k);
  if (threadIdx.x % RB_G != 0) return;
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    const int key = best_k[r];
    const int idx = key < 0 ? -1 : __ldg(ord + key / tile) * tile + key % tile;
    recover(gr[r], W, ids, idx, rb_ray(slot, r, q), t_out, u_out, v_out, id_out);
  }
}

// K5: CTA q takes block of rays q of ray tile q / CULL_CTAS.
template <bool FMA>
__global__ void __launch_bounds__(RB_THREADS)
occluded_culled_kernel(const float* __restrict__ g, const float* __restrict__ W,
                       const int* __restrict__ ids, const int* __restrict__ excl,
                       const float* __restrict__ tmax, const int* __restrict__ order,
                       const float* __restrict__ te, int nb, int tile, int real,
                       float t_eps, int* __restrict__ out) {
  extern __shared__ float4 rb_tiles[];
  __shared__ uint64_t full[RB_STAGES];
  const int q = blockIdx.x;
  const int rt = q / CULL_CTAS;
  const int* ord = order + (size_t)rt * nb;
  const float* tev = te + (size_t)rt * nb;
  int nv = 0, hi = nb;                 // visited: the prefix with te < SKIP_TE
  while (nv < hi) {
    const int mid = (nv + hi) / 2;
    if (__ldg(tev + mid) < SKIP_TE) nv = mid + 1; else hi = mid;
  }
  const int sub = (tile + RB_TILE - 1) / RB_TILE;
  const Ring<ScheduleFeed> ring{W, rb_tiles, full, {ord, tile, sub, real}, nv * sub};
  ring.start();
  const int slot = threadIdx.x / RB_G;
  float gr[RB_R][10];
  int ex[RB_R];
  load_rays(g, excl, INT_MAX, slot, gr, ex, q);
  float tm[RB_R];
  bool blocked[RB_R];
#pragma unroll
  for (int r = 0; r < RB_R; ++r) {
    tm[r] = tmax[rb_ray(slot, r, q)];
    blocked[r] = false;
  }
  anyhit_walk<FMA>(ring, gr, ex, tm, blocked, ids, t_eps);
  if (threadIdx.x % RB_G != 0) return;
#pragma unroll
  for (int r = 0; r < RB_R; ++r) out[rb_ray(slot, r, q)] = blocked[r] ? 1 : 0;
}

inline bool culled_args_ok(int nrt, int nb, int tile, int real, const float* W) {
  return nrt > 0 && nb > 0 && tile > 0 && tile <= TILE && real >= 0 && real <= nb * tile &&
         reinterpret_cast<uintptr_t>(W) % 16 == 0;
}

// CTAs for N rays, or 0 when the call is not valid (W must be 16-byte
// aligned for the bulk copies).
int rb_blocks(int N, int T, const float* W) {
  if (T < 0 || reinterpret_cast<uintptr_t>(W) % 16) return 0;
  return (N + RB_SLOTS * RB_R - 1) / (RB_SLOTS * RB_R);
}

}  // namespace

// fma: 1 for fused dots, 0 for separately rounded ones (the plain version's
// arithmetic, bit for bit).
extern "C" int mcpt_nearest(const float* g, const float* W, const int* ids,
                            const int* excl, int N, int T, float t_eps,
                            float* t, float* u, float* v, int* tri_id, int fma,
                            void* stream) {
  if (N <= 0) return 0;
  const int blocks = rb_blocks(N, T, W);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  auto fn = fma ? nearest_kernel<true> : nearest_kernel<false>;
  fn<<<blocks, RB_THREADS, RB_SMEM, (cudaStream_t)stream>>>(g, W, ids, excl, N, T, t_eps,
                                                            t, u, v, tri_id);
  return (int)cudaGetLastError();
}

extern "C" int mcpt_occluded(const float* g, const float* W, const int* ids,
                             const int* excl, const float* tmax, int N, int T,
                             float t_eps, int* blocked, int fma, void* stream) {
  if (N <= 0) return 0;
  const int blocks = rb_blocks(N, T, W);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  auto fn = fma ? occluded_kernel<true> : occluded_kernel<false>;
  fn<<<blocks, RB_THREADS, RB_SMEM, (cudaStream_t)stream>>>(g, W, ids, excl, tmax, N, T,
                                                            t_eps, blocked);
  return (int)cudaGetLastError();
}

// real: rows of W below it are real triangles, the rest padding (never
// accepted); fma as in mcpt_nearest. W must be 16-byte aligned.
extern "C" int mcpt_nearest_culled(const float* g, const float* W, const int* ids,
                                   const int* excl, const float* cap,
                                   const int* order, const float* te, int nrt,
                                   int nb, int tile, int real, float t_eps, float* t,
                                   float* u, float* v, int* tri_id, int fma, void* stream) {
  if (!culled_args_ok(nrt, nb, tile, real, W)) return (int)cudaErrorInvalidValue;
  auto fn = fma ? nearest_culled_kernel<true> : nearest_culled_kernel<false>;
  fn<<<nrt * CULL_CTAS, RB_THREADS, RB_SMEM, (cudaStream_t)stream>>>(
      g, W, ids, excl, cap, order, te, nb, tile, real, t_eps, t, u, v, tri_id);
  return (int)cudaGetLastError();
}

// real, fma and W as in mcpt_nearest_culled.
extern "C" int mcpt_occluded_culled(const float* g, const float* W, const int* ids,
                                    const int* excl, const float* tmax,
                                    const int* order, const float* te, int nrt,
                                    int nb, int tile, int real, float t_eps, int* blocked,
                                    int fma, void* stream) {
  if (!culled_args_ok(nrt, nb, tile, real, W)) return (int)cudaErrorInvalidValue;
  auto fn = fma ? occluded_culled_kernel<true> : occluded_culled_kernel<false>;
  fn<<<nrt * CULL_CTAS, RB_THREADS, RB_SMEM, (cudaStream_t)stream>>>(
      g, W, ids, excl, tmax, order, te, nb, tile, real, t_eps, blocked);
  return (int)cudaGetLastError();
}
