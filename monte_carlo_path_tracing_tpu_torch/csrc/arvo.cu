// K3: fused Arvo light selection for Hopper.
//
// Replaces the Pallas TPU kernel monte_carlo_path_tracing_tpu/ops/
// arvo_pallas.py::_kernel (called through _call / arvo_select; constants
// from pack_consts).
//
// What it computes. For a shading point x with normal n and every light
// triangle (pa, pb, pc, geometric normal nl) it evaluates the Van
// Oosterom-Strackee solid angle from quadratic forms in x (the expansion of
// sampling/light_spherical.prepare), culls triangles that are not
// front-facing, lie below the horizon of n, or subtend sA <= 1e-6, and
// weights the rest by sA * radiance_sum. It then picks one triangle by
// inverse CDF with the caller's uniform u: idx = count(cdf <= u * wsum),
// clamped to L - 1. Only (idx, wsum) leave the kernel.
//
// R picks a point. The caller may give R uniforms a point (u as [R, N],
// rounds major) and gets R picks (idx as [R, N]) against the one weight
// row and wsum: the regeneration prepass picks a light for each of its
// spp_cap rounds at every primary hit. The JAX package leaves that dense
// pick to XLA, which fuses the [points, lights] field into its scan (no
// Pallas kernel); in plain torch the field and its cdf were [chunk, L]
// tensors in device memory. Here phases 1-3 (culls, weights, block sums)
// run once a point and only the pick repeats: a ballot and at most
// ceil(L / G) shared reads a round, so the weights still bound the kernel.
// With R = 1 it is the single pick.
//
// What bounds it on this card. Per (point, light) ~88 f32 operations with
// three square roots and one atan2f (a division inside); the light
// constants (24 floats per light) are shared by all points, so the kernel
// is bound by instruction issue, not memory. As on the TPU, the point is
// that the [points, lights] weight field never reaches device memory. Its
// first design (one thread per point, two passes) ran at a tenth of that
// bound: 4-8 warps an SM could not hide the long dependent chain of one
// weight, and the second pass recomputed the weights up to the pick.
// Design:
//   - G = 16 threads per point (two points a warp), G times the warps (8
//     and 32 were measured slower, PERF.md);
//   - cheap culls first, and compacted: front and above need four 3-term
//     dots and no transcendental. The G threads test G adjacent lights at a
//     time and append the ones that pass to the point's list in shared
//     memory (ballot + popc, in light order); then they evaluate the
//     square roots and atan2f for the listed lights only, G at a time, and
//     write each weight at its light's place in a zeroed row. A Veach point
//     sees ~46% of the lights (the front halves of the spheres), so about
//     half the weights are evaluated, with no thread idle but in the last
//     batch. (Branching around the expensive part without compacting does
//     not pay: a warp runs it whenever one of its threads needs it, and with
//     4 points a warp that was 96% of rounds; contiguous segments of L / G
//     lights per thread ran at the pace of a thread that sees all of its
//     half sphere. Both measured, PERF.md);
//   - one pass over the row: thread j sums a block of ceil(L / G) weights
//     in light order; a shuffle chain over the G block sums, taken in block
//     order by every thread, gives each block's prefix and wsum, so a
//     block's end (prefix + sum) is exactly the next one's prefix and the
//     cdf stays monotone. The first block whose end exceeds u * wsum holds
//     the pick; its thread walks the stored weights to it. When none does
//     (all weights zero, or u * wsum rounds to wsum) the pick is L, clamped
//     to L - 1, as before;
//   - constants in shared memory as float4, each light padded to 7 float4
//     so that G adjacent lights read at once fall on different banks (at
//     the unpadded 6, two threads share a bank); staged once per CTA (36 KB
//     for Veach's 320 lights), read from global memory through the
//     read-only cache when they would not leave room for two CTAs an SM.
//     The row and list take 6 bytes a light a point: 60 KB for the 32
//     points of a 512-thread CTA at 320 lights, 97 KB with the constants;
//   - persistent CTAs: as many as are resident at once, each staging the
//     constants once and taking points in turn (one CTA per 8 points
//     copied 245 MB of constants from L2 at 65,536 points).
//
// Numerics. atan2f is used where the TPU kernel had _atan2_pos, a
// polynomial that exists only because Mosaic has no atan2; atan2f is what
// the plain torch version (ops/arvo_cuda.py) calls. Each weight's terms are
// ordered as the plain version orders them and the build uses -fmad=false,
// so the weights agree with it to atan2's rounding; wsum and the cdf are
// sums by blocks, the plain version's torch.sum / cumsum in theirs, so a
// pick may differ by one index where u * wsum lies within rounding of a
// cdf boundary (counted in chip_smoke.py). No library kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int G = 16;                        // threads per point
constexpr unsigned GROUP = (1u << G) - 1u;   // a group's lanes
constexpr int THREADS = 512;                 // most threads per CTA
constexpr int LIGHT_F4 = 7;                  // float4 per staged light (6 + 1 pad)
constexpr int STAGED_MAX = 100 * 1024;       // staged CTA at most: two fit an SM
constexpr int MAX_SMEM = 227 * 1024;         // an H100 block's shared memory
constexpr float EPS = 1e-6f;
static_assert(G < 32 && (G & (G - 1)) == 0, "G: a power of two below 32");

// One light's 24 constants (ops/arvo_cuda.pack_consts), as 6 float4:
// 0:3 pa  3:6 pb  6:9 pc  9:12 crs  12:15 nl
// 15 pa.pb  16 pb.pc  17 pc.pa  18 |pa|^2  19 |pb|^2  20 |pc|^2
// 21 nl.pa  22 det(pa,pb,pc)  23 radiance_sum
struct Light {
  float c[24];
  __device__ __forceinline__ explicit Light(const float4* p) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float4 v = p[i];
      c[4 * i] = v.x;
      c[4 * i + 1] = v.y;
      c[4 * i + 2] = v.z;
      c[4 * i + 3] = v.w;
    }
  }
};

struct Point {
  float x0, x1, x2, n0, n1, n2, xx, nx;
};

__device__ __forceinline__ float dot3(float x0, float x1, float x2, const float* c) {
  return x0 * c[0] + x1 * c[1] + x2 * c[2];
}

// front && above: the light faces x and some vertex lies above the horizon
// of n (no transcendental).
__device__ __forceinline__ bool sees(const float* c, const Point& p) {
  const float xnl = dot3(p.x0, p.x1, p.x2, c + 12);
  const float na = dot3(p.n0, p.n1, p.n2, c + 0);
  const float nb = dot3(p.n0, p.n1, p.n2, c + 3);
  const float nc = dot3(p.n0, p.n1, p.n2, c + 6);
  const bool front = (xnl - c[21]) > EPS;
  const bool above = (na - p.nx) > EPS || (nb - p.nx) > EPS || (nc - p.nx) > EPS;
  return front && above;
}

// The weight of a light that sees() passed.
__device__ __forceinline__ float weight(const float* c, const Point& p) {
  const float xa = dot3(p.x0, p.x1, p.x2, c + 0);
  const float xb = dot3(p.x0, p.x1, p.x2, c + 3);
  const float xc = dot3(p.x0, p.x1, p.x2, c + 6);
  const float xcrs = dot3(p.x0, p.x1, p.x2, c + 9);
  const float ab = ((c[15] - xa) - xb) + p.xx;
  const float bc = ((c[16] - xb) - xc) + p.xx;
  const float ca = ((c[17] - xc) - xa) + p.xx;
  const float la = sqrtf(fmaxf((c[18] - 2.0f * xa) + p.xx, 1e-20f));
  const float lb = sqrtf(fmaxf((c[19] - 2.0f * xb) + p.xx, 1e-20f));
  const float lc = sqrtf(fmaxf((c[20] - 2.0f * xc) + p.xx, 1e-20f));
  const float det = c[22] - xcrs;
  const float denom = ((la * lb * lc + ab * lc) + bc * la) + ca * lb;
  const float sA = 2.0f * atan2f(fabsf(det), denom);
  const bool valid = sA > EPS && isfinite(sA);
  const float w = valid ? sA * c[23] : 0.0f;
  return isfinite(w) ? w : 0.0f;
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
arvo_select_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                   const float* __restrict__ u, const float4* __restrict__ C, int N, int L,
                   int R, int* __restrict__ idx_out, float* __restrict__ wsum_out) {
  // [STAGED: L lights x LIGHT_F4 float4] [points x L weights] [points x L
  // list entries: 16-bit light indices, as a row fits MAX_SMEM only for
  // L < 2^16 (arvo_layout)]
  extern __shared__ float4 smem[];
  constexpr int F4 = STAGED ? LIGHT_F4 : 6;
  const float4* lights = STAGED ? smem : C;
  const int points = blockDim.x / G;
  const int pl = threadIdx.x / G, j = threadIdx.x % G;
  float* w = reinterpret_cast<float*>(smem + (STAGED ? L * LIGHT_F4 : 0)) + pl * L;
  uint16_t* list = reinterpret_cast<uint16_t*>(w - pl * L + points * L) + pl * L;
  if (STAGED) {
    for (int i = threadIdx.x; i < 6 * L; i += blockDim.x)
      smem[(i / 6) * LIGHT_F4 + i % 6] = C[i];
    __syncthreads();
  }
  const int base = (threadIdx.x % 32) & ~(G - 1);   // the group's first lane
  const int B = (L + G - 1) / G;                     // lights a block (phase 3)
  const int l0 = j * B;
  const int n = max(0, min(B, L - l0));

  // Persistent CTAs: the constants are staged once, the points taken in
  // turn (the trip count is the same for every warp of the CTA).
  for (int first = blockIdx.x * points; first < N; first += gridDim.x * points) {
    const int pt = first + pl;
    const bool active = pt < N;
    Point p;
    p.x0 = active ? x[pt * 3 + 0] : 0.0f;
    p.x1 = active ? x[pt * 3 + 1] : 0.0f;
    p.x2 = active ? x[pt * 3 + 2] : 0.0f;
    p.n0 = active ? nrm[pt * 3 + 0] : 0.0f;
    p.n1 = active ? nrm[pt * 3 + 1] : 0.0f;
    p.n2 = active ? nrm[pt * 3 + 2] : 1.0f;
    p.xx = p.x0 * p.x0 + p.x1 * p.x1 + p.x2 * p.x2;
    p.nx = p.n0 * p.x0 + p.n1 * p.x1 + p.n2 * p.x2;

    // 1. Zero the row; list, in light order, the lights that pass the culls.
    int M = 0;
    for (int c0 = 0; c0 < L; c0 += G) {
      const int l = c0 + j;
      bool pass = false;
      if (l < L) {
        w[l] = 0.0f;
        pass = sees(Light(lights + l * F4).c, p);
      }
      const unsigned b = (__ballot_sync(0xffffffffu, pass) >> base) & GROUP;
      if (pass) list[M + __popc(b & ((1u << j) - 1u))] = l;
      M += __popc(b);
    }
    __syncwarp();
    // 2. The listed lights' weights, G at a time, each at its light's place.
    for (int i = j; i < M; i += G) {
      const int l = list[i];
      w[l] = weight(Light(lights + l * F4).c, p);
    }
    __syncwarp();

    // 3. Block sums in light order; prefix (before j), end (through j), wsum.
    float sum = 0.0f;
    for (int i = 0; i < n; ++i) sum = sum + w[l0 + i];
    float acc = 0.0f, prefix = 0.0f, end = 0.0f;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const float v = __shfl_sync(0xffffffffu, sum, s, G);
      if (s == j) prefix = acc;
      acc = acc + v;
      if (s == j) end = acc;
    }
    const float wsum = acc;
    if (active && j == 0) wsum_out[pt] = wsum;
    // 4. The picks, one a round (u and idx rounds major): none when no cdf
    // value exceeds u * wsum (L, clamped); else the first cdf value above it
    // in the first block whose end is.
    for (int r = 0; r < R; ++r) {
      const size_t o = static_cast<size_t>(r) * N + pt;
      const float thresh = (active ? u[o] : 0.0f) * wsum;
      const unsigned over = (__ballot_sync(0xffffffffu, end > thresh) >> base) & GROUP;
      if (active && j == 0 && over == 0u) idx_out[o] = L - 1;
      if (active && over != 0u && j == __ffs(over) - 1) {
        float part = 0.0f;
        int i = 0;
        while (i < n - 1 && !(prefix + (part + w[l0 + i]) > thresh)) part = part + w[l0 + i++];
        idx_out[o] = l0 + i;
      }
    }
    __syncwarp();                      // the row is free for the next point
  }
}

}  // namespace

// (staged, points per CTA) for L lights: the constants staged while a CTA
// of the most points takes at most STAGED_MAX, else read from global
// memory with as many whole warps of points as fit; points 0 when not one
// warp's rows fit.
static void arvo_layout(int L, bool* staged, int* points) {
  const int row = 6 * L;                               // weights + list, a point
  const int warp = 32 / G;                             // points a warp
  *points = THREADS / G;
  *staged = L * LIGHT_F4 * 16 + *points * row <= STAGED_MAX;
  if (!*staged) *points = min(THREADS / G, MAX_SMEM / row / warp * warp);
}

extern "C" int mcpt_arvo_select(const float* x, const float* n,
                                const float* u, const float* consts, int N,
                                int L, int R, int* idx, float* wsum, void* stream) {
  if (N <= 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  if (L <= 0 || reinterpret_cast<uintptr_t>(consts) % 16) return (int)cudaErrorInvalidValue;
  bool staged;
  int points;
  arvo_layout(L, &staged, &points);
  if (points == 0) return (int)cudaErrorInvalidValue;
  const int smem = (staged ? L * LIGHT_F4 * 16 : 0) + points * 6 * L;
  auto fn = staged ? arvo_select_kernel<true> : arvo_select_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
    if (e != cudaSuccess) return (int)e;
  }
  // As many CTAs as are resident at once, each walking its share of points.
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, points * G, smem);
  const int blocks = min((N + points - 1) / points, max(1, sms * per_sm));
  fn<<<blocks, points * G, smem, (cudaStream_t)stream>>>(x, n, u,
                                                         reinterpret_cast<const float4*>(consts),
                                                         N, L, R, idx, wsum);
  return (int)cudaGetLastError();
}
