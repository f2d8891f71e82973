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
// What bounds it on this card. Per (point, light) ~45 f32 operations, three
// square roots and one atan2f; the light constants (24 floats per light)
// are shared by all points, so the kernel is bound by instruction issue,
// not memory. As on the TPU, the point is that the [points, lights] weight
// field never reaches device memory. Design: one thread per point; the
// light constants are staged through shared memory in tiles of LTILE
// lights; pass 1 sums wsum in light order, pass 2 recomputes the same
// weights in the same order until the running cdf exceeds u * wsum. The
// block leaves pass 2 once all its points have picked.
//
// Numerics. atan2f is used where the TPU kernel had _atan2_pos, a
// polynomial that exists only because Mosaic has no atan2; atan2f is what
// the plain torch version (ops/arvo_cuda.py) calls. The ordered sums equal
// the plain version's term by term and the build uses -fmad=false, so the
// weights agree with it to atan2's rounding; wsum and the cdf are summed
// in light order, the plain version's torch.sum / cumsum in theirs, so a
// pick may differ by one index where u * wsum lies within rounding of a
// cdf boundary. No library kernels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LTILE = 256;     // lights staged per step
constexpr int BLOCK = 128;     // points per block
constexpr int NC = 24;         // floats per light (ops/arvo_cuda.pack_consts)
constexpr float EPS = 1e-6f;

// Layout of one light's constants (ops/arvo_cuda.pack_consts):
// 0:3 pa  3:6 pb  6:9 pc  9:12 crs  12:15 nl
// 15 pa.pb  16 pb.pc  17 pc.pa  18 |pa|^2  19 |pb|^2  20 |pc|^2
// 21 nl.pa  22 det(pa,pb,pc)  23 radiance_sum

__device__ __forceinline__ float dot3(float x0, float x1, float x2,
                                      const float* c) {
  return x0 * c[0] + x1 * c[1] + x2 * c[2];
}

__device__ __forceinline__ float weight(const float* c, float x0, float x1,
                                        float x2, float n0, float n1,
                                        float n2, float xx, float nx) {
  const float xa = dot3(x0, x1, x2, c + 0);
  const float xb = dot3(x0, x1, x2, c + 3);
  const float xc = dot3(x0, x1, x2, c + 6);
  const float xcrs = dot3(x0, x1, x2, c + 9);
  const float xnl = dot3(x0, x1, x2, c + 12);
  const float na = dot3(n0, n1, n2, c + 0);
  const float nb = dot3(n0, n1, n2, c + 3);
  const float nc = dot3(n0, n1, n2, c + 6);
  const float ab = ((c[15] - xa) - xb) + xx;
  const float bc = ((c[16] - xb) - xc) + xx;
  const float ca = ((c[17] - xc) - xa) + xx;
  const float la = sqrtf(fmaxf((c[18] - 2.0f * xa) + xx, 1e-20f));
  const float lb = sqrtf(fmaxf((c[19] - 2.0f * xb) + xx, 1e-20f));
  const float lc = sqrtf(fmaxf((c[20] - 2.0f * xc) + xx, 1e-20f));
  const float det = c[22] - xcrs;
  const float denom = ((la * lb * lc + ab * lc) + bc * la) + ca * lb;
  const float sA = 2.0f * atan2f(fabsf(det), denom);
  const bool front = (xnl - c[21]) > EPS;
  const bool above = (na - nx) > EPS || (nb - nx) > EPS || (nc - nx) > EPS;
  const bool valid = front && above && sA > EPS && isfinite(sA);
  const float w = valid ? sA * c[23] : 0.0f;
  return isfinite(w) ? w : 0.0f;
}

__device__ __forceinline__ void stage(float* sC, const float* C, int base,
                                      int n) {
  for (int i = threadIdx.x; i < n * NC; i += BLOCK) sC[i] = C[base * NC + i];
}

__global__ void __launch_bounds__(BLOCK)
arvo_select_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                   const float* __restrict__ u, const float* __restrict__ C,
                   int N, int L, int* __restrict__ idx_out,
                   float* __restrict__ wsum_out) {
  __shared__ float sC[LTILE * NC];
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = p < N;
  const float x0 = active ? x[p * 3 + 0] : 0.0f;
  const float x1 = active ? x[p * 3 + 1] : 0.0f;
  const float x2 = active ? x[p * 3 + 2] : 0.0f;
  const float n0 = active ? nrm[p * 3 + 0] : 0.0f;
  const float n1 = active ? nrm[p * 3 + 1] : 0.0f;
  const float n2 = active ? nrm[p * 3 + 2] : 1.0f;
  const float xx = x0 * x0 + x1 * x1 + x2 * x2;
  const float nx = n0 * x0 + n1 * x1 + n2 * x2;

  // Pass 1: wsum in light order.
  float wsum = 0.0f;
  for (int base = 0; base < L; base += LTILE) {
    const int n = min(LTILE, L - base);
    __syncthreads();
    stage(sC, C, base, n);
    __syncthreads();
    for (int l = 0; l < n; ++l)
      wsum = wsum + weight(&sC[l * NC], x0, x1, x2, n0, n1, n2, xx, nx);
  }

  // Pass 2: first index whose inclusive cdf exceeds u * wsum.
  const float thresh = (active ? u[p] : 0.0f) * wsum;
  float cdf = 0.0f;
  int idx = L;                  // = count(cdf <= thresh) when none exceeds
  bool found = !active;
  for (int base = 0; base < L; base += LTILE) {
    if (__syncthreads_and(found)) break;
    const int n = min(LTILE, L - base);
    stage(sC, C, base, n);
    __syncthreads();
    for (int l = 0; l < n && !found; ++l) {
      cdf = cdf + weight(&sC[l * NC], x0, x1, x2, n0, n1, n2, xx, nx);
      if (cdf > thresh) {
        idx = base + l;
        found = true;
      }
    }
  }
  if (!active) return;
  idx_out[p] = min(idx, L - 1);
  wsum_out[p] = wsum;
}

}  // namespace

extern "C" int mcpt_arvo_select(const float* x, const float* n,
                                const float* u, const float* consts, int N,
                                int L, int* idx, float* wsum, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + BLOCK - 1) / BLOCK;
  arvo_select_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      x, n, u, consts, N, L, idx, wsum);
  return (int)cudaGetLastError();
}
