// K6: threefry2x32 (20 rounds) for the port's counter-based streams.
//
// Not a TPU kernel: on the TPU, XLA fused each of the JAX package's
// threefry calls (monte_carlo_path_tracing_tpu/core/rng.py: fold_in,
// random_bits, uniform) into one generated kernel. The port's plain version
// (monte_carlo_path_tracing_tpu_torch/core/rng.py) spells the 20 rounds out
// as int64 torch ops with 32-bit masks, ~170 launches a call; this kernel
// computes the same words, bit for bit, in one launch a call.
//
// What one launch computes (ops/rng_cuda.py builds the arguments):
//   - threefry_fold_kernel: fold_in(key, d) = threefry2x32(key, (0, d mod
//     2**32)) over a broadcast batch of up to four dimensions. Key and data
//     are read through their strides (a stride of 0 broadcasts), so no
//     operand is materialised at the batch's shape. Output: the two words
//     as int64 [..., 2], the port's key layout.
//   - threefry_bits_kernel: random_bits(key, shape) = y0 ^ y1 of
//     threefry2x32(key_j, (hi, lo)) over the 64-bit count start + i, one
//     run of n counts per key j (start = row_offset * prod(shape[1:]) for a
//     scalar key, so counts past 2**32 split into (hi, lo)); modes 2 and 3
//     turn the words into f32 uniforms, bitcast((bits >> 9) | 0x3F800000) -
//     1, and mode 3 (a range other than [0, 1)) then into max(lo, f * span +
//     lo). The build's -fmad=false keeps that multiply and add separately
//     rounded, as torch rounds them.
//
// What bounds it on this card. Per element ~80 32-bit integer operations
// (20 rounds of an add, a rotate and a xor; five key injections of three
// adds; the key schedule) against up to 40 bytes moved (keys and data as
// int64, words out as int64 or f32): at 65,536 lanes a pixel fold moves
// 2.6 MB, 0.8 us at 3.35 TB/s, and does ~5.2 M integer operations, 0.3 us
// at the card's 64 INT32 lanes an SM. Both sit below the launch floor (the
// kernel takes ~2.2 us on an H100, chip_smoke.py phase "rng"), so its time
// measures the launch; the design is the plainest one, a thread an element,
// the rotations as funnel shifts, each element's key words read once. The
// rounds are threefry.cuh's, which the fused MIS vertex (vertex.cu) shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

//! The broadcast batch of a fold: sizes padded in front with 1s, element
//! strides of the key and the data along each dimension (0: broadcast), and
//! the stride between the key's two words.
struct FoldArgs {
  long long size[4];
  long long kstride[4];
  long long dstride[4];
  long long kword;
};

__global__ void threefry_fold_kernel(const long long* __restrict__ key, const void* data,
                                     int data64, uint32_t scalar, FoldArgs a, long long total,
                                     long long* __restrict__ out) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    long long rest = t, koff = 0, doff = 0;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
      const long long i = rest % a.size[d];
      rest /= a.size[d];
      koff += i * a.kstride[d];
      doff += i * a.dstride[d];
    }
    uint32_t x0 = 0, x1 = scalar;
    if (data != nullptr) {
      x1 = data64 ? static_cast<uint32_t>(static_cast<const long long*>(data)[doff])
                  : static_cast<uint32_t>(static_cast<const int*>(data)[doff]);
    }
    threefry2x32(static_cast<uint32_t>(key[koff]), static_cast<uint32_t>(key[koff + a.kword]),
                 x0, x1);
    out[2 * t] = x0;
    out[2 * t + 1] = x1;
  }
}

__global__ void threefry_bits_kernel(const long long* __restrict__ key, long long kstride,
                                     long long kword, long long n, unsigned long long start,
                                     long long total, int mode, float lo, float span,
                                     void* out) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long j = t / n;
    const unsigned long long count = start + static_cast<unsigned long long>(t - j * n);
    uint32_t x0 = static_cast<uint32_t>(count >> 32), x1 = static_cast<uint32_t>(count);
    threefry2x32(static_cast<uint32_t>(key[j * kstride]),
                 static_cast<uint32_t>(key[j * kstride + kword]), x0, x1);
    const uint32_t bits = x0 ^ x1;
    if (mode == 1) {
      static_cast<long long*>(out)[t] = bits;
    } else {
      float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      if (mode == 3) f = fmaxf(lo, f * span + lo);
      static_cast<float*>(out)[t] = f;
    }
  }
}

int blocks_for(long long total) {
  const long long b = (total + THREADS - 1) / THREADS;
  return static_cast<int>(b < (1ll << 30) ? b : (1ll << 30));
}

}  // namespace

//! fold_in over a broadcast batch; ``args`` is a host array of 13 values:
//! size[4], kstride[4], dstride[4], kword. ``data`` null: the scalar.
extern "C" int mcpt_threefry_fold(const void* key, const void* data, int data64,
                                  unsigned int scalar, const long long* args, long long total,
                                  void* out, void* stream) {
  if (total <= 0) return 0;
  FoldArgs a;
  for (int d = 0; d < 4; ++d) {
    a.size[d] = args[d];
    a.kstride[d] = args[4 + d];
    a.dstride[d] = args[8 + d];
    if (a.size[d] <= 0) return (int)cudaErrorInvalidValue;
  }
  a.kword = args[12];
  threefry_fold_kernel<<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(key), data, data64, scalar, a, total,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

//! random_bits (mode 1: int64 words), uniform on [0, 1) (mode 2) or on
//! [lo, lo + span) (mode 3): ``total`` = keys x n elements.
extern "C" int mcpt_threefry_bits(const void* key, long long kstride, long long kword,
                                  long long n, unsigned long long start, long long total,
                                  int mode, float lo, float span, void* out, void* stream) {
  if (total <= 0) return 0;
  if (n <= 0 || mode < 1 || mode > 3) return (int)cudaErrorInvalidValue;
  threefry_bits_kernel<<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(key), kstride, kword, n, start, total, mode, lo, span, out);
  return (int)cudaGetLastError();
}
