// threefry2x32 (20 rounds) and the draws built on it, for every kernel that
// draws from the port's counter-based streams: K6 (rng.cu) and the fused
// MIS vertex (vertex.cu). One copy, so that a draw made inside a kernel is
// K6's draw bit for bit, and K6's is the plain int64 version's
// (core/rng.py::threefry2x32, fold_in_plain, uniform_plain).

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

//! threefry2x32 with 20 rounds on (x0, x1) under key (k0, k1): the round
//! structure of core/rng.py::threefry2x32 (rotations (13, 15, 26, 6) and
//! (17, 29, 16, 24) in turn, a key injection after every four).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

//! A stream key: the two uint32 words of a jax threefry key.
struct ThreefryKey {
  uint32_t k0, k1;
};

//! fold_in(key, d) = threefry2x32(key, (0, d)): the two words are the new key.
__device__ __forceinline__ ThreefryKey threefry_fold(ThreefryKey k, uint32_t d) {
  uint32_t x0 = 0, x1 = d;
  threefry2x32(k.k0, k.k1, x0, x1);
  return {x0, x1};
}

//! Draw ``count`` of a per-lane key's uniform on [0, 1) (counts below
//! 2**32: a lane draws its own few): bitcast((y0 ^ y1) >> 9 | 1.0f) - 1.
__device__ __forceinline__ float threefry_uniform(ThreefryKey k, uint32_t count) {
  uint32_t x0 = 0, x1 = count;
  threefry2x32(k.k0, k.k1, x0, x1);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}
