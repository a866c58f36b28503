// Threefry-2x32 (20 rounds) and the integer/float draws built on it, shared
// by every kernel of the port.
//
// Counterpart of torch_random_walk_tpu/utils/prng.py (threefry2x32, mulhi32,
// randint_from_bits, uniform_from_bits, step_round_counter): equal
// (key, counter) inputs give equal words, so a kernel draws exactly what the
// JAX package draws.  Everything is unsigned 32-bit arithmetic that wraps.
#pragma once

#include <cstdint>

namespace trw {

struct U32x2 {
  uint32_t x0, x1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ U32x2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    if (g % 2 == 0) {
      x0 += x1; x1 = rotl32(x1, 13); x1 ^= x0;
      x0 += x1; x1 = rotl32(x1, 15); x1 ^= x0;
      x0 += x1; x1 = rotl32(x1, 26); x1 ^= x0;
      x0 += x1; x1 = rotl32(x1, 6);  x1 ^= x0;
    } else {
      x0 += x1; x1 = rotl32(x1, 17); x1 ^= x0;
      x0 += x1; x1 = rotl32(x1, 29); x1 ^= x0;
      x0 += x1; x1 = rotl32(x1, 16); x1 ^= x0;
      x0 += x1; x1 = rotl32(x1, 24); x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  return {x0, x1};
}

// c1 counter word of one (step, round) pair.
__device__ __forceinline__ uint32_t step_round_counter(uint32_t step,
                                                       uint32_t round) {
  return step * 65536u + round;
}

// floor(bits * n / 2^32): uniform integer in [0, n).
__device__ __forceinline__ uint32_t randint(uint32_t bits, uint32_t n) {
  return __umulhi(bits, n);
}

// Top 24 bits -> float32 uniform in [0, 1), exactly representable.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

}  // namespace trw
