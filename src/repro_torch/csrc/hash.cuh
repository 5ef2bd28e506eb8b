// K0: counter-based Threefry-2x32 hash, device side.
//
// Replaces the JAX package's kernels/hash.py (threefry2x32, uniform, normal,
// gumbel, bh_ctr), which the TPU kernels inline into their bodies. Here it is
// a set of __device__ functions included by the activity window (K1) and the
// Barnes-Hut traversal (K2); repro_torch/kernels/hash.py is the plain torch
// version and the two are held bit-equal on the card.
//
// Bound on the H100: pure 32-bit integer work, 72 operations per call (2
// initial adds, 20 rounds of add / rotate / xor, 5 key injections of 2 adds;
// the key schedule is loop-invariant), no memory traffic. The callers
// skip it where its result is masked anyway (local or empty edges, invalid
// frontier entries).
//
// The float helpers use logf / log1pf / cosf / sqrtf in the order of the plain
// version; the library is built with --fmad=false so no multiply-add is
// contracted.
#pragma once
#include <stdint.h>

namespace repro {

constexpr uint32_t NOISE_DOMAIN = 0x6E6F6973u;
constexpr uint32_t SPIKE_DOMAIN = 0x73706B73u;
constexpr uint32_t BH_DOMAIN = 0x62687472u;
constexpr int BH_ROUNDS = 64;
constexpr int BH_DRAWS = 128;

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Full 20-round Threefry-2x32: key (k0, k1), counter (c0, c1).
__host__ __device__ __forceinline__ void threefry2x32(
    uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
    uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot_a[4] = {13, 15, 26, 6};
  const int rot_b[4] = {17, 29, 16, 24};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, (g % 2 == 0) ? rot_a[i] : rot_b[i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

// u32 -> f32 uniform in [0, 1): top 24 bits, exactly representable.
__device__ __forceinline__ float to_unit(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t domain,
                                              uint32_t ctr, uint32_t entity) {
  uint32_t x0, x1;
  threefry2x32(seed, domain, ctr, entity, &x0, &x1);
  return to_unit(x0);
}

__device__ __forceinline__ float hash_gumbel(uint32_t seed, uint32_t domain,
                                             uint32_t ctr, uint32_t entity) {
  float u = hash_uniform(seed, domain, ctr, entity);
  u = u < 1e-20f ? 1e-20f : u;
  return -logf(-logf(u));
}

// Box-Muller: r = sqrt(-2 log1p(-u1)), z = r cos(2 pi u2).
__device__ __forceinline__ float hash_normal(uint32_t seed, uint32_t domain,
                                             uint32_t ctr, uint32_t entity) {
  uint32_t x0, x1;
  threefry2x32(seed, domain, ctr, entity, &x0, &x1);
  const float u1 = to_unit(x0);
  const float u2 = to_unit(x1);
  const float r = sqrtf(-2.0f * log1pf(-u1));
  return r * cosf((float)(2.0 * 3.14159265358979) * u2);
}

// (chunk, round, draw) -> u32 counter, int32 wrap-around as in the reference.
__device__ __forceinline__ uint32_t bh_ctr(int chunk, int rnd, int draw) {
  return ((uint32_t)chunk * BH_ROUNDS + (uint32_t)rnd) * BH_DRAWS +
         (uint32_t)draw;
}

}  // namespace repro
