// The threefry-2x32 hash and its f32 draw as device functions, shared by
// the draw kernels (threefry.cu) and a round's shading kernel (round.cu), so
// that both give rng.py's bits: jax.random's threefry2x32 with
// jax_threefry_partitionable=True.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define TF_MIX(r) \
  x1 += x2;      \
  x2 = rotl(x2, r) ^ x1;

// (x1, x2) <- threefry2x32 of the counter words (x1, x2) under (k1, k2).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x1 += k2;
  x2 += k3 + 1u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x1 += k3;
  x2 += k1 + 2u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x1 += k1;
  x2 += k2 + 3u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x1 += k2;
  x2 += k3 + 4u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x1 += k3;
  x2 += k1 + 5u;
}

#undef TF_MIX

// 32 random bits -> f32 in [1, 2) by mantissa fill, minus 1.
__device__ __forceinline__ float unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// (l1, l2) <- fold_in(fold_in(key, site), sid): the per-lane key of
// rng.draw_lanes.
__device__ __forceinline__ void lane_key(uint32_t k1, uint32_t k2, uint32_t site, uint32_t sid,
                                         uint32_t& l1, uint32_t& l2) {
  uint32_t s1 = 0u, s2 = site;
  threefry(k1, k2, s1, s2);
  l1 = 0u;
  l2 = sid;
  threefry(s1, s2, l1, l2);
}

// Draw j of a lane keyed (l1, l2): uniform(lane key, (n,))[j].
__device__ __forceinline__ float lane_draw(uint32_t l1, uint32_t l2, uint32_t j) {
  uint32_t y1 = 0u, y2 = j;
  threefry(l1, l2, y1, y2);
  return unit(y1 ^ y2);
}

}  // namespace tf
