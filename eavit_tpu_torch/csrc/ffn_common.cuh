// Device functions of the fused-FFN forward (fused_ffn.cu) and backward
// (fused_ffn_bwd.cu): the Abramowitz-Stegun erf, exact GELU and its
// derivative (eavit_tpu/ops/fused_ffn.py `_erf` 100-115, `_gelu_exact` 118,
// `_gelu_grad` 122-125), and one element's mask value.
#pragma once

#include <cstdint>

#include "philox.cuh"

// FAST takes the one division by the fast reciprocal (__fdividef, within an
// ulp of it and without the slow-path branch of an IEEE division): K2f's
// forward does, so that a chunk's elementwise work is branch-free and the
// compiler can interleave it with the next chunk's mmas.
template <bool FAST = false>
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float d = 1.f + 0.3275911f * a;
  float t;
  if constexpr (FAST) {
    t = __fdividef(1.f, d);
  } else {
    t = 1.f / d;
  }
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-a * a);
  return x < 0.f ? -e : e;
}

template <bool FAST = false>
__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erf_as<FAST>(h * 0.70710678118654752f));
}

// The 24-bit mask value of element e of a stream: word e % 4 of Philox group
// e / 4 (philox.cuh); picked by selects, so the words stay in registers.
__device__ __forceinline__ uint32_t mask_word(uint64_t e, uint32_t stream, uint32_t s0,
                                              uint32_t s1) {
  const Philox4 p = philox_group(e >> 2, stream, s0, s1);
  const uint32_t k = static_cast<uint32_t>(e & 3u);
  return (k == 0 ? p.w[0] : k == 1 ? p.w[1] : k == 2 ? p.w[2] : p.w[3]) >> 8;
}

// d gelu / dh with the same erf: cdf + h * pdf.
__device__ __forceinline__ float gelu_grad(float h) {
  const float phi = expf(-0.5f * h * h) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erf_as(h * 0.70710678118654752f));
  return cdf + h * phi;
}

// gelu(h) and d gelu / dh from one erf, each as gelu and gelu_grad compute it
template <bool FAST = false>
__device__ __forceinline__ void gelu_and_grad(float h, float& g, float& dg) {
  const float e = erf_as<FAST>(h * 0.70710678118654752f);
  const float phi = expf(-0.5f * h * h) * 0.3989422804014327f;
  g = 0.5f * h * (1.f + e);
  dg = 0.5f * (1.f + e) + h * phi;
}

// The keep bits of an accumulator pair's elements (columns 2 t4, 2 t4 + 1 of an
// n8 tile) in rows a and a + 8 of a 16-row tile: the four elements of a
// Philox group (4 columns) belong to the lanes t4 and t4 ^ 1, so the lane
// with t4 even draws row a's group, the odd one row a + 8's, and they swap.
// e0: the mask element of (row a, the group's first column); row a + 8 is
// 8 * width elements on. Returns bits 0-1 row a, 2-3 row a + 8, for the
// lane's two columns.
// Rows past R draw bits that nobody reads: no branch.
__device__ __forceinline__ uint32_t pair_keep(uint64_t e0, int width, int t4, uint32_t stream,
                                              uint32_t thresh, uint32_t s0, uint32_t s1) {
  const int odd = t4 & 1;
  uint32_t mine = 0u;
  const Philox4 p = philox_group((e0 + (odd ? 8ull * width : 0ull)) >> 2, stream, s0, s1);
#pragma unroll
  for (int k = 0; k < 4; ++k) mine |= static_cast<uint32_t>((p.w[k] >> 8) < thresh) << k;
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const uint32_t ra = odd ? other : mine, rb = odd ? mine : other;
  const int off = 2 * odd;  // the lane's columns in the group
  return ((ra >> off) & 3u) | (((rb >> off) & 3u) << 2);
}
