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
