// Device functions of the fused-FFN forward (fused_ffn.cu) and backward
// (fused_ffn_bwd.cu): the Abramowitz-Stegun erf, exact GELU and its
// derivative (eavit_tpu/ops/fused_ffn.py `_erf` 100-115, `_gelu_exact` 118,
// `_gelu_grad` 122-125), and the forward's mask bits of a warp's 4 x 32 tile.
#pragma once

#include <cstdint>

#include "philox.cuh"

__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-a * a);
  return x < 0.f ? -e : e;
}

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erf_as(h * 0.70710678118654752f));
}

// Mask bits of a 4-row x 32-column tile owned by one warp: lane l needs
// the bits of (row0 + i, col0 + l) for i < 4. Lane 4q + i computes the one
// Philox group covering columns col0 + 4q .. +3 of row i and shares its four
// words through `buf` (128 words per warp). Needs width % 4 == 0 and
// col0 % 4 == 0, so a group never straddles two rows.
__device__ __forceinline__ void quad_bits(uint32_t* buf, int64_t row0, int width,
                                          int col0, int lane, uint32_t stream,
                                          uint32_t s0, uint32_t s1, uint32_t out[4]) {
  const int i = lane & 3, q = lane >> 2;
  const uint64_t e = static_cast<uint64_t>(row0 + i) * width + col0 + 4 * q;
  const Philox4 p = philox_group(e >> 2, stream, s0, s1);
#pragma unroll
  for (int k = 0; k < 4; ++k) buf[i * 32 + 4 * q + k] = p.w[k];
  __syncwarp();
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) out[ii] = buf[ii * 32 + lane];
  __syncwarp();
}

// d gelu / dh with the same erf: cdf + h * pdf.
__device__ __forceinline__ float gelu_grad(float h) {
  const float phi = expf(-0.5f * h * h) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erf_as(h * 0.70710678118654752f));
  return cdf + h * phi;
}
