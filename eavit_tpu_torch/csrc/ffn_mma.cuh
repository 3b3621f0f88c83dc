// Tensor-core pieces shared by the fused-FFN forward (fused_ffn.cu) and
// backward (fused_ffn_bwd.cu): operands as bf16 planes in shared memory, the
// warp-level products on them (mma.sync m16n8k16, f32 accumulators,
// mma_common.cuh), and the kernel that splits the float32 weights into
// planes.
//
// A bf16 activation has every operand rounded to bf16 already (round_T), so
// one mma per product computes it exactly, apart from the order of the sums.
// A float32 activation (SPLIT) enters each operand as two bf16 terms, hi =
// bf16(v) and lo = bf16(v - hi), and each product as three mmas, hi hi + hi lo
// + lo hi: the dropped lo lo term and the rounding of lo leave a relative error
// of about 2^-16 per product (no TF32, whose one term keeps about 2^-11 and
// misses float32's 1e-4). Planes sit in shared memory with rows padded by 16
// bytes and are read by ldmatrix.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps, every kernel of K2
constexpr int kWarps = kThreads / 32;
constexpr int kHC = 32;        // hidden units per chunk of the fused kernels
constexpr int kLH = kHC + 8;   // row stride of a [rows][kHC] plane, elements

__host__ __device__ constexpr int planes(bool split) { return split ? 2 : 1; }

// A fragments of the 16 x 16 block at (m0, k0): from an [M][K] plane, or
// (A_T) from a [K][M] plane through ldmatrix.trans
template <bool A_T>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* p, int ld, int m0,
                                            int k0, int lane) {
  if constexpr (A_T) {
    ldsm_x4_t(a, p + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8);
  } else {
    ldsm_x4(a, p + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  }
}

// B fragments of two n8 tiles (n0 .. n0+15) x 16 depth at k0, b[0..1] the
// first tile's, b[2..3] the second's: from an [N][K] plane, or (B_T) from a
// [K][N] plane through ldmatrix.trans
template <bool B_T>
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], const bf16* p, int ld, int n0,
                                            int k0, int lane) {
  if constexpr (B_T) {
    ldsm_x4_t(b, p + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
  } else {
    ldsm_x4(b, p + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
  }
}

// acc[MT][NT] += A * B over depth [0, kdim): A's 16-row tiles at m0, m0+16,
// ...; B's n8 tiles in pairs, pair q at columns n0 + q * pstride, the first
// `pairs` of NT / 2 live. Each operand has `planes(SPLIT)` planes, the lo one
// `a_lo` / `b_lo` elements after the hi one; SPLIT takes hi hi + hi lo + lo
// hi, in that order, each term over all of a pair's tiles before the next.
template <int MT, int NT, bool A_T, bool B_T, bool SPLIT>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const bf16* a, int lda,
                                          int a_lo, int m0, const bf16* b, int ldb, int b_lo,
                                          int n0, int pstride, int pairs, int kdim, int lane) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs");
  constexpr int P = planes(SPLIT);
  for (int k = 0; k < kdim; k += 16) {
    uint32_t af[MT][P][4];
#pragma unroll
    for (int pl = 0; pl < P; ++pl)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        load_a_frag<A_T>(af[m][pl], a + pl * a_lo, lda, m0 + 16 * m, k, lane);
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) {
      if (q >= pairs) break;
      uint32_t bf[P][4];
#pragma unroll
      for (int pl = 0; pl < P; ++pl)
        load_b_pair<B_T>(bf[pl], b + pl * b_lo, ldb, n0 + q * pstride, k, lane);
#pragma unroll
      for (int t = 0; t < (SPLIT ? 3 : 1); ++t) {
        const int pa = t == 2, pb = t == 1;  // the planes of term t
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            mma_bf16(acc[m][2 * q + hf], af[m][pa], bf[pb][2 * hf], bf[pb][2 * hf + 1]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
}

// four consecutive values as bf16 planes: rounded (hi only) or hi + lo
template <bool SPLIT>
__device__ __forceinline__ void store4(bf16* hi, size_t lo_off, float4 v) {
  uint2 h, l;
  if constexpr (SPLIT) {
    split_bf16(v.x, v.y, h.x, l.x);
    split_bf16(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + lo_off) = l;
  } else {
    h.x = pack_bf16(v.x, v.y);
    h.y = pack_bf16(v.z, v.w);
  }
  *reinterpret_cast<uint2*>(hi) = h;
}

// one value as bf16 planes
template <bool SPLIT>
__device__ __forceinline__ void store1(bf16* hi, size_t lo_off, float v) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  if constexpr (SPLIT) hi[lo_off] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// two consecutive values as bf16 planes (an accumulator pair of a fragment)
template <bool SPLIT>
__device__ __forceinline__ void store2(bf16* hi, size_t lo_off, float x0, float x1) {
  uint32_t h, l;
  if constexpr (SPLIT) {
    split_bf16(x0, x1, h, l);
    *reinterpret_cast<uint32_t*>(hi + lo_off) = l;
  } else {
    h = pack_bf16(x0, x1);
  }
  *reinterpret_cast<uint32_t*>(hi) = h;
}

// hi (and lo) bf16 planes [P][rows_p][cols_p] of a float32 matrix w [rows][cols]
// (rounded to bf16 when !SPLIT), zero past rows and cols: the lo plane is
// rows_p * cols_p elements after the hi one
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    split_planes_kernel(const float* __restrict__ w, int rows, int cols, bf16* __restrict__ p,
                        int rows_p, int cols_p) {
  const int64_t n = static_cast<int64_t>(rows_p) * cols_p;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int r = static_cast<int>(i / cols_p), c = static_cast<int>(i % cols_p);
  const float v = r < rows && c < cols ? w[static_cast<int64_t>(r) * cols + c] : 0.f;
  const bf16 h = __float2bfloat16_rn(v);
  p[i] = h;
  if constexpr (SPLIT) p[n + i] = __float2bfloat16_rn(v - __bfloat162float(h));
}

template <bool SPLIT>
cudaError_t split_planes(const float* w, int rows, int cols, bf16* p, int rows_p, int cols_p,
                         cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(rows_p) * cols_p;
  split_planes_kernel<SPLIT><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
                               0, stream>>>(w, rows, cols, p, rows_p, cols_p);
  return cudaGetLastError();
}

// out[col] = sum over p < parts of part[p * stride + col], in a fixed order:
// eight strided partial sums per column, then those eight in order.
__global__ void __launch_bounds__(kThreads)
    reduce_parts_kernel(const float* __restrict__ part, int64_t parts, size_t stride,
                        size_t width, float* __restrict__ out) {
  __shared__ float sm[kWarps][33];
  const int lane = threadIdx.x & 31, pl = threadIdx.x >> 5;
  const size_t col = static_cast<size_t>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (col < width)
    for (int64_t q = pl; q < parts; q += kWarps) s += part[q * stride + col];
  sm[pl][lane] = s;
  __syncthreads();
  if (pl == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += sm[q][lane];
    out[col] = t;
  }
}

cudaError_t reduce_parts(const float* part, int64_t parts, size_t width, float* out,
                         cudaStream_t stream) {
  reduce_parts_kernel<<<static_cast<unsigned>((width + 31) / 32), kThreads, 0, stream>>>(
      part, parts, width, width, out);
  return cudaGetLastError();
}

}  // namespace
