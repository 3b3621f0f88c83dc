// K2f fused_ffn_fwd and K2r fused_ffn_bits.
//
// Replaces the TPU kernel eavit_tpu/ops/fused_ffn.py `_fwd_kernel` (line 160,
// via `_recompute_fwd` at line 128, launched by `_fwd` at line 288) and its
// mask replay `_masks_kernel` (line 433, launched at line 455).
//
// What it computes, for each row r of x [R, D]:
//   u  = round_T(LayerNorm(x) * ln_w + ln_b)          LN in f32
//   h  = u W1^T + b1                                  f32 accumulation
//   g  = gelu(h)                                      A&S 7.1.26 erf
//   gd = round_T(keep1 ? g * 2^24/thresh : 0)         mask1: stream 0, e = r*Hd + j
//   y0 = gd W2^T + b2
//   y  = keep2 ? y0 * 2^24/thresh : 0                 mask2: stream 1, e = r*D + c
// where T is the input dtype and W1, W2 are rounded to T as the JAX kernel
// casts them (fused_ffn.py:172-174). Weights come in the torch layout:
// w1 [Hd, D] and w2 [D, Hd] ([out, in]), all parameters float32.
//
// What bounds it on an H100: operations. At the flagship act shape
// (R = 12,672 rows of D = 256, Hd = 1024) it does 13.3 GFLOP against
// ~28 MB of traffic when x is float32, which is what the JAX package feeds
// it (the residual stream stays float32 under ComputeDtype = bfloat16; only
// the Dense layers run in bf16). The design keeps the Hd-wide intermediate
// out of device memory, as the TPU kernel did: one block owns 32 rows, holds
// their normalised input in shared memory, and walks the hidden units in
// chunks of 32 -- fc1 for the chunk, GELU and mask1 in registers, then the
// chunk's share of fc2 into 32 x D f32 accumulators held in registers. Only
// y is written. The products run on the CUDA cores in f32 (exact for bf16
// operands), so the float32 peak of the cores is the bound; tensor cores are
// work for a later version.
#include <cstdint>

#include "common.cuh"
#include "ffn_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTR = 32;       // rows per block
constexpr int kHC = 32;       // hidden units per chunk
constexpr int kThreads = 256; // 8 warps: warp w owns rows 4w..4w+3
constexpr int kMaxM = 8;      // D / 32 <= 8, so D <= 256
constexpr int kUS = kTR + 4;  // uT [D][kUS]: row stride keeps float4 alignment
constexpr int kW1S = kHC + 1; // w1T [D][kW1S]
constexpr int kGS = kTR + 4;  // gT [kHC][kGS]

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ffn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, const float* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ w2,
                         const float* __restrict__ b2, T* __restrict__ y, int64_t R,
                         int D, int Hd, float eps, uint32_t thresh, float inv_keep,
                         uint32_t s0, uint32_t s1, int use_dropout) {
  extern __shared__ float4 smem4[];
  float* uT = reinterpret_cast<float*>(smem4);  // [D][kUS]
  float* w1T = uT + D * kUS;                     // [D][kW1S]
  float* w2T = w1T + D * kW1S;                   // [kHC][D + 1]
  float* gT = w2T + kHC * (D + 1);               // [kHC][kGS]
  uint32_t* qbuf = reinterpret_cast<uint32_t*>(gT + kHC * kGS);  // [8][128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTR;
  const int M = D / 32;
  uint32_t* wbuf = qbuf + warp * 128;

  // LayerNorm of the block's rows (warp per row), stored k-major and
  // rounded to T; rows past R are zero.
  for (int rr = warp; rr < kTR; rr += kThreads / 32) {
    const int64_t r = r0 + rr;
    if (r < R) {
      const T* xr = x + r * D;
      float s = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float v = to_f(xr[k]);
        uT[k * kUS + rr] = v;
        s += v;
      }
      const float mu = warp_sum(s) / D;
      float ss = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float c = uT[k * kUS + rr] - mu;
        ss += c * c;
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + eps);
      for (int k = lane; k < D; k += 32) {
        const float c = uT[k * kUS + rr] - mu;
        uT[k * kUS + rr] = round_to<T>(c * rstd * ln_w[k] + ln_b[k]);
      }
    } else {
      for (int k = lane; k < D; k += 32) uT[k * kUS + rr] = 0.f;
    }
  }

  float acc[4][kMaxM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) acc[i][m] = 0.f;

  for (int j0 = 0; j0 < Hd; j0 += kHC) {
    __syncthreads();  // uT complete; previous chunk done with w1T, w2T, gT
    for (int idx = tid; idx < kHC * D; idx += kThreads) {
      const int jj = idx / D, k = idx % D;
      w1T[k * kW1S + jj] = round_to<T>(w1[static_cast<size_t>(j0 + jj) * D + k]);
    }
    for (int idx = tid; idx < kHC * D; idx += kThreads) {
      const int c = idx / kHC, jj = idx % kHC;
      w2T[jj * (D + 1) + c] = round_to<T>(w2[static_cast<size_t>(c) * Hd + j0 + jj]);
    }
    __syncthreads();

    // fc1 for rows 4*warp .. +3, hidden unit j0 + lane
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < D; ++k) {
      const float4 u4 = *reinterpret_cast<const float4*>(&uT[k * kUS + warp * 4]);
      const float w = w1T[k * kW1S + lane];
      h[0] = fmaf(u4.x, w, h[0]);
      h[1] = fmaf(u4.y, w, h[1]);
      h[2] = fmaf(u4.z, w, h[2]);
      h[3] = fmaf(u4.w, w, h[3]);
    }
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if (use_dropout) quad_bits(wbuf, r0 + warp * 4, Hd, j0, lane, 0u, s0, s1, bits);
    const float bj = b1[j0 + lane];
    float g4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float g = gelu(h[i] + bj);
      if (use_dropout) g = (bits[i] >> 8) < thresh ? g * inv_keep : 0.f;
      g4[i] = round_to<T>(g);
    }
    *reinterpret_cast<float4*>(&gT[lane * kGS + warp * 4]) =
        make_float4(g4[0], g4[1], g4[2], g4[3]);
    __syncthreads();

    // fc2 share of the chunk: rows 4*warp .. +3, columns lane + 32*m
    for (int jj = 0; jj < kHC; ++jj) {
      const float4 g = *reinterpret_cast<const float4*>(&gT[jj * kGS + warp * 4]);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float w = w2T[jj * (D + 1) + lane + 32 * m];
          acc[0][m] = fmaf(g.x, w, acc[0][m]);
          acc[1][m] = fmaf(g.y, w, acc[1][m]);
          acc[2][m] = fmaf(g.z, w, acc[2][m]);
          acc[3][m] = fmaf(g.w, w, acc[3][m]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    if (m < M) {
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      if (use_dropout) quad_bits(wbuf, r0 + warp * 4, D, 32 * m, lane, 1u, s0, s1, bits);
      const int c = lane + 32 * m;
      const float bc = b2[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = r0 + warp * 4 + i;
        float v = acc[i][m] + bc;
        if (use_dropout) v = (bits[i] >> 8) < thresh ? v * inv_keep : 0.f;
        if (r < R) y[r * D + c] = from_f<T>(v);
      }
    }
  }
}

__global__ void fused_ffn_bits_kernel(int32_t* __restrict__ m1, uint64_t n1,
                                      int32_t* __restrict__ m2, uint64_t n2,
                                      uint32_t s0, uint32_t s1) {
  // mask1 on stream 0, mask2 on stream 1 (the forward's draw order)
  bits24_grid_stride(m1, n1, 0u, s0, s1);
  bits24_grid_stride(m2, n2, 1u, s0, s1);
}

size_t fwd_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(D) * kUS + static_cast<size_t>(D) * kW1S +
                          static_cast<size_t>(kHC) * (D + 1) + kHC * kGS) +
         sizeof(uint32_t) * (kThreads / 32) * 128;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* y,
                       int64_t R, int D, int Hd, float eps, uint32_t thresh,
                       float inv_keep, uint32_t s0, uint32_t s1, int use_dropout,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(D);
  cudaError_t err = allow_smem(fused_ffn_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((R + kTR - 1) / kTR);
  fused_ffn_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), R, D, Hd, eps, thresh,
      inv_keep, s0, s1, use_dropout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t eavit_fused_ffn_fwd_smem(int D) { return fwd_smem_bytes(D); }

// Returns the cudaError_t of the launch (0 on success). Needs D % 32 == 0,
// D <= 256 and Hd % 32 == 0 (checked by the Python wrapper).
int eavit_fused_ffn_fwd(const void* x, const void* ln_w, const void* ln_b,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        void* y, long long R, int D, int Hd, int dtype, float eps,
                        uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                        int use_dropout, void* stream) {
  if (D % 32 != 0 || D > 32 * kMaxM || Hd % kHC != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return launch_fwd<__nv_bfloat16>(x, ln_w, ln_b, w1, b1, w2, b2, y, R, D, Hd, eps,
                                     thresh, inv_keep, s0, s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return launch_fwd<float>(x, ln_w, ln_b, w1, b1, w2, b2, y, R, D, Hd, eps, thresh,
                             inv_keep, s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

int eavit_fused_ffn_bits(void* m1, unsigned long long n1, void* m2,
                         unsigned long long n2, uint32_t s0, uint32_t s1,
                         void* stream) {
  const int threads = 256;
  const unsigned long long groups = (n1 > n2 ? n1 : n2) / 4 + 1;
  fused_ffn_bits_kernel<<<bits_grid(groups, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(m1), n1, static_cast<int32_t*>(m2), n2, s0, s1);
  return cudaGetLastError();
}

}  // extern "C"
