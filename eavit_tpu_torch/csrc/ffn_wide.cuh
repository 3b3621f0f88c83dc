// The fused FFN at the widths its fused kernels do not take: D not a multiple
// of 32 or above 256, or Hd not a multiple of 32, at any D and Hd, as the JAX
// kernel takes any width (eavit_tpu/ops/fused_ffn.py:287-301; no shipped
// config needs these widths).
//
// The fused kernels hold a tile of rows at the full width D in shared memory
// beside a chunk of both weight matrices, also D wide; as hi + lo bf16 planes
// that does not fit one block above D = 256. So here the work is split at the
// products: row kernels on the CUDA cores (LayerNorm, the masks, GELU, the
// LayerNorm backward) and a tiled tensor-core product between them, each
// reading and writing device memory:
//   forward   u = LN(x) -> H = u W1^T -> gd = mask1(gelu(H + b1))
//             -> Y = gd W2^T -> y = mask2(Y + b2)
//   backward  u, dy0 = LN(x), mask2(dy) -> H = u W1^T, G = dy0 W2
//             -> dh, gd (and db1) -> DU = dh W1 -> dx (and dln_w, dln_b),
//             and dW1, dW2 from the dh, gd, u and dy0 planes (fused_ffn_bwd.cu)
// The products' operands are bf16 planes padded to Dp = round_up(D, 32) and
// Hdp = round_up(Hd, 32) with zeros, so the padded sums are exact; H, G, Y and
// DU are float32 [R][Hdp] or [R][Dp]. LayerNorm runs over the true D and the
// masks draw at the logical indices (mask1 e = r*Hd + j on stream 0, mask2 e =
// r*D + c on stream 1), so every width gives the plain version's function and
// masks. Each sum has one owner and a fixed order: two calls give equal bits.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ffn_common.cuh"
#include "ffn_mma.cuh"

namespace {

constexpr int kWRows = 64;   // rows of a block of the row kernels
constexpr int kWT = 128;     // rows and columns of a product's block tile
constexpr int kWK = 32;      // depth of one stage of it
constexpr int kWStages = 3;  // stages in flight
constexpr int kWCols = 256;  // columns of a slice of the LayerNorm kernels' column sums
constexpr int kWSlab = kWT * (kWK + 8);  // elements of one plane of one operand's stage
static_assert(kWK * (kWT + 8) <= kWSlab && kWT * kWK / 8 == 2 * kThreads,
              "two 16-byte pieces a thread per plane and operand");

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// LayerNorm of rows: u planes [P][R][Dp]; with BWD also dy0 = mask2(dy)
// planes, mu and rstd (stats [2][R]) and the block's partial db2 (column sums
// of dy0, at part[tile][Hdp + 2 Dp + c]). Warp w takes rows 8w .. 8w+7: first
// their statistics over the whole row, then the row in slices of kWCols
// columns, each slice's column sums reduced over the warps before the next,
// so shared memory does not grow with D (the sums keep one order: rows, then
// warps).
template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads)
    wide_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const T* __restrict__ dy,
                     bf16* __restrict__ up, bf16* __restrict__ dp, float* __restrict__ stats,
                     float* __restrict__ part, int64_t R, int D, int Dp, int Hdp, float eps,
                     uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                     int use_dropout) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  constexpr int RW = kWRows / kWarps;  // rows of a warp
  __shared__ float red[kWarps][kWCols];  // BWD: each warp's column sums of dy0 in a slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = static_cast<size_t>(R) * Dp;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kWRows + warp * RW;
  float mu[RW], rstd[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t r = r0 + i;
    mu[i] = rstd[i] = 0.f;
    if (r >= R) continue;
    const T* xr = x + r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
    mu[i] = warp_sum(s) / D;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_f(xr[c]) - mu[i];
      ss += v * v;
    }
    rstd[i] = rsqrtf(warp_sum(ss) / D + eps);
    if (BWD && lane == 0) {
      stats[r] = mu[i];
      stats[R + r] = rstd[i];
    }
  }
  for (int c0 = 0; c0 < Dp; c0 += kWCols) {
    const int cn = min(kWCols, Dp - c0);
    if constexpr (BWD)
      for (int c = lane; c < cn; c += 32) red[warp][c] = 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int64_t r = r0 + i;
      if (r >= R) continue;
      const T* xr = x + r * D;
      for (int c = c0 + lane; c < c0 + cn; c += 32) {
        const float u =
            c < D ? round_to<T>((to_f(xr[c]) - mu[i]) * rstd[i] * ln_w[c] + ln_b[c]) : 0.f;
        store1<SPLIT>(up + r * Dp + c, plane, u);
        if constexpr (BWD) {
          float v = 0.f;
          if (c < D) {
            v = to_f(dy[r * D + c]);
            if (use_dropout)
              v = mask_word(static_cast<uint64_t>(r) * D + c, 1u, s0, s1) < thresh
                      ? v * inv_keep
                      : 0.f;
            red[warp][c - c0] += v;
          }
          store1<SPLIT>(dp + r * Dp + c, plane, round_to<T>(v));
        }
      }
    }
    if constexpr (BWD) {
      __syncthreads();
      float* my = part + static_cast<size_t>(blockIdx.x) * (Hdp + 3 * Dp) + Hdp + 2 * Dp + c0;
      for (int c = threadIdx.x; c < cn; c += kThreads) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += red[w][c];
        my[c] = t;
      }
      __syncthreads();  // the slice's sums are read before the next slice zeroes them
    }
  }
}

// C [M][N] (float32, row stride N) = A B over depth K, A [M][K] bf16 planes
// (row stride lda, the lo plane a_plane elements after the hi one), B as
// [N][K] planes or (B_T) [K][N] ones. One kWT x kWT tile of C a block, 8 warps
// of 32 x 64, the depth streamed in stages of kWK through a cp.async ring.
// K, N and the plane widths are multiples of 32 (zero-padded); rows past M
// are zero in shared memory and not written.
template <bool B_T, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    wide_gemm_kernel(const bf16* __restrict__ a, int lda, size_t a_plane,
                     const bf16* __restrict__ b, int ldb, size_t b_plane, float* __restrict__ c,
                     int64_t M, int N, int K) {
  constexpr int P = planes(SPLIT), LA = kWK + 8, LB = B_T ? kWT + 8 : kWK + 8;
  constexpr int stage = P * kWSlab;
  extern __shared__ float4 smem4[];
  bf16* as = reinterpret_cast<bf16*>(smem4);  // [kWStages][P][kWT][LA]
  bf16* bs = as + kWStages * stage;           // [kWStages][P][..][LB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kWT;
  const int n0 = blockIdx.x * kWT;
  const int m_live = static_cast<int>(M - m0 < kWT ? M - m0 : kWT);
  const int n_live = min(kWT, N - n0);
  const int steps = K / kWK;
  auto issue = [&](int i) {
    const int k0 = i * kWK, st = i % kWStages * stage;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * kThreads;
      const int ra = q / (kWK / 8), ka = q % (kWK / 8) * 8;  // A: kWT rows x kWK
#pragma unroll
      for (int pl = 0; pl < P; ++pl) {
        bf16* sa = as + st + pl * kWSlab + ra * LA + ka;
        if (ra < m_live) {
          cp_async16(sa, a + pl * a_plane + (m0 + ra) * lda + k0 + ka);
        } else {
          *reinterpret_cast<uint4*>(sa) = make_uint4(0u, 0u, 0u, 0u);
        }
        if constexpr (B_T) {  // kWK rows of depth x kWT columns
          const int rb = q / (kWT / 8), kb = q % (kWT / 8) * 8;
          bf16* sb = bs + st + pl * kWSlab + rb * LB + kb;
          if (kb < n_live) {
            cp_async16(sb, b + pl * b_plane + static_cast<size_t>(k0 + rb) * ldb + n0 + kb);
          } else {
            *reinterpret_cast<uint4*>(sb) = make_uint4(0u, 0u, 0u, 0u);
          }
        } else {  // kWT columns x kWK depth
          bf16* sb = bs + st + pl * kWSlab + ra * LB + ka;
          if (ra < n_live) {
            cp_async16(sb, b + pl * b_plane + static_cast<size_t>(n0 + ra) * ldb + k0 + ka);
          } else {
            *reinterpret_cast<uint4*>(sb) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kWStages - 1; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }
  const int wm = warp & 3, wn = warp >> 2;  // rows 32 wm, columns 64 wn of the tile
  const int pairs = max(0, min(4, (n_live - 64 * wn) / 16));
  float acc[2][8][4];
  zero(acc);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // step i is in; every warp is done with step i - 1's stage
    if (i + kWStages - 1 < steps) issue(i + kWStages - 1);
    cp_async_commit();
    const int st = i % kWStages * stage;
    warp_gemm<2, 8, false, B_T, SPLIT>(acc, as + st, LA, kWSlab, 32 * wm, bs + st, LB, kWSlab,
                                       64 * wn, 16, pairs, kWK, lane);
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= pairs) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 32 * wm + 16 * m + g + 8 * r;
          if (row >= m_live) continue;
          *reinterpret_cast<float2*>(c + (m0 + row) * N + n0 + 64 * wn + 16 * q + 8 * hf +
                                     2 * t4) =
              make_float2(acc[m][2 * q + hf][2 * r], acc[m][2 * q + hf][2 * r + 1]);
        }
    }
}

size_t wide_gemm_smem(bool split) {
  return sizeof(bf16) * 2 * kWStages * planes(split) * kWSlab;
}

template <bool B_T, bool SPLIT>
cudaError_t wide_gemm(const bf16* a, int lda, size_t a_plane, const bf16* b, int ldb,
                      size_t b_plane, float* c, int64_t M, int N, int K, cudaStream_t stream) {
  const size_t smem = wide_gemm_smem(SPLIT);
  cudaError_t err = allow_smem(wide_gemm_kernel<B_T, SPLIT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kWT - 1) / kWT, static_cast<unsigned>((M + kWT - 1) / kWT));
  wide_gemm_kernel<B_T, SPLIT><<<grid, kThreads, smem, stream>>>(a, lda, a_plane, b, ldb,
                                                                 b_plane, c, M, N, K);
  return cudaGetLastError();
}

// The hidden units elementwise, from H = u W1^T (and, BWD, G = dy0 W2), both
// [R][Hdp]: gd = round_T(mask1(gelu(H + b1))) as planes at hp [P][R][Hdp];
// with BWD dh = gelu'(H + b1) * mask1(G) as planes at hp and gd after them,
// and the block's partial db1 (column sums of dh) at part[tile][j]. A block
// takes kWRows rows x 32 units: lane l unit j0 + l, warp w rows 8w .. 8w+7.
template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads)
    wide_hidden_kernel(const float* __restrict__ H, const float* __restrict__ G,
                       const float* __restrict__ b1, bf16* __restrict__ hp,
                       float* __restrict__ part, int64_t R, int Hd, int Hdp, int Dp,
                       uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                       int use_dropout) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.y * 32 + lane;
  const size_t plane = static_cast<size_t>(R) * Hdp;
  float dsum = 0.f;
  for (int i = 0; i < kWRows / kWarps; ++i) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kWRows + warp * (kWRows / kWarps) + i;
    if (r >= R) break;
    float gd = 0.f, dh = 0.f;
    if (j < Hd) {
      const float hh = H[r * Hdp + j] + b1[j];
      float g = gelu(hh), dg = BWD ? G[r * Hdp + j] : 0.f;
      if (use_dropout) {
        const bool keep = mask_word(static_cast<uint64_t>(r) * Hd + j, 0u, s0, s1) < thresh;
        g = keep ? g * inv_keep : 0.f;
        dg = keep ? dg * inv_keep : 0.f;
      }
      gd = round_to<T>(g);
      if constexpr (BWD) dh = gelu_grad(hh) * dg;
    }
    if constexpr (BWD) {
      store1<SPLIT>(hp + r * Hdp + j, plane, round_to<T>(dh));
      store1<SPLIT>(hp + planes(SPLIT) * plane + r * Hdp + j, plane, gd);
      dsum += dh;
    } else {
      store1<SPLIT>(hp + r * Hdp + j, plane, gd);
    }
  }
  if constexpr (BWD) {
    red[warp][lane] = dsum;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][lane];
      part[static_cast<size_t>(blockIdx.x) * (Hdp + 3 * Dp) + j] = t;
    }
  }
}

// y = mask2(Y + b2) in T, Y [R][Dp]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_out_kernel(const float* __restrict__ Y, const float* __restrict__ b2, T* __restrict__ y,
                    int64_t R, int D, int Dp, uint32_t thresh, float inv_keep, uint32_t s0,
                    uint32_t s1, int use_dropout) {
  const int64_t n = R * D;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = e / D;
    const int c = static_cast<int>(e - r * D);
    float v = Y[r * Dp + c] + b2[c];
    if (use_dropout)
      v = mask_word(static_cast<uint64_t>(e), 1u, s0, s1) < thresh ? v * inv_keep : 0.f;
    y[e] = from_f<T>(v);
  }
}

// LayerNorm backward of rows from DU = dh W1 [R][Dp]: dx in T and the block's
// partial dln_w, dln_b at part[tile][Hdp + c], part[tile][Hdp + Dp + c]. As
// wide_rows_kernel: each row's sums over the whole row first, then the row in
// slices of kWCols columns (dx, and the column sums reduced over the warps).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                       const float* __restrict__ stats, const float* __restrict__ DU,
                       T* __restrict__ dx, float* __restrict__ part, int64_t R, int D, int Dp,
                       int Hdp) {
  constexpr int RW = kWRows / kWarps;  // rows of a warp
  __shared__ float red[2][kWarps][kWCols];  // dln_w, dln_b by warp, in a slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kWRows + warp * RW;
  float mu[RW], rstd[RW], mt[RW], mtx[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t r = r0 + i;
    mu[i] = rstd[i] = mt[i] = mtx[i] = 0.f;
    if (r >= R) continue;
    mu[i] = stats[r], rstd[i] = stats[R + r];
    float st = 0.f, stx = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float g = DU[r * Dp + c], xh = (to_f(x[r * D + c]) - mu[i]) * rstd[i];
      const float t = g * ln_w[c];
      st += t;
      stx = fmaf(t, xh, stx);
    }
    mt[i] = warp_sum(st) / D, mtx[i] = warp_sum(stx) / D;
  }
  float* my = part + static_cast<size_t>(blockIdx.x) * (Hdp + 3 * Dp) + Hdp;
  for (int c0 = 0; c0 < Dp; c0 += kWCols) {
    const int cn = min(kWCols, Dp - c0);
    float* gw = red[0][warp];
    float* gb = red[1][warp];
    for (int c = lane; c < cn; c += 32) gw[c] = gb[c] = 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int64_t r = r0 + i;
      if (r >= R) continue;
      for (int c = c0 + lane; c < c0 + cn && c < D; c += 32) {
        const float g = DU[r * Dp + c], xh = (to_f(x[r * D + c]) - mu[i]) * rstd[i];
        gw[c - c0] = fmaf(g, xh, gw[c - c0]);
        gb[c - c0] += g;
        dx[r * D + c] = from_f<T>((g * ln_w[c] - mt[i] - xh * mtx[i]) * rstd[i]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cn; c += kThreads) {
      float tw = 0.f, tb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        tw += red[0][w][c];
        tb += red[1][w][c];
      }
      my[c0 + c] = tw;
      my[Dp + c0 + c] = tb;
    }
    __syncthreads();  // the slice's sums are read before the next slice zeroes them
  }
}

// Launch helpers: grids of the row kernels
inline unsigned row_tiles(int64_t R) { return static_cast<unsigned>((R + kWRows - 1) / kWRows); }

}  // namespace
