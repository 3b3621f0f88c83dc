// K2b fused_ffn_bwd: the backward of the fused pre-norm FFN.
//
// Replaces the TPU kernel eavit_tpu/ops/fused_ffn.py `_bwd_kernel` (line 180,
// launched by `_bwd` at line 321).
//
// What it computes from x [R, D], dy [R, D] and the parameters (torch layout:
// w1 [Hd, D], w2 [D, Hd], all float32), with T the dtype of x and every
// product accumulated in f32:
//   u, xhat, rstd, h, g   the forward, recomputed (fused_ffn.cu)
//   m1, m2                both masks, regenerated (Philox: m1 stream 0 at
//                         e = r*Hd + j, m2 stream 1 at e = r*D + c)
//   dy0 = m2 ? dy * inv_keep : 0
//   gd  = round_T(m1 ? g * inv_keep : 0)
//   dW2 = round_T(dy0)^T gd        db2 = sum_r dy0
//   dgd = round_T(dy0) round_T(W2)
//   dh  = gelu'(h) * (m1 ? dgd * inv_keep : 0)
//   dW1 = round_T(dh)^T u          db1 = sum_r dh
//   du  = round_T(dh) round_T(W1)
//   dln_w = sum_r du * xhat        dln_b = sum_r du
//   t = du * ln_w;  dx = (t - mean(t) - xhat * mean(t * xhat)) * rstd
// dx is written in T, the six parameter gradients in float32. The fc2
// output itself is needed by no gradient and is not recomputed.
//
// What bounds it on an H100: operations. At the flagship training shape
// (R = 50,688 rows of D = 256, Hd = 1024, float32 activations) the five
// products the gradients need (fc1, dW2, dgd, dW1, du) are 133 GFLOP in
// float32 against 156 MB of traffic.
//
// The TPU kernel sums the parameter gradients in place across grid cells that
// run one after the other. Blocks of a GPU grid run concurrently, so the work
// is decomposed twice, once for each kind of output, and nothing is summed
// with atomics (every sum has a fixed order: the result is deterministic):
//   dx kernel   one block owns 32 rows (as the forward does) and walks the
//               hidden units in chunks of 32: fc1 and dgd for the chunk, then
//               the chunk's share of du into registers. It ends with the
//               LayerNorm backward and writes dx plus one partial row each of
//               dln_w, dln_b and db2.
//   dW kernel   one block owns a chunk of 32 hidden units and every S-th tile
//               of 32 rows. It keeps the chunk of W1 and W2 in shared memory,
//               recomputes u, h and dgd tile by tile, and accumulates
//               dW1[chunk, :] and dW2[:, chunk] (2 x 32 x D floats) in
//               registers; one partial per row slice.
//   reduce      sums the partials (S slices; R/32 row blocks) in order.
// The hidden-wide intermediates never reach device memory; the price is that
// fc1 and dgd are computed in both kernels (seven products in all). The
// products run on the CUDA cores in f32, so the float32 peak of the cores is
// the bound; see PERF.md for the measured time.
#include <cstdint>

#include "common.cuh"
#include "ffn_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTR = 32;        // rows per tile
constexpr int kHC = 32;        // hidden units per chunk
constexpr int kThreads = 256;  // 8 warps: warp w owns rows 4w..4w+3 of a tile
constexpr int kWarpsB = kThreads / 32;
constexpr int kMaxM = 8;       // D / 32 <= 8, so D <= 256
constexpr int kWS = kHC + 1;   // weight chunks [D][kWS]
constexpr int kTS = kHC + 4;   // [32][32] tiles, row stride keeps float4 alignment

// Loads one tile of kTR rows starting at r0; warp w loads rows 4w..4w+3.
//   u_rm [kTR][DS]   round_T(LayerNorm(x) * ln_w + ln_b)
//   dy_rm[kTR][DS]   round_T(dy0), mask2 regenerated
//   mu_s, rstd_s     the rows' LayerNorm statistics (0 past R)
//   red [warps][D]   when not null: the warp's column sums of unrounded dy0
// Rows past R are zero. A warp reads back only what it wrote itself, so the
// caller needs __syncwarp() before using its own rows and __syncthreads()
// before using the others'.
template <typename T>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, float* u_rm, float* dy_rm, float* mu_s,
    float* rstd_s, float* red, int64_t r0, int64_t R, int D, int DS, float eps,
    uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1, int use_dropout) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = D / 4;  // <= 64: at most two Philox groups per lane and row
  float dsum[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) dsum[m] = 0.f;
  for (int i = 0; i < 4; ++i) {
    const int rr = warp * 4 + i;
    const int64_t r = r0 + rr;
    float* ur = u_rm + rr * DS;
    float* dr = dy_rm + rr * DS;
    if (r < R) {
      const T* xr = x + r * D;
      float s = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float v = to_f(xr[k]);
        ur[k] = v;
        s += v;
      }
      const float mu = warp_sum(s) / D;
      float ss = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float c = ur[k] - mu;
        ss += c * c;
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + eps);
      for (int k = lane; k < D; k += 32)
        ur[k] = round_to<T>((ur[k] - mu) * rstd * ln_w[k] + ln_b[k]);
      if (lane == 0) {
        mu_s[rr] = mu;
        rstd_s[rr] = rstd;
      }
      const T* dyr = dy + r * D;
#pragma unroll
      for (int t = 0; t < kMaxM / 4; ++t) {
        const int g = lane + 32 * t;
        if (g < groups) {
          const int c = 4 * g;
          Philox4 p = {};
          if (use_dropout)
            p = philox_group((static_cast<uint64_t>(r) * D + c) >> 2, 1u, s0, s1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float v = to_f(dyr[c + kk]);
            if (use_dropout) v = (p.w[kk] >> 8) < thresh ? v * inv_keep : 0.f;
            dsum[t * 4 + kk] += v;
            dr[c + kk] = round_to<T>(v);
          }
        }
      }
    } else {
      for (int k = lane; k < D; k += 32) {
        ur[k] = 0.f;
        dr[k] = 0.f;
      }
      if (lane == 0) {
        mu_s[rr] = 0.f;
        rstd_s[rr] = 0.f;
      }
    }
  }
  if (red != nullptr) {
#pragma unroll
    for (int t = 0; t < kMaxM / 4; ++t) {
      const int g = lane + 32 * t;
      if (g < groups) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) red[warp * D + 4 * g + kk] = dsum[t * 4 + kk];
      }
    }
  }
}

// Stages the chunk j0 .. j0+kHC of both weight matrices, rounded to T:
//   w1T[k][jj] = W1[j0 + jj][k]      w2c[c][jj] = W2[c][j0 + jj]
template <typename T>
__device__ __forceinline__ void load_chunk(const float* __restrict__ w1,
                                           const float* __restrict__ w2, float* w1T,
                                           float* w2c, int j0, int D, int Hd) {
  for (int idx = threadIdx.x; idx < kHC * D; idx += kThreads) {
    const int jj = idx / D, k = idx % D;
    w1T[k * kWS + jj] = round_to<T>(w1[static_cast<size_t>(j0 + jj) * D + k]);
  }
  for (int idx = threadIdx.x; idx < kHC * D; idx += kThreads) {
    const int c = idx / kHC, jj = idx % kHC;
    w2c[c * kWS + jj] = round_to<T>(w2[static_cast<size_t>(c) * Hd + j0 + jj]);
  }
}

// For the warp's rows 4w..4w+3 and the chunk's hidden unit `lane`:
//   h[i]   = sum_k u[row][k]  * W1[j][k]      (fc1 without its bias)
//   dgd[i] = sum_c dy[row][c] * W2[c][j]
__device__ __forceinline__ void chunk_products(const float* u_rm, const float* dy_rm,
                                               const float* w1T, const float* w2c,
                                               int D, int DS, float h[4],
                                               float dgd[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = dgd[i] = 0.f;
  const float* ub = u_rm + warp * 4 * DS;
  const float* db = dy_rm + warp * 4 * DS;
  for (int k = 0; k < D; k += 4) {
    float wa[4], wb[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wa[kk] = w1T[(k + kk) * kWS + lane];
      wb[kk] = w2c[(k + kk) * kWS + lane];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 u4 = *reinterpret_cast<const float4*>(ub + i * DS + k);
      const float4 d4 = *reinterpret_cast<const float4*>(db + i * DS + k);
      h[i] = fmaf(u4.x, wa[0], h[i]);
      h[i] = fmaf(u4.y, wa[1], h[i]);
      h[i] = fmaf(u4.z, wa[2], h[i]);
      h[i] = fmaf(u4.w, wa[3], h[i]);
      dgd[i] = fmaf(d4.x, wb[0], dgd[i]);
      dgd[i] = fmaf(d4.y, wb[1], dgd[i]);
      dgd[i] = fmaf(d4.z, wb[2], dgd[i]);
      dgd[i] = fmaf(d4.w, wb[3], dgd[i]);
    }
  }
}

// Sums red[warps][D] over the warps, in order, into out[D].
__device__ __forceinline__ void block_column_sum(const float* red, int D, float* out) {
  if (static_cast<int>(threadIdx.x) < D) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsB; ++w) s += red[w * D + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ffn_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, int64_t R, int D, int Hd,
                            float eps, uint32_t thresh, float inv_keep, uint32_t s0,
                            uint32_t s1, int use_dropout) {
  extern __shared__ float4 smem4[];
  const int DS = D + 4;
  float* u_rm = reinterpret_cast<float*>(smem4);  // [kTR][DS]
  float* dy_rm = u_rm + kTR * DS;                  // [kTR][DS]
  float* w1T = dy_rm + kTR * DS;                   // [D][kWS]
  float* w2c = w1T + D * kWS;                      // [D][kWS]
  float* dhT = w2c + D * kWS;                      // [kHC][kTS]
  float* red = dhT + kHC * kTS;                    // [kWarpsB][D]
  float* mu_s = red + kWarpsB * D;                 // [kTR]
  float* rstd_s = mu_s + kTR;                      // [kTR]
  uint32_t* qbuf = reinterpret_cast<uint32_t*>(rstd_s + kTR);  // [kWarpsB][128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTR;
  const int M = D / 32;
  uint32_t* wbuf = qbuf + warp * 128;
  float* my_part = part + static_cast<size_t>(blockIdx.x) * 3 * D;  // dln_w|dln_b|db2

  load_tile<T>(x, dy, ln_w, ln_b, u_rm, dy_rm, mu_s, rstd_s, red, r0, R, D, DS, eps,
               thresh, inv_keep, s0, s1, use_dropout);
  __syncthreads();
  block_column_sum(red, D, my_part + 2 * D);  // db2

  float acc[4][kMaxM];  // du of rows 4*warp + i, columns lane + 32*m
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) acc[i][m] = 0.f;

  for (int j0 = 0; j0 < Hd; j0 += kHC) {
    __syncthreads();  // the previous chunk is done with w1T and w2c
    load_chunk<T>(w1, w2, w1T, w2c, j0, D, Hd);
    __syncthreads();

    float h[4], dgd[4];
    chunk_products(u_rm, dy_rm, w1T, w2c, D, DS, h, dgd);
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if (use_dropout) quad_bits(wbuf, r0 + warp * 4, Hd, j0, lane, 0u, s0, s1, bits);
    const float bj = b1[j0 + lane];
    float d4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dg = dgd[i];
      if (use_dropout) dg = (bits[i] >> 8) < thresh ? dg * inv_keep : 0.f;
      d4[i] = round_to<T>(gelu_grad(h[i] + bj) * dg);
    }
    // dhT[jj][rows]: written and read by this warp only (its own four rows)
    *reinterpret_cast<float4*>(&dhT[lane * kTS + warp * 4]) =
        make_float4(d4[0], d4[1], d4[2], d4[3]);
    __syncwarp();
    for (int jj = 0; jj < kHC; ++jj) {
      const float4 g = *reinterpret_cast<const float4*>(&dhT[jj * kTS + warp * 4]);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float w = w1T[(lane + 32 * m) * kWS + jj];
          acc[0][m] = fmaf(g.x, w, acc[0][m]);
          acc[1][m] = fmaf(g.y, w, acc[1][m]);
          acc[2][m] = fmaf(g.z, w, acc[2][m]);
          acc[3][m] = fmaf(g.w, w, acc[3][m]);
        }
      }
    }
    __syncwarp();
  }

  // LayerNorm backward for the warp's rows; partial sums of dln_w and dln_b
  float gw[kMaxM], gb[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) gw[m] = gb[m] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = warp * 4 + i;
    const int64_t r = r0 + rr;
    const float mu = mu_s[rr], rstd = rstd_s[rr];
    float t[kMaxM], xh[kMaxM];
    float st = 0.f, stx = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      t[m] = xh[m] = 0.f;
      if (m < M) {
        const int c = lane + 32 * m;
        xh[m] = r < R ? (to_f(x[r * D + c]) - mu) * rstd : 0.f;
        t[m] = acc[i][m] * ln_w[c];
        st += t[m];
        stx = fmaf(t[m], xh[m], stx);
        gw[m] = fmaf(acc[i][m], xh[m], gw[m]);
        gb[m] += acc[i][m];
      }
    }
    const float mt = warp_sum(st) / D, mtx = warp_sum(stx) / D;
    if (r < R) {
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M)
          dx[r * D + lane + 32 * m] = from_f<T>((t[m] - mt - xh[m] * mtx) * rstd);
      }
    }
  }
  __syncthreads();  // red is free again
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < M) red[warp * D + lane + 32 * m] = gw[m];
  __syncthreads();
  block_column_sum(red, D, my_part);  // dln_w
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    if (m < M) red[warp * D + lane + 32 * m] = gb[m];
  __syncthreads();
  block_column_sum(red, D, my_part + D);  // dln_b
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ffn_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const T* __restrict__ dy, float* __restrict__ part,
                            int64_t R, int D, int Hd, float eps, uint32_t thresh,
                            float inv_keep, uint32_t s0, uint32_t s1, int use_dropout) {
  extern __shared__ float4 smem4[];
  const int DS = D + 4;
  float* u_rm = reinterpret_cast<float*>(smem4);  // [kTR][DS]
  float* dy_rm = u_rm + kTR * DS;                  // [kTR][DS]
  float* w1T = dy_rm + kTR * DS;                   // [D][kWS]
  float* w2c = w1T + D * kWS;                      // [D][kWS]
  float* gd_rm = w2c + D * kWS;                    // [kTR][kTS]
  float* dh_rm = gd_rm + kTR * kTS;                // [kTR][kTS]
  float* red1 = dh_rm + kTR * kTS;                 // [kWarpsB][kHC]
  float* mu_s = red1 + kWarpsB * kHC;              // [kTR]
  float* rstd_s = mu_s + kTR;                      // [kTR]
  uint32_t* qbuf = reinterpret_cast<uint32_t*>(rstd_s + kTR);  // [kWarpsB][128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kHC;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int M = D / 32;
  uint32_t* wbuf = qbuf + warp * 128;
  const int64_t tiles = (R + kTR - 1) / kTR;

  load_chunk<T>(w1, w2, w1T, w2c, j0, D, Hd);
  const float bj = b1[j0 + lane];

  // thread: hidden units j0 + 4*warp + jj, columns lane + 32*m
  float acc1[4][kMaxM], acc2[4][kMaxM];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) acc1[jj][m] = acc2[jj][m] = 0.f;
  float db1 = 0.f;  // hidden unit j0 + lane, the warp's rows

  for (int64_t tile = slice; tile < tiles; tile += slices) {
    const int64_t r0 = tile * kTR;
    __syncthreads();  // the previous tile's sums are done; the chunk is staged
    load_tile<T>(x, dy, ln_w, ln_b, u_rm, dy_rm, mu_s, rstd_s, nullptr, r0, R, D, DS,
                 eps, thresh, inv_keep, s0, s1, use_dropout);
    __syncwarp();

    float h[4], dgd[4];
    chunk_products(u_rm, dy_rm, w1T, w2c, D, DS, h, dgd);
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if (use_dropout) quad_bits(wbuf, r0 + warp * 4, Hd, j0, lane, 0u, s0, s1, bits);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float hh = h[i] + bj;
      float g = gelu(hh), dg = dgd[i];
      if (use_dropout) {
        const bool keep = (bits[i] >> 8) < thresh;
        g = keep ? g * inv_keep : 0.f;
        dg = keep ? dg * inv_keep : 0.f;
      }
      const float dh = gelu_grad(hh) * dg;
      db1 += dh;
      gd_rm[(warp * 4 + i) * kTS + lane] = round_to<T>(g);
      dh_rm[(warp * 4 + i) * kTS + lane] = round_to<T>(dh);
    }
    __syncthreads();

    for (int r = 0; r < kTR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&dh_rm[r * kTS + warp * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gd_rm[r * kTS + warp * 4]);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float uu = u_rm[r * DS + lane + 32 * m];
          const float dd = dy_rm[r * DS + lane + 32 * m];
          acc1[0][m] = fmaf(a.x, uu, acc1[0][m]);
          acc1[1][m] = fmaf(a.y, uu, acc1[1][m]);
          acc1[2][m] = fmaf(a.z, uu, acc1[2][m]);
          acc1[3][m] = fmaf(a.w, uu, acc1[3][m]);
          acc2[0][m] = fmaf(b.x, dd, acc2[0][m]);
          acc2[1][m] = fmaf(b.y, dd, acc2[1][m]);
          acc2[2][m] = fmaf(b.z, dd, acc2[2][m]);
          acc2[3][m] = fmaf(b.w, dd, acc2[3][m]);
        }
      }
    }
  }

  // this slice's partials: dW1 [Hd][D] | dW2 [D][Hd] | db1 [Hd]
  const size_t hd = static_cast<size_t>(Hd) * D;
  float* p = part + static_cast<size_t>(slice) * (2 * hd + Hd);
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    if (m < M) {
      const int c = lane + 32 * m;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        p[static_cast<size_t>(j0 + warp * 4 + jj) * D + c] = acc1[jj][m];
      *reinterpret_cast<float4*>(&p[hd + static_cast<size_t>(c) * Hd + j0 + warp * 4]) =
          make_float4(acc2[0][m], acc2[1][m], acc2[2][m], acc2[3][m]);
    }
  }
  red1[warp * kHC + lane] = db1;
  __syncthreads();
  if (tid < kHC) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsB; ++w) s += red1[w * kHC + tid];
    p[2 * hd + j0 + tid] = s;
  }
}

// out[col] = sum over p < parts of part[p * stride + col], in a fixed order:
// eight strided partial sums per column, then those eight in order.
__global__ void __launch_bounds__(kThreads)
    reduce_parts_kernel(const float* __restrict__ part, int64_t parts, size_t stride,
                        size_t width, float* __restrict__ out) {
  __shared__ float sm[kWarpsB][33];
  const int lane = threadIdx.x & 31, pl = threadIdx.x >> 5;
  const size_t col = static_cast<size_t>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (col < width)
    for (int64_t q = pl; q < parts; q += kWarpsB) s += part[q * stride + col];
  sm[pl][lane] = s;
  __syncthreads();
  if (pl == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarpsB; ++q) t += sm[q][lane];
    out[col] = t;
  }
}

size_t dx_smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kTR) * (D + 4) +
                          2 * static_cast<size_t>(D) * kWS + kHC * kTS +
                          static_cast<size_t>(kWarpsB) * D + 2 * kTR) +
         sizeof(uint32_t) * kWarpsB * 128;
}

size_t dw_smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kTR) * (D + 4) +
                          2 * static_cast<size_t>(D) * kWS + 2 * kTR * kTS +
                          kWarpsB * kHC + 2 * kTR) +
         sizeof(uint32_t) * kWarpsB * 128;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* dy, void* dx,
                       float* grads, float* part_dx, float* part_dw, int64_t R, int D,
                       int Hd, int slices, float eps, uint32_t thresh, float inv_keep,
                       uint32_t s0, uint32_t s1, int use_dropout, cudaStream_t stream) {
  const int64_t tiles = (R + kTR - 1) / kTR;
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const float* W1 = static_cast<const float*>(w1);
  const float* B1 = static_cast<const float*>(b1);
  const float* W2 = static_cast<const float*>(w2);

  size_t smem = dx_smem_bytes(D);
  cudaError_t err = allow_smem(fused_ffn_bwd_dx_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  fused_ffn_bwd_dx_kernel<T><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), lw, lb, W1, B1, W2, static_cast<const T*>(dy),
      static_cast<T*>(dx), part_dx, R, D, Hd, eps, thresh, inv_keep, s0, s1,
      use_dropout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = dw_smem_bytes(D);
  err = allow_smem(fused_ffn_bwd_dw_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  fused_ffn_bwd_dw_kernel<T><<<dim3(Hd / kHC, slices), kThreads, smem, stream>>>(
      static_cast<const T*>(x), lw, lb, W1, B1, W2, static_cast<const T*>(dy), part_dw,
      R, D, Hd, eps, thresh, inv_keep, s0, s1, use_dropout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // grads: dW1 [Hd][D] | dW2 [D][Hd] | db1 [Hd] | dln_w [D] | dln_b [D] | db2 [D]
  const size_t wide = 2 * static_cast<size_t>(Hd) * D + Hd;
  reduce_parts_kernel<<<static_cast<unsigned>((wide + 31) / 32), kThreads, 0, stream>>>(
      part_dw, slices, wide, wide, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t narrow = 3 * static_cast<size_t>(D);
  reduce_parts_kernel<<<static_cast<unsigned>((narrow + 31) / 32), kThreads, 0, stream>>>(
      part_dx, tiles, narrow, narrow, grads + wide);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the first launch that failed (0 on success).
// Needs D % 32 == 0, D <= 256, Hd % 32 == 0 and 1 <= slices <= 65535
// (checked by the Python wrapper). Scratch, all float32, from the caller:
// part_dx [ceil(R/32)][3*D] and part_dw [slices][2*Hd*D + Hd]; `grads` is
// the flat output described in launch_bwd.
int eavit_fused_ffn_bwd(const void* x, const void* ln_w, const void* ln_b,
                        const void* w1, const void* b1, const void* w2, const void* dy,
                        void* dx, void* grads, void* part_dx, void* part_dw,
                        long long R, int D, int Hd, int slices, int dtype, float eps,
                        uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                        int use_dropout, void* stream) {
  if (D % 32 != 0 || D > 32 * kMaxM || Hd % kHC != 0 || slices < 1 || slices > 65535 ||
      R < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grads);
  float* pdx = static_cast<float*>(part_dx);
  float* pdw = static_cast<float*>(part_dw);
  if (dtype == kBF16) {
    return launch_bwd<__nv_bfloat16>(x, ln_w, ln_b, w1, b1, w2, dy, dx, g, pdx, pdw, R,
                                     D, Hd, slices, eps, thresh, inv_keep, s0, s1,
                                     use_dropout, st);
  }
  if (dtype == kF32) {
    return launch_bwd<float>(x, ln_w, ln_b, w1, b1, w2, dy, dx, g, pdx, pdw, R, D, Hd,
                             slices, eps, thresh, inv_keep, s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
