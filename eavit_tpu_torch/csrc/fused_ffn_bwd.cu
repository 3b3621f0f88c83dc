// K2b fused_ffn_bwd: the backward of the fused pre-norm FFN, every product on
// Hopper's tensor cores.
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
// products the gradients need (fc1, dW2, dgd, dW1, du) are 133 GFLOP against
// 156 MB of traffic.
//
// Every product runs on mma.sync.m16n8k16 with bf16 operands and f32
// accumulators (mma_common.cuh). A bf16 x has every operand rounded to bf16
// already (round_T), so one mma per product computes it exactly, apart from
// the order of the sums. A float32 x (SPLIT) enters each operand as two bf16
// terms, hi = bf16(v) and lo = bf16(v - hi), and each product as three mmas,
// hi hi + hi lo + lo hi: the dropped lo lo term and the rounding of lo leave a
// relative error of about 2^-16 per product (no TF32, whose one term misses
// float32's 1e-4). Operands sit in shared memory as bf16 planes (hi, and lo
// when SPLIT) with rows padded by 16 bytes, read by ldmatrix.
//
// The TPU kernel sums the parameter gradients in place across grid cells that
// run one after the other. Blocks of a GPU grid run concurrently, so the work
// is decomposed twice, once for each kind of output, and nothing is summed
// with atomics (every sum has a fixed order: the result is deterministic):
//   split       the weights as bf16 planes in a scratch, once per call.
//   dx kernel   one block of 8 warps owns kXRows rows. It recomputes u and
//               dy0 as planes in shared memory, then walks the hidden units in
//               chunks of kHC: fc1 and dgd for the chunk (four warps each, 16
//               rows x kHC), gd and dh elementwise through shared memory, and
//               the chunk's share of du, which stays in registers: each warp
//               owns a 32-row x D/4-column slab of it. It ends with the
//               LayerNorm backward and writes dx plus one partial row each of
//               db1, dln_w, dln_b and db2. u, dy0, dh and gd go to scratches
//               as the planes the products read, for the dW kernel.
//   dW kernel   dW1 = dh^T u and dW2 = dy0^T gd from those planes: one block a
//               128 x 128 tile of one of them and one slice of the rows, which
//               it streams through a three-stage cp.async ring; one partial
//               per slice.
//   reduce      sums the partials (S slices; R / kXRows row blocks) in order.
// The five products are the JAX kernel's; in exchange, dh and gd pass through
// device memory (8 bytes per row and hidden unit in float32, 4 in bf16). The
// dx kernel reads the 2 MB of weight planes once per 64-row tile from L2 (1.6
// GB at R = 50,688, float32); clock64 probes on an H100 showed it waiting for
// each chunk's weights about a third of its time. See PERF.md for the times.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ffn_common.cuh"
#include "ffn_mma.cuh"
#include "ffn_wide.cuh"
#include "mma_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kXRows = 64;     // rows of a dx-kernel block
constexpr int kMaxD = 256;
constexpr int kHG = kHC + 4;   // row stride of the f32 fc1 / dgd exchange
constexpr int kEw = kXRows * kHC / 4 / kThreads;  // dx kernel: groups of 4 units a thread
constexpr int kGT = 128;       // rows and columns of a weight-gradient block tile
constexpr int kGK = 32;        // data rows (the depth) of one stage of it
constexpr int kGL = kGT + 8;   // its shared-memory row stride
constexpr int kGStages = 3;    // stages in flight
static_assert(kXRows == 64 && kHC == 32 && kGT == 128 && kGK % 16 == 0 && kWarps == 8 &&
                  kXRows * kHC / 4 % kThreads == 0,
              "the warp layouts below assume these tiles");

// Bytes of the dx kernel's region of the chunk's W2 planes, which the fc1 /
// dgd exchange and the dh planes reuse once the chunk's dgd is taken
__host__ __device__ constexpr size_t dx_w2_bytes(int D, bool split) {
  const size_t w2 = sizeof(bf16) * planes(split) * D * kLH;
  const size_t reuse =
      sizeof(float) * 2 * kXRows * kHG + sizeof(bf16) * planes(split) * kXRows * kLH;
  return w2 > reuse ? w2 : reuse;
}

// rows [0, rows) x cols bf16 (cols % 8 == 0) from src (row stride lds) to
// dst (row stride ldd) by cp.async
__device__ __forceinline__ void copy_rows(bf16* dst, int ldd, const bf16* src, int64_t lds,
                                          int rows, int cols) {
  const int chunks = cols / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks, k = (c % chunks) * 8;
    cp_async16(dst + r * ldd + k, src + r * lds + k);
  }
}

// The chunk j0 .. j0+kHC of the weight planes into shared memory:
// w1s [P][kHC][D+8] = W1[j0 + jj][:], w2s [P][D][kLH] = W2[:][j0 + jj].
// w1p [P][Hd][D] and w2p [P][D][Hd] are split_planes_kernel's planes.
template <bool SPLIT>
__device__ __forceinline__ void copy_chunk(bf16* w1s, bf16* w2s, const bf16* w1p,
                                           const bf16* w2p, int j0, int D, int Hd) {
  const int ldd = D + 8;
#pragma unroll
  for (int pl = 0; pl < planes(SPLIT); ++pl) {
    const size_t off = static_cast<size_t>(pl) * Hd * D;
    copy_rows(w1s + pl * kHC * ldd, ldd, w1p + off + static_cast<size_t>(j0) * D, D, kHC, D);
    copy_rows(w2s + pl * D * kLH, kLH, w2p + off + j0, Hd, D, kHC);
  }
}

// The dx kernel's fc1 (prod 0: u W1c^T) or dgd (prod 1: dy0 W2c) of rows m0
// .. m0+15 and the chunk's kHC units, K = D, written as f32 to hg
// [2][kXRows][kHG] once every warp is done with w2s, whose memory hg reuses
template <bool SPLIT>
__device__ __forceinline__ void chunk_product(float* hg, int prod, const bf16* us,
                                              const bf16* ds, const bf16* w1s, const bf16* w2s,
                                              int D, int m0, int lane) {
  constexpr int NT = kHC / 8;
  const int ldd = D + 8;
  float acc[1][NT][4];
  zero(acc);
  if (prod == 0) {
    warp_gemm<1, NT, false, false, SPLIT>(acc, us, ldd, kXRows * ldd, m0, w1s, ldd,
                                          kHC * ldd, 0, 16, NT / 2, D, lane);
  } else {
    warp_gemm<1, NT, false, true, SPLIT>(acc, ds, ldd, kXRows * ldd, m0, w2s, kLH, D * kLH, 0,
                                         16, NT / 2, D, lane);
  }
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
  float* out = hg + prod * kXRows * kHG;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (m0 + g + 8 * r) * kHG + 8 * n + 2 * t4) =
          make_float2(acc[0][n][2 * r], acc[0][n][2 * r + 1]);
}

// ---- the kernels ----

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, const bf16* __restrict__ w1p,
                            const float* __restrict__ b1, const bf16* __restrict__ w2p,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            bf16* __restrict__ rowp, bf16* __restrict__ hp,
                            float* __restrict__ part, int64_t R, int D, int Hd, float eps,
                            uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                            int use_dropout) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  constexpr int P = planes(SPLIT), XR = kXRows;
  extern __shared__ float4 smem4[];
  const int ldd = D + 8;
  bf16* us = reinterpret_cast<bf16*>(smem4);  // [P][XR][ldd] u
  bf16* ds = us + P * XR * ldd;               // [P][XR][ldd] dy0
  bf16* w1s = ds + P * XR * ldd;              // [P][kHC][ldd]
  bf16* w2s = w1s + P * kHC * ldd;            // [P][D][kLH]
  // after fc1 and dgd, the chunk's w2s is dead: hg and dhs take its place
  float* hg = reinterpret_cast<float*>(w2s);  // [2][XR][kHG]
  bf16* dhs = reinterpret_cast<bf16*>(hg + 2 * XR * kHG);  // [P][XR][kLH]
  // red [kWarps][D], after the region of w2s, hg and dhs
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(w2s) + dx_w2_bytes(D, SPLIT));
  float* mu_s = red + kWarps * D;                            // [XR]
  float* rstd_s = mu_s + XR;                                 // [XR]
  float* dbr = rstd_s + XR;  // [kEw * kWarps][kHC] the chunk's db1, by groups of 4 rows
  float* dus = reinterpret_cast<float*>(us);  // [XR][D + 4] du, after the chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * XR;
  const int groups = D / 4;  // <= 64: a lane's groups are lane and lane + 32
  // db1 [Hd] | dln_w [D] | dln_b [D] | db2 [D]
  float* my_part = part + static_cast<size_t>(blockIdx.x) * (Hd + 3 * D);
  const size_t plane = static_cast<size_t>(R) * D;  // elements of one row plane
  const size_t hplane = static_cast<size_t>(R) * Hd;  // of one hidden plane

  // ---- u and dy0 of the block's rows, as planes here and in the scratch
  // rowp [2][P][R][D] (u, then dy0); warp w takes rows 8w .. 8w+7 ----
  {
    float dsum[8];  // columns 4 (lane + 32 t) + k of the warp's rows
#pragma unroll
    for (int k = 0; k < 8; ++k) dsum[k] = 0.f;
    for (int i = 0; i < XR / kWarps; ++i) {
      const int rr = warp * (XR / kWarps) + i;
      const int64_t r = r0 + rr;
      float4 xv[2] = {};
      float s = 0.f, ss = 0.f, mu = 0.f, rstd = 0.f;
      if (r < R) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = 4 * (lane + 32 * t);
          if (c < D) {
            xv[t] = make_float4(to_f(x[r * D + c]), to_f(x[r * D + c + 1]),
                                to_f(x[r * D + c + 2]), to_f(x[r * D + c + 3]));
            s += (xv[t].x + xv[t].y) + (xv[t].z + xv[t].w);
          }
        }
        mu = warp_sum(s) / D;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (4 * (lane + 32 * t) < D) {
            const float a = xv[t].x - mu, b = xv[t].y - mu, c = xv[t].z - mu, d = xv[t].w - mu;
            ss += (a * a + b * b) + (c * c + d * d);
          }
        }
        rstd = rsqrtf(warp_sum(ss) / D + eps);
      }
      if (lane == 0) {
        mu_s[rr] = mu;
        rstd_s[rr] = rstd;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int gi = lane + 32 * t, c = 4 * gi;
        if (gi >= groups) continue;
        float4 u = {}, d = {};
        if (r < R) {
          u = make_float4(
              round_to<T>((xv[t].x - mu) * rstd * ln_w[c] + ln_b[c]),
              round_to<T>((xv[t].y - mu) * rstd * ln_w[c + 1] + ln_b[c + 1]),
              round_to<T>((xv[t].z - mu) * rstd * ln_w[c + 2] + ln_b[c + 2]),
              round_to<T>((xv[t].w - mu) * rstd * ln_w[c + 3] + ln_b[c + 3]));
          Philox4 p = {};
          if (use_dropout) p = philox_group((static_cast<uint64_t>(r) * D + c) >> 2, 1u, s0, s1);
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[k] = to_f(dy[r * D + c + k]);
            if (use_dropout) v[k] = (p.w[k] >> 8) < thresh ? v[k] * inv_keep : 0.f;
            dsum[4 * t + k] += v[k];
          }
          d = make_float4(round_to<T>(v[0]), round_to<T>(v[1]), round_to<T>(v[2]),
                          round_to<T>(v[3]));
          store4<SPLIT>(rowp + r * D + c, plane, u);
          store4<SPLIT>(rowp + P * plane + r * D + c, plane, d);
        }
        store4<SPLIT>(us + rr * ldd + c, static_cast<size_t>(XR) * ldd, u);
        store4<SPLIT>(ds + rr * ldd + c, static_cast<size_t>(XR) * ldd, d);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int gi = lane + 32 * t;
      if (gi < groups) {
#pragma unroll
        for (int k = 0; k < 4; ++k) red[warp * D + 4 * gi + k] = dsum[4 * t + k];
      }
    }
  }
  __syncthreads();
  if (tid < D) {  // db2: the warps' column sums in order
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * D + tid];
    my_part[Hd + 2 * D + tid] = s;
  }

  // du: warp w owns rows 32 (w & 1) .. +32 and the column pairs (16 columns
  // each) cg, cg + 4, cg + 8, cg + 12 with cg = w >> 1
  const int rh = warp & 1, cg = warp >> 1;
  const int du_pairs = (D / 16 - cg + 3) / 4;  // live pairs of this warp
  float du[2][8][4];
  zero(du);

  for (int j0 = 0; j0 < Hd; j0 += kHC) {
    __syncthreads();  // the previous chunk is done with w1s, hg and dhs
    copy_chunk<SPLIT>(w1s, w2s, w1p, w2p, j0, D, Hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // fc1 (warps 0-3) and dgd (warps 4-7), 16 rows x kHC each
    chunk_product<SPLIT>(hg, warp >> 2, us, ds, w1s, w2s, D, 16 * (warp & 3), lane);
    __syncthreads();
    // dh = gelu'(h) * (m1 ? dgd * inv_keep : 0) and gd = m1 ? gelu(h) *
    // inv_keep : 0, four hidden units a thread per pass: dh into dhs, both
    // into the scratch for the dW kernel, dh's column sums into dbr
#pragma unroll
    for (int it = 0; it < kEw; ++it) {
      const int rr = (tid + it * kThreads) / (kHC / 4), jj = 4 * (tid % (kHC / 4));
      const int64_t r = r0 + rr;
      float dh[4] = {0.f, 0.f, 0.f, 0.f}, gd[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < R) {
        Philox4 p = {};
        if (use_dropout)  // mask1: element r Hd + j, stream 0
          p = philox_group((static_cast<uint64_t>(r) * Hd + j0 + jj) >> 2, 0u, s0, s1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float hh = hg[rr * kHG + jj + k] + b1[j0 + jj + k];
          float g = gelu(hh), dg = hg[XR * kHG + rr * kHG + jj + k];
          if (use_dropout) {
            const bool keep = (p.w[k] >> 8) < thresh;
            g = keep ? g * inv_keep : 0.f;
            dg = keep ? dg * inv_keep : 0.f;
          }
          dh[k] = gelu_grad(hh) * dg;
          gd[k] = round_to<T>(g);
        }
        const float4 hv = make_float4(round_to<T>(dh[0]), round_to<T>(dh[1]),
                                      round_to<T>(dh[2]), round_to<T>(dh[3]));
        store4<SPLIT>(hp + r * Hd + j0 + jj, hplane, hv);
        store4<SPLIT>(hp + P * hplane + r * Hd + j0 + jj, hplane,
                      make_float4(gd[0], gd[1], gd[2], gd[3]));
        store4<SPLIT>(dhs + rr * kLH + jj, static_cast<size_t>(XR) * kLH, hv);
      } else {
        store4<SPLIT>(dhs + rr * kLH + jj, static_cast<size_t>(XR) * kLH, float4{});
      }
      // the warp's four rows (lanes l, l ^ 8, l ^ 16, l ^ 24), in a fixed order
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dh[k] += __shfl_xor_sync(0xffffffffu, dh[k], 8);
        dh[k] += __shfl_xor_sync(0xffffffffu, dh[k], 16);
        if (lane < kHC / 4) dbr[(it * kWarps + warp) * kHC + jj + k] = dh[k];
      }
    }
    __syncthreads();
    if (warp == 0) {  // db1 of the chunk: the groups of rows in order
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kEw * kWarps; ++q) sum += dbr[q * kHC + lane];
      my_part[j0 + lane] = sum;
    }
    // du += dh W1c
    warp_gemm<2, 8, false, true, SPLIT>(du, dhs, kLH, XR * kLH, 32 * rh, w1s, ldd, kHC * ldd,
                                        16 * cg, 64, du_pairs, kHC, lane);
  }

  // du to shared memory (over u and dy0, which no warp reads any more)
  __syncthreads();
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= du_pairs) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(
                dus + (32 * rh + 16 * m + g + 8 * r) * (D + 4) + 16 * (cg + 4 * q) + 8 * hf +
                2 * t4) = make_float2(du[m][2 * q + hf][2 * r], du[m][2 * q + hf][2 * r + 1]);
      }
  }
  __syncthreads();

  // LayerNorm backward for the warp's rows 8w .. 8w+7; partial sums of
  // dln_w and dln_b (columns lane + 32 m)
  const int M = D / 32;
  float gw[kMaxD / 32], gb[kMaxD / 32];
#pragma unroll
  for (int m = 0; m < kMaxD / 32; ++m) gw[m] = gb[m] = 0.f;
  for (int i = 0; i < XR / kWarps; ++i) {
    const int rr = warp * (XR / kWarps) + i;
    const int64_t r = r0 + rr;
    const float mu = mu_s[rr], rstd = rstd_s[rr];
    float t[kMaxD / 32], xh[kMaxD / 32];
    float st = 0.f, stx = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxD / 32; ++m) {
      t[m] = xh[m] = 0.f;
      if (m < M) {
        const int c = lane + 32 * m;
        const float g = dus[rr * (D + 4) + c];
        xh[m] = r < R ? (to_f(x[r * D + c]) - mu) * rstd : 0.f;
        t[m] = g * ln_w[c];
        st += t[m];
        stx = fmaf(t[m], xh[m], stx);
        gw[m] = fmaf(g, xh[m], gw[m]);
        gb[m] += g;
      }
    }
    const float mt = warp_sum(st) / D, mtx = warp_sum(stx) / D;
    if (r < R) {
#pragma unroll
      for (int m = 0; m < kMaxD / 32; ++m) {
        if (m < M) dx[r * D + lane + 32 * m] = from_f<T>((t[m] - mt - xh[m] * mtx) * rstd);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxD / 32; ++m)
    if (m < M) red[warp * D + lane + 32 * m] = gw[m];
  __syncthreads();
  if (tid < D) {  // dln_w
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * D + tid];
    my_part[Hd + tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMaxD / 32; ++m)
    if (m < M) red[warp * D + lane + 32 * m] = gb[m];
  __syncthreads();
  if (tid < D) {  // dln_b
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * D + tid];
    my_part[Hd + D + tid] = s;
  }
}

// dW1 = dh^T u [Hd][D] and dW2 = dy0^T gd [D][Hd], C = A^T B over the rows
// of one slice, A [R][M] and B [R][N] bf16 planes from the scratches: one
// kGT x kGT tile of C a block, 8 warps of 32 x 64, the rows streamed in
// stages of kGK through a cp.async ring. grid.x: the tiles of dW1, then of
// dW2; grid.y: the slice. Writes the slice's partial [2][Hd * D].
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2)
    fused_ffn_bwd_dw_kernel(const bf16* __restrict__ rowp, const bf16* __restrict__ hp,
                            float* __restrict__ part, int64_t R, int D, int Hd) {
  constexpr int P = planes(SPLIT);
  extern __shared__ float4 smem4[];
  bf16* as = reinterpret_cast<bf16*>(smem4);  // [kGStages][P][kGK][kGL]
  bf16* bs = as + kGStages * P * kGK * kGL;   // [kGStages][P][kGK][kGL]
  constexpr int stage = P * kGK * kGL;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int th = (Hd + kGT - 1) / kGT, td = (D + kGT - 1) / kGT;
  const bool second = blockIdx.x >= th * td;  // dW2
  const int t = second ? blockIdx.x - th * td : blockIdx.x;
  const int M = second ? D : Hd, N = second ? Hd : D;
  const int m0 = t / (second ? th : td) * kGT, n0 = t % (second ? th : td) * kGT;
  const size_t hplane = static_cast<size_t>(R) * Hd, rplane = static_cast<size_t>(R) * D;
  const bf16* A = second ? rowp + P * rplane : hp;  // dy0 or dh planes, [R][M]
  const bf16* B = second ? hp + P * hplane : rowp;  // gd or u planes, [R][N]
  const size_t a_plane = second ? rplane : hplane, b_plane = second ? hplane : rplane;
  const int m_live = min(kGT, M - m0), n_live = min(kGT, N - n0);

  const int steps = static_cast<int>((R + kGK - 1) / kGK);
  const int s_beg = static_cast<int>(static_cast<int64_t>(steps) * blockIdx.y / gridDim.y);
  const int n_steps =
      static_cast<int>(static_cast<int64_t>(steps) * (blockIdx.y + 1) / gridDim.y) - s_beg;
  // the rows of step s_beg + i into stage i % kGStages (zero past R and past
  // the tile's live columns); thread tid copies the 16-byte pieces tid and
  // tid + kThreads of each plane's kGK x kGT block
  static_assert(kGK * kGT / 8 == 2 * kThreads, "two pieces a thread");
  auto issue = [&](int i) {
    const int64_t r0 = static_cast<int64_t>(s_beg + i) * kGK;
    const int live = static_cast<int>(R - r0 < kGK ? R - r0 : kGK);
    const int st = i % kGStages * stage;
    const bf16* ga = A + r0 * M + m0;
    const bf16* gb = B + r0 * N + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tid + h * kThreads, r = c / (kGT / 8), k = c % (kGT / 8) * 8;
#pragma unroll
      for (int pl = 0; pl < P; ++pl) {
        bf16* sa = as + st + pl * kGK * kGL + r * kGL + k;
        bf16* sb = bs + st + pl * kGK * kGL + r * kGL + k;
        if (r < live && k < m_live) {
          cp_async16(sa, ga + pl * a_plane + r * M + k);
        } else {
          *reinterpret_cast<uint4*>(sa) = make_uint4(0u, 0u, 0u, 0u);
        }
        if (r < live && k < n_live) {
          cp_async16(sb, gb + pl * b_plane + r * N + k);
        } else {
          *reinterpret_cast<uint4*>(sb) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kGStages - 1; ++i) {
    if (i < n_steps) issue(i);
    cp_async_commit();
  }

  const int wm = warp & 3, wn = warp >> 2;  // rows 32 wm, columns 64 wn of the tile
  const int pairs = max(0, min(4, (n_live - 64 * wn) / 16));
  float acc[2][8][4];
  zero(acc);
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // step i is in; every warp is done with step i - 1's stage
    if (i + kGStages - 1 < n_steps) issue(i + kGStages - 1);
    cp_async_commit();
    const int st = i % kGStages * stage;
    warp_gemm<2, 8, true, true, SPLIT>(acc, as + st, kGL, kGK * kGL, 32 * wm, bs + st, kGL,
                                       kGK * kGL, 64 * wn, 16, pairs, kGK, lane);
  }
  cp_async_wait<0>();

  float* out = part + static_cast<size_t>(blockIdx.y) * 2 * Hd * D +
               (second ? static_cast<size_t>(Hd) * D : 0);
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
          *reinterpret_cast<float2*>(out + static_cast<size_t>(m0 + row) * N + n0 + 64 * wn +
                                     16 * q + 8 * hf + 2 * t4) =
              make_float2(acc[m][2 * q + hf][2 * r], acc[m][2 * q + hf][2 * r + 1]);
        }
    }
}

size_t dx_smem_bytes(int D, bool split) {
  const size_t P = planes(split), ldd = D + 8;
  return sizeof(bf16) * (2 * P * kXRows * ldd + P * kHC * ldd) + dx_w2_bytes(D, split) +
         sizeof(float) * (static_cast<size_t>(kWarps) * D + 2 * kXRows + kEw * kWarps * kHC);
}

size_t dw_smem_bytes(bool split) {
  return sizeof(bf16) * 2 * kGStages * planes(split) * kGK * kGL;
}

// dW1 and dW2 from the planes (per-slice partials), then every gradient
// summed from its partials in order into grads: dW1 [Hd][D] | dW2 [D][Hd] |
// db1 [Hd] | dln_w [D] | dln_b [D] | db2 [D]
template <bool SPLIT>
cudaError_t weight_grads(const bf16* rowp, const bf16* hp, float* part_dx, int64_t tiles,
                         float* part_dw, int slices, float* grads, int64_t R, int D, int Hd,
                         cudaStream_t stream) {
  const size_t smem = dw_smem_bytes(SPLIT);
  cudaError_t err = allow_smem(fused_ffn_bwd_dw_kernel<SPLIT>, smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles_w = 2 * ((Hd + kGT - 1) / kGT) * ((D + kGT - 1) / kGT);
  fused_ffn_bwd_dw_kernel<SPLIT><<<dim3(tiles_w, slices), kThreads, smem, stream>>>(
      rowp, hp, part_dw, R, D, Hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t wide = 2 * static_cast<size_t>(Hd) * D;
  if ((err = reduce_parts(part_dw, slices, wide, grads, stream)) != cudaSuccess) return err;
  return reduce_parts(part_dx, tiles, Hd + 3 * static_cast<size_t>(D), grads + wide, stream);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* dy, void* dx,
                       float* grads, float* part_dx, float* part_dw, bf16* wplanes,
                       bf16* rowp, bf16* hp, int64_t R, int D, int Hd, int slices, float eps,
                       uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                       int use_dropout, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  const int64_t tiles = (R + kXRows - 1) / kXRows;
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const float* B1 = static_cast<const float*>(b1);
  bf16* w1p = wplanes;                                                 // [P][Hd][D]
  bf16* w2p = wplanes + planes(SPLIT) * static_cast<size_t>(Hd) * D;  // [P][D][Hd]

  cudaError_t err = split_planes<SPLIT>(static_cast<const float*>(w1), Hd, D, w1p, Hd, D, stream);
  if (err != cudaSuccess) return err;
  if ((err = split_planes<SPLIT>(static_cast<const float*>(w2), D, Hd, w2p, D, Hd, stream)) !=
      cudaSuccess)
    return err;

  const size_t smem = dx_smem_bytes(D, SPLIT);
  if ((err = allow_smem(fused_ffn_bwd_dx_kernel<T>, smem)) != cudaSuccess) return err;
  fused_ffn_bwd_dx_kernel<T><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), lw, lb, w1p, B1, w2p, static_cast<const T*>(dy),
      static_cast<T*>(dx), rowp, hp, part_dx, R, D, Hd, eps, thresh, inv_keep, s0, s1,
      use_dropout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return weight_grads<SPLIT>(rowp, hp, part_dx, tiles, part_dw, slices, grads, R, D, Hd, stream);
}

// The split path (ffn_wide.cuh) at any width, on planes padded to Dp =
// round_up(D, 32) and Hdp = round_up(Hd, 32): wplanes [3][P][Hdp*Dp] (W1
// [Hdp][Dp], W2^T [Hdp][Dp], W1^T [Dp][Hdp]), du float32 [R][Dp], stats
// float32 [2][R] (mu, rstd), grads at the padded widths
template <typename T>
cudaError_t launch_bwd_wide(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* dy, void* dx,
                            float* grads, float* part_dx, bf16* wplanes, bf16* rowp, bf16* hp,
                            float* du, float* stats, int64_t R, int D, int Hd, float eps,
                            uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                            int use_dropout, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  constexpr int P = planes(SPLIT);
  const int Dp = round_up(D, 32), Hdp = round_up(Hd, 32);
  const size_t rdp = static_cast<size_t>(R) * Dp, rhp = static_cast<size_t>(R) * Hdp;
  const size_t wsz = static_cast<size_t>(Hdp) * Dp;
  const float* W1 = static_cast<const float*>(w1);
  bf16* w1p = wplanes;             // [P][Hdp][Dp]
  bf16* w2t = wplanes + P * wsz;   // [P][Hdp][Dp]
  bf16* w1t = w2t + P * wsz;       // [P][Dp][Hdp]
  bf16* up = rowp;                 // u [P][R][Dp]
  bf16* dp = rowp + P * rdp;       // dy0
  bf16* dhp = hp;                  // dh [P][R][Hdp]
  bf16* gdp = hp + P * rhp;        // gd
  cudaError_t err = split_planes<SPLIT>(W1, Hd, D, w1p, Hdp, Dp, stream);
  if (err != cudaSuccess) return err;
  if ((err = split_planes_t<SPLIT>(static_cast<const float*>(w2), D, Hd, w2t, Dp, Hdp,
                                   stream)) != cudaSuccess ||
      (err = split_planes_t<SPLIT>(W1, Hd, D, w1t, Hdp, Dp, stream)) != cudaSuccess)
    return err;
  wide_rows_kernel<T, true><<<row_tiles(R), kRowThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const T*>(dy), up, dp, stats, part_dx, R, D,
      Dp, Hdp, eps, thresh, inv_keep, s0, s1, use_dropout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // K-major reads (boxes of the tile's rows) by the row products, MN-major
  // ones (64 rows of depth) by the weight gradients
  constexpr int kDual = gemm_min_blocks(P, kDualMinBlocks), kDualCols = gemm_dual_cols(kDual);
  constexpr int kDU = gemm_min_blocks(P, kDuMinBlocks), kDW = gemm_min_blocks(P, kDwMinBlocks);
  constexpr int kDUN = gemm_cols(P, kDuCols), kDWN = gemm_cols(P, kDwCols);
  CUtensorMap mu, mdy, mw1, mw2t, mdh, mw1t, mdh_k, mu_k, mdy_k, mgd_k;
  if ((err = plane_map(&mu, up, R, Dp, P, kTM)) != cudaSuccess ||
      (err = plane_map(&mdy, dp, R, Dp, P, kTM)) != cudaSuccess ||
      (err = plane_map(&mw1, w1p, Hdp, Dp, P, kDualCols)) != cudaSuccess ||
      (err = plane_map(&mw2t, w2t, Hdp, Dp, P, kDualCols)) != cudaSuccess ||
      (err = plane_map(&mdh, dhp, R, Hdp, P, kTM)) != cudaSuccess ||
      (err = plane_map(&mw1t, w1t, Dp, Hdp, P, kDUN)) != cudaSuccess ||
      (err = plane_map(&mdh_k, dhp, R, Hdp, P, kTK)) != cudaSuccess ||
      (err = plane_map(&mu_k, up, R, Dp, P, kTK)) != cudaSuccess ||
      (err = plane_map(&mdy_k, dp, R, Dp, P, kTK)) != cudaSuccess ||
      (err = plane_map(&mgd_k, gdp, R, Hdp, P, kTK)) != cudaSuccess)
    return err;
  // H = u W1^T and G = dy0 W2 per tile -> dh, gd planes and db1 partials
  const EpiDh<T> hid{static_cast<const float*>(b1), dhp, gdp, part_dx, R, Hd, Hdp, Dp,
                     thresh, inv_keep, s0, s1, use_dropout};
  if ((err = wg_gemm<P, kDualCols, kDual, false, false, true>(
           mu, mw1, mdy, mw2t, GemmShape{{R, 0}, {Hdp, 0}, Dp, 0}, hid, stream)) != cudaSuccess)
    return err;
  // DU = dh W1 [R][Dp], then dx and the dln_w, dln_b partials
  if ((err = wg_gemm<P, kDUN, kDU, false, false, false>(mdh, mw1t, mdh, mw1t,
                                                      GemmShape{{R, 0}, {Dp, 0}, Hdp, 0},
                                                      EpiF32{du, du, R, R, Dp, Dp}, stream)) !=
      cudaSuccess)
    return err;
  wide_ln_bwd_kernel<T><<<row_tiles(R), kRowThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w), stats, du,
      static_cast<T*>(dx), part_dx, R, D, Dp, Hdp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dW1 = dh^T u [Hdp][Dp] and dW2 = dy0^T gd [Dp][Hdp] into grads: one block
  // a 128 x 128 tile of either, over every row
  float* dw2 = grads + wsz;
  if ((err = wg_gemm<P, kDWN, kDW, true, true, false>(
           mdh_k, mu_k, mdy_k, mgd_k, GemmShape{{Hdp, Dp}, {Dp, Hdp}, static_cast<int>(R), 0},
           EpiF32{grads, dw2, Hdp, Dp, Dp, Hdp}, stream)) != cudaSuccess)
    return err;
  // db1, dln_w, dln_b, db2 from the row tiles' partials, in order
  return reduce_parts(part_dx, row_tiles(R), Hdp + 3 * static_cast<size_t>(Dp), grads + 2 * wsz,
                      stream);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the first launch that failed (0 on success).
// Needs D % 32 == 0, D <= 256, Hd % 32 == 0 and 1 <= slices <= 65535
// (checked by the Python wrapper); every pointer on a 16-byte boundary.
// Scratch from the caller: part_dx float32 [ceil(R / 64)][Hd + 3*D], part_dw
// float32 [slices][2*Hd*D], and bf16 planes (P = 2 for float32 x, hi and lo;
// 1 for bf16): wplanes [2][P][Hd*D] (W1, then W2), rowp [2][P][R][D] (u,
// then dy0) and hplanes [2][P][R][Hd] (dh, then gd). `grads` is the flat
// output described in launch_bwd.
int eavit_fused_ffn_bwd(const void* x, const void* ln_w, const void* ln_b,
                        const void* w1, const void* b1, const void* w2, const void* dy,
                        void* dx, void* grads, void* part_dx, void* part_dw, void* wplanes,
                        void* rowp, void* hplanes, long long R, int D, int Hd, int slices,
                        int dtype, float eps, uint32_t thresh, float inv_keep, uint32_t s0,
                        uint32_t s1, int use_dropout, void* stream) {
  if (D % 32 != 0 || D > kMaxD || Hd % kHC != 0 || slices < 1 || slices > 65535 || R < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grads);
  float* pdx = static_cast<float*>(part_dx);
  float* pdw = static_cast<float*>(part_dw);
  bf16* wp = static_cast<bf16*>(wplanes);
  bf16* rp = static_cast<bf16*>(rowp);
  bf16* hp = static_cast<bf16*>(hplanes);
  if (dtype == kBF16) {
    return launch_bwd<bf16>(x, ln_w, ln_b, w1, b1, w2, dy, dx, g, pdx, pdw, wp, rp, hp, R, D,
                            Hd, slices, eps, thresh, inv_keep, s0, s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return launch_bwd<float>(x, ln_w, ln_b, w1, b1, w2, dy, dx, g, pdx, pdw, wp, rp, hp, R,
                             D, Hd, slices, eps, thresh, inv_keep, s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

// The split path at any D and Hd (ffn_wide.cuh), with Dp = round_up(D, 32)
// and Hdp = round_up(Hd, 32): part_dx float32 [ceil(R / 64)][Hdp + 3*Dp],
// wplanes bf16 [3][P][Hdp*Dp], rowp [2][P][R][Dp], hplanes [2][P][R][Hdp],
// du float32 [R][Dp] and stats float32 [2][R]; grads at the padded widths,
// dW1 [Hdp][Dp] | dW2 [Dp][Hdp] | db1 [Hdp] | dln_w [Dp] | dln_b [Dp] | db2 [Dp].
int eavit_fused_ffn_bwd_wide(const void* x, const void* ln_w, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* dy,
                             void* dx, void* grads, void* part_dx, void* wplanes, void* rowp,
                             void* hplanes, void* du, void* stats, long long R, int D, int Hd,
                             int dtype, float eps, uint32_t thresh, float inv_keep, uint32_t s0,
                             uint32_t s1, int use_dropout, void* stream) {
  if (D < 1 || Hd < 1 || R < 1 || R > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grads);
  float* pdx = static_cast<float*>(part_dx);
  bf16* wp = static_cast<bf16*>(wplanes);
  bf16* rp = static_cast<bf16*>(rowp);
  bf16* hp = static_cast<bf16*>(hplanes);
  float* u = static_cast<float*>(du);
  float* sb = static_cast<float*>(stats);
  if (dtype == kBF16) {
    return launch_bwd_wide<bf16>(x, ln_w, ln_b, w1, b1, w2, dy, dx, g, pdx, wp, rp, hp, u, sb,
                                 R, D, Hd, eps, thresh, inv_keep, s0, s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return launch_bwd_wide<float>(x, ln_w, ln_b, w1, b1, w2, dy, dx, g, pdx, wp, rp, hp, u, sb,
                                  R, D, Hd, eps, thresh, inv_keep, s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
