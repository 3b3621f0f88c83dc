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
// What bounds it on an H100: operations. At the flagship act shape (R =
// 12,672 rows of D = 256, Hd = 1024) it does 13.3 GFLOP against ~28 MB of
// traffic when x is float32, which is what the JAX package feeds it (the
// residual stream stays float32 under ComputeDtype = bfloat16; only the Dense
// layers run in bf16).
//
// Both products run on the tensor cores (mma.sync m16n8k16, ffn_mma.cuh):
// bf16 x in one mma a product, float32 x as hi + lo bf16 planes in three. The
// fused kernel (D = 256, Hd % 32 == 0: every shipped config) keeps the
// Hd-wide intermediate out of device memory, as the TPU kernel does. A first
// launch writes every 32-unit hidden chunk's W1 and W2 planes and biases,
// laid out as they sit in shared memory (a "stage"), to a scratch the
// wrapper allocates. A block of 8 warps owns 64 rows: it writes their
// LayerNorm as u planes to shared memory, then walks the chunks: fc1 (each
// warp a 16 x 16 tile, each product term on its own accumulators), bias,
// GELU and mask1 on the accumulator fragments in registers (lane pairs share
// a Philox group), gd as planes in shared memory, then the chunk's share of
// fc2 into 64 x D f32 accumulators held in registers (each warp 32 rows x
// D/4 columns) for the whole walk. Only y is written.
//
// What the design does about the H100: every block reads the 2.4 MB of
// stages (float32) from L2, so a two-stage ring keeps the next chunk in
// flight, each stage one bulk copy (cp.async.bulk, counted in by an
// mbarrier) that one thread issues: per-thread cp.async cost the block a
// sixth of its time issuing copies. With one block of 8 warps an SM the
// phases of a chunk do not overlap across warps, so the chunks run in a
// software pipeline: the mmas of chunk i + 1's fc1 are issued before chunk
// i's GELU, which is branch-free for that (clock64 probes and the times are
// in PERF.md). Other widths take the split path of ffn_wide.cuh (wgmma
// products fed by TMA).
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ffn_common.cuh"
#include "ffn_mma.cuh"
#include "ffn_wide.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {

constexpr int kFRows = 64;    // rows of a block of the fused kernel
constexpr int kFStages = 2;   // weight chunks in flight
constexpr int kFD = 256;      // D of the fused kernel
static_assert(kFRows == 64 && kHC == 32 && kWarps == 8, "the warp layouts below assume these");

// One stage: the chunk's weight planes as they sit in shared memory, w1s
// [P][kHC][D+8] (W1[j0 + jj][:]) and w2s [P][D][kLH] (W2[:][j0 + jj]), pad
// columns zero, then its kHC biases b1 as float32. stage_planes_kernel writes
// every chunk's stage into a scratch, so that one bulk copy moves a stage.
__host__ __device__ constexpr size_t fwd_stage_bytes(int D, bool split) {
  return sizeof(bf16) * planes(split) * (kHC * (D + 8) + D * kLH) + sizeof(float) * kHC;
}

size_t fwd_smem_bytes(int D, bool split) {
  const size_t P = planes(split);
  return sizeof(bf16) * P * kFRows * (D + 8) + kFStages * fwd_stage_bytes(D, split) +
         sizeof(bf16) * P * kFRows * kLH + sizeof(uint64_t) * kFStages;
}

// The stages of every chunk, [Hd / kHC][fwd_stage_bytes], from the float32
// weights: hi (and lo) bf16 planes, rounded to bf16 when !SPLIT
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    stage_planes_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, char* __restrict__ out, int D, int Hd) {
  constexpr int P = planes(SPLIT);
  const int ldd = D + 8;
  const int w1n = kHC * ldd, w2n = D * kLH;  // elements of one plane of each
  const int64_t per = P * (w1n + w2n);       // bf16 elements of a stage
  const size_t bytes = fwd_stage_bytes(D, SPLIT);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t chunks = Hd / kHC;
  if (i < chunks * kHC) {  // the biases
    const int64_t c = i / kHC;
    reinterpret_cast<float*>(out + c * bytes + sizeof(bf16) * per)[i % kHC] = b1[i];
  }
  if (i >= chunks * per) return;
  const int64_t c = i / per;
  int e = static_cast<int>(i - c * per);
  float v = 0.f;
  bool lo = false;
  if (e < P * w1n) {  // W1 row j0 + jj, column k
    lo = e >= w1n;
    e -= lo ? w1n : 0;
    const int jj = e / ldd, k = e % ldd;
    if (k < D) v = w1[(c * kHC + jj) * D + k];
  } else {  // W2 row cc, column j0 + jj
    e -= P * w1n;
    lo = e >= w2n;
    e -= lo ? w2n : 0;
    const int cc = e / kLH, jj = e % kLH;
    if (jj < kHC) v = w2[static_cast<int64_t>(cc) * Hd + c * kHC + jj];
  }
  const bf16 h = __float2bfloat16_rn(v);
  reinterpret_cast<bf16*>(out + c * bytes)[i - c * per] =
      lo ? __float2bfloat16_rn(v - __bfloat162float(h)) : h;
}

// fc1 of a warp's 16 x 16 tile (rows fm of u, units fn of the chunk) over the
// depth D. A float32 product's three terms (hi hi, hi lo, lo hi) have their
// own accumulators, so that their mmas do not wait on one another; they are
// summed at the end in a fixed order.
template <bool SPLIT>
__device__ __forceinline__ void fc1_tile(float (&h)[2][4], const bf16* us, const bf16* w1s,
                                         int D, int fm, int fn, int lane) {
  constexpr int P = planes(SPLIT), TERMS = SPLIT ? 3 : 1;
  const int ldd = D + 8;
  float acc[TERMS][2][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[P][4], b[P][4];
#pragma unroll
    for (int pl = 0; pl < P; ++pl) {
      load_a_frag<false>(a[pl], us + pl * kFRows * ldd, ldd, fm, k0, lane);
      load_b_pair<false>(b[pl], w1s + pl * kHC * ldd, ldd, fn, k0, lane);
    }
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        mma_bf16(acc[t][hf], a[t == 2], b[t == 1][2 * hf], b[t == 1][2 * hf + 1]);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < TERMS; ++t) v += acc[t][hf][e];
      h[hf][e] = v;
    }
}

// DROPOUT: the rate is above 0
template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(kThreads, std::is_same_v<T, float> ? 1 : 2)
    fused_ffn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, const char* __restrict__ stages,
                         const float* __restrict__ b2, T* __restrict__ y, int64_t R, int Hd,
                         float eps, uint32_t thresh, float inv_keep, uint32_t s0,
                         uint32_t s1) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  constexpr int P = planes(SPLIT);
  constexpr int RW = kFRows / kWarps;  // LayerNorm rows of a warp
  constexpr int D = kFD, M = D / 32, ldd = D + 8;
  constexpr uint32_t stage = static_cast<uint32_t>(fwd_stage_bytes(D, SPLIT));
  extern __shared__ float4 smem4[];
  bf16* us = reinterpret_cast<bf16*>(smem4);  // [P][kFRows][ldd] u
  char* ring = reinterpret_cast<char*>(us + P * kFRows * ldd);  // [kFStages] stages
  bf16* gds = reinterpret_cast<bf16*>(ring + kFStages * stage);  // [P][kFRows][kLH] gd
  uint64_t* bars = reinterpret_cast<uint64_t*>(gds + P * kFRows * kLH);  // [kFStages]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kFRows;
  const int chunks = Hd / kHC;
  auto issue = [&](int i) {  // thread 0 alone
    bulk_load(ring + (i % kFStages) * stage, stages + static_cast<size_t>(i) * stage, stage,
              &bars[i % kFStages]);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kFStages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
#pragma unroll
    for (int s = 0; s < kFStages; ++s)
      if (s < chunks) issue(s);
  }

  // LayerNorm of the block's rows as u planes (rows past R are zero); warp w
  // takes rows 8w .. 8w+7, lane l columns l + 32 m, all their loads first
  float v[RW][M];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t r = r0 + warp * RW + i;
#pragma unroll
    for (int m = 0; m < M; ++m) v[i][m] = r < R ? to_f(x[r * D + lane + 32 * m]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int rr = warp * RW + i;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) s += v[i][m];
    const float mu = warp_sum(s) / D;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float c = v[i][m] - mu;
      ss += c * c;
    }
    const float rstd = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = lane + 32 * m;
      const float u = r0 + rr < R ? round_to<T>((v[i][m] - mu) * rstd * ln_w[c] + ln_b[c]) : 0.f;
      store1<SPLIT>(us + rr * ldd + c, static_cast<size_t>(kFRows) * ldd, u);
    }
  }
  __syncthreads();  // u and the mbarriers are ready

  // fc1: warp w the 16 x 16 tile at rows fm, units fn of the chunk. fc2: warp
  // w rows 32 (w & 1) .. +32 of y and the column pairs (16 columns each) cg,
  // cg + 4, cg + 8, cg + 12 with cg = w >> 1
  const int fm = 16 * (warp & 3), fn = 16 * (warp >> 2);
  const int rh = warp & 1, cg = warp >> 1;
  // fc2's column pairs a warp, D / 64 = 4, counted from cg: with the count a
  // constant the compiler unrolls fc2 and the epilogue whole, and the bf16
  // kernel spills at its 128 registers (two blocks an SM)
  const int pairs = (D / 16 - cg + 3) / 4;
  float yacc[2][8][4];
  zero(yacc);

  // The chunks in a software pipeline: the mmas of chunk i + 1's fc1 come
  // before chunk i's bias, GELU, mask1 and gd stores, which do not depend on
  // them, so that the warp issues both together. (The last fc1 reads a stage
  // that holds an earlier chunk, and its result is not used.)
  auto stage_w1 = [&](int i) {
    return reinterpret_cast<const bf16*>(ring + (i % kFStages) * stage);
  };
  float h[2][4];
  mbar_wait(&bars[0], 0);
  fc1_tile<SPLIT>(h, us, stage_w1(0), D, fm, fn, lane);
  for (int i = 0; i < chunks; ++i) {
    const bf16* w2s = stage_w1(i) + P * kHC * ldd;
    const float* b1s = reinterpret_cast<const float*>(w2s + P * D * kLH);
    const int j0 = i * kHC;
    if (i + 1 < chunks) mbar_wait(&bars[(i + 1) % kFStages], ((i + 1) / kFStages) & 1);
    float hn[2][4];
    fc1_tile<SPLIT>(hn, us, stage_w1(i + 1), D, fm, fn, lane);
    // gd = round_T(mask1(gelu(h + b1))) into the gd planes
    const int64_t ra = r0 + fm + g;  // the lane's rows ra and ra + 8
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int j = j0 + fn + 8 * n + 2 * t4;
      uint32_t keep = 0xfu;
      if constexpr (DROPOUT)
        keep = pair_keep(static_cast<uint64_t>(ra) * Hd + (j & ~3), Hd, t4, 0u, thresh, s0, s1);
      const float bj0 = b1s[j - j0], bj1 = b1s[j - j0 + 1];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float v0 = gelu<true>(h[n][2 * rr] + bj0), v1 = gelu<true>(h[n][2 * rr + 1] + bj1);
        if constexpr (DROPOUT) {
          v0 = (keep >> (2 * rr)) & 1u ? v0 * inv_keep : 0.f;
          v1 = (keep >> (2 * rr + 1)) & 1u ? v1 * inv_keep : 0.f;
        }
        store2<SPLIT>(gds + (fm + g + 8 * rr) * kLH + fn + 8 * n + 2 * t4,
                      static_cast<size_t>(kFRows) * kLH, round_to<T>(v0), round_to<T>(v1));
      }
    }
    __syncthreads();  // the chunk's gd is complete
    warp_gemm<2, 8, false, false, SPLIT>(yacc, gds, kLH, kFRows * kLH, 32 * rh, w2s, kLH,
                                         D * kLH, 16 * cg, 64, pairs, kHC, lane);
    __syncthreads();  // every warp is done with this stage and gd
    if (tid == 0 && i + kFStages < chunks) issue(i + kFStages);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[n][e] = hn[n][e];
  }

  // y = mask2(y0 + b2) in T
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int64_t ra = r0 + 32 * rh + 16 * m + g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= pairs) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 16 * (cg + 4 * q) + 8 * hf + 2 * t4;
        uint32_t keep = 0xfu;
        if constexpr (DROPOUT)
          keep = pair_keep(static_cast<uint64_t>(ra) * D + (c & ~3), D, t4, 1u, thresh, s0, s1);
        const float bc0 = b2[c], bc1 = b2[c + 1];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t r = ra + 8 * rr;
          float v0 = yacc[m][2 * q + hf][2 * rr] + bc0, v1 = yacc[m][2 * q + hf][2 * rr + 1] + bc1;
          if constexpr (DROPOUT) {
            v0 = (keep >> (2 * rr)) & 1u ? v0 * inv_keep : 0.f;
            v1 = (keep >> (2 * rr + 1)) & 1u ? v1 * inv_keep : 0.f;
          }
          if (r < R) {
            if constexpr (SPLIT) {
              *reinterpret_cast<float2*>(y + r * D + c) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(y + r * D + c) = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
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

template <typename T>
cudaError_t launch_fwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* y, char* stages,
                       int64_t R, int D, int Hd, float eps, uint32_t thresh, float inv_keep,
                       uint32_t s0, uint32_t s1, int use_dropout, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  const int64_t n = static_cast<int64_t>(Hd / kHC) * planes(SPLIT) * (kHC * (D + 8) + D * kLH);
  stage_planes_kernel<SPLIT><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
                               0, stream>>>(static_cast<const float*>(w1),
                                            static_cast<const float*>(b1),
                                            static_cast<const float*>(w2), stages, D, Hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = fwd_smem_bytes(D, SPLIT);
  const auto kernel =
      use_dropout ? fused_ffn_fwd_kernel<T, true> : fused_ffn_fwd_kernel<T, false>;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((R + kFRows - 1) / kFRows);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), stages, static_cast<const float*>(b2),
      static_cast<T*>(y), R, Hd, eps, thresh, inv_keep, s0, s1);
  return cudaGetLastError();
}

// The split path (ffn_wide.cuh) at any width: the weights as planes, u by
// the row kernel, then the two products with their epilogues
template <typename T>
cudaError_t launch_fwd_wide(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y,
                            bf16* wplanes, bf16* up, bf16* hp, int64_t R, int D, int Hd,
                            float eps, uint32_t thresh, float inv_keep, uint32_t s0,
                            uint32_t s1, int use_dropout, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  constexpr int P = planes(SPLIT);
  const int Dp = round_up(D, 32), Hdp = round_up(Hd, 32);
  bf16* w1p = wplanes;                                      // [P][Hdp][Dp]
  bf16* w2p = wplanes + P * static_cast<size_t>(Hdp) * Dp;  // [P][Dp][Hdp]
  cudaError_t err =
      split_planes<SPLIT>(static_cast<const float*>(w1), Hd, D, w1p, Hdp, Dp, stream);
  if (err != cudaSuccess) return err;
  if ((err = split_planes<SPLIT>(static_cast<const float*>(w2), D, Hd, w2p, Dp, Hdp, stream)) !=
      cudaSuccess)
    return err;
  wide_rows_kernel<T, false><<<row_tiles(R), kRowThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), nullptr, up, nullptr, nullptr, nullptr, R, D, Dp, Hdp,
      eps, thresh, inv_keep, s0, s1, use_dropout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int kH = gemm_min_blocks(P, kHiddenMinBlocks), kO = gemm_min_blocks(P, kOutMinBlocks);
  constexpr int kHN = gemm_cols(P, kHiddenCols), kON = gemm_cols(P, kOutCols);
  CUtensorMap mu, mw1, mg, mw2;  // boxes of 64 columns x the tile's rows
  if ((err = plane_map(&mu, up, R, Dp, P, kTM)) != cudaSuccess ||
      (err = plane_map(&mw1, w1p, Hdp, Dp, P, kHN)) != cudaSuccess ||
      (err = plane_map(&mg, hp, R, Hdp, P, kTM)) != cudaSuccess ||
      (err = plane_map(&mw2, w2p, Dp, Hdp, P, kON)) != cudaSuccess)
    return err;
  // gd = mask1(gelu(u W1^T + b1)) as planes [P][R][Hdp]
  const EpiHidden<T> hidden{static_cast<const float*>(b1), hp, R, Hd, Hdp, thresh, inv_keep,
                            s0, s1, use_dropout};
  if ((err = wg_gemm<P, kHN, kH, false, false, false>(
           mu, mw1, mu, mw1, GemmShape{{R, 0}, {Hdp, 0}, Dp, 0}, hidden, stream)) != cudaSuccess)
    return err;
  // y = mask2(gd W2^T + b2)
  const EpiOut<T> out{static_cast<const float*>(b2), static_cast<T*>(y), R, D, thresh,
                      inv_keep, s0, s1, use_dropout};
  return wg_gemm<P, kON, kO, false, false, false>(mg, mw2, mg, mw2,
                                                  GemmShape{{R, 0}, {Dp, 0}, Hdp, 0}, out, stream);
}

}  // namespace

extern "C" {

size_t eavit_fused_ffn_fwd_smem(int D, int dtype) { return fwd_smem_bytes(D, dtype == kF32); }

// Bytes of the fused kernel's weight scratch: every chunk's stage
size_t eavit_fused_ffn_fwd_stage_bytes(int D, int Hd, int dtype) {
  return static_cast<size_t>(Hd / kHC) * fwd_stage_bytes(D, dtype == kF32);
}

// The fused kernel. Returns the cudaError_t of the first launch that failed
// (0 on success). Needs D == 256, Hd % 32 == 0 and R >= 1
// (checked by the Python wrapper); wplanes: a scratch of
// eavit_fused_ffn_fwd_stage_bytes bytes on a 16-byte boundary.
int eavit_fused_ffn_fwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, void* wplanes,
                        long long R, int D, int Hd, int dtype, float eps, uint32_t thresh,
                        float inv_keep, uint32_t s0, uint32_t s1, int use_dropout,
                        void* stream) {
  if (D != kFD || Hd % kHC != 0 || R < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* wp = static_cast<char*>(wplanes);
  if (dtype == kBF16) {
    return launch_fwd<bf16>(x, ln_w, ln_b, w1, b1, w2, b2, y, wp, R, D, Hd, eps, thresh,
                            inv_keep, s0, s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return launch_fwd<float>(x, ln_w, ln_b, w1, b1, w2, b2, y, wp, R, D, Hd, eps, thresh,
                             inv_keep, s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

// The split path at any D and Hd, with Dp = round_up(D, 32), Hdp =
// round_up(Hd, 32) and scratch from the caller (16-byte aligned): wplanes
// bf16 [2][P][Hdp*Dp] (W1, W2), up bf16 [P][R][Dp] (u) and hp bf16
// [P][R][Hdp] (gd).
int eavit_fused_ffn_fwd_wide(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* y,
                             void* wplanes, void* up, void* hp, long long R, int D, int Hd,
                             int dtype, float eps, uint32_t thresh, float inv_keep, uint32_t s0,
                             uint32_t s1, int use_dropout, void* stream) {
  if (D < 1 || Hd < 1 || R < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* wp = static_cast<bf16*>(wplanes);
  bf16* u = static_cast<bf16*>(up);
  bf16* h = static_cast<bf16*>(hp);
  if (dtype == kBF16) {
    return launch_fwd_wide<bf16>(x, ln_w, ln_b, w1, b1, w2, b2, y, wp, u, h, R, D, Hd, eps,
                                 thresh, inv_keep, s0, s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return launch_fwd_wide<float>(x, ln_w, ln_b, w1, b1, w2, b2, y, wp, u, h, R, D, Hd, eps,
                                  thresh, inv_keep, s0, s1, use_dropout, st);
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
