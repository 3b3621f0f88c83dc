// The fused FFN at the widths its fused kernels do not take: D not a multiple
// of 32 or above 256 (K2f: D != 256), or Hd not a multiple of 32, at any D and
// Hd, as the JAX kernel takes any width (eavit_tpu/ops/fused_ffn.py:287-301).
// The HF-flavour ViT runs here: D = 1,024, Hd = 3,072 (config.ViTHGConfig).
// It replaces the same TPU kernels as fused_ffn.cu and fused_ffn_bwd.cu do:
// `_fwd_kernel` (fused_ffn.py:160, launched at :288) and `_bwd_kernel` (:180,
// launched at :321).
//
// What bounds it on an H100: operations. At the HG minibatch (R = 13,056 rows,
// bf16) the forward's two products are 164 GFLOP, 0.166 ms on the bf16 tensor
// cores, against 0.02 ms of traffic; the backward's five 0.415 ms.
//
// The fused kernels hold a tile of rows at the full width D in shared memory
// beside a chunk of both weight matrices; above D = 256 that does not fit one
// block. So here the work is split at the products: row kernels on the CUDA
// cores (LayerNorm, the LayerNorm backward) and products on Hopper's
// warpgroup tensor cores, whose epilogues do the elementwise work in
// registers:
//   forward   u = LN(x) (wide_rows_kernel)
//             gd = mask1(gelu(u W1^T + b1))       product 1, EpiHidden
//             y = mask2(gd W2^T + b2)             product 2, EpiOut
//   backward  u, dy0 = LN(x), mask2(dy), db2 partials (wide_rows_kernel)
//             H = u W1^T and G = dy0 W2 on the same tile, two accumulators:
//             dh = gelu'(H + b1) mask1(G), gd, db1 partials (EpiDh)
//             DU = dh W1 (EpiF32) -> dx, dln_w, dln_b (wide_ln_bwd_kernel)
//             dW1 = dh^T u and dW2 = dy0^T gd in one launch, one block per
//             128 x 128 output tile walking every row (EpiF32)
// so no float32 H, G or Y reaches device memory; gd and dh do, as bf16
// planes, since the next product reads them whole. DU stays float32 [R][Dp]:
// the LayerNorm backward needs whole-row sums of it.
//
// The product (wg_gemm_kernel) is one template: C = A B^T over depth K on a
// tile of 128 rows and 64, 128 or 256 columns of C, bf16 operand planes
// padded to Dp = round_up(D, 32) and Hdp = round_up(Hd, 32) with zeros (so the
// padded sums are exact). One producer thread issues TMA copies of 64-deep
// stages of both operands into a ring of shared memory (128-byte swizzle),
// counted in by an mbarrier per stage; two consumer warpgroups, 64 rows each,
// issue wgmma.m64nNk16 on each stage as it lands and give it back through a
// second mbarrier. The epilogue stages each warpgroup's tile in the finished
// ring and copies it out along rows; where it computes, two blocks share an
// SM so that one's epilogue runs beside the other's products. A float32
// activation enters as hi + lo bf16 planes (P = 2) and each product as three
// wgmmas into one accumulator, hi hi + hi lo + lo hi (about 2^-16 relative a
// product; ffn_mma.cuh); bf16 as one plane. Either operand may be MN-major
// (its depth along the rows of the plane), so the weight gradients read the
// [R][.] planes as they are. Edges: TMA reads past a plane as zeros; the
// epilogues write only rows < R and columns < the width. LayerNorm runs over
// the true D and the masks draw at the logical indices (mask1 e = r*Hd + j on
// stream 0, mask2 e = r*D + c on stream 1), so every width and tiling gives
// the plain version's function and masks. Each output has one owner and each
// sum a fixed order, with no atomics: two calls give equal bits.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ffn_common.cuh"
#include "ffn_mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int kWRows = 64;        // rows of a block of the row kernels
constexpr int kRowThreads = 512;  // threads of one: 16 warps of 4 rows, so that enough
constexpr int kRowWarps = kRowThreads / 32;  // loads are in flight to cover their latency
constexpr int kWCols = 256;       // columns of a slice of the LayerNorm kernels' column sums
constexpr int kTM = 128;     // rows of a product's block tile: two consumer warpgroups
constexpr int kTK = 64;      // depth of a stage: one 128-byte swizzled row of bf16
constexpr int kTile = kTM * kTK * 2;  // bytes of one plane of A in a stage
constexpr int kGemmThreads = 288;     // two consumer warpgroups, then the producer warp

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A product's stages in its ring: as many as fit its share of shared memory
// (MINB blocks an SM), at most 8. A stage holds P planes of A (kTM x kTK) and
// of B (BN x kTK).
__host__ __device__ constexpr int gemm_stage_bytes(int P, int BN) {
  return P * (kTile + BN * kTK * 2);
}
__host__ __device__ constexpr int gemm_stages(int P, int BN, int MINB) {
  const int fit = ((MINB == 2 ? 110 : 220) * 1024 - 8192) / gemm_stage_bytes(P, BN);
  return fit < 8 ? fit : 8;
}
// the ring, its full and empty mbarriers, the epilogue's column sums, and
// room to align the ring to 1,024 bytes (the swizzle's period)
__host__ __device__ constexpr size_t gemm_smem(int P, int BN, int MINB) {
  return 1024 + static_cast<size_t>(gemm_stages(P, BN, MINB)) * gemm_stage_bytes(P, BN) +
         2 * sizeof(uint64_t) * gemm_stages(P, BN, MINB) + sizeof(float) * 2 * 4 * BN;
}

// Tiles of the bf16 products (P = 1): the columns of a tile and the blocks
// an SM holds (tune_ffn_wide.py). Two blocks of 112 registers a thread let
// one block's epilogue run beside the other's products, which pays where the
// epilogue computes (GELU and its derivative); the backward's H and G, two
// accumulators, then take 64 columns. DU, whose epilogue only stores, is
// faster on one block of 256 columns; the weight gradients' 2 x 24 x 8 tiles
// of 128 at the HF widths fill three waves of 132 SMs. Float32 (P = 2) takes
// 128 columns and one block an SM everywhere: its stages are twice as large.
constexpr int kHiddenCols = 128, kHiddenMinBlocks = 2;  // forward fc1 (GELU, mask1)
constexpr int kOutCols = 128, kOutMinBlocks = 2;        // forward fc2
constexpr int kDualMinBlocks = 2;                       // backward H and G
constexpr int kDuCols = 256, kDuMinBlocks = 1;          // backward DU
constexpr int kDwCols = 128, kDwMinBlocks = 1;          // dW1 and dW2
// the epilogues' erf divides by __fdividef (within an ulp of the IEEE
// division), as K2f's fused kernel does
constexpr bool kFastErf = true;
__host__ __device__ constexpr int gemm_min_blocks(int P, int want) { return P == 1 ? want : 1; }
__host__ __device__ constexpr int gemm_cols(int P, int want) { return P == 1 ? want : 128; }
__host__ __device__ constexpr int gemm_dual_cols(int minb) { return minb == 2 ? 64 : 128; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Eight consecutive values of a row, c .. c + 7, of which the first n are
// inside it: one or two 16-byte accesses where the row allows (vec: D % 8
// == 0 and the array 16-byte aligned, so every chunk is), else one element
// at a time.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, bool vec, float (&v)[8]) {
  if (vec && n == 8) {
    if constexpr (std::is_same_v<T, float>) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
      v[7] = b.w;
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        v[2 * k] = f.x, v[2 * k + 1] = f.y;
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = k < n ? to_f(p[k]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, int n, bool vec, const float (&v)[8]) {
  if (vec && n == 8) {
    if constexpr (std::is_same_v<T, float>) {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) p[k] = from_f<T>(v[k]);
}

// eight values as bf16 planes, 16-byte aligned (hi, and lo lo_off elements on)
template <bool SPLIT>
__device__ __forceinline__ void store8_planes(bf16* hi, size_t lo_off, const float (&v)[8]) {
  store4<SPLIT>(hi, lo_off, make_float4(v[0], v[1], v[2], v[3]));
  store4<SPLIT>(hi + 4, lo_off, make_float4(v[4], v[5], v[6], v[7]));
}

// The keep bits of mask elements e .. e + 7 (bit k: e + k)
__device__ __forceinline__ uint32_t keep8(uint64_t e, uint32_t stream, uint32_t thresh,
                                          uint32_t s0, uint32_t s1) {
  uint32_t bits = 0u;
  if (e % 4 == 0) {  // two whole Philox groups
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const Philox4 p = philox_group(e / 4 + g, stream, s0, s1);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bits |= static_cast<uint32_t>((p.w[k] >> 8) < thresh) << (4 * g + k);
    }
    return bits;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bits |= static_cast<uint32_t>(mask_word(e + k, stream, s0, s1) < thresh) << k;
  return bits;
}

// LayerNorm of rows: u planes [P][R][Dp]; with BWD also dy0 = mask2(dy)
// planes, mu and rstd (stats [2][R]) and the block's partial db2 (column sums
// of dy0, at part[tile][Hdp + 2 Dp + c]). Warp w takes rows 4w .. 4w+3: first
// their statistics over the whole row, then the row in slices of kWCols
// columns, each lane eight consecutive columns of a slice, each slice's
// column sums reduced over the warps before the next, so shared memory does
// not grow with D (the sums keep one order: rows, then warps). Columns D ..
// Dp - 1 are written as zeros.
template <typename T, bool BWD>
__global__ void __launch_bounds__(kRowThreads)
    wide_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const T* __restrict__ dy,
                     bf16* __restrict__ up, bf16* __restrict__ dp, float* __restrict__ stats,
                     float* __restrict__ part, int64_t R, int D, int Dp, int Hdp, float eps,
                     uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                     int use_dropout) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  constexpr int RW = kWRows / kRowWarps;  // rows of a warp
  static_assert(kWCols == 8 * 32, "a warp's eight columns a lane span a slice");
  __shared__ float red[kRowWarps][kWCols];  // BWD: each warp's column sums of dy0 in a slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = D % 8 == 0 && aligned16(x) && (!BWD || aligned16(dy));
  const size_t plane = static_cast<size_t>(R) * Dp;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kWRows + warp * RW;
  // the warp's rows' statistics, the rows side by side so their loads overlap
  float mu[RW], rstd[RW], sum[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) sum[i] = 0.f;
  for (int c = 8 * lane; c < D; c += kWCols) {
    const int n = min(8, D - c);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (r0 + i >= R) continue;
      float v[8];
      load8(x + (r0 + i) * D + c, n, vec, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum[i] += v[k];
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    mu[i] = warp_sum(sum[i]) / D;
    sum[i] = 0.f;
  }
  for (int c = 8 * lane; c < D; c += kWCols) {
    const int n = min(8, D - c);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (r0 + i >= R) continue;
      float v[8];
      load8(x + (r0 + i) * D + c, n, vec, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = k < n ? v[k] - mu[i] : 0.f;
        sum[i] += d * d;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t r = r0 + i;
    rstd[i] = rsqrtf(warp_sum(sum[i]) / D + eps);
    if (BWD && lane == 0 && r < R) {
      stats[r] = mu[i];
      stats[R + r] = rstd[i];
    }
  }
  for (int c0 = 0; c0 < Dp; c0 += kWCols) {
    const int c = c0 + 8 * lane;  // the lane's columns c .. c + 7
    const bool live = c < Dp;
    const int n = max(0, min(8, D - c));
    float w[8], b[8], col[8];
    load8(ln_w + c, n, aligned16(ln_w), w);
    load8(ln_b + c, n, aligned16(ln_b), b);
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k] = 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int64_t r = r0 + i;
      if (r >= R || !live) continue;
      float v[8];
      load8(x + r * D + c, n, vec, v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = k < n ? round_to<T>((v[k] - mu[i]) * rstd[i] * w[k] + b[k]) : 0.f;
      store8_planes<SPLIT>(up + r * Dp + c, plane, v);
      if constexpr (BWD) {
        load8(dy + r * D + c, n, vec, v);
        const uint32_t keep =
            use_dropout ? keep8(static_cast<uint64_t>(r) * D + c, 1u, thresh, s0, s1) : 255u;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (use_dropout) v[k] = keep >> k & 1u ? v[k] * inv_keep : 0.f;
          col[k] += v[k];
          v[k] = round_to<T>(v[k]);
        }
        store8_planes<SPLIT>(dp + r * Dp + c, plane, v);
      }
    }
    if constexpr (BWD) {
#pragma unroll
      for (int k = 0; k < 8; ++k) red[warp][8 * lane + k] = col[k];
      __syncthreads();
      const int cn = min(kWCols, Dp - c0);
      float* my = part + static_cast<size_t>(blockIdx.x) * (Hdp + 3 * Dp) + Hdp + 2 * Dp + c0;
      for (int cc = threadIdx.x; cc < cn; cc += kRowThreads) {
        float t = 0.f;
#pragma unroll
        for (int ww = 0; ww < kRowWarps; ++ww) t += red[ww][cc];
        my[cc] = t;
      }
      __syncthreads();  // the slice's sums are read before the next slice writes them
    }
  }
}

// bf16 planes [P][cols_p][rows_p] of w [rows][cols] transposed (rounded when
// !SPLIT), zero past rows and cols: the products read W2 as [Hd][D] and W1 as
// [D][Hd] K-major. A block moves a 32 x 32 tile through shared memory, so
// both its reads and its writes are along rows; rows_p, cols_p are multiples
// of 32.
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    split_planes_t_kernel(const float* __restrict__ w, int rows, int cols,
                          bf16* __restrict__ p, int rows_p, int cols_p) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
#pragma unroll
  for (int k = 0; k < 32; k += kWarps) {
    const int r = r0 + ty + k, c = c0 + tx;
    tile[ty + k][tx] = r < rows && c < cols ? w[static_cast<int64_t>(r) * cols + c] : 0.f;
  }
  __syncthreads();
  const size_t n = static_cast<size_t>(rows_p) * cols_p;
#pragma unroll
  for (int k = 0; k < 32; k += kWarps) {
    const float v = tile[tx][ty + k];
    const size_t i = static_cast<size_t>(c0 + ty + k) * rows_p + r0 + tx;
    const bf16 h = __float2bfloat16_rn(v);
    p[i] = h;
    if constexpr (SPLIT) p[n + i] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

template <bool SPLIT>
cudaError_t split_planes_t(const float* w, int rows, int cols, bf16* p, int rows_p, int cols_p,
                           cudaStream_t stream) {
  split_planes_t_kernel<SPLIT><<<dim3(cols_p / 32, rows_p / 32), kThreads, 0, stream>>>(
      w, rows, cols, p, rows_p, cols_p);
  return cudaGetLastError();
}

// ---- the product ----

// C = A B^T (A [M][K], B [N][K]), or two such problems. DUAL: two products
// of one tile, A0 B0^T into acc[0] and then A1 B1^T into acc[1] (the
// backward's H and G). Otherwise blocks past tiles0 take problem 1 with the
// maps a1, b1 (dW2 beside dW1). Both problems have depth k.
struct GemmShape {
  int64_t m[2];
  int n[2];
  int k;
  int tiles0;
};

// The thread's place in its warpgroup's 64 x BN fragment (sm90.cuh wgmma):
// row r0 + 8 h, column n0 + 8 j + 2 q + e holds acc[4 j + 2 h + e]; rl is r0
// within the warpgroup's 64 rows
struct FragPos {
  int warp, lane, q, rl;
  int64_t r0;
};

__device__ __forceinline__ FragPos frag_pos(int64_t row0) {
  const int t = threadIdx.x % 128;
  const int rl = 16 * (t / 32) + t % 32 / 4;
  return {t / 32, t % 32, t % 4, rl, row0 + rl};
}

// The keep bits of a fragment pair (columns col, col + 1; col even) in rows r
// and r + 8 of a mask `width` wide: bits 0-1 row r, 2-3 row r + 8. Every lane
// of the warp calls it: with width % 4 == 0 a Philox group is four columns of
// one row, shared by the lanes q and q ^ 1 (pair_keep); otherwise each
// element draws its own group.
__device__ __forceinline__ uint32_t frag_keep(int64_t r, int col, int width, int q,
                                              uint32_t stream, uint32_t thresh, uint32_t s0,
                                              uint32_t s1) {
  if (width % 4 == 0)
    return pair_keep(static_cast<uint64_t>(r) * width + (col & ~3), width, q, stream, thresh,
                     s0, s1);
  uint32_t bits = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bits |= static_cast<uint32_t>(
                  mask_word(static_cast<uint64_t>(r + 8 * h) * width + col + e, stream, s0, s1) <
                  thresh)
              << (2 * h + e);
  return bits;
}

// A consumer's step i: wait for its stage, issue its products on the
// warpgroup's 64 rows, then give back the stage of step i - 1, whose products
// are done once only this step's group is pending
template <int P, int BN, int S, bool A_MN, bool B_MN>
__device__ __forceinline__ void consume_stage(float (&d)[BN / 2], int i, uint64_t* full,
                                              uint64_t* empty, uint32_t base, int c) {
  constexpr uint32_t kStage = gemm_stage_bytes(P, BN);
  const int st = i % S;
  mbar_wait_or_trap(&full[st], (i / S) & 1);
  const uint32_t sa = base + st * kStage + c * (kTile / 2);  // the warpgroup's 64 rows of A
  const uint32_t sb = base + st * kStage + P * kTile;
  constexpr uint32_t kB = BN * kTK * 2;  // bytes of a plane of B
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTK / 16; ++kk)
#pragma unroll
    for (int term = 0; term < (P == 2 ? 3 : 1); ++term) {  // hi hi, hi lo, lo hi
      const uint32_t pa = term == 2 ? kTile : 0, pb = term == 1 ? kB : 0;
      const uint64_t da = A_MN ? sw128_desc(sa + pa + kk * 2048, kTile / 2, 1024)
                               : sw128_desc(sa + pa + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? sw128_desc(sb + pb + kk * 2048, kTK * 128, 1024)
                               : sw128_desc(sb + pb + kk * 32, 16, 1024);
      wgmma<BN, A_MN, B_MN>(d, da, db);
    }
  wgmma_commit();
  wgmma_wait<1>();
  // a wgmma is one operation of the warpgroup: once its thread 0 has seen
  // step i - 1 complete, no warp reads that stage any more
  if (i > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(i - 1) % S]);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The product kernel: C = A B^T on kTM x BN tiles. grid.x: the tiles of C,
// row-major (of problem 0, then of problem 1); 288 threads, MINB blocks an SM.
// P: planes of every operand. A_MN / B_MN: the operand's planes are [K][M] /
// [K][N] (depth along the rows), read in boxes of 64 columns x 64 rows; else
// [M][K] / [N][K], in boxes of 64 columns x kTM (BN) rows. Once both
// consumers are done with the ring, Epi(acc, problem, first row of the
// warpgroup, n0, warpgroup, column-sum scratch, the warpgroup's half of the
// ring) writes the tile.
template <int P, int BN, int MINB, bool A_MN, bool B_MN, bool DUAL, class Epi>
__global__ void __launch_bounds__(kGemmThreads, MINB)
    wg_gemm_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
                   const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
                   const GemmShape s, const Epi epi) {
  constexpr int S = gemm_stages(P, BN, MINB), NA = DUAL ? 2 : 1;
  constexpr uint32_t kStage = gemm_stage_bytes(P, BN);  // A's planes, then B's
  constexpr uint32_t kB = BN * kTK * 2;
  static_assert(2 * Epi::template stage_bytes<BN>() <= S * kStage,
                "each warpgroup stages its tile in half the ring");
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kStage);
  uint64_t* empty = full + S;
  float* red = reinterpret_cast<float*>(empty + S);

  const bool second = !DUAL && static_cast<int>(blockIdx.x) >= s.tiles0;
  const int t = second ? blockIdx.x - s.tiles0 : blockIdx.x;
  const int tn = ((second ? s.n[1] : s.n[0]) + BN - 1) / BN;
  const int m0 = t / tn * kTM, n0 = t % tn * BN;
  const int ksteps = (s.k + kTK - 1) / kTK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // each consumer warpgroup gives a stage back
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == 256) {
      for (int i = 0; i < NA * ksteps; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait_or_trap(&empty[st], (i / S - 1) & 1);
        const bool other = DUAL ? i >= ksteps : second;
        const CUtensorMap* ta = other ? &a1 : &a0;
        const CUtensorMap* tb = other ? &b1 : &b0;
        const int k0 = i % ksteps * kTK;
        uint8_t* sa = smem + st * kStage;
        uint8_t* sb = sa + P * kTile;
        mbar_expect_tx(&full[st], kStage);
#pragma unroll
        for (int pl = 0; pl < P; ++pl) {
          if constexpr (A_MN) {
            tma_load_3d(sa + pl * kTile, ta, m0, k0, pl, &full[st]);
            tma_load_3d(sa + pl * kTile + kTile / 2, ta, m0 + 64, k0, pl, &full[st]);
          } else {
            tma_load_3d(sa + pl * kTile, ta, k0, m0, pl, &full[st]);
          }
          if constexpr (B_MN) {
#pragma unroll
            for (int h = 0; h < BN / 64; ++h)
              tma_load_3d(sb + pl * kB + h * (kTK * 128), tb, n0 + 64 * h, k0, pl, &full[st]);
          } else {
            tma_load_3d(sb + pl * kB, tb, k0, n0, pl, &full[st]);
          }
        }
      }
    }
  } else {  // two consumers, rows m0 + 64 c .. + 63 of the tile
    const int c = threadIdx.x / 128;
    const uint32_t base = smem_addr(smem);
    float acc[NA][BN / 2];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[a][e] = 0.f;
    int i = 0;
    for (; i < ksteps; ++i) consume_stage<P, BN, S, A_MN, B_MN>(acc[0], i, full, empty, base, c);
    if constexpr (DUAL)
      for (; i < 2 * ksteps; ++i)
        consume_stage<P, BN, S, A_MN, B_MN>(acc[NA - 1], i, full, empty, base, c);
    wgmma_wait<0>();
    named_sync(3, 256);  // every copy has landed and both warpgroups' products are done
    epi(acc, second, static_cast<int64_t>(m0) + 64 * c, n0, c, red,
        smem + c * (S * kStage / 2));
  }
}

inline unsigned gemm_tiles(int64_t m, int n, int bn) {
  return static_cast<unsigned>((m + kTM - 1) / kTM * ((n + bn - 1) / bn));
}

// Launch the product on s (with s.m[1] = 0 there is no problem 1)
template <int P, int BN, int MINB, bool A_MN, bool B_MN, bool DUAL, class Epi>
cudaError_t wg_gemm(const CUtensorMap& a0, const CUtensorMap& b0, const CUtensorMap& a1,
                    const CUtensorMap& b1, GemmShape s, const Epi& epi, cudaStream_t stream) {
  const auto kernel = wg_gemm_kernel<P, BN, MINB, A_MN, B_MN, DUAL, Epi>;
  constexpr size_t smem = gemm_smem(P, BN, MINB);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  s.tiles0 = static_cast<int>(gemm_tiles(s.m[0], s.n[0], BN));
  const unsigned blocks =
      s.tiles0 + (DUAL || s.m[1] == 0 ? 0u : gemm_tiles(s.m[1], s.n[1], BN));
  kernel<<<blocks, kGemmThreads, smem, stream>>>(a0, b0, a1, b1, s, epi);
  return cudaGetLastError();
}

// ---- the epilogues ----
//
// Each warpgroup writes its 64 x BN tile of every output into its half of
// the finished ring ([64][BN + pad], rows 16-byte aligned), then copies the
// tile to device memory in 16-byte pieces along the rows, so that a warp's
// stores are whole rows rather than the fragment's scattered pairs.

template <typename T>
constexpr int kStagePad = 16 / sizeof(T);  // elements: rows stay 16-byte aligned

// two values at (rl, col) of a staged [64][BN + pad] tile of T (col even)
template <typename T, int BN>
__device__ __forceinline__ void stage2(T* tile, int rl, int col, float a, float b) {
  T* p = tile + rl * (BN + kStagePad<T>) + col;
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
}

// two values as bf16 planes of a staged tile (hi, and the lo tile after it)
template <bool SPLIT, int BN>
__device__ __forceinline__ void stage2_planes(bf16* tile, int rl, int col, float a, float b) {
  constexpr int kTileElems = 64 * (BN + kStagePad<bf16>);
  uint32_t hi, lo;
  if constexpr (SPLIT) {
    split_bf16(a, b, hi, lo);
    *reinterpret_cast<uint32_t*>(tile + kTileElems + rl * (BN + kStagePad<bf16>) + col) = lo;
  } else {
    hi = pack_bf16(a, b);
  }
  *reinterpret_cast<uint32_t*>(tile + rl * (BN + kStagePad<bf16>) + col) = hi;
}

// The warpgroup's staged tile of T to out (row stride ld): rows < nrows,
// columns < ncols. vec: out's rows are 16-byte aligned and ncols fills whole
// pieces, so each thread moves 16 bytes at a time.
template <typename T, int BN>
__device__ __forceinline__ void tile_out(const T* tile, T* out, int64_t ld, int nrows, int ncols,
                                         bool vec) {
  constexpr int LD = BN + kStagePad<T>, PER = 16 / sizeof(T), PIECES = BN / PER;
  const int t = threadIdx.x % 128;
  if (vec) {
    for (int i = t; i < 64 * PIECES; i += 128) {
      const int r = i / PIECES, col = i % PIECES * PER;
      if (r < nrows && col < ncols)
        *reinterpret_cast<uint4*>(out + r * ld + col) =
            *reinterpret_cast<const uint4*>(tile + r * LD + col);
    }
  } else {
    for (int i = t; i < 64 * BN; i += 128) {
      const int r = i / BN, col = i % BN;
      if (r < nrows && col < ncols) out[r * ld + col] = tile[r * LD + col];
    }
  }
}

// forward fc1: gd = round_T(mask1(gelu(acc + b1))) as planes [P][R][Hdp],
// zero past Hd
template <typename T>
struct EpiHidden {
  const float* b1;
  bf16* gd;
  int64_t R;
  int Hd, Hdp;
  uint32_t thresh;
  float inv_keep;
  uint32_t s0, s1;
  int use_dropout;

  template <int BN>
  __host__ __device__ static constexpr int stage_bytes() {
    return planes(std::is_same_v<T, float>) * 64 * (BN + kStagePad<bf16>) * 2;
  }

  template <int HALF>
  __device__ void operator()(const float (&acc)[1][HALF], bool, int64_t row0, int n0, int c,
                             float*, uint8_t* stage) const {
    constexpr bool SPLIT = std::is_same_v<T, float>;
    constexpr int BN = 2 * HALF;
    bf16* tile = reinterpret_cast<bf16*>(stage);
    const FragPos f = frag_pos(row0);
#pragma unroll
    for (int j = 0; j < HALF / 4; ++j) {
      const int cl = 8 * j + 2 * f.q, col = n0 + cl;
      const uint32_t keep = use_dropout ? frag_keep(f.r0, col, Hd, f.q, 0u, thresh, s0, s1) : 15u;
      const float bias[2] = {col < Hd ? b1[col] : 0.f, col + 1 < Hd ? b1[col + 1] : 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float g = 0.f;
          if (col + e < Hd && (keep >> (2 * h + e) & 1u)) {
            g = gelu<kFastErf>(acc[0][4 * j + 2 * h + e] + bias[e]);
            if (use_dropout) g *= inv_keep;
          }
          v[e] = round_to<T>(g);
        }
        stage2_planes<SPLIT, BN>(tile, f.rl + 8 * h, cl, v[0], v[1]);
      }
    }
    named_sync(1 + c, 128);
    const int nrows = static_cast<int>(R - row0 < 64 ? R - row0 : 64);
    const size_t plane = static_cast<size_t>(R) * Hdp;
#pragma unroll
    for (int pl = 0; pl < planes(SPLIT); ++pl)
      tile_out<bf16, BN>(tile + pl * 64 * (BN + kStagePad<bf16>), gd + pl * plane + row0 * Hdp + n0,
                         Hdp, nrows, Hdp - n0, true);
  }
};

// forward fc2: y = mask2(acc + b2) in T, [R][D]
template <typename T>
struct EpiOut {
  const float* b2;
  T* y;
  int64_t R;
  int D;
  uint32_t thresh;
  float inv_keep;
  uint32_t s0, s1;
  int use_dropout;

  template <int BN>
  __host__ __device__ static constexpr int stage_bytes() {
    return 64 * (BN + kStagePad<T>) * static_cast<int>(sizeof(T));
  }

  template <int HALF>
  __device__ void operator()(const float (&acc)[1][HALF], bool, int64_t row0, int n0, int c,
                             float*, uint8_t* stage) const {
    constexpr int BN = 2 * HALF;
    T* tile = reinterpret_cast<T*>(stage);
    const FragPos f = frag_pos(row0);
#pragma unroll
    for (int j = 0; j < HALF / 4; ++j) {
      const int cl = 8 * j + 2 * f.q, col = n0 + cl;
      const uint32_t keep = use_dropout ? frag_keep(f.r0, col, D, f.q, 1u, thresh, s0, s1) : 15u;
      const float bias[2] = {col < D ? b2[col] : 0.f, col + 1 < D ? b2[col + 1] : 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[0][4 * j + 2 * h + e] + bias[e];
          if (use_dropout) v[e] = keep >> (2 * h + e) & 1u ? v[e] * inv_keep : 0.f;
        }
        stage2<T, BN>(tile, f.rl + 8 * h, cl, v[0], v[1]);
      }
    }
    named_sync(1 + c, 128);
    const int nrows = static_cast<int>(R - row0 < 64 ? R - row0 : 64);
    tile_out<T, BN>(tile, y + row0 * D + n0, D, nrows, D - n0,
                    D % (16 / sizeof(T)) == 0 && aligned16(y));
  }
};

// backward, H = acc[0] and G = acc[1]: dh = gelu'(H + b1) * mask1(G) and gd =
// round_T(mask1(gelu(H + b1))) as planes [P][R][Hdp] (zero past Hd), and the
// warpgroup's column sums of dh (64 rows, the row kernels' tile) as db1's
// partial at part[tile][j]: over each warp's rows by shuffles, then over the
// four warps in order
template <typename T>
struct EpiDh {
  const float* b1;
  bf16* dh;
  bf16* gd;
  float* part;
  int64_t R;
  int Hd, Hdp, Dp;
  uint32_t thresh;
  float inv_keep;
  uint32_t s0, s1;
  int use_dropout;

  template <int BN>
  __host__ __device__ static constexpr int stage_bytes() {  // dh's planes, then gd's
    return 2 * planes(std::is_same_v<T, float>) * 64 * (BN + kStagePad<bf16>) * 2;
  }

  template <int HALF>
  __device__ void operator()(const float (&acc)[2][HALF], bool, int64_t row0, int n0, int c,
                             float* red, uint8_t* stage) const {
    static_assert(HALF <= 64, "one column of the tile a thread in the column sums");
    constexpr bool SPLIT = std::is_same_v<T, float>;
    constexpr int BN = 2 * HALF, kOut = planes(SPLIT) * 64 * (BN + kStagePad<bf16>);
    bf16* dh_tile = reinterpret_cast<bf16*>(stage);
    bf16* gd_tile = dh_tile + kOut;
    const FragPos f = frag_pos(row0);
    float* my = red + (c * 4 + f.warp) * BN;
#pragma unroll
    for (int j = 0; j < HALF / 4; ++j) {
      const int cl = 8 * j + 2 * f.q, col = n0 + cl;
      const uint32_t keep = use_dropout ? frag_keep(f.r0, col, Hd, f.q, 0u, thresh, s0, s1) : 15u;
      const float bias[2] = {col < Hd ? b1[col] : 0.f, col + 1 < Hd ? b1[col + 1] : 0.f};
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float gv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float g = 0.f, d = 0.f;
          if (col + e < Hd) {
            const float hh = acc[0][4 * j + 2 * h + e] + bias[e];
            float dg = acc[1][4 * j + 2 * h + e], slope;
            gelu_and_grad<kFastErf>(hh, g, slope);
            if (use_dropout) {
              const bool kept = keep >> (2 * h + e) & 1u;
              g = kept ? g * inv_keep : 0.f;
              dg = kept ? dg * inv_keep : 0.f;
            }
            d = slope * dg;
          }
          gv[e] = round_to<T>(g);
          dv[e] = round_to<T>(d);
          if (f.r0 + 8 * h < R) sum[e] += d;
        }
        stage2_planes<SPLIT, BN>(dh_tile, f.rl + 8 * h, cl, dv[0], dv[1]);
        stage2_planes<SPLIT, BN>(gd_tile, f.rl + 8 * h, cl, gv[0], gv[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o);
        if (f.lane < 4) my[cl + e] = sum[e];
      }
    }
    named_sync(1 + c, 128);
    const int col = threadIdx.x % 128;
    if (col < BN && row0 < R && n0 + col < Hdp) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) t += red[(c * 4 + w) * BN + col];
      part[row0 / kWRows * (Hdp + 3 * static_cast<int64_t>(Dp)) + n0 + col] = t;
    }
    const int nrows = static_cast<int>(R - row0 < 64 ? R - row0 : 64);
    const size_t plane = static_cast<size_t>(R) * Hdp;
    constexpr int kTileElems = 64 * (BN + kStagePad<bf16>);
#pragma unroll
    for (int pl = 0; pl < planes(SPLIT); ++pl) {
      tile_out<bf16, BN>(dh_tile + pl * kTileElems, dh + pl * plane + row0 * Hdp + n0, Hdp,
                         nrows, Hdp - n0, true);
      tile_out<bf16, BN>(gd_tile + pl * kTileElems, gd + pl * plane + row0 * Hdp + n0, Hdp,
                         nrows, Hdp - n0, true);
    }
  }
};

// C float32 of problem 0 or 1: out [rows][cols] (row stride cols, a multiple
// of 32)
struct EpiF32 {
  float *out0, *out1;
  int64_t rows0, rows1;
  int cols0, cols1;

  template <int BN>
  __host__ __device__ static constexpr int stage_bytes() {
    return 64 * (BN + kStagePad<float>) * 4;
  }

  template <int HALF>
  __device__ void operator()(const float (&acc)[1][HALF], bool second, int64_t row0, int n0,
                             int c, float*, uint8_t* stage) const {
    constexpr int BN = 2 * HALF;
    float* tile = reinterpret_cast<float*>(stage);
    const FragPos f = frag_pos(row0);
#pragma unroll
    for (int j = 0; j < HALF / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        stage2<float, BN>(tile, f.rl + 8 * h, 8 * j + 2 * f.q, acc[0][4 * j + 2 * h],
                          acc[0][4 * j + 2 * h + 1]);
    named_sync(1 + c, 128);
    const int N = second ? cols1 : cols0;
    const int64_t M = second ? rows1 : rows0;
    const int nrows = static_cast<int>(M - row0 < 64 ? (M - row0 > 0 ? M - row0 : 0) : 64);
    tile_out<float, BN>(tile, (second ? out1 : out0) + row0 * N + n0, N, nrows, N - n0, true);
  }
};

// LayerNorm backward of rows from DU = dh W1 [R][Dp]: dx in T and the block's
// partial dln_w, dln_b at part[tile][Hdp + c], part[tile][Hdp + Dp + c]. As
// wide_rows_kernel: each row's sums over the whole row first, then the row in
// slices of kWCols columns, eight a lane (dx, and the column sums reduced over
// the warps).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    wide_ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                       const float* __restrict__ stats, const float* __restrict__ DU,
                       T* __restrict__ dx, float* __restrict__ part, int64_t R, int D, int Dp,
                       int Hdp) {
  constexpr int RW = kWRows / kRowWarps;  // rows of a warp
  __shared__ float red[2][kRowWarps][kWCols];  // dln_w, dln_b by warp, in a slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = D % 8 == 0 && aligned16(x) && aligned16(dx), wvec = aligned16(ln_w);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kWRows + warp * RW;
  float mu[RW], rstd[RW], mt[RW], mtx[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const bool in = r0 + i < R;
    mu[i] = in ? stats[r0 + i] : 0.f, rstd[i] = in ? stats[R + r0 + i] : 0.f;
    mt[i] = mtx[i] = 0.f;
  }
  // the warp's rows side by side, so their loads overlap
  for (int c = 8 * lane; c < D; c += kWCols) {
    const int n = min(8, D - c);
    float w[8];
    load8(ln_w + c, n, wvec, w);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int64_t r = r0 + i;
      if (r >= R) continue;
      float g[8], v[8];
      load8(DU + r * Dp + c, n, true, g);
      load8(x + r * D + c, n, vec, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = g[k] * w[k], xh = (v[k] - mu[i]) * rstd[i];
        mt[i] += t;
        mtx[i] = fmaf(t, k < n ? xh : 0.f, mtx[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) mt[i] = warp_sum(mt[i]) / D, mtx[i] = warp_sum(mtx[i]) / D;
  float* my = part + static_cast<size_t>(blockIdx.x) * (Hdp + 3 * Dp) + Hdp;
  for (int c0 = 0; c0 < Dp; c0 += kWCols) {
    const int c = c0 + 8 * lane;  // the lane's columns c .. c + 7
    const int n = max(0, min(8, D - c));
    float w[8], gw[8], gb[8];
    load8(ln_w + c, n, wvec, w);
#pragma unroll
    for (int k = 0; k < 8; ++k) gw[k] = gb[k] = 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int64_t r = r0 + i;
      if (r >= R || n == 0) continue;
      float g[8], v[8];
      load8(DU + r * Dp + c, n, true, g);
      load8(x + r * D + c, n, vec, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = (v[k] - mu[i]) * rstd[i];
        gw[k] = fmaf(g[k], xh, gw[k]);
        gb[k] += g[k];
        v[k] = (g[k] * w[k] - mt[i] - xh * mtx[i]) * rstd[i];
      }
      store8(dx + r * D + c, n, vec, v);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[0][warp][8 * lane + k] = k < n ? gw[k] : 0.f;
      red[1][warp][8 * lane + k] = k < n ? gb[k] : 0.f;
    }
    __syncthreads();
    const int cn = min(kWCols, Dp - c0);
    for (int cc = threadIdx.x; cc < cn; cc += kRowThreads) {
      float tw = 0.f, tb = 0.f;
#pragma unroll
      for (int ww = 0; ww < kRowWarps; ++ww) {
        tw += red[0][ww][cc];
        tb += red[1][ww][cc];
      }
      my[c0 + cc] = tw;
      my[Dp + c0 + cc] = tb;
    }
    __syncthreads();  // the slice's sums are read before the next slice writes them
  }
}

// Launch helpers: grids of the row kernels
inline unsigned row_tiles(int64_t R) { return static_cast<unsigned>((R + kWRows - 1) / kWRows); }

}  // namespace
