// Device helpers shared by the tensor-core attention templates,
// attn_fwd_mma.cuh (the bf16 K1f) and attn_bwd_mma.cuh (the bf16 K1b, K3b and
// K4b): operand tiles in shared memory as bf16 rows padded by 16 bytes (N
// padded to a multiple of 16 with zero rows), ldmatrix / mma.sync m16n8k16
// wrappers, the re-pack of f32 accumulators into A operands, and the keep
// bitmap of the Philox dropout mask (philox.cuh, ops/kernel_prng.py).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a[0] rows g, cols 2t..2t+1; a[1] row g+8; a[2] row g,
//                     cols 8+2t..; a[3] row g+8, cols 8+2t..
//   B (16 x 8, col):  b0 depth 2t..2t+1, col g; b1 depth 8+2t..
//   C (16 x 8):       c[0..1] row g, cols 2t..2t+1; c[2..3] row g+8
#pragma once

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int mma_pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int mma_ld(int dh) { return dh + 8; }  // row stride, elements

// Words of a keep bitmap for `elements` consecutive mask elements: bit p is
// element base + p, base the first element rounded down to a multiple of 32
// (an offset of up to 31 bits), plus the 16 bits a padded tile reads past
// the last element and one word that a 32-bit window at the end reads, in
// whole chunks of 128 bits.
__host__ __device__ constexpr int keep_bit_words(long long elements) {
  return static_cast<int>(((31 + elements + 16 + 31) / 32 + 1 + 3) / 4 * 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// x0, x1 as hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  memcpy(&hi, &h, sizeof(hi));
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// A fragments of one 16x16 tile from the accumulators of two n8 tiles c[0],
// c[1] (rows g, g+8; columns 2t, 2t+1 and 8+2t, 8+2t+1): rounded to bf16
// (ROUND) or as hi and lo terms
template <bool ROUND>
__device__ __forceinline__ void to_a(const float (&c)[2][4], uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (ROUND) {
        hi[2 * n + r] = pack_bf16(c[n][2 * r], c[n][2 * r + 1]);
      } else {
        split_bf16(c[n][2 * r], c[n][2 * r + 1], hi[2 * n + r], lo[2 * n + r]);
      }
    }
}

// acc[NT] (16 x DH) += A (16 x 16 tokens) * X[tok0 .. tok0+15][0 .. DH) from
// shared memory, X's token axis being the depth: ldmatrix.trans
template <int DH, bool ROUND>
__device__ __forceinline__ void acc_times_rows(float (&acc)[DH / 8][4], const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               const __nv_bfloat16* xs, int tok0, int lane) {
  constexpr int LD = mma_ld(DH);
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, xs + (tok0 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * np], hi, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
    if constexpr (!ROUND) {
      mma_bf16(acc[2 * np], lo, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// A fragments of the 16 x DH tile at rows row0 .. row0+15 of X
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const __nv_bfloat16* xs,
                                       int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(a[kk], xs + (row0 + (lane & 15)) * mma_ld(DH) + kk * 16 + (lane >> 4) * 8);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 32 keep bits from bit p of the bitmap on
__device__ __forceinline__ uint32_t keep_window(const uint32_t* bits, int p) {
  return __funnelshift_r(bits[p >> 5], bits[(p >> 5) + 1], p & 31);
}

// Chunk c of a keep bitmap whose bit 0 is mask element base (base % 32 == 0),
// by one warp: bits 128c .. 128c+127 into words 4c .. 4c+3. Lane l draws the
// Philox group of elements base + 128c + 4l .. + 3 (one call, four words) and
// the lanes' four-bit pieces are gathered into words with three shuffles, so
// that every group is drawn once however rows and groups fall.
__device__ __forceinline__ void draw_keep_chunk(uint32_t* bits, uint64_t base, int c, int lane,
                                                uint32_t thresh, uint32_t s0, uint32_t s1) {
  const Philox4 r = philox_group((base >> 2) + 32ull * c + lane, 0u, s0, s1);
  uint32_t v = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) v |= static_cast<uint32_t>((r.w[k] >> 8) < thresh) << k;
  v <<= 4 * (lane & 7);
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  v |= __shfl_xor_sync(0xffffffffu, v, 4);
  if ((lane & 7) == 0) bits[4 * c + (lane >> 3)] = v;
}

}  // namespace
