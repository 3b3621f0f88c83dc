// Device helpers shared by the tensor-core attention templates,
// attn_fwd_mma.cuh (the bf16 K1f, K3f and K4f) and attn_bwd_mma.cuh (the bf16
// K1b, K3b and K4b): operand tiles streamed into shared memory as bf16 rows
// padded by 16 bytes (zero rows past N), ldmatrix / mma.sync m16n8k16
// wrappers, the re-pack of f32 accumulators into A operands, and the keep
// bits of the Philox dropout mask (philox.cuh, ops/kernel_prng.py), drawn in
// registers where they are used.
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

__host__ __device__ constexpr int mma_ld(int dh) { return dh + 8; }  // row stride, elements

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

// The keep bits of the mask, drawn in registers where they are used. Mask
// element e is kept when word e % 4 of Philox group e / 4 (philox.cuh, stream
// 0) is below thresh, so any tiling draws the same bits.

// The four keep bits of group G, bit b for element 4 G + b (nothing when
// !live: a padded row, whose bits are never read)
__device__ __forceinline__ uint32_t keep_nibble(uint64_t G, bool live, uint32_t thresh,
                                                uint32_t s0, uint32_t s1) {
  uint32_t v = 0u;
  if (live) {
    const Philox4 r = philox_group(G, 0u, s0, s1);
#pragma unroll
    for (int k = 0; k < 4; ++k) v |= static_cast<uint32_t>((r.w[k] >> 8) < thresh) << k;
  }
  return v;
}

// The 16 keep bits of groups G .. G+3 (elements 4 G .. 4 G + 15), drawn by
// the four lanes of a quad (lane t4 draws G + t4) and gathered by two
// shuffles, so that every lane of the quad holds them. Every lane of the warp
// calls it.
__device__ __forceinline__ uint32_t quad_keep16(uint64_t G, int t4, bool live, uint32_t thresh,
                                                uint32_t s0, uint32_t s1) {
  uint32_t v = keep_nibble(G + t4, live, thresh, s0, s1) << (4 * t4);
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The keep bits of a lane's two rows (g and g+8 of a 16-row tile, in the
// accumulator layout) over a sweep of 16-key steps: bit c of the window of
// row r is keep(row, j0 + c) for the step's first key j0. A row's elements
// are consecutive in the mask, so each step draws the four groups that follow
// the previous step's and every group is drawn once per sweep. Row g+8 starts
// 8 N elements (2 N groups) after row g, so both rows share one offset. Only
// the current step's 16 bits of each row are held; the caller passes the
// mask element e of (row g, the step's first key), a multiple of 16 keys
// into the row, and keeps no counter of its own.
__device__ __forceinline__ void keep_rows_start(uint32_t (&cur)[2], uint64_t e, int N,
                                                const bool (&live)[2], int t4, uint32_t thresh,
                                                uint32_t s0, uint32_t s1) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    cur[r] = quad_keep16((e >> 2) + 2ull * r * N, t4, live[r], thresh, s0, s1);
}

// the windows of the step at element e, then the bits of the next step
__device__ __forceinline__ void keep_rows_step(uint32_t (&cur)[2], uint32_t (&win)[2],
                                               uint64_t e, int N, const bool (&live)[2],
                                               int t4, uint32_t thresh, uint32_t s0,
                                               uint32_t s1) {
  const int off = static_cast<int>(e & 3u);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t nxt = quad_keep16((e >> 2) + 2ull * r * N + 4, t4, live[r], thresh, s0, s1);
    win[r] = (cur[r] | (nxt << 16)) >> off;
    cur[r] = nxt;
  }
}

// The keep bits of one 16 x 16 block in the transposed accumulator layout
// (rows are keys j0 + g, j0 + g + 8; columns queries): bit 16 n + 8 r + g of
// out[c] is keep(query i0 + 8 n + 2 t4 + c, key j0 + g + 8 r). The quads draw
// the block's query rows as in the row layout (quad g: queries i0 + g and
// i0 + g + 8, 16 consecutive elements each, four or five groups), and two
// shuffles hand each lane the rows of its columns. e_head: the head's first
// mask element; query rows past N draw nothing.
__device__ __forceinline__ void keep_block_t(uint32_t (&out)[2], uint64_t e_head, int N, int i0,
                                             int j0, int lane, uint32_t thresh, uint32_t s0,
                                             uint32_t s1) {
  const int g = lane >> 2, t4 = lane & 3;
  // query row g+8 starts 8 N elements (2 N groups) after row g: one offset
  const uint64_t e = e_head + static_cast<uint64_t>(i0 + g) * N + j0;
  const uint64_t G = e >> 2;
  const int off = static_cast<int>(e & 3u);
  const bool live[2] = {i0 + g < N, i0 + g + 8 < N};
  uint32_t w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    w[r] = keep_nibble(G + 2ull * r * N + t4, live[r], thresh, s0, s1) << (4 * t4);
  // the fifth group of row r, needed unless the rows start on a group: lane
  // r of the quad draws it
  const bool r1 = t4 == 1;
  const uint32_t x = keep_nibble(G + (r1 ? 2ull * N : 0ull) + 4,
                                 t4 < 2 && (r1 ? live[1] : live[0]) && off != 0, thresh, s0,
                                 s1);
  uint32_t p = 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w[r] |= __shfl_xor_sync(0xffffffffu, w[r], 1);
    w[r] |= __shfl_xor_sync(0xffffffffu, w[r], 2);
    const uint32_t xr = __shfl_sync(0xffffffffu, x, (lane & ~3) | r);
    p |= (((w[r] | (xr << 16)) >> off) & 0xffffu) << (16 * r);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) out[c] = __shfl_sync(0xffffffffu, p, 4 * (2 * t4 + c));
}

// The [B*H, N, Dh] layout of K3 and K4 in a template's arguments (MmaFwdArgs,
// MmaBwdArgs): H = 1 and contiguous heads
template <typename A>
void mma_head_major(A& a, int BH, int N, int DH) {
  const long long head = static_cast<long long>(N) * DH;
  a.x_batch = head, a.x_head = 0, a.x_tok = DH;
  a.B = BH, a.H = 1, a.N = N;
}

// ---- streaming tiles ----

// Rows [t0, t0 + rows) of one operand ([token][DH] at src + t * tok) into a
// [rows][LD] bf16 tile: cp.async for rows before N, zeros past N (so that
// products over them stay finite; their weights are 0). The caller commits.
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long tok, int t0, int rows, int N) {
  constexpr int CH = DH / 8, LD = mma_ld(DH);
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, d = (c % CH) * 8;
    __nv_bfloat16* p = dst + r * LD + d;
    if (t0 + r < N) {
      cp_async16(p, src + static_cast<long long>(t0 + r) * tok + d);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `pending` committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

}  // namespace
