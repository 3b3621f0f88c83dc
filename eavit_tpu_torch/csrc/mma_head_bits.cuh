// The keep bitmaps of the whole-head tensor-core kernels (attn_fwd_head.cuh,
// attn_bwd_head.cuh): keep bits of consecutive mask elements drawn by a warp
// into words of shared memory in the mask's own element order, and 32-bit
// windows read back from them. (The streaming kernels draw in registers,
// mma_common.cuh.)
#pragma once

#include <cstdint>

#include "mma_common.cuh"

namespace {

__host__ __device__ constexpr int mma_pad16(int n) { return (n + 15) / 16 * 16; }

// Words of a keep bitmap for `elements` consecutive mask elements: bit p is
// element base + p, base the first element rounded down to a multiple of 32
// (an offset of up to 31 bits), plus the 16 bits a padded tile reads past
// the last element and one word that a 32-bit window at the end reads, in
// whole chunks of 128 bits.
__host__ __device__ constexpr int keep_bit_words(long long elements) {
  return static_cast<int>(((31 + elements + 16 + 31) / 32 + 1 + 3) / 4 * 4);
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
