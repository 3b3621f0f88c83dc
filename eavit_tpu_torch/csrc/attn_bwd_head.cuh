// The whole-head form of the bf16 K1b (csrc/flash_qkv_bwd.cu), K3b
// (csrc/flash_dropout.cu) and K4b (csrc/flash.cu): the tensor-core backward
// of attn_bwd_mma.cuh (same function, same operand layout, same ROUND,
// DROPOUT and DELTA_FROM_O flags) in one kernel whose block holds a whole
// head instead of two kernels that stream. One block of kHeadWarps warps per
// (b, h) holds the head's q, k, v and dO in shared memory as bf16 (rows
// padded by 16 bytes, N padded to 16 with zero rows), about 73 KB at N =
// 198, Dh = 32. Three passes, each warp owning one 16-row tile per step:
//   0. all warps draw the head's keep bits into a bitmap in the mask's own
//      element order, while cp.async brings the operands (draw_keep_chunk:
//      every group of four is drawn once), or sum delta from O (K4b);
//   1. rows, one warp per 16-query tile: S and dP by mma, rowsum (one sweep),
//      then a second sweep forms ds and dQ += dS K, and writes dq;
//   2. columns, one warp per 16-key tile: S^T and dP^T, then dV += pd^T dO
//      and dK += ds^T Q.
// The mask is drawn once per head where the streaming kernels draw it in
// each of their three sweeps, and nothing is reloaded, so at the flagship
// N = 198 this kernel is the faster one (PERF.md); its shared memory grows
// with N, so the wrapper runs it only where it fits and N <= 256, and the
// streaming kernels past that. See attn_bwd_mma.cuh for what it computes.
#pragma once

#include <cstdint>

#include "attn_bwd_mma.cuh"
#include "mma_head_bits.cuh"

namespace {

// Warps of a block, each owning one 16-row tile at a time, and blocks per SM
// that the register budget must allow at Dh <= 32 (80 registers a thread:
// three blocks of 73 KB fit beside each other at N = 198). The A fragments of
// a warp's own tile are reloaded by ldmatrix at every step rather than held,
// which is what keeps the kernels inside 80 registers without spills
// (tune_attn_bwd.py measures these choices).
constexpr int kHeadWarps = 8;
constexpr int kHeadMinBlocks = 3;

// Words of the head's keep bitmap
__host__ __device__ constexpr int mma_bit_words(int n) {
  return keep_bit_words(static_cast<long long>(n) * n);
}

size_t head_bwd_smem_bytes(int N, int DH, bool dropout) {
  const size_t np = mma_pad16(N);
  return 4 * np * mma_ld(DH) * sizeof(__nv_bfloat16) + 2 * np * sizeof(float) +
         (dropout ? mma_bit_words(N) * sizeof(uint32_t) : 0);
}

// The block's offset into q, k, v and their gradients, recomputed where the
// gradients are written: a value the compiler kept across the passes cost
// K4b a spill at Dh 32 (the volatile read of ctaid stops it from hoisting)
__device__ __forceinline__ long long head_x_offset(const MmaBwdArgs& a) {
  unsigned bh;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bh));
  return static_cast<long long>(bh / a.H) * a.x_batch +
         static_cast<long long>(bh % a.H) * a.x_head;
}

template <int DH, bool ROUND, bool DROPOUT, bool DELTA_FROM_O>
__global__ void __launch_bounds__(kHeadWarps * 32, DH >= 64 ? 1 : kHeadMinBlocks)
    attn_bwd_head_kernel(MmaBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = mma_ld(DH), KS = DH / 16, NT = DH / 8;
  extern __shared__ float4 smem4[];
  const int N = a.N, Np = mma_pad16(N), T = Np / 16;
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [Np][LD] each
  bf16* ks = qs + Np * LD;
  bf16* vs = ks + Np * LD;
  bf16* gs = vs + Np * LD;
  float* ls = reinterpret_cast<float*>(gs + Np * LD);  // [Np] lse * log2(e)
  float* rs = ls + Np;                                 // [Np] rowsum or delta
  uint32_t* bits = reinterpret_cast<uint32_t*>(rs + Np);  // mma_bit_words(N), dropout only

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const long long xo = b * a.x_batch + h * a.x_head, go = b * a.g_batch + h * a.g_head;
  const int tid = threadIdx.x;

  // ---- operands by cp.async, zero rows past N ----
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int c = tid; c < Np * CH; c += blockDim.x) {
    const int t = c / CH, d = (c % CH) * 8, so = t * LD + d;
    if (t < N) {
      const long long x = xo + t * a.x_tok + d;
      cp_async16(qs + so, a.q + x);
      cp_async16(ks + so, a.k + x);
      cp_async16(vs + so, a.v + x);
      cp_async16(gs + so, a.g + go + t * a.g_tok + d);
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(qs + so) = z;
      *reinterpret_cast<uint4*>(ks + so) = z;
      *reinterpret_cast<uint4*>(vs + so) = z;
      *reinterpret_cast<uint4*>(gs + so) = z;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = tid; t < Np; t += blockDim.x)
    ls[t] = t < N ? a.lse[static_cast<long long>(bh) * N + t] * kLog2e : 0.f;

  // ---- keep bits: bit p is element base + p, (i, j) at p = off + i*N + j ----
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const uint64_t e_head = static_cast<uint64_t>(bh) * N * N, base = e_head & ~31ull;
  const int off = static_cast<int>(e_head - base);
  if constexpr (DROPOUT) {
    for (int c = warp; c < mma_bit_words(N) / 4; c += kHeadWarps)
      draw_keep_chunk(bits, base, c, lane, a.thresh, a.s0, a.s1);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  if constexpr (DELTA_FROM_O) {
    // delta_t = sum_d dO[t, d] O[t, d] in f32: CH consecutive lanes share a
    // row, 8 dims each from one 16-byte load of O (global) and of dO (shared
    // memory), then a shuffle tree. CH divides 32, so a row's lanes sit in
    // one warp, and every lane of the block runs every step of the loop.
    for (int c0 = 0; c0 < Np * CH; c0 += blockDim.x) {
      const int c = c0 + tid, t = c / CH, d = (c % CH) * 8;
      float part = 0.f;
      if (t < N) {
        const uint4 ov = *reinterpret_cast<const uint4*>(a.o + go + t * a.g_tok + d);
        const uint4 gv = *reinterpret_cast<const uint4*>(gs + t * LD + d);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
#pragma unroll
      for (int m = 1; m < CH; m <<= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
      if (c % CH == 0 && t < Np) rs[t] = part;
    }
    __syncthreads();
  }

  const float scale2 = a.scale * kLog2e, ik = DROPOUT ? a.inv_keep : 1.f;
  const int ns = a.num_special;

  // ---- pass 1: rows -> rowsum, dq ----
  for (int it = warp; it < T; it += kHeadWarps) {
    const int i0 = it * 16;
    const int rows[2] = {i0 + g, i0 + g + 8};
    const float l2[2] = {ls[rows[0]], ls[rows[1]]};
    float rsum[2] = {0.f, 0.f};
    float dq[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

    // sweep 0 sums rowsum (not with delta from O); sweep 1 recomputes the
    // tiles and forms ds
#pragma unroll
    for (int sweep = DELTA_FROM_O ? 1 : 0; sweep < 2; ++sweep) {
      for (int jt = 0; jt < T; ++jt) {
        const int j0 = jt * 16;
        uint32_t qa[KS][4], ga[KS][4];
        load_a<DH>(qa, qs, i0, lane);
        load_a<DH>(ga, gs, i0, lane);
        float s[2][4], p[2][4];
        two_products<DH>(s, p, qa, ga, ks, vs, j0, lane);
        // every pair valid: no padding and no dual-query mask in the tile
        const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
        uint32_t kw[2] = {~0u, ~0u};  // keep bits of columns j0 .. j0+15
        if constexpr (DROPOUT) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            kw[r] = rows[r] < N ? keep_window(bits, off + rows[r] * N + j0) : 0u;
        }
        float ds[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = 8 * n + 2 * t4 + (e & 1), i = rows[r], j = j0 + col;
            const bool valid = full || (i < N && j < N && dual_query_allowed(i, j, ns));
            float sg, pd, dsg;
            probs<DROPOUT>(s[n][e], p[n][e], l2[r], valid, (kw[r] >> col) & 1u, scale2, ik,
                           sg, pd, dsg);
            if (sweep == 0) {
              rsum[r] = fmaf(dsg, sg, rsum[r]);
            } else {
              const float rowsum = DELTA_FROM_O ? rs[rows[r]] : rsum[r];
              ds[n][e] = sg * (dsg - rowsum) * a.scale;
            }
          }
        if (sweep == 1) {
          uint32_t hi[4], lo[4];
          to_a<ROUND>(ds, hi, lo);
          acc_times_rows<DH, ROUND>(dq, hi, lo, ks, j0, lane);
        }
      }
      if (sweep == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
          if (t4 == 0) rs[rows[r]] = rsum[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= N) continue;
      bf16* out = a.dq + head_x_offset(a) + rows[r] * a.x_tok + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
  __syncthreads();  // rowsum of every row

  // ---- pass 2: columns -> dk, dv ----
  for (int jt = warp; jt < T; jt += kHeadWarps) {
    const int j0 = jt * 16;
    const int keys[2] = {j0 + g, j0 + g + 8};
    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int it = 0; it < T; ++it) {
      const int i0 = it * 16;
      uint32_t ka[KS][4], va[KS][4];
      load_a<DH>(ka, ks, j0, lane);
      load_a<DH>(va, vs, j0, lane);
      float st[2][4], pt[2][4];  // S^T, dP^T: rows are keys, columns queries
      two_products<DH>(st, pt, ka, va, qs, gs, i0, lane);
      const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
      float pd[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + 8 * n + 2 * t4 + c;
          const float l2 = ls[i], rsum = rs[i];
          uint32_t kw = ~0u;  // keep bits of keys j0 .. j0+15 in row i
          if constexpr (DROPOUT) kw = i < N ? keep_window(bits, off + i * N + j0) : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = keys[r], e = 2 * r + c;
            const bool valid = full || (i < N && j < N && dual_query_allowed(i, j, ns));
            float sg, dsg;
            probs<DROPOUT>(st[n][e], pt[n][e], l2, valid, (kw >> (j - j0)) & 1u, scale2, ik,
                           sg, pd[n][e], dsg);
            ds[n][e] = sg * (dsg - rsum) * a.scale;
          }
        }
      uint32_t hi[4], lo[4];
      to_a<ROUND>(pd, hi, lo);
      acc_times_rows<DH, ROUND>(dv, hi, lo, gs, i0, lane);
      to_a<ROUND>(ds, hi, lo);
      acc_times_rows<DH, ROUND>(dk, hi, lo, qs, i0, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= N) continue;
      const long long o = head_x_offset(a) + keys[r] * a.x_tok + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + o + 8 * n) =
            __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + o + 8 * n) =
            __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <int DH, bool ROUND, bool DROPOUT, bool DELTA_FROM_O>
cudaError_t launch_head_bwd_t(const MmaBwdArgs& a, cudaStream_t stream) {
  const size_t smem = head_bwd_smem_bytes(a.N, DH, DROPOUT);
  cudaError_t err = allow_smem(attn_bwd_head_kernel<DH, ROUND, DROPOUT, DELTA_FROM_O>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_head_kernel<DH, ROUND, DROPOUT, DELTA_FROM_O>
      <<<a.B * a.H, kHeadWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dh in {16, 32, 64} -> one instantiation
template <bool ROUND, bool DROPOUT, bool DELTA_FROM_O = false>
cudaError_t launch_head_bwd(int DH, const MmaBwdArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0 ||
      static_cast<long long>(a.B) * a.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_head_bwd_t<16, ROUND, DROPOUT, DELTA_FROM_O>(a, stream);
    case 32: return launch_head_bwd_t<32, ROUND, DROPOUT, DELTA_FROM_O>(a, stream);
    case 64: return launch_head_bwd_t<64, ROUND, DROPOUT, DELTA_FROM_O>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
