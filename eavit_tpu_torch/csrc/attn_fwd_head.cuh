// The whole-head form of the bf16 K1f (csrc/flash_qkv.cu): the tensor-core
// forward of attn_fwd_mma.cuh's K1f instantiation (same function, same
// operand layout, same two sweeps; ROUND, sigma' rounded to bf16), with the
// head's q, k and v held in shared memory instead of streamed. One block of
// kHeadFwdWarps warps per (b, h); the head's q, k and v as bf16 (cp.async,
// rows padded by 16 bytes, N padded to 16 with zero rows; 52 KB at N = 198,
// Dh = 32), each warp owning one 16-query tile at a time. A warp draws the
// keep bits of its own 16 rows, 16 N contiguous mask elements, into a
// bitmap of its own (draw_keep_chunk) before sweep A, so every group of the
// mask is drawn once. Shared memory grows with N, so the wrapper runs this
// kernel only where it fits and where it is the faster one (N <= 256): at
// the flagship N = 198 the streaming kernel of attn_fwd_mma.cuh ran 1.23x
// slower, at N = 443 0.87x (PERF.md). See attn_fwd_mma.cuh for what it
// computes.
#pragma once

#include <cstdint>

#include "attn_fwd_mma.cuh"
#include "mma_head_bits.cuh"

namespace {

// Warps of a block and the blocks per SM the register budget must allow at
// Dh <= 32: four blocks of 53 KB at N = 198 (64 registers, no spills).
// tune_attn_bwd.py measures these choices: at [256, 8, 198, 32] rate 0.1,
// 3 blocks / 2 blocks / 16 warps x 2 blocks ran 1.13 / 1.12 / 1.06x this.
constexpr int kHeadFwdWarps = 8;
constexpr int kHeadFwdMinBlocks = 4;

// Words of one warp's keep bitmap: its 16 rows of the head's mask
__host__ __device__ constexpr int mma_strip_words(int n) {
  return keep_bit_words(16LL * n);
}

size_t head_fwd_smem_bytes(int N, int DH, bool dropout) {
  const size_t np = mma_pad16(N);
  return 3 * np * mma_ld(DH) * sizeof(__nv_bfloat16) +
         (dropout ? kHeadFwdWarps * mma_strip_words(N) * sizeof(uint32_t) : 0);
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kHeadFwdWarps * 32, DH >= 64 ? 1 : kHeadFwdMinBlocks)
    attn_fwd_head_kernel(MmaFwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = mma_ld(DH), KS = DH / 16, NT = DH / 8;
  extern __shared__ float4 smem4[];
  const int N = a.N, Np = mma_pad16(N), T = Np / 16;
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [Np][LD] each
  bf16* ks = qs + Np * LD;
  bf16* vs = ks + Np * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // this warp's keep bitmap, mma_strip_words(N), dropout only
  uint32_t* bits = reinterpret_cast<uint32_t*>(vs + Np * LD) + warp * mma_strip_words(N);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const long long xo = b * a.x_batch + h * a.x_head, oo = b * a.o_batch + h * a.o_head;

  // ---- operands by cp.async, zero rows past N ----
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int c = tid; c < Np * CH; c += blockDim.x) {
    const int t = c / CH, d = (c % CH) * 8, so = t * LD + d;
    if (t < N) {
      const long long x = xo + t * a.x_tok + d;
      cp_async16(qs + so, a.q + x);
      cp_async16(ks + so, a.k + x);
      cp_async16(vs + so, a.v + x);
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(qs + so) = z;
      *reinterpret_cast<uint4*>(ks + so) = z;
      *reinterpret_cast<uint4*>(vs + so) = z;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const float scale2 = a.scale * kLog2e;
  const int ns = a.num_special;
  const uint64_t e_head = static_cast<uint64_t>(bh) * N * N;

  for (int it = warp; it < T; it += kHeadFwdWarps) {
    const int i0 = it * 16;
    const int rows[2] = {i0 + g, i0 + g + 8};
    // keep bits of rows i0 .. i0+15: bit p is element base + p, (i, j) at
    // p = off + (i - i0)*N + j
    const uint64_t e_strip = e_head + static_cast<uint64_t>(i0) * N, base = e_strip & ~31ull;
    const int off = static_cast<int>(e_strip - base);
    if constexpr (DROPOUT) {
      __syncwarp();  // the warp's previous tile has read its windows
      for (int c = 0; c < mma_strip_words(N) / 4; ++c)
        draw_keep_chunk(bits, base, c, lane, a.thresh, a.s0, a.s1);
      __syncwarp();
    }
    uint32_t qa[KS][4];
    load_a<DH>(qa, qs, i0, lane);

    // ---- sweep A: running (max, sum) per lane and row, in log2 units ----
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int jt = 0; jt < T; ++jt) {
      const int j0 = jt * 16;
      float s[2][4];
      score_tile<DH>(s, qa, ks, j0, lane);
      // every pair valid: no padding and no dual-query mask in the tile
      const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x[4], mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + 8 * n + 2 * t4 + c;
            const bool valid = full || (rows[r] < N && j < N && dual_query_allowed(rows[r], j, ns));
            x[2 * n + c] = valid ? s[n][2 * r + c] * scale2 : -INFINITY;
            mt = fmaxf(mt, x[2 * n + c]);
          }
        if (mt > m[r]) {
          l[r] *= ex2(m[r] - mt);  // m = -inf: l is 0 and stays 0
          m[r] = mt;
        }
        if (m[r] != -INFINITY) {
#pragma unroll
          for (int e = 0; e < 4; ++e) l[r] += ex2(x[e] - m[r]);  // ex2(-inf) = 0
        }
      }
    }
    // combine the four lanes of a row: every lane ends with the same bits
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mn = fmaxf(m[r], mo);
        if (mn != -INFINITY) {
          l[r] = (m[r] == -INFINITY ? 0.f : l[r] * ex2(m[r] - mn)) +
                 (mo == -INFINITY ? 0.f : lo * ex2(mo - mn));
        }
        m[r] = mn;
      }
      lse2[r] = m[r] + log2f(l[r]);  // rows past N: never used
    }

    // ---- sweep B: O += bf16(sigma') V ----
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int jt = 0; jt < T; ++jt) {
      const int j0 = jt * 16;
      float s[2][4];
      score_tile<DH>(s, qa, ks, j0, lane);
      const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
      uint32_t kw[2] = {~0u, ~0u};  // keep bits of columns j0 .. j0+15
      if constexpr (DROPOUT) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          kw[r] = rows[r] < N ? keep_window(bits, off + (rows[r] - i0) * N + j0) : 0u;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = 8 * n + 2 * t4 + (e & 1), i = rows[r], j = j0 + col;
          const bool valid = full || (i < N && j < N && dual_query_allowed(i, j, ns));
          float sg = valid ? ex2(fmaf(s[n][e], scale2, -lse2[r])) : 0.f;
          if constexpr (DROPOUT) sg = (kw[r] >> col) & 1u ? sg * a.inv_keep : 0.f;
          s[n][e] = sg;
        }
      uint32_t hi[4], lo[4];
      to_a<true>(s, hi, lo);
      acc_times_rows<DH, true>(acc, hi, lo, vs, j0, lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= N) continue;
      bf16* out = a.o + oo + rows[r] * a.o_tok + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      if (t4 == 0) a.lse[static_cast<long long>(bh) * N + rows[r]] = lse2[r] / kLog2e;
    }
  }
}

template <int DH, bool DROPOUT>
cudaError_t launch_head_fwd_t(const MmaFwdArgs& a, cudaStream_t stream) {
  const size_t smem = head_fwd_smem_bytes(a.N, DH, DROPOUT);
  cudaError_t err = allow_smem(attn_fwd_head_kernel<DH, DROPOUT>, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_head_kernel<DH, DROPOUT><<<a.B * a.H, kHeadFwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dh in {16, 32, 64} -> one instantiation
template <bool DROPOUT>
cudaError_t launch_head_fwd(int DH, const MmaFwdArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0 ||
      static_cast<long long>(a.B) * a.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_head_fwd_t<16, DROPOUT>(a, stream);
    case 32: return launch_head_fwd_t<32, DROPOUT>(a, stream);
    case 64: return launch_head_fwd_t<64, DROPOUT>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
