// Attention forward on Hopper's tensor cores for bf16 inputs, streaming K and
// V so that no buffer grows with N: the template of the bf16 K1f
// (csrc/flash_qkv.cu, from the merged qkv projection), K3f
// (csrc/flash_dropout.cu) and K4f (csrc/flash.cu), both on [B*H, N, Dh].
// Their float32 forms run on flash_stream.cuh's CUDA-core template.
//
// What it computes, per batch row b and head h:
//   s      = q k^T * scale (f32), the dual-query mask when num_special > 0
//   m, l   = max_j s, sum_j exp(s - m);  lse = m + log l
//   sigma  = exp(s - lse)                       (0 where masked or padded)
//   keep   = Philox (philox.cuh), stream 0, element ((b*H + h)*N + i)*N + j,
//            keep = (bits >> 8) < thresh (DROPOUT only)
//   sigma' = keep ? sigma * inv_keep : 0
//   o      = sigma' v with f32 accumulation, written in bf16
// ROUND selects how sigma' enters o = sigma' v:
//   K1f (eavit_tpu/ops/flash_qkv.py `_head_fwd`, 223-239) rounds the
//     normalised, dropped sigma' to bf16, so one bf16 mma with f32
//     accumulation is its product exactly, apart from the order of the sums;
//   K3f (eavit_tpu/ops/flash_dropout.py `_fwd_kernel`, 123-147) and K4f
//     (eavit_tpu/ops/flash.py `_fwd_kernel`, 74-104, at rate 0: o = (p / l) v)
//     keep sigma' f32: it enters as two bf16 terms, hi = bf16(x) and lo =
//     bf16(x - hi), two mmas per product (relative error ~2^-17).
// K1f's rounding after normalising and dropping is part of its function, and
// an online softmax (an FA-2 accumulator rescaled as the maximum moves) would
// round other numbers, so the kernel takes two sweeps over the keys:
//   A. S = Q K^T over 16-key steps; each lane keeps a running (max, sum) of
//      its columns, and a quad-shuffle combine gives the row's lse;
//   B. S again; sigma' = exp2(s scale log2e - lse log2e) * keep * inv_keep
//      straight from the accumulators as the A operand of O += sigma' V
//      (V by ldmatrix.trans), the register re-pack of attn_bwd_mma.cuh.
// Three N^2 Dh products, all bf16 mma.sync m16n8k16 with f32 accumulators
// (four with hi + lo). K3f and K4f take these two sweeps too.
//
// ONE_SWEEP (K5f, csrc/flash_stream.cu: eavit_tpu/ops/flash_stream.py
// `_fwd_kernel`, 99-137, rounds nothing and draws no mask) is the online
// softmax instead: K and V stream together in one sweep; per 16-key step
// S = Q K^T, the quad's lanes agree on the row's running maximum m (two
// shuffles), the accumulator and each lane's partial sum l are rescaled by
// exp2(m_old - m_new) as m moves, and the unnormalised p = exp2(s - m) enters
// O += p V as hi + lo bf16 terms; at the end the quad's sums are combined,
// o = acc / l and lse = m + log l. Two N^2 Dh products (three mmas with hi +
// lo). Only ROUND = false and DROPOUT = false take it: K1f rounds sigma'
// after normalising, which the running rescale cannot reproduce.
//
// What bounds it on an H100: bytes (26 MB at the act shape [64, 198, 768],
// 0.008 ms; 105 MB at the minibatch), then the exp and the mask (one Philox
// call per four elements at rate 0.1). The design: one block of kFwdWarps
// warps per (b, h, chunk of kFwdWarps x 16 query rows), each warp owning one
// 16-row tile, so every output has one owner and every sum a fixed order
// (equal bits twice, no atomics). The chunk's Q is loaded once; K and V come
// in tiles of kFwdKeys rows through a double buffer filled by cp.async (rows
// padded by 16 bytes so that ldmatrix reads without bank conflicts, zero rows
// past N): sweep A streams K, sweep B (and ONE_SWEEP's only sweep) K and V.
// Shared memory is (kFwdWarps x 16 + 4 kFwdKeys) rows of Dh + 8 bf16,
// whatever N is: 30 KB at Dh 32. The mask is drawn in registers in sweep B
// (keep_rows_step, mma_common.cuh): the four lanes of a quad draw the next
// four groups of their row for each 16-key step, so every group of the mask
// is drawn once. See PERF.md for the times.
#pragma once

#include <cstdint>

#include "mma_common.cuh"

namespace {

// Warps of a block (one 16-row tile each), keys of a streamed tile, the
// blocks per SM the register budget must allow at Dh <= 32 with the mask (80
// registers) and without it (64; one sweep too: three blocks ran K5f 1.09x
// slower), and the 16-key steps of a tile the compiler may interleave with
// the mask (without it, all of a tile's): interleaving
// overlaps the steps' loads and Philox rounds but costs registers, and at 80
// the masked kernels spilled 4-12 bytes. tune_attn_bwd.py measures these
// choices: at [256, 8, 198, 32] two blocks ran K3f 1.17x and K4f 1.35x
// slower than this, 128-key tiles no faster, four warps slower.
constexpr int kFwdWarps = 8;
constexpr int kFwdKeys = 64;
constexpr int kFwdMinBlocks = 3;
constexpr int kFwdMinBlocksNoMask = 4;
constexpr int kFwdStepUnroll = 1;

// Operand layout: element (b, h, token t, dim d) of q, k and v sits at
// ptr + b*x_batch + h*x_head + t*x_tok + d, of o with the o_ strides; lse is
// [B, H, N]. K1f: the merged qkv [B, N, 3*H*Dh] and o [B, N, H*Dh]; K3f and
// K4f: [B*H, N, Dh] with H = 1.
struct MmaFwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  long long x_batch, x_head, x_tok;
  long long o_batch, o_head, o_tok;
  int B, H, N;
  float scale;
  int num_special;
  uint32_t thresh;  // dropout only
  float inv_keep;
  uint32_t s0, s1;
};

// shared memory of one block: the chunk's Q and two K and two V tiles
constexpr size_t mma_fwd_smem_bytes(int DH) {
  return static_cast<size_t>(kFwdWarps * 16 + 4 * kFwdKeys) * mma_ld(DH) *
         sizeof(__nv_bfloat16);
}

// s[2] (16 x 16) = A (16 x DH) * Y[tok0 .. tok0+15]^T: the scores of one
// 16 x 16 block
template <int DH>
__device__ __forceinline__ void score_tile(float (&s)[2][4], const uint32_t (&a)[DH / 16][4],
                                           const __nv_bfloat16* ys, int tok0, int lane) {
  constexpr int LD = mma_ld(DH);
  const int row = tok0 + (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t y[4];
    ldsm_x4(y, ys + row * LD + ks * 16 + col);
    mma_bf16(s[0], a[ks], y[0], y[1]);
    mma_bf16(s[1], a[ks], y[2], y[3]);
  }
}

template <int DH, bool ROUND, bool DROPOUT, bool ONE_SWEEP = false>
__global__ void __launch_bounds__(kFwdWarps * 32,
                                  DH >= 64 ? 1 : DROPOUT ? kFwdMinBlocks : kFwdMinBlocksNoMask)
    attn_fwd_mma_kernel(MmaFwdArgs a) {
  static_assert(!ONE_SWEEP || (!ROUND && !DROPOUT),
                "one sweep rescales p online: no rounding of sigma', no mask");
  using bf16 = __nv_bfloat16;
  constexpr int LD = mma_ld(DH), KS = DH / 16, NT = DH / 8, KT = kFwdKeys;
  constexpr int ROWS = kFwdWarps * 16;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [ROWS][LD]
  bf16* ks = qs + ROWS * LD;                  // [2][KT][LD]
  bf16* vs = ks + 2 * KT * LD;                // [2][KT][LD]

  const int N = a.N, chunks = (N + ROWS - 1) / ROWS, T = (N + KT - 1) / KT;
  const int bh = blockIdx.x / chunks, q0 = (blockIdx.x % chunks) * ROWS;
  const int b = bh / a.H, h = bh % a.H;
  const long long xo = b * a.x_batch + h * a.x_head;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int i0 = q0 + warp * 16;
  const bool active = i0 < N;  // warp-uniform: a tile past N only loads and syncs
  const int rows[2] = {i0 + g, i0 + g + 8};
  const bool live[2] = {rows[0] < N, rows[1] < N};
  const float scale2 = a.scale * kLog2e;
  const int ns = a.num_special;

  // two sweeps: steps 0 .. T-1 stream K tiles (sweep A), T .. 2T-1 K and V
  // tiles (sweep B); ONE_SWEEP: steps 0 .. T-1 stream K and V tiles
  const int S = ONE_SWEEP ? T : 2 * T, B0 = ONE_SWEEP ? 0 : T;  // B0: first PV step
  auto issue = [&](int s) {
    const int t = s < T ? s : s - T, buf = s & 1;
    load_rows<DH>(ks + buf * KT * LD, a.k + xo, a.x_tok, t * KT, KT, N);
    if (s >= B0) load_rows<DH>(vs + buf * KT * LD, a.v + xo, a.x_tok, t * KT, KT, N);
    cp_async_commit();
  };
  load_rows<DH>(qs, a.q + xo, a.x_tok, q0, ROWS, N);
  issue(0);  // Q rides in the first group

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t kcur[2];  // keep bits of the current 16-key step (keep_rows_step)
  const uint64_t e_row = (static_cast<uint64_t>(bh) * N + rows[0]) * N;  // row g's key 0

  for (int s = 0; s < S; ++s) {
    if (s + 1 < S) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = s < T ? s : s - T;
    const bf16* kt = ks + (s & 1) * KT * LD;
    const bf16* vt = vs + (s & 1) * KT * LD;
    if (active) {
      if (!ONE_SWEEP && s == T) {
        // end of sweep A: combine the four lanes of a row, so that every lane
        // ends with the same bits
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
        if constexpr (DROPOUT) keep_rows_start(kcur, e_row, N, live, t4, a.thresh, a.s0, a.s1);
      }
#pragma unroll(DROPOUT ? kFwdStepUnroll : kFwdKeys / 16)
      for (int sb = 0; sb < KT / 16; ++sb) {
        const int j0 = t * KT + sb * 16;
        if (j0 >= N) break;
        // keep bits of keys j0 .. j0+15, drawn before the scores exist so
        // that the Philox rounds and the score fragments are never live
        // together
        uint32_t kw[2] = {~0u, ~0u};
        if constexpr (DROPOUT) {
          if (s >= T) keep_rows_step(kcur, kw, e_row + j0, N, live, t4, a.thresh, a.s0, a.s1);
        }
        // the warp's Q fragments, reloaded at every step rather than held in
        // registers: that keeps three blocks per SM without spills
        uint32_t qa[KS][4];
        load_a<DH>(qa, qs, warp * 16, lane);
        float sc[2][4];
        score_tile<DH>(sc, qa, kt, sb * 16, lane);
        // every pair valid: no padding and no dual-query mask in the block
        const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
        if constexpr (ONE_SWEEP) {
          // ---- online softmax: O += p V with p = exp2(s - m), m the row's
          // running maximum, which the quad's four lanes share ----
          float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, j = j0 + 8 * n + 2 * t4 + (e & 1);
              const bool valid = full || (rows[r] < N && j < N &&
                                          dual_query_allowed(rows[r], j, ns));
              sc[n][e] = valid ? sc[n][e] * scale2 : -INFINITY;
              mt[r] = fmaxf(mt[r], sc[n][e]);
            }
          float off[2];  // the exponent's offset: the running maximum, 0 while none
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
            const float mn = fmaxf(m[r], mt[r]);
            off[r] = mn == -INFINITY ? 0.f : mn;  // nothing allowed yet: p = 0
            const float alpha = ex2(m[r] - off[r]);  // m = -inf: 0; unmoved: 1
            l[r] *= alpha;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              acc[n][2 * r] *= alpha;
              acc[n][2 * r + 1] *= alpha;
            }
            m[r] = mn;
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = ex2(sc[n][e] - off[e >> 1]);  // ex2(-inf) = 0
              l[e >> 1] += p;
              sc[n][e] = p;
            }
          uint32_t hi[4], lo[4];
          to_a<false>(sc, hi, lo);
          acc_times_rows<DH, false>(acc, hi, lo, vt, sb * 16, lane);
        } else if (s < T) {
          // ---- sweep A: running (max, sum) per lane and row, log2 units ----
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x[4], mt = -INFINITY;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int j = j0 + 8 * n + 2 * t4 + c;
                const bool valid = full || (rows[r] < N && j < N &&
                                            dual_query_allowed(rows[r], j, ns));
                x[2 * n + c] = valid ? sc[n][2 * r + c] * scale2 : -INFINITY;
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
        } else {
          // ---- sweep B: O += sigma' V ----
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, col = 8 * n + 2 * t4 + (e & 1), j = j0 + col;
              const bool valid = full || (rows[r] < N && j < N &&
                                          dual_query_allowed(rows[r], j, ns));
              float sg = valid ? ex2(fmaf(sc[n][e], scale2, -lse2[r])) : 0.f;
              if constexpr (DROPOUT) sg = (kw[r] >> col) & 1u ? sg * a.inv_keep : 0.f;
              sc[n][e] = sg;
            }
          uint32_t hi[4], lo[4];
          to_a<ROUND>(sc, hi, lo);
          acc_times_rows<DH, ROUND>(acc, hi, lo, vt, sb * 16, lane);
        }
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
  }

  if (!active) return;
  float inv_l[2] = {1.f, 1.f};
  if constexpr (ONE_SWEEP) {
    // the quad's partial sums, in an order that gives every lane the same bits
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv_l[r] = 1.f / l[r];
      lse2[r] = m[r] + log2f(l[r]);  // rows past N: never written
    }
  }
  const long long oo = b * a.o_batch + h * a.o_head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    bf16* out = a.o + oo + rows[r] * a.o_tok + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (ONE_SWEEP) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
            acc[n][2 * r] * inv_l[r], acc[n][2 * r + 1] * inv_l[r]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
    if (t4 == 0) a.lse[static_cast<long long>(bh) * N + rows[r]] = lse2[r] / kLog2e;
  }
}

template <int DH, bool ROUND, bool DROPOUT, bool ONE_SWEEP>
cudaError_t launch_mma_fwd_t(const MmaFwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = mma_fwd_smem_bytes(DH);
  cudaError_t err = allow_smem(attn_fwd_mma_kernel<DH, ROUND, DROPOUT, ONE_SWEEP>, smem);
  if (err != cudaSuccess) return err;
  const long long chunks = (a.N + kFwdWarps * 16 - 1) / (kFwdWarps * 16);
  const long long blocks = chunks * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_fwd_mma_kernel<DH, ROUND, DROPOUT, ONE_SWEEP>
      <<<static_cast<unsigned>(blocks), kFwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dh in {16, 32, 64, 128} -> one instantiation
template <bool ROUND, bool DROPOUT, bool ONE_SWEEP = false>
cudaError_t launch_mma_fwd(int DH, const MmaFwdArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_mma_fwd_t<16, ROUND, DROPOUT, ONE_SWEEP>(a, stream);
    case 32: return launch_mma_fwd_t<32, ROUND, DROPOUT, ONE_SWEEP>(a, stream);
    case 64: return launch_mma_fwd_t<64, ROUND, DROPOUT, ONE_SWEEP>(a, stream);
    case 128: return launch_mma_fwd_t<128, ROUND, DROPOUT, ONE_SWEEP>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// shared-memory bytes of the instantiation at head width DH (any N)
inline size_t mma_fwd_smem_by_dh(int DH) {
  return DH == 16 || DH == 32 || DH == 64 || DH == 128 ? mma_fwd_smem_bytes(DH) : 0;
}

}  // namespace
