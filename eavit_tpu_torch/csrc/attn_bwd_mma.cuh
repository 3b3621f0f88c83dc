// Attention backward on Hopper's tensor cores for bf16 inputs, in two kernels
// that stream their operands so that no buffer grows with N: the template of
// K1b (csrc/flash_qkv_bwd.cu, from the merged qkv projection), K3b
// (csrc/flash_dropout.cu, on [B*H, N, Dh] with probability dropout), K4b
// (csrc/flash.cu, on [B*H, N, Dh], no dropout, delta from the forward's O)
// and K5q / K5kv (csrc/flash_stream.cu, on [B*H, N, Dh], no dropout, delta
// given), which launch the dq and the dk/dv kernel as two functions. Their
// float32 forms run on flash_stream.cuh's CUDA-core template, whose
// products stay in float32 as the JAX kernels' do.
//
// What it computes, per batch row b and head h (lse from the forward):
//   s      = q k^T * scale (f32), the dual-query mask when num_special > 0
//   sigma  = exp(s - lse)                        (0 where masked or padded)
//   keep   = the forward's mask: Philox (philox.cuh), stream 0, element
//            ((b*H + h)*N + i)*N + j, keep = (bits >> 8) < thresh
//   pd     = keep ? sigma * inv_keep : 0,  dsigma = keep ? (dO v^T) * inv_keep : 0
//   rowsum = sum_j dsigma * sigma            (f32, from the unrounded sigma;
//            ROWTERM = kRowsum, K1b and K3b), or delta = sum_d dO * O from
//            the O the forward wrote (kDeltaFromO, K4b,
//            eavit_tpu/ops/flash.py:179), or the caller's delta (kGiven, K5,
//            eavit_tpu/ops/flash_stream.py:273-274)
//   ds     = sigma * (dsigma - rowsum) * scale
//   dv = pd^T dO,  dq = ds k,  dk = ds^T q
// with every sum in f32. The kernels differ in how pd and ds enter their
// products, which the template parameter ROUND selects:
//   K1b (eavit_tpu/ops/flash_qkv.py `_head_bwd`, 266-302): pd and ds are
//     rounded to bf16 (`pd.astype(dt)`, `ds.astype(dt)`), so one bf16
//     m16n8k16 mma with f32 accumulation is that kernel's product exactly,
//     apart from the order of the sums;
//   K3b (eavit_tpu/ops/flash_dropout.py `_bwd_kernel`, 150-196), K4b
//     (eavit_tpu/ops/flash.py `_bwd_kernel`, 147-189) and K5q / K5kv
//     (eavit_tpu/ops/flash_stream.py `_bwd_dq_kernel` 183-218,
//     `_bwd_dkv_kernel` 221-262): pd and ds stay f32.
//     Each row of ds sums to about 0, so dq = ds k cancels and a bf16 ds
//     would swamp it: pd and ds enter as two bf16 terms, hi = bf16(x) and
//     lo = bf16(x - hi), two mmas per product (relative error ~2^-17).
// q, k, v and dO are bf16 already and enter as they are.
//
// What bounds it on an H100: bytes (183 MB at the flagship minibatch [256, 8,
// 198, 32], 0.055 ms; K4b also reads O), then the mask: one Philox call of
// ~100 integer operations per four elements, drawn in each pass that needs
// it. The split is FlashAttention-2's, as K5q and K5kv split pallas_stream:
//   dq kernel, one block of kBwdWarps warps per (b, h, chunk of kBwdWarps x 16
//     query rows), each warp owning one 16-row tile; the chunk's Q and dO in
//     shared memory, K and V streamed in tiles of kBwdKeys rows through a
//     double buffer (cp.async). Sweep 0 (K1b, K3b) recomputes S = Q K^T and
//     dP = dO V^T by mma and sums rowsum with quad shuffles; K4b sums delta
//     from O instead. Either is written to a [B, H, N] f32 scratch for the
//     dk/dv kernel. K5 reads the caller's delta and writes nothing but dq.
//     Sweep 1 (the only one but for kRowsum) recomputes S and dP, forms ds
//     and feeds it straight from the accumulators as the A operand of dQ +=
//     dS K (the FlashAttention-2 register re-pack), and writes dq.
//   dk/dv kernel, one block per (b, h, chunk of kBwdWarps x 16 keys), each
//     warp owning 16 keys; the chunk's K and V in shared memory, Q and dO
//     streamed in tiles with their lse and rowsum (or delta). It forms S^T =
//     K Q^T and dP^T = V dO^T, so that pd^T and ds^T come out in the
//     accumulator layout and feed dV += pd^T dO and dK += ds^T Q as A
//     operands from registers. It reads the row term of each streamed query
//     row and never writes it, so K5kv may run first, or alone.
// Every output has one owner and every sum a fixed order: no float atomics,
// equal bits twice. Shared memory is (2 x kBwdWarps x 16 + 4 kBwdKeys) rows of
// Dh + 8 bf16 (the dk/dv kernel also 4 kBwdKeys floats), whatever N is: 30 KB
// at Dh 32. The mask is drawn in registers where it is used (mma_common.cuh):
// the dq kernel's quads draw the next four groups of their rows for each
// 16-key step (keep_rows_step), the dk/dv kernel's the four or five groups of the
// 16 keys of each query row of a block and hand them across the warp
// (keep_block_t). B operands come from shared memory by ldmatrix (.trans
// where the token axis is the product's depth). See PERF.md for the times.
#pragma once

#include <cstdint>

#include "mma_common.cuh"

namespace {

// Warps of a block, each owning one 16-row tile (query rows in the dq kernel,
// keys in the dk/dv kernel), keys or queries of a streamed tile, and blocks
// per SM that the register budget must allow at Dh <= 32 (128 registers).
// The A fragments of a warp's own tile are reloaded by ldmatrix at every
// step rather than held. tune_attn_bwd.py measures these choices: eight
// warps at 80 registers spilled up to 84 bytes; at [16, 8, 786, 32] eight
// warps x two blocks ran 1.05x slower than this, 128-key tiles no faster.
constexpr int kBwdWarps = 4;
constexpr int kBwdKeys = 64;
constexpr int kBwdMinBlocks = 4;

// Operand layout of one kernel: element (b, h, token t, dim d) of q, k, v, dq,
// dk and dv sits at ptr + b*x_batch + h*x_head + t*x_tok + d; of dO (and O)
// with the g_ strides. K1b: the merged qkv [B, N, 3*H*Dh]; K3b and K4b:
// [B*H, N, Dh] with H = 1. lse and the row term are [B, H, N].
struct MmaBwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;  // dO
  const __nv_bfloat16* o;  // the forward's output, kDeltaFromO only
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;
  const float* rowterm;  // rowsum or delta as the dk/dv kernel (and the dq kernel
                         // under kGiven) reads it
  float* rowterm_out;    // the same buffer, where the dq kernel writes it under
                         // kDeltaFromO and kRowsum
  long long x_batch, x_head, x_tok;
  long long g_batch, g_head, g_tok;
  int B, H, N;
  float scale;
  int num_special;
  uint32_t thresh;  // dropout only
  float inv_keep;
  uint32_t s0, s1;
};

// The arguments of a backward on contiguous [B*H, N, Dh] operands (K3b, K4b,
// K5q, K5kv): H = 1, dO laid out as q, no dropout; the caller adds O, the row
// term and the mask where its kernel takes them
inline MmaBwdArgs mma_bwd_head_major(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, void* dq, void* dk,
                                     void* dv, int BH, int N, int DH, float scale,
                                     int num_special) {
  using bf16 = __nv_bfloat16;
  MmaBwdArgs a{};
  a.q = static_cast<const bf16*>(q), a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v), a.g = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq), a.dk = static_cast<bf16*>(dk), a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse), a.scale = scale, a.num_special = num_special;
  a.inv_keep = 1.f;
  mma_head_major(a, BH, N, DH);
  a.g_batch = a.x_batch, a.g_head = 0, a.g_tok = DH;
  return a;
}

// shared memory of one block of either kernel: its chunk's two operands and
// two double-buffered streamed ones (the dk/dv kernel adds the streamed rows'
// lse and rowterm)
constexpr size_t mma_dq_smem_bytes(int DH) {
  return static_cast<size_t>(2 * kBwdWarps * 16 + 4 * kBwdKeys) * mma_ld(DH) *
         sizeof(__nv_bfloat16);
}
constexpr size_t mma_dkv_smem_bytes(int DH) {
  return mma_dq_smem_bytes(DH) + 4 * kBwdKeys * sizeof(float);
}

// s[2] (16 x 16) = A (16 x DH) * Y[tok0 .. tok0+15]^T, and p[2] likewise with
// a second pair: the score tiles of one 16 x 16 block
template <int DH>
__device__ __forceinline__ void two_products(float (&s)[2][4], float (&p)[2][4],
                                             const uint32_t (&a)[DH / 16][4],
                                             const uint32_t (&b)[DH / 16][4],
                                             const __nv_bfloat16* ys, const __nv_bfloat16* zs,
                                             int tok0, int lane) {
  constexpr int LD = mma_ld(DH);
  const int row = tok0 + (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = p[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t y[4], z[4];
    ldsm_x4(y, ys + row * LD + ks * 16 + col);
    ldsm_x4(z, zs + row * LD + ks * 16 + col);
    mma_bf16(s[0], a[ks], y[0], y[1]);
    mma_bf16(s[1], a[ks], y[2], y[3]);
    mma_bf16(p[0], b[ks], z[0], z[1]);
    mma_bf16(p[1], b[ks], z[2], z[3]);
  }
}

// sigma, pd and dsigma of one score element
template <bool DROPOUT>
__device__ __forceinline__ void probs(float s, float dp, float lse2, bool valid, bool kept,
                                      float scale2, float inv_keep, float& sg, float& pd,
                                      float& dsg) {
  sg = valid ? ex2(fmaf(s, scale2, -lse2)) : 0.f;
  if constexpr (DROPOUT) {
    pd = kept ? sg * inv_keep : 0.f;
    dsg = kept ? dp * inv_keep : 0.f;
  } else {
    pd = sg;
    dsg = dp;
  }
}

// The block's (b, h) and chunk: blockIdx.x = bh * chunks + chunk
__device__ __forceinline__ void block_chunk(const MmaBwdArgs& a, int& bh, int& c0) {
  const int chunks = (a.N + kBwdWarps * 16 - 1) / (kBwdWarps * 16);
  bh = blockIdx.x / chunks;
  c0 = (blockIdx.x % chunks) * (kBwdWarps * 16);
}

// The block's offset into q, k, v and their gradients, recomputed where the
// gradients are written: a value the compiler kept across the loop cost a
// spill (the volatile read of ctaid stops it from hoisting)
__device__ __forceinline__ long long block_x_offset(const MmaBwdArgs& a) {
  unsigned blk;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(blk));
  const int chunks = (a.N + kBwdWarps * 16 - 1) / (kBwdWarps * 16);
  const unsigned bh = blk / chunks;
  return static_cast<long long>(bh / a.H) * a.x_batch +
         static_cast<long long>(bh % a.H) * a.x_head;
}

// ---- dq: one block per (b, h, chunk of query rows), K and V streamed ----
template <int DH, bool ROUND, bool DROPOUT, int ROWTERM>
__global__ void __launch_bounds__(kBwdWarps * 32, DH >= 64 ? 1 : kBwdMinBlocks)
    attn_dq_mma_kernel(MmaBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = mma_ld(DH), KS = DH / 16, NT = DH / 8, KT = kBwdKeys;
  constexpr int ROWS = kBwdWarps * 16;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [ROWS][LD]
  bf16* gs = qs + ROWS * LD;                  // [ROWS][LD] dO
  bf16* ks = gs + ROWS * LD;                  // [2][KT][LD]
  bf16* vs = ks + 2 * KT * LD;                // [2][KT][LD]

  int bh, q0;
  block_chunk(a, bh, q0);
  const int N = a.N, T = (N + KT - 1) / KT;
  const int b = bh / a.H, h = bh % a.H;
  const long long xo = b * a.x_batch + h * a.x_head, go = b * a.g_batch + h * a.g_head;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int i0 = q0 + warp * 16;
  const bool active = i0 < N;  // warp-uniform: a tile past N only loads and syncs
  const int rows[2] = {i0 + g, i0 + g + 8};
  const bool live[2] = {rows[0] < N, rows[1] < N};
  constexpr int SWEEPS = ROWTERM == kRowsum ? 2 : 1;  // sweep 0 sums rowsum

  auto issue = [&](int s) {
    const int t = s % T, buf = s & 1;
    load_rows<DH>(ks + buf * KT * LD, a.k + xo, a.x_tok, t * KT, KT, N);
    load_rows<DH>(vs + buf * KT * LD, a.v + xo, a.x_tok, t * KT, KT, N);
    cp_async_commit();
  };
  load_rows<DH>(qs, a.q + xo, a.x_tok, q0, ROWS, N);
  load_rows<DH>(gs, a.g + go, a.g_tok, q0, ROWS, N);
  issue(0);  // Q and dO ride in the first group

  float l2[2], rterm[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l2[r] = live[r] ? a.lse[static_cast<long long>(bh) * N + rows[r]] * kLog2e : 0.f;
  if constexpr (ROWTERM == kGiven) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rterm[r] = live[r] ? a.rowterm[static_cast<long long>(bh) * N + rows[r]] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float scale2 = a.scale * kLog2e, ik = DROPOUT ? a.inv_keep : 1.f;
  const int ns = a.num_special;
  const uint64_t e_head = static_cast<uint64_t>(bh) * N * N;
  uint32_t kcur[2];  // keep bits of the current 16-key step (keep_rows_step)
  const uint64_t e_row = e_head + static_cast<uint64_t>(rows[0]) * N;  // row g's key 0

  for (int s = 0; s < SWEEPS * T; ++s) {
    if (s + 1 < SWEEPS * T) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = s % T, sweep = SWEEPS == 1 ? 1 : s / T;
    const bf16* kt = ks + (s & 1) * KT * LD;
    const bf16* vt = vs + (s & 1) * KT * LD;
    if (active) {
      if constexpr (ROWTERM == kDeltaFromO) {
        if (s == 0) {
          // delta = sum_d dO * O in f32: lane t4 of quad g sums a quarter of
          // the dims of rows g and g+8 (O from global memory, dO from shared),
          // then the quad adds its parts
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float part = 0.f;
            if (live[r]) {
              constexpr int DQ = DH / 4;  // 4, 8, 16 or 32 dims
#pragma unroll
              for (int dd = 0; dd < DQ; dd += 2) {
                const int d = t4 * DQ + dd;
                const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    a.o + go + static_cast<long long>(rows[r]) * a.g_tok + d));
                const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    gs + (warp * 16 + g + 8 * r) * LD + d));
                part = fmaf(gf.x, of.x, part);
                part = fmaf(gf.y, of.y, part);
              }
            }
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            rterm[r] = part;
            if (t4 == 0 && live[r])
              a.rowterm_out[static_cast<long long>(bh) * N + rows[r]] = part;
          }
        }
      }
      if constexpr (DROPOUT) {
        if (t == 0) keep_rows_start(kcur, e_row, N, live, t4, a.thresh, a.s0, a.s1);
      }
#pragma unroll
      for (int sb = 0; sb < KT / 16; ++sb) {
        const int j0 = t * KT + sb * 16;
        if (j0 >= N) break;
        // keep bits of keys j0 .. j0+15, drawn before the products so that
        // the Philox rounds and the score fragments are never live together
        uint32_t kw[2] = {~0u, ~0u};
        if constexpr (DROPOUT)
          keep_rows_step(kcur, kw, e_row + j0, N, live, t4, a.thresh, a.s0, a.s1);
        uint32_t qa[KS][4], ga[KS][4];
        load_a<DH>(qa, qs, warp * 16, lane);
        load_a<DH>(ga, gs, warp * 16, lane);
        float sc[2][4], dp[2][4];
        two_products<DH>(sc, dp, qa, ga, kt, vt, sb * 16, lane);
        // every pair valid: no padding and no dual-query mask in the block
        const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
        float ds[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = 8 * n + 2 * t4 + (e & 1), j = j0 + col;
            const bool valid = full || (live[r] && j < N && dual_query_allowed(rows[r], j, ns));
            float sg, pd, dsg;
            probs<DROPOUT>(sc[n][e], dp[n][e], l2[r], valid, (kw[r] >> col) & 1u, scale2, ik,
                           sg, pd, dsg);
            if (sweep == 0) {
              rterm[r] = fmaf(dsg, sg, rterm[r]);
            } else {
              ds[n][e] = sg * (dsg - rterm[r]) * a.scale;
            }
          }
        if (sweep == 1) {
          uint32_t hi[4], lo[4];
          to_a<ROUND>(ds, hi, lo);
          acc_times_rows<DH, ROUND>(dq, hi, lo, kt, sb * 16, lane);
        }
      }
      if (ROWTERM == kRowsum && s == T - 1) {
        // end of sweep 0: the quad adds its columns' parts of rowsum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rterm[r] += __shfl_xor_sync(0xffffffffu, rterm[r], 1);
          rterm[r] += __shfl_xor_sync(0xffffffffu, rterm[r], 2);
          if (t4 == 0 && live[r])
            a.rowterm_out[static_cast<long long>(bh) * N + rows[r]] = rterm[r];
        }
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    bf16* out = a.dq + block_x_offset(a) + rows[r] * a.x_tok + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ---- dk, dv: one block per (b, h, chunk of keys), Q and dO streamed ----
template <int DH, bool ROUND, bool DROPOUT>
__global__ void __launch_bounds__(kBwdWarps * 32, DH >= 64 ? 1 : kBwdMinBlocks)
    attn_dkv_mma_kernel(MmaBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = mma_ld(DH), KS = DH / 16, NT = DH / 8, QT = kBwdKeys;
  constexpr int ROWS = kBwdWarps * 16;
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);  // [ROWS][LD]
  bf16* vs = ks + ROWS * LD;                  // [ROWS][LD]
  bf16* qs = vs + ROWS * LD;                  // [2][QT][LD]
  bf16* gs = qs + 2 * QT * LD;                // [2][QT][LD] dO
  float* ls = reinterpret_cast<float*>(gs + 2 * QT * LD);  // [2][QT] lse * log2(e)
  float* rs = ls + 2 * QT;                                 // [2][QT] rowsum or delta

  int bh, k0;
  block_chunk(a, bh, k0);
  const int N = a.N, T = (N + QT - 1) / QT;
  const int b = bh / a.H, h = bh % a.H;
  const long long xo = b * a.x_batch + h * a.x_head, go = b * a.g_batch + h * a.g_head;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int j0 = k0 + warp * 16;
  const bool active = j0 < N;
  const int keys[2] = {j0 + g, j0 + g + 8};

  auto issue = [&](int t) {
    const int buf = t & 1;
    load_rows<DH>(qs + buf * QT * LD, a.q + xo, a.x_tok, t * QT, QT, N);
    load_rows<DH>(gs + buf * QT * LD, a.g + go, a.g_tok, t * QT, QT, N);
    cp_async_commit();
    for (int r = tid; r < QT; r += blockDim.x) {
      const int i = t * QT + r;
      const long long at = static_cast<long long>(bh) * N + i;
      ls[buf * QT + r] = i < N ? a.lse[at] * kLog2e : 0.f;
      rs[buf * QT + r] = i < N ? a.rowterm[at] : 0.f;
    }
  };
  load_rows<DH>(ks, a.k + xo, a.x_tok, k0, ROWS, N);
  load_rows<DH>(vs, a.v + xo, a.x_tok, k0, ROWS, N);
  issue(0);  // K and V ride in the first group

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e, ik = DROPOUT ? a.inv_keep : 1.f;
  const int ns = a.num_special;
  const uint64_t e_head = static_cast<uint64_t>(bh) * N * N;

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + (t & 1) * QT * LD;
    const bf16* gt = gs + (t & 1) * QT * LD;
    const float* lt = ls + (t & 1) * QT;
    const float* rt = rs + (t & 1) * QT;
    if (active) {
#pragma unroll
      for (int sb = 0; sb < QT / 16; ++sb) {
        const int i0 = t * QT + sb * 16;
        if (i0 >= N) break;
        // bit 16 n + 8 r + g of kw[c]: see keep_block_t; drawn before the
        // products, as in the dq kernel
        uint32_t kw[2] = {~0u, ~0u};
        if constexpr (DROPOUT) keep_block_t(kw, e_head, N, i0, j0, lane, a.thresh, a.s0, a.s1);
        uint32_t ka[KS][4], va[KS][4];
        load_a<DH>(ka, ks, warp * 16, lane);
        load_a<DH>(va, vs, warp * 16, lane);
        float st[2][4], pt[2][4];  // S^T, dP^T: rows are keys, columns queries
        two_products<DH>(st, pt, ka, va, qt, gt, sb * 16, lane);
        const bool full = i0 + 16 <= N && j0 + 16 <= N && (ns == 0 || (i0 >= ns && j0 >= ns));
        float pd[2][4], ds[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int il = sb * 16 + 8 * n + 2 * t4 + c, i = t * QT + il;
            const float l2 = lt[il], rsum = rt[il];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = keys[r], e = 2 * r + c;
              const bool valid = full || (i < N && j < N && dual_query_allowed(i, j, ns));
              float sg, dsg;
              probs<DROPOUT>(st[n][e], pt[n][e], l2, valid, (kw[c] >> (16 * n + 8 * r + g)) & 1u,
                             scale2, ik, sg, pd[n][e], dsg);
              ds[n][e] = sg * (dsg - rsum) * a.scale;
            }
          }
        uint32_t hi[4], lo[4];
        to_a<ROUND>(pd, hi, lo);
        acc_times_rows<DH, ROUND>(dv, hi, lo, gt, sb * 16, lane);
        to_a<ROUND>(ds, hi, lo);
        acc_times_rows<DH, ROUND>(dk, hi, lo, qt, sb * 16, lane);
      }
    }
    __syncthreads();  // the buffers are refilled two steps on
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= N) continue;
    const long long o = block_x_offset(a) + keys[r] * a.x_tok + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + o + 8 * n) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + o + 8 * n) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// The grid of either kernel: one block per (b, h, chunk of kBwdWarps x 16 rows)
inline bool mma_bwd_grid(const MmaBwdArgs& a, unsigned& grid) {
  const long long chunks = (a.N + kBwdWarps * 16 - 1) / (kBwdWarps * 16);
  const long long blocks = chunks * a.B * a.H;
  grid = static_cast<unsigned>(blocks);
  return blocks <= 0x7fffffffLL;
}

template <int DH, bool ROUND, bool DROPOUT, int ROWTERM>
cudaError_t launch_mma_dq_t(const MmaBwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = mma_dq_smem_bytes(DH);
  const cudaError_t err = allow_smem(attn_dq_mma_kernel<DH, ROUND, DROPOUT, ROWTERM>, smem);
  if (err != cudaSuccess) return err;
  unsigned grid;
  if (!mma_bwd_grid(a, grid)) return cudaErrorInvalidValue;
  attn_dq_mma_kernel<DH, ROUND, DROPOUT, ROWTERM><<<grid, kBwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, bool ROUND, bool DROPOUT>
cudaError_t launch_mma_dkv_t(const MmaBwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = mma_dkv_smem_bytes(DH);
  const cudaError_t err = allow_smem(attn_dkv_mma_kernel<DH, ROUND, DROPOUT>, smem);
  if (err != cudaSuccess) return err;
  unsigned grid;
  if (!mma_bwd_grid(a, grid)) return cudaErrorInvalidValue;
  attn_dkv_mma_kernel<DH, ROUND, DROPOUT><<<grid, kBwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The dq kernel alone, Dh in {16, 32, 64, 128}
template <bool ROUND, bool DROPOUT, int ROWTERM>
cudaError_t launch_mma_dq(int DH, const MmaBwdArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_mma_dq_t<16, ROUND, DROPOUT, ROWTERM>(a, stream);
    case 32: return launch_mma_dq_t<32, ROUND, DROPOUT, ROWTERM>(a, stream);
    case 64: return launch_mma_dq_t<64, ROUND, DROPOUT, ROWTERM>(a, stream);
    case 128: return launch_mma_dq_t<128, ROUND, DROPOUT, ROWTERM>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The dk/dv kernel alone: a.rowterm must hold the row term of every row
template <bool ROUND, bool DROPOUT>
cudaError_t launch_mma_dkv(int DH, const MmaBwdArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_mma_dkv_t<16, ROUND, DROPOUT>(a, stream);
    case 32: return launch_mma_dkv_t<32, ROUND, DROPOUT>(a, stream);
    case 64: return launch_mma_dkv_t<64, ROUND, DROPOUT>(a, stream);
    case 128: return launch_mma_dkv_t<128, ROUND, DROPOUT>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K1b, K3b and K4b: the dq kernel, which writes the row term to
// a.rowterm_out, then the dk/dv kernel, which reads it (a.rowterm, the same
// scratch)
template <bool ROUND, bool DROPOUT, int ROWTERM = kRowsum>
cudaError_t launch_mma_bwd(int DH, const MmaBwdArgs& a, cudaStream_t stream) {
  const cudaError_t err = launch_mma_dq<ROUND, DROPOUT, ROWTERM>(DH, a, stream);
  if (err != cudaSuccess) return err;
  return launch_mma_dkv<ROUND, DROPOUT>(DH, a, stream);
}

// shared-memory bytes of each kernel at head width DH (any N); which: 0 = dq,
// 1 = dk/dv
inline size_t mma_bwd_smem_by_dh(int DH, int which) {
  if (DH != 16 && DH != 32 && DH != 64 && DH != 128) return 0;
  return which == 0 ? mma_dq_smem_bytes(DH) : mma_dkv_smem_bytes(DH);
}

}  // namespace
