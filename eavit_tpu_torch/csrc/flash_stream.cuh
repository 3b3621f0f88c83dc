// The streaming CUDA-core attention template: flash attention that streams K/V
// (forward, dq) or Q/dO (dk, dv) through shared memory in fixed tiles, so that
// no buffer grows with N. It is the float32 K5f, K5q and K5kv
// (csrc/flash_stream.cu, AttentionImpl = pallas_stream) and the float32 forms
// of K1 (flash_qkv.cu, flash_qkv_bwd.cu), K3 (flash_dropout.cu) and K4
// (flash.cu), whose bf16 forms run on the tensor-core templates
// attn_fwd_mma.cuh / attn_bwd_mma.cuh, as the bf16 K5 does.
//
// Operands of K5, K3 and K4 are contiguous [B*H, N, Dh]; K1's (MERGED) are
// taken by strides: element (b, h, token t, dim d) of q, k, v, dq, dk and dv
// sits at ptr + b*x_batch + h*x_head + t*x_tok + d, of dO and o with the g_
// strides (the merged qkv [B, N, 3*H*Dh], o and dO [B, N, H*Dh]). lse and the
// row terms are [B, H, N]. The dual-query mask is applied on
// absolute row and column indices; masked edges contribute exactly 0. Dh is
// 16, 32, 64 or 128; every operand and sum is float32. N is taken as it is.
//
//   forward, one block per (bh, tile of kRows query rows), K/V tiles streamed:
//     s = q k^T * scale, running max m, normaliser l and accumulator acc (the
//     online softmax, one rescale per chunk of keys), o = acc / l, lse = m +
//     log l. DROPOUT (K1f, K3f in float32) multiplies each p by keep *
//     inv_keep in the accumulator, not in l, so o = sum_j keep inv_keep
//     (p_j / l) v_j: at float32 K1f's rounding of sigma' to the input dtype
//     is the identity, and the online softmax computes its function.
//   dq, one block per (bh, query tile), K/V tiles streamed:
//     p = exp(s - lse), dp = dO v^T, dsigma = keep ? dp inv_keep : dp,
//     ds = p (dsigma - rowterm) scale, dq = ds k. The row term is (ROWTERM)
//     kGiven: delta from the caller (K5, sum(dO * O) outside);
//     kDeltaFromO: delta = sum(dO * O) from the forward's O, summed here
//     (K4b, eavit_tpu/ops/flash.py:179); kRowsum: rowsum = sum_j dsigma p from
//     a first sweep over the keys (K1b, K3b: the delta trick is wrong under
//     dropout). The last two write the row term to a [B, H, N] scratch.
//   dk/dv, one block per (bh, key tile), Q/dO tiles streamed with lse and the
//     row term (delta: K5's, or the dq pass's scratch) of their rows:
//     pd = keep ? p inv_keep : 0, dv = pd^T dO, dk = ds^T q.
// This is the FA-2 split: every output element has one owner thread that sums
// in a fixed order, so there are no float atomics and two identical calls
// give equal bits. K5's instantiations (no dropout, row term given) compute
// exactly what they did before the flags existed.
//
// Dropout: Philox4x32-10 (philox.cuh) on the logical index ((b*H + h)*N + i)*N
// + j of the [B, H, N, N] mask, stream 0, keep = (bits >> 8) < thresh
// (ops/kernel_prng.py). The forward draws the groups of each chunk of keys of
// its row, the dq pass those of 32 keys at a time, the dk/dv pass one group
// per element (its keys are the fixed axis).
//
// A thread owns one row (a query row, or a key row in dk/dv) and min(Dh, 16)
// of its dims in registers; at Dh = 32 and 64 two or four neighbouring lanes
// share a row and add their parts of each dot product with shuffles. Every
// lane of a warp reads the same streamed row at a time, so the shared-memory
// reads are broadcasts; the parts of a row sit 20 floats apart, on other
// banks. Each value read from shared memory feeds one FMA per thread, so this
// template is bound by shared-memory bandwidth, not by the FMA units.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kRows = 64;  // rows a block owns
constexpr int kTile = 64;  // rows of a streamed tile
constexpr int kDims = 16;  // most dims of a row one thread owns
// Rows scored at once by one thread. The compiler hoists the shared-memory
// loads of a whole chunk, so registers grow with it: on an H100 the backward
// passes at a chunk of 8 spilled to local memory and ran K5kv 26x slower
// than at 1 (tune_flash_stream.py; PERF.md).
constexpr int kFwdChunk = 8;
constexpr int kBwdChunk = 1;
// The dq pass's chunk loop is unrolled twice (#pragma unroll 2): K5q ran
// faster so, the other passes slower (tune_flash_stream.py, PERF.md).
constexpr int kKeepRun = 32;  // keys whose keep bits the dq pass draws at once
static_assert(kTile % kFwdChunk == 0 && kTile % kBwdChunk == 0, "chunks split a tile");
static_assert(kTile % kKeepRun == 0 && kKeepRun % kBwdChunk == 0, "keep runs split a tile");
static_assert(kDims % 4 == 0 && 64 % kDims == 0, "a thread reads its dims as float4");

// How the DH dims of a row are shared among TPR neighbouring threads, and
// where each thread's DPT dims sit in a shared-memory row.
template <int DH>
struct Split {
  static constexpr int DPT = DH < kDims ? DH : kDims;  // dims a thread owns
  static constexpr int TPR = DH / DPT;                 // threads per row: 1, 2, 4 or 8
  static constexpr int CH = DPT + (TPR > 1 ? 4 : 0);   // floats per part of a row
  static constexpr int RS = TPR * CH;                  // shared-memory row stride
  static constexpr int THREADS = kRows * TPR;
  // rows of a streamed tile: half at Dh 128, so that two tiles stay within
  // the 48 KB of static shared memory a block may hold
  static constexpr int TILE = DH > 64 ? kTile / 2 : kTile;
  static_assert(TILE % kFwdChunk == 0 && TILE % kKeepRun == 0, "chunks and keep runs split a tile");
};

struct StreamArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward
  const void* o;       // kDeltaFromO: the forward's output (g_ strides)
  const float* lse;    // backward
  const float* delta;  // dq with kGiven, and dk/dv: the row term of each row
  float* rowterm;      // dq with kDeltaFromO / kRowsum: where it writes the row term
  void* out;           // forward: o (g_ strides)
  float* lse_out;      // forward
  void* dq;
  void* dk;
  void* dv;
  int H, N;
  long long x_batch, x_head, x_tok;
  long long g_batch, g_head, g_tok;
  float scale;
  int num_special;
  uint32_t thresh;  // DROPOUT only
  float inv_keep;
  uint32_t s0, s1;
};

// shared memory of each kernel: two tiles (K and V, or Q and dO), plus the
// lse and row term of the streamed query rows in dk/dv
template <int DH>
constexpr size_t fwd_smem() { return 2 * sizeof(float) * Split<DH>::TILE * Split<DH>::RS; }
template <int DH>
constexpr size_t dkv_smem() { return fwd_smem<DH>() + 2 * sizeof(float) * Split<DH>::TILE; }

// The keep bits of mask elements e .. e + C - 1 (bit c for e + c), from the
// Philox groups that hold them
template <int C>
__device__ __forceinline__ uint32_t keep_run(uint64_t e, uint32_t thresh, uint32_t s0,
                                             uint32_t s1) {
  static_assert(C <= 32, "one word of keep bits");
  constexpr int NG = (C + 6) / 4;  // groups that C elements at any offset touch
  const uint64_t g0 = e >> 2;
  const int off = static_cast<int>(e & 3u);
  uint64_t m = 0;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    if (4 * k < off + C) {
      const Philox4 r = philox_group(g0 + k, 0u, s0, s1);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        m |= static_cast<uint64_t>((r.w[w] >> 8) < thresh) << (4 * k + w);
    }
  }
  return static_cast<uint32_t>(m >> off);
}

// the keep bit of one mask element
__device__ __forceinline__ bool keep_one(uint64_t e, uint32_t thresh, uint32_t s0, uint32_t s1) {
  const Philox4 r = philox_group(e >> 2, 0u, s0, s1);
  const uint32_t w = (e & 3u) == 0 ? r.w[0] : (e & 3u) == 1 ? r.w[1] : (e & 3u) == 2 ? r.w[2]
                                                                                      : r.w[3];
  return (w >> 8) < thresh;
}

// the sum of a dot product's parts over the TPR threads of a row; every one
// of them gets the same bits (a + b == b + a at each step)
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [t0, t0 + TILE) of a head (row t at src + t * tok) into a
// [TILE][RS] f32 tile; rows at or past N are zero, so the products over them
// stay finite (their weights are 0).
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t tok, int t0,
                                          int N) {
  using S = Split<DH>;
  const int len = min(S::TILE, N - t0);
  for (int idx = threadIdx.x; idx < S::TILE * DH; idx += blockDim.x) {
    const int r = idx / DH, d = idx % DH;
    dst[r * S::RS + (d / S::DPT) * S::CH + d % S::DPT] =
        r < len ? src[static_cast<size_t>(t0 + r) * tok + d] : 0.f;
  }
}

// dims [d0, d0 + DPT) of row `row` of a head into registers (0 past N)
template <int DH>
__device__ __forceinline__ void load_row(float* out, const float* src, size_t tok, int row,
                                         bool live, int d0) {
#pragma unroll
  for (int d = 0; d < Split<DH>::DPT; ++d)
    out[d] = live ? src[static_cast<size_t>(row) * tok + d0 + d] : 0.f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The block's head in the operand layout: its offsets into the x_ and g_
// layouts, and the row stride of each. MERGED is K1's merged qkv, whose
// strides come from the arguments; otherwise the layout is the contiguous
// [B*H, N, Dh] of K3, K4 and K5, whose stride Dh the compiler knows (a
// runtime stride cost K5f a 64-bit multiply per loaded element, 24%).
template <int DH, bool MERGED>
struct Head {
  size_t x, g, x_tok, g_tok;
};
template <int DH, bool MERGED>
__device__ __forceinline__ Head<DH, MERGED> head_of(const StreamArgs a, size_t bh) {
  if constexpr (MERGED) {
    const size_t b = bh / a.H, h = bh % a.H;
    return {b * a.x_batch + h * a.x_head, b * a.g_batch + h * a.g_head,
            static_cast<size_t>(a.x_tok), static_cast<size_t>(a.g_tok)};
  } else {
    const size_t head = bh * a.N * DH;
    return {head, head, DH, DH};
  }
}

template <int DH, bool DROPOUT, bool MERGED>
__global__ void __launch_bounds__(Split<DH>::THREADS) stream_fwd_kernel(StreamArgs a) {
  using S = Split<DH>;
  __shared__ __align__(16) float ks[S::TILE * S::RS];
  __shared__ __align__(16) float vs[S::TILE * S::RS];
  const int N = a.N, ns = a.num_special;  // read once: no reloads in the loops
  const float scale = a.scale;
  const size_t bh = blockIdx.x;
  const auto hd = head_of<DH, MERGED>(a, bh);
  const float* kh = static_cast<const float*>(a.k) + hd.x;
  const float* vh = static_cast<const float*>(a.v) + hd.x;
  const int row = blockIdx.y * kRows + threadIdx.x / S::TPR;
  const int part = threadIdx.x % S::TPR;
  const bool live = row < N;
  const int d0 = part * S::DPT;  // dims in global memory
  const int c0 = part * S::CH;   // the same dims in a shared-memory row

  float q[S::DPT], acc[S::DPT];
  load_row<DH>(q, static_cast<const float*>(a.q) + hd.x, hd.x_tok, row, live, d0);
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int t0 = 0; t0 < N; t0 += S::TILE) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<DH>(ks, kh, hd.x_tok, t0, N);
    load_tile<DH>(vs, vh, hd.x_tok, t0, N);
    __syncthreads();
    const int len = min(S::TILE, N - t0);
    for (int j0 = 0; j0 < len; j0 += kFwdChunk) {
      float s[kFwdChunk];
#pragma unroll
      for (int c = 0; c < kFwdChunk; ++c) s[c] = 0.f;
#pragma unroll
      for (int d = 0; d < S::DPT; d += 4) {
#pragma unroll
        for (int c = 0; c < kFwdChunk; ++c) {
          const float4 kv = ld4(&ks[(j0 + c) * S::RS + c0 + d]);
          s[c] = fmaf(q[d], kv.x, s[c]);
          s[c] = fmaf(q[d + 1], kv.y, s[c]);
          s[c] = fmaf(q[d + 2], kv.z, s[c]);
          s[c] = fmaf(q[d + 3], kv.w, s[c]);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kFwdChunk; ++c) {
        const int j = t0 + j0 + c;
        const float dot = row_sum<S::TPR>(s[c]);
        s[c] = j < N && dual_query_allowed(row, j, ns) ? dot * scale
                                                                   : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      // nothing allowed so far: every p below is exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - m_use);
      float psum = 0.f;
      if constexpr (DROPOUT) {
        // dropout weighs the accumulator, not the normaliser
        const uint32_t keep =  // bit c: key t0 + j0 + c
            live ? keep_run<kFwdChunk>((static_cast<uint64_t>(bh) * N + row) * N + t0 + j0,
                                       a.thresh, a.s0, a.s1)
                 : 0u;
#pragma unroll
        for (int c = 0; c < kFwdChunk; ++c) {
          const float p = expf(s[c] - m_use);
          psum += p;
          s[c] = (keep >> c) & 1u ? p * a.inv_keep : 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kFwdChunk; ++c) {
          s[c] = expf(s[c] - m_use);
          psum += s[c];
        }
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < S::DPT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kFwdChunk; ++c) {
#pragma unroll
        for (int d = 0; d < S::DPT; d += 4) {
          const float4 vv = ld4(&vs[(j0 + c) * S::RS + c0 + d]);
          acc[d] = fmaf(s[c], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[c], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[c], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[c], vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  float* orow = static_cast<float*>(a.out) + hd.g + static_cast<size_t>(row) * hd.g_tok + d0;
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) orow[d] = acc[d] / l;
  if (part == 0) a.lse_out[bh * N + row] = m + logf(l);
}

template <int DH, bool DROPOUT, int ROWTERM, bool MERGED>
__global__ void __launch_bounds__(Split<DH>::THREADS) stream_dq_kernel(StreamArgs a) {
  using S = Split<DH>;
  __shared__ __align__(16) float ks[S::TILE * S::RS];
  __shared__ __align__(16) float vs[S::TILE * S::RS];
  const int N = a.N, ns = a.num_special;  // read once: no reloads in the loops
  const float scale = a.scale;
  const size_t bh = blockIdx.x;
  const auto hd = head_of<DH, MERGED>(a, bh);
  const float* kh = static_cast<const float*>(a.k) + hd.x;
  const float* vh = static_cast<const float*>(a.v) + hd.x;
  const int row = blockIdx.y * kRows + threadIdx.x / S::TPR;
  const int part = threadIdx.x % S::TPR;
  const bool live = row < N;
  const int d0 = part * S::DPT;
  const int c0 = part * S::CH;
  const uint64_t e_row = (static_cast<uint64_t>(bh) * N + row) * static_cast<uint64_t>(N);

  float q[S::DPT], g[S::DPT], acc[S::DPT];
  load_row<DH>(q, static_cast<const float*>(a.q) + hd.x, hd.x_tok, row, live, d0);
  load_row<DH>(g, static_cast<const float*>(a.dout) + hd.g, hd.g_tok, row, live, d0);
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) acc[d] = 0.f;
  const float lse = live ? a.lse[bh * N + row] : 0.f;
  float delta = 0.f;  // the row term
  if constexpr (ROWTERM == kGiven) {
    delta = live ? a.delta[bh * N + row] : 0.f;
  } else if constexpr (ROWTERM == kDeltaFromO) {
    float o[S::DPT];
    load_row<DH>(o, static_cast<const float*>(a.o) + hd.g, hd.g_tok, row, live, d0);
    float part_sum = 0.f;
#pragma unroll
    for (int d = 0; d < S::DPT; ++d) part_sum = fmaf(g[d], o[d], part_sum);
    delta = row_sum<S::TPR>(part_sum);
  } else {
    // rowsum = sum_j dsigma p, in a first sweep over the keys
    for (int t0 = 0; t0 < N; t0 += S::TILE) {
      __syncthreads();
      load_tile<DH>(ks, kh, hd.x_tok, t0, N);
      load_tile<DH>(vs, vh, hd.x_tok, t0, N);
      __syncthreads();
      const int len = min(S::TILE, N - t0);
      uint32_t keep = ~0u;  // bit j0 % kKeepRun: key t0 + j0
      for (int j0 = 0; j0 < len; ++j0) {
        if constexpr (DROPOUT) {
          if (j0 % kKeepRun == 0 && live)
            keep = keep_run<kKeepRun>(e_row + t0 + j0, a.thresh, a.s0, a.s1);
        }
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < S::DPT; d += 4) {
          const float4 kv = ld4(&ks[j0 * S::RS + c0 + d]);
          const float4 vv = ld4(&vs[j0 * S::RS + c0 + d]);
          sc = fmaf(q[d], kv.x, sc);  // the order of the ds sweep below: the same p
          sc = fmaf(q[d + 1], kv.y, sc);
          sc = fmaf(q[d + 2], kv.z, sc);
          sc = fmaf(q[d + 3], kv.w, sc);
          dp = fmaf(g[d], vv.x, dp);
          dp = fmaf(g[d + 1], vv.y, dp);
          dp = fmaf(g[d + 2], vv.z, dp);
          dp = fmaf(g[d + 3], vv.w, dp);
        }
        const int j = t0 + j0;
        const float dot = row_sum<S::TPR>(sc);
        float dpc = row_sum<S::TPR>(dp);
        const float p = j < N && dual_query_allowed(row, j, ns)
                            ? expf(dot * scale - lse) : 0.f;
        if constexpr (DROPOUT) dpc = (keep >> (j0 % kKeepRun)) & 1u ? dpc * a.inv_keep : 0.f;
        delta = fmaf(dpc, p, delta);
      }
    }
  }
  if constexpr (ROWTERM != kGiven) {
    if (live && part == 0) a.rowterm[bh * N + row] = delta;
  }

  for (int t0 = 0; t0 < N; t0 += S::TILE) {
    __syncthreads();
    load_tile<DH>(ks, kh, hd.x_tok, t0, N);
    load_tile<DH>(vs, vh, hd.x_tok, t0, N);
    __syncthreads();
    const int len = min(S::TILE, N - t0);
    uint32_t keep = ~0u;  // bit j0 % kKeepRun: key t0 + j0
#pragma unroll 2
    for (int j0 = 0; j0 < len; j0 += kBwdChunk) {
      if constexpr (DROPOUT) {
        if (j0 % kKeepRun == 0 && live)
          keep = keep_run<kKeepRun>(e_row + t0 + j0, a.thresh, a.s0, a.s1);
      }
      float s[kBwdChunk], dp[kBwdChunk];
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) s[c] = dp[c] = 0.f;
#pragma unroll
      for (int d = 0; d < S::DPT; d += 4) {
#pragma unroll
        for (int c = 0; c < kBwdChunk; ++c) {
          const float4 kv = ld4(&ks[(j0 + c) * S::RS + c0 + d]);
          const float4 vv = ld4(&vs[(j0 + c) * S::RS + c0 + d]);
          s[c] = fmaf(q[d], kv.x, s[c]);
          s[c] = fmaf(q[d + 1], kv.y, s[c]);
          s[c] = fmaf(q[d + 2], kv.z, s[c]);
          s[c] = fmaf(q[d + 3], kv.w, s[c]);
          dp[c] = fmaf(g[d], vv.x, dp[c]);
          dp[c] = fmaf(g[d + 1], vv.y, dp[c]);
          dp[c] = fmaf(g[d + 2], vv.z, dp[c]);
          dp[c] = fmaf(g[d + 3], vv.w, dp[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) {
        const int j = t0 + j0 + c;
        const float dot = row_sum<S::TPR>(s[c]);
        const float dpc = row_sum<S::TPR>(dp[c]);
        const float p = j < N && dual_query_allowed(row, j, ns)
                            ? expf(dot * scale - lse) : 0.f;
        if constexpr (DROPOUT) {
          const float dsg = (keep >> ((j0 + c) % kKeepRun)) & 1u ? dpc * a.inv_keep : 0.f;
          s[c] = p * (dsg - delta) * scale;  // ds
        } else {
          s[c] = p * (dpc - delta) * scale;  // ds
        }
      }
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) {
#pragma unroll
        for (int d = 0; d < S::DPT; d += 4) {
          const float4 kv = ld4(&ks[(j0 + c) * S::RS + c0 + d]);
          acc[d] = fmaf(s[c], kv.x, acc[d]);
          acc[d + 1] = fmaf(s[c], kv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[c], kv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[c], kv.w, acc[d + 3]);
        }
      }
    }
  }
  if (!live) return;
  float* out = static_cast<float*>(a.dq) + hd.x + static_cast<size_t>(row) * hd.x_tok + d0;
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) out[d] = acc[d];
}

template <int DH, bool DROPOUT, bool MERGED>
__global__ void __launch_bounds__(Split<DH>::THREADS) stream_dkv_kernel(StreamArgs a) {
  using S = Split<DH>;
  __shared__ __align__(16) float qs[S::TILE * S::RS];
  __shared__ __align__(16) float gs[S::TILE * S::RS];  // dO
  __shared__ float ls[S::TILE];                        // lse of the tile's rows
  __shared__ float es[S::TILE];                        // row term of the tile's rows
  const int N = a.N, ns = a.num_special;  // read once: no reloads in the loops
  const float scale = a.scale;
  const size_t bh = blockIdx.x;
  const auto hd = head_of<DH, MERGED>(a, bh);
  const float* qh = static_cast<const float*>(a.q) + hd.x;
  const float* gh = static_cast<const float*>(a.dout) + hd.g;
  const int col = blockIdx.y * kRows + threadIdx.x / S::TPR;  // the key row owned
  const int part = threadIdx.x % S::TPR;
  const bool live = col < N;
  const int d0 = part * S::DPT;
  const int c0 = part * S::CH;
  float k[S::DPT], v[S::DPT], dk[S::DPT], dv[S::DPT];
  load_row<DH>(k, static_cast<const float*>(a.k) + hd.x, hd.x_tok, col, live, d0);
  load_row<DH>(v, static_cast<const float*>(a.v) + hd.x, hd.x_tok, col, live, d0);
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) dk[d] = dv[d] = 0.f;

  for (int t0 = 0; t0 < N; t0 += S::TILE) {
    __syncthreads();
    load_tile<DH>(qs, qh, hd.x_tok, t0, N);
    load_tile<DH>(gs, gh, hd.g_tok, t0, N);
    const int len = min(S::TILE, N - t0);
    for (int r = threadIdx.x; r < S::TILE; r += blockDim.x) {
      ls[r] = r < len ? a.lse[bh * N + t0 + r] : 0.f;
      es[r] = r < len ? a.delta[bh * N + t0 + r] : 0.f;
    }
    __syncthreads();
    for (int i0 = 0; i0 < len; i0 += kBwdChunk) {
      float s[kBwdChunk], dp[kBwdChunk];
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) s[c] = dp[c] = 0.f;
#pragma unroll
      for (int d = 0; d < S::DPT; d += 4) {
#pragma unroll
        for (int c = 0; c < kBwdChunk; ++c) {
          const float4 qv = ld4(&qs[(i0 + c) * S::RS + c0 + d]);
          const float4 gv = ld4(&gs[(i0 + c) * S::RS + c0 + d]);
          s[c] = fmaf(k[d], qv.x, s[c]);
          s[c] = fmaf(k[d + 1], qv.y, s[c]);
          s[c] = fmaf(k[d + 2], qv.z, s[c]);
          s[c] = fmaf(k[d + 3], qv.w, s[c]);
          dp[c] = fmaf(v[d], gv.x, dp[c]);
          dp[c] = fmaf(v[d + 1], gv.y, dp[c]);
          dp[c] = fmaf(v[d + 2], gv.z, dp[c]);
          dp[c] = fmaf(v[d + 3], gv.w, dp[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) {
        const int i = t0 + i0 + c;
        const float dot = row_sum<S::TPR>(s[c]);
        const float dpc = row_sum<S::TPR>(dp[c]);
        const float p = i < N && dual_query_allowed(i, col, ns)
                            ? expf(dot * scale - ls[i0 + c]) : 0.f;
        if constexpr (DROPOUT) {
          const bool kept =
              live && i < N &&
              keep_one((static_cast<uint64_t>(bh) * N + i) * N + col, a.thresh, a.s0, a.s1);
          s[c] = kept ? p * a.inv_keep : 0.f;  // pd
          dp[c] = p * ((kept ? dpc * a.inv_keep : 0.f) - es[i0 + c]) * scale;  // ds
        } else {
          s[c] = p;
          dp[c] = p * (dpc - es[i0 + c]) * scale;  // ds
        }
      }
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) {
#pragma unroll
        for (int d = 0; d < S::DPT; d += 4) {
          const float4 qv = ld4(&qs[(i0 + c) * S::RS + c0 + d]);
          const float4 gv = ld4(&gs[(i0 + c) * S::RS + c0 + d]);
          dv[d] = fmaf(s[c], gv.x, dv[d]);
          dv[d + 1] = fmaf(s[c], gv.y, dv[d + 1]);
          dv[d + 2] = fmaf(s[c], gv.z, dv[d + 2]);
          dv[d + 3] = fmaf(s[c], gv.w, dv[d + 3]);
          dk[d] = fmaf(dp[c], qv.x, dk[d]);
          dk[d + 1] = fmaf(dp[c], qv.y, dk[d + 1]);
          dk[d + 2] = fmaf(dp[c], qv.z, dk[d + 2]);
          dk[d + 3] = fmaf(dp[c], qv.w, dk[d + 3]);
        }
      }
    }
  }
  if (!live) return;
  const size_t off = hd.x + static_cast<size_t>(col) * hd.x_tok + d0;
  float* dkr = static_cast<float*>(a.dk) + off;
  float* dvr = static_cast<float*>(a.dv) + off;
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) {
    dkr[d] = dk[d];
    dvr[d] = dv[d];
  }
}

enum Which : int { kFwd = 0, kDq = 1, kDkv = 2 };

template <int W, int DH, bool DROPOUT, int ROWTERM, bool MERGED>
cudaError_t launch_stream_t(int BH, const StreamArgs& a, cudaStream_t st) {
  const dim3 grid(BH, (a.N + kRows - 1) / kRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if constexpr (W == kFwd)
    stream_fwd_kernel<DH, DROPOUT, MERGED><<<grid, Split<DH>::THREADS, 0, st>>>(a);
  if constexpr (W == kDq)
    stream_dq_kernel<DH, DROPOUT, ROWTERM, MERGED><<<grid, Split<DH>::THREADS, 0, st>>>(a);
  if constexpr (W == kDkv)
    stream_dkv_kernel<DH, DROPOUT, MERGED><<<grid, Split<DH>::THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// one pass of the template, Dh in {16, 32, 64, 128}; BH = B * H. MERGED: K1's
// merged qkv layout (strides from the arguments), else [B*H, N, Dh]
template <int W, bool DROPOUT = false, int ROWTERM = kGiven, bool MERGED = false>
cudaError_t launch_stream(int DH, int BH, const StreamArgs& a, cudaStream_t st) {
  if (BH <= 0 || a.N <= 0 || a.H <= 0) return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_stream_t<W, 16, DROPOUT, ROWTERM, MERGED>(BH, a, st);
    case 32: return launch_stream_t<W, 32, DROPOUT, ROWTERM, MERGED>(BH, a, st);
    case 64: return launch_stream_t<W, 64, DROPOUT, ROWTERM, MERGED>(BH, a, st);
    case 128: return launch_stream_t<W, 128, DROPOUT, ROWTERM, MERGED>(BH, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// the float32 backward of K1, K3 and K4: the dq pass (which writes its row
// term to a.rowterm), then the dk/dv pass reading it
template <bool DROPOUT, int ROWTERM, bool MERGED = false>
cudaError_t launch_stream_bwd_f32(int DH, int BH, StreamArgs a, cudaStream_t st) {
  cudaError_t err = launch_stream<kDq, DROPOUT, ROWTERM, MERGED>(DH, BH, a, st);
  if (err != cudaSuccess) return err;
  a.delta = a.rowterm;
  return launch_stream<kDkv, DROPOUT, kGiven, MERGED>(DH, BH, a, st);
}

// static shared-memory bytes of each pass at head width DH (any N)
inline size_t stream_smem_by_dh(int W, int DH) {
  switch (DH) {
    case 16: return W == kDkv ? dkv_smem<16>() : fwd_smem<16>();
    case 32: return W == kDkv ? dkv_smem<32>() : fwd_smem<32>();
    case 64: return W == kDkv ? dkv_smem<64>() : fwd_smem<64>();
    case 128: return W == kDkv ? dkv_smem<128>() : fwd_smem<128>();
    default: return 0;
  }
}

// The [B*H, N, Dh] layout of K3, K4 and K5: H = 1 and contiguous heads
inline void head_major(StreamArgs& a, int N, int DH) {
  a.H = 1;
  a.x_batch = a.g_batch = static_cast<long long>(N) * DH;
  a.x_head = a.g_head = 0;
  a.x_tok = a.g_tok = DH;
}

}  // namespace
