// K5f flash_stream_fwd, K5q flash_stream_dq and K5kv flash_stream_dkv: flash
// attention on [B, H, N, Dh] that streams K/V (forward, dq) or Q/dO (dk, dv)
// through shared memory in fixed tiles, so that no buffer grows with N.
//
// Replaces the TPU kernels eavit_tpu/ops/flash_stream.py `_fwd_kernel` (line
// 99, launched by `_fwd` at line 159), `_bwd_dq_kernel` (line 183, launched by
// `_bwd` at line 285) and `_bwd_dkv_kernel` (line 221, launched at line 304).
// The math is theirs, with the dual-query mask (`_mask`, line 83) on absolute
// row and column indices; masked edges contribute exactly 0. Inputs are
// contiguous [B*H, N, Dh], bf16 or f32, with Dh in {16, 32, 64}; sums are f32
// and only o, dq, dk and dv are rounded to the input dtype. N is taken as it
// is: the TPU's padding of N to a multiple of both tiles has no counterpart.
//
//   K5f, one block per (bh, tile of kRows query rows), K/V tiles streamed:
//     s = q k^T * scale, running max m, normaliser l and accumulator acc
//     (the online softmax, one rescale per chunk of keys), o = acc / l,
//     lse = m + log l.
//   K5q, one block per (bh, query tile), K/V tiles streamed:
//     p = exp(s - lse), dp = dO v^T, ds = p (dp - delta) scale, dq = ds k.
//   K5kv, one block per (bh, key tile), Q/dO tiles streamed (with lse and
//     delta of their rows): dv = p^T dO, dk = ds^T q.
// delta = sum(dO * O) per row is computed outside, from the rounded O the
// forward returned (flash_stream.py:273-274). This is the FA-2 split: every
// output element has one owner thread that sums in a fixed order, so there
// are no float atomics and two identical calls give equal bits.
//
// A thread owns one row (a query row, or a key row in K5kv) and min(Dh, 16)
// of its dims in registers; at Dh = 32 and 64 two or four neighbouring lanes
// share a row and add their parts of each dot product with shuffles. Every
// lane of a warp reads the same streamed row at a time, so the shared-memory
// reads are broadcasts; the parts of a row sit 20 floats apart, on other
// banks. Each value read from shared memory feeds one FMA per thread, so this
// first version is bound by shared-memory bandwidth, not by the FMA units.
//
// What bounds them on an H100: bytes at the flagship's N. At [256, 8, 198, 32]
// bf16 the forward must move 105 MB against 10 GFLOP, the dq pass 133 MB
// against 15 GFLOP, the dk/dv pass 159 MB against 20 GFLOP, all below the
// bf16 tensor cores' 295 FLOP/byte; past N of about 1,000 at Dh = 64 the
// operations bound instead. The design keeps scores and probabilities out of
// device memory and reads each operand once per block. This first version
// computes on the CUDA cores in f32 (no tensor cores); see PERF.md for its
// measured time.
#include "common.cuh"

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
static_assert(kTile % kFwdChunk == 0 && kTile % kBwdChunk == 0, "chunks split a tile");
static_assert(kDims % 4 == 0 && 64 % kDims == 0, "a thread reads its dims as float4");

// How the DH dims of a row are shared among TPR neighbouring threads, and
// where each thread's DPT dims sit in a shared-memory row.
template <int DH>
struct Split {
  static constexpr int DPT = DH < kDims ? DH : kDims;  // dims a thread owns
  static constexpr int TPR = DH / DPT;                 // threads per row: 1, 2 or 4
  static constexpr int CH = DPT + (TPR > 1 ? 4 : 0);   // floats per part of a row
  static constexpr int RS = TPR * CH;                  // shared-memory row stride
  static constexpr int THREADS = kRows * TPR;
};

struct StreamArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward
  const float* lse;    // backward
  const float* delta;  // backward
  void* o;             // K5f
  float* lse_out;      // K5f
  void* dq;            // K5q
  void* dk;            // K5kv
  void* dv;            // K5kv
  int N;
  float scale;
  int num_special;
};

// shared memory of each kernel: two tiles (K and V, or Q and dO), plus the
// lse and delta of the streamed query rows in K5kv
template <int DH>
constexpr size_t fwd_smem() { return 2 * sizeof(float) * kTile * Split<DH>::RS; }
template <int DH>
constexpr size_t dkv_smem() { return fwd_smem<DH>() + 2 * sizeof(float) * kTile; }

// the sum of a dot product's parts over the TPR threads of a row; every one
// of them gets the same bits (a + b == b + a at each step)
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [t0, t0 + kTile) of a [N, DH] head into a [kTile][RS] f32 tile; rows at
// or past N are zero, so the products over them stay finite (their weights
// are 0).
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int t0, int N) {
  using S = Split<DH>;
  const int len = min(kTile, N - t0);
  for (int idx = threadIdx.x; idx < kTile * DH; idx += blockDim.x) {
    const int r = idx / DH, d = idx % DH;
    dst[r * S::RS + (d / S::DPT) * S::CH + d % S::DPT] =
        r < len ? to_f(src[static_cast<size_t>(t0 + r) * DH + d]) : 0.f;
  }
}

// dims [d0, d0 + DPT) of row `row` of a head into registers (0 past N)
template <typename T, int DH>
__device__ __forceinline__ void load_row(float* out, const T* src, int row, bool live,
                                         int d0) {
#pragma unroll
  for (int d = 0; d < Split<DH>::DPT; ++d)
    out[d] = live ? to_f(src[static_cast<size_t>(row) * DH + d0 + d]) : 0.f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Split<DH>::THREADS) stream_fwd_kernel(StreamArgs a) {
  using S = Split<DH>;
  __shared__ __align__(16) float ks[kTile * S::RS];
  __shared__ __align__(16) float vs[kTile * S::RS];
  const int N = a.N;
  const size_t bh = blockIdx.x;
  const size_t head = bh * N * DH;
  const T* kh = static_cast<const T*>(a.k) + head;
  const T* vh = static_cast<const T*>(a.v) + head;
  const int row = blockIdx.y * kRows + threadIdx.x / S::TPR;
  const int part = threadIdx.x % S::TPR;
  const bool live = row < N;
  const int d0 = part * S::DPT;  // dims in global memory
  const int c0 = part * S::CH;   // the same dims in a shared-memory row

  float q[S::DPT], acc[S::DPT];
  load_row<T, DH>(q, static_cast<const T*>(a.q) + head, row, live, d0);
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, DH>(ks, kh, t0, N);
    load_tile<T, DH>(vs, vh, t0, N);
    __syncthreads();
    const int len = min(kTile, N - t0);
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
        s[c] = j < N && dual_query_allowed(row, j, a.num_special) ? dot * a.scale
                                                                   : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      // nothing allowed so far: every p below is exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - m_use);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kFwdChunk; ++c) {
        s[c] = expf(s[c] - m_use);
        psum += s[c];
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
  T* orow = static_cast<T*>(a.o) + head + static_cast<size_t>(row) * DH + d0;
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) orow[d] = from_f<T>(acc[d] / l);
  if (part == 0) a.lse_out[bh * N + row] = m + logf(l);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Split<DH>::THREADS) stream_dq_kernel(StreamArgs a) {
  using S = Split<DH>;
  __shared__ __align__(16) float ks[kTile * S::RS];
  __shared__ __align__(16) float vs[kTile * S::RS];
  const int N = a.N;
  const size_t bh = blockIdx.x;
  const size_t head = bh * N * DH;
  const T* kh = static_cast<const T*>(a.k) + head;
  const T* vh = static_cast<const T*>(a.v) + head;
  const int row = blockIdx.y * kRows + threadIdx.x / S::TPR;
  const int part = threadIdx.x % S::TPR;
  const bool live = row < N;
  const int d0 = part * S::DPT;
  const int c0 = part * S::CH;

  float q[S::DPT], g[S::DPT], acc[S::DPT];
  load_row<T, DH>(q, static_cast<const T*>(a.q) + head, row, live, d0);
  load_row<T, DH>(g, static_cast<const T*>(a.dout) + head, row, live, d0);
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) acc[d] = 0.f;
  const float lse = live ? a.lse[bh * N + row] : 0.f;
  const float delta = live ? a.delta[bh * N + row] : 0.f;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    __syncthreads();
    load_tile<T, DH>(ks, kh, t0, N);
    load_tile<T, DH>(vs, vh, t0, N);
    __syncthreads();
    const int len = min(kTile, N - t0);
    for (int j0 = 0; j0 < len; j0 += kBwdChunk) {
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
        const float p = j < N && dual_query_allowed(row, j, a.num_special)
                            ? expf(dot * a.scale - lse) : 0.f;
        s[c] = p * (dpc - delta) * a.scale;  // ds
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
  T* out = static_cast<T*>(a.dq) + head + static_cast<size_t>(row) * DH + d0;
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) out[d] = from_f<T>(acc[d]);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Split<DH>::THREADS) stream_dkv_kernel(StreamArgs a) {
  using S = Split<DH>;
  __shared__ __align__(16) float qs[kTile * S::RS];
  __shared__ __align__(16) float gs[kTile * S::RS];  // dO
  __shared__ float ls[kTile];                        // lse of the tile's rows
  __shared__ float es[kTile];                        // delta of the tile's rows
  const int N = a.N;
  const size_t bh = blockIdx.x;
  const size_t head = bh * N * DH;
  const T* qh = static_cast<const T*>(a.q) + head;
  const T* gh = static_cast<const T*>(a.dout) + head;
  const int col = blockIdx.y * kRows + threadIdx.x / S::TPR;  // the key row owned
  const int part = threadIdx.x % S::TPR;
  const bool live = col < N;
  const int d0 = part * S::DPT;
  const int c0 = part * S::CH;

  float k[S::DPT], v[S::DPT], dk[S::DPT], dv[S::DPT];
  load_row<T, DH>(k, static_cast<const T*>(a.k) + head, col, live, d0);
  load_row<T, DH>(v, static_cast<const T*>(a.v) + head, col, live, d0);
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) dk[d] = dv[d] = 0.f;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    __syncthreads();
    load_tile<T, DH>(qs, qh, t0, N);
    load_tile<T, DH>(gs, gh, t0, N);
    const int len = min(kTile, N - t0);
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
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
        const float p = i < N && dual_query_allowed(i, col, a.num_special)
                            ? expf(dot * a.scale - ls[i0 + c]) : 0.f;
        s[c] = p;
        dp[c] = p * (dpc - es[i0 + c]) * a.scale;  // ds
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
  const size_t off = head + static_cast<size_t>(col) * DH + d0;
  T* dkr = static_cast<T*>(a.dk) + off;
  T* dvr = static_cast<T*>(a.dv) + off;
#pragma unroll
  for (int d = 0; d < S::DPT; ++d) {
    dkr[d] = from_f<T>(dk[d]);
    dvr[d] = from_f<T>(dv[d]);
  }
}

enum Which : int { kFwd = 0, kDq = 1, kDkv = 2 };

template <int W, typename T, int DH>
cudaError_t launch_t(int BH, const StreamArgs& a, cudaStream_t st) {
  const dim3 grid(BH, (a.N + kRows - 1) / kRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if constexpr (W == kFwd)
    stream_fwd_kernel<T, DH><<<grid, Split<DH>::THREADS, 0, st>>>(a);
  if constexpr (W == kDq)
    stream_dq_kernel<T, DH><<<grid, Split<DH>::THREADS, 0, st>>>(a);
  if constexpr (W == kDkv)
    stream_dkv_kernel<T, DH><<<grid, Split<DH>::THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <int W, typename T>
cudaError_t launch_dh(int DH, int BH, const StreamArgs& a, cudaStream_t st) {
  switch (DH) {
    case 16: return launch_t<W, T, 16>(BH, a, st);
    case 32: return launch_t<W, T, 32>(BH, a, st);
    case 64: return launch_t<W, T, 64>(BH, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: common.cuh's codes
template <int W>
int launch(int dtype, int DH, int BH, const StreamArgs& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch_dh<W, __nv_bfloat16>(DH, BH, a, st);
  if (dtype == kF32) return launch_dh<W, float>(DH, BH, a, st);
  return cudaErrorInvalidValue;
}

template <int W>
size_t smem_by_dh(int DH) {
  switch (DH) {
    case 16: return W == kDkv ? dkv_smem<16>() : fwd_smem<16>();
    case 32: return W == kDkv ? dkv_smem<32>() : fwd_smem<32>();
    case 64: return W == kDkv ? dkv_smem<64>() : fwd_smem<64>();
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of each kernel at head width DH, whatever N is.
size_t eavit_flash_stream_fwd_smem(int DH) { return smem_by_dh<kFwd>(DH); }
size_t eavit_flash_stream_dq_smem(int DH) { return smem_by_dh<kDq>(DH); }
size_t eavit_flash_stream_dkv_smem(int DH) { return smem_by_dh<kDkv>(DH); }

// Each returns the cudaError_t of its launch (0 on success). BH = B * H.
int eavit_flash_stream_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int N, int DH, int dtype, float scale, int num_special,
                           void* stream) {
  StreamArgs a{q, k, v, nullptr, nullptr, nullptr, o, static_cast<float*>(lse),
               nullptr, nullptr, nullptr, N, scale, num_special};
  return launch<kFwd>(dtype, DH, BH, a, stream);
}

int eavit_flash_stream_dq(const void* q, const void* k, const void* v, const void* lse,
                          const void* delta, const void* dout, void* dq, int BH, int N,
                          int DH, int dtype, float scale, int num_special, void* stream) {
  StreamArgs a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, nullptr, dq, nullptr, nullptr,
               N, scale, num_special};
  return launch<kDq>(dtype, DH, BH, a, stream);
}

int eavit_flash_stream_dkv(const void* q, const void* k, const void* v, const void* lse,
                           const void* delta, const void* dout, void* dk, void* dv, int BH,
                           int N, int DH, int dtype, float scale, int num_special,
                           void* stream) {
  StreamArgs a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, nullptr, nullptr, dk, dv,
               N, scale, num_special};
  return launch<kDkv>(dtype, DH, BH, a, stream);
}

}  // extern "C"
