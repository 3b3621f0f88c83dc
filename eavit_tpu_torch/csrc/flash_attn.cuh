// Flash attention on [B, H, N, Dh] inputs: the forward and backward kernels
// of csrc/flash.cu (K4f, K4b: no dropout) and csrc/flash_dropout.cu (K3f, K3b:
// probability dropout in the kernel). The two pairs share one template each,
// with DROPOUT as its parameter: K3 is K4 with a Philox mask on the
// normalised probabilities and another softmax-VJP row term. K3b and K4b run
// this backward for float32 inputs only: for bf16 they are the tensor-core
// kernel of attn_bwd_mma.cuh.
//
// Inputs are contiguous [B, H, N, Dh] (row bh = b*H + h of N x Dh), bf16 or
// f32; lse is f32 [B, H, N]. Sums are f32. Unlike K1 (flash_qkv.cu) nothing
// is rounded to the input dtype before a product: p, pd and ds stay f32, and
// only o, dq, dk and dv are written in the input dtype (eavit_tpu/ops/flash.py
// and ops/flash_dropout.py do the same). N is taken as it is: the TPU's
// padding of N to 128 lanes and of B*H to the row block has no counterpart.
//
// Forward, one block per (bh, tile of kFwdRows query rows):
//   s = q k^T * scale (f32), -inf where the dual-query mask forbids
//   p = exp(s - m), l = sum p, lse = m + log l
//   K4f: o = (p v) / l
//   K3f: pd = keep ? (p / l) * inv_keep : 0, o = pd v
// K and V of the head stay in shared memory as f32 (N * (2 Dh + 1) floats);
// each warp owns one query row at a time and keeps its scores in a
// shared-memory row.
//
// Backward, one block per bh, two passes so that every sum has one fixed
// order (no float atomics; two identical calls give equal bits):
//   sigma = exp(s - lse) (0 where masked), dp = dO v^T
//   K4b: dsigma = dp, rowsum_i = delta_i = sum_d dO_id O_id (from the O the
//        forward wrote, computed here as on the TPU, flash.py:179)
//   K3b: pd = keep ? sigma * inv_keep : 0, dsigma = keep ? dp * inv_keep : 0,
//        rowsum_i = sum_j dsigma_ij sigma_ij (the delta trick is wrong under
//        dropout, flash_dropout.py:34-39)
//   ds = sigma (dsigma - rowsum) * scale
//   pass A, one warp per query row i: dq_i = sum_j ds_ij k_j (K3b also
//     draws the row's keep bits into an N x N bitmap and sums rowsum_i);
//   pass B, one warp per key column j: the column's sigma, dp and ds
//     recomputed, dv_j = sum_i pd_ij dO_i, dk_j = sum_i ds_ij q_i.
// q, k, v and dO stay in shared memory as f32 (4 N (Dh + 1) floats).
//
// Dropout bits: Philox4x32-10 (philox.cuh) on the logical index
// ((b*H + h)*N + i)*N + j of the [B, H, N, N] mask, stream 0, keep =
// (bits >> 8) < thresh, as ops/kernel_prng.py documents.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kFwdWarps = 8;   // query rows in flight per forward block
constexpr int kFwdRows = 64;   // query tile of one forward block

// Warps of a backward block. Fewer at Dh = 64: q and dO of a row in registers
// (2 x 64 floats) need more than the 128 registers 512 threads leave, and the
// per-warp rows cost shared memory that N = 198 needs for the operands.
__host__ __device__ constexpr int bwd_warps(int dh) { return dh >= 64 ? 8 : 16; }

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int N;
  float scale;
  int num_special;
  uint32_t thresh;  // K3 only
  float inv_keep;
  uint32_t s0, s1;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;  // K4 only
  const float* lse;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int N;
  float scale;
  int num_special;
  uint32_t thresh;  // K3 only
  float inv_keep;
  uint32_t s0, s1;
};

size_t fwd_smem_bytes(int N, int DH) {
  return sizeof(float) * (static_cast<size_t>(N) * (2 * DH + 1) +
                          static_cast<size_t>(kFwdWarps) * N);
}

size_t bwd_smem_bytes(int N, int DH, bool dropout) {
  const size_t n = static_cast<size_t>(N);
  const size_t warps = bwd_warps(DH);
  const size_t bitmap = dropout ? sizeof(uint32_t) * n * ((n + 31) / 32) : 0;
  return sizeof(float) * (4 * n * (DH + 1) + 2 * n + warps * 2 * n) + bitmap;
}

template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kFwdWarps * 32) attn_fwd_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KS = DH + 1;  // odd row stride: lane j reads row j conflict-free
  const int N = a.N;
  float* ks = smem;         // [N][KS]
  float* vs = ks + N * KS;  // [N][DH]
  float* ps = vs + N * DH;  // [kFwdWarps][N]: one row of scores per warp

  const size_t bh = blockIdx.x;
  const size_t head = bh * N * DH;
  const T* qh = static_cast<const T*>(a.q) + head;
  const T* kh = static_cast<const T*>(a.k) + head;
  const T* vh = static_cast<const T*>(a.v) + head;
  T* oh = static_cast<T*>(a.o) + head;

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    ks[(idx / DH) * KS + idx % DH] = to_f(kh[idx]);
    vs[idx] = to_f(vh[idx]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * N;
  const int row0 = blockIdx.y * kFwdRows;
  const int row_end = min(row0 + kFwdRows, N);
  for (int i = row0 + warp; i < row_end; i += kFwdWarps) {
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = to_f(qh[i * DH + d]);  // broadcast

    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = -INFINITY;
      if (dual_query_allowed(i, j, a.num_special)) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc = fmaf(q[d], ks[j * KS + d], acc);
        s = acc * a.scale;
      }
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    __syncwarp();

    if constexpr (DROPOUT) {
      // one Philox call per group of four consecutive mask elements
      const uint64_t e0 = (bh * N + i) * static_cast<uint64_t>(N);
      const uint64_t g_first = e0 >> 2, g_last = (e0 + N - 1) >> 2;
      for (uint64_t g = g_first + lane; g <= g_last; g += 32) {
        const Philox4 r = philox_group(g, 0u, a.s0, a.s1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t e = g * 4 + k;
          if (e >= e0 && e < e0 + N) {
            const int j = static_cast<int>(e - e0);
            p[j] = (r.w[k] >> 8) < a.thresh ? (p[j] / l) * a.inv_keep : 0.f;
          }
        }
      }
      __syncwarp();
    }

    for (int d = lane; d < DH; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], vs[j * DH + d], acc);
      oh[i * DH + d] = from_f<T>(DROPOUT ? acc : acc / l);
    }
    if (lane == 0) a.lse[bh * N + i] = m + logf(l);
    __syncwarp();  // p is reused by the warp's next row
  }
}

// float32 inputs: bf16 goes to attn_bwd_mma.cuh
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(bwd_warps(DH) * 32) attn_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KS = DH + 1;  // odd row stride: lane r reads row r conflict-free
  constexpr int W = bwd_warps(DH);
  const int N = a.N;
  const int NW = (N + 31) / 32;  // bitmap words per row
  float* qs = smem;              // [N][KS]
  float* ks = qs + N * KS;       // [N][KS]
  float* vs = ks + N * KS;       // [N][KS]
  float* gs = vs + N * KS;       // [N][KS]  dO
  float* ls = gs + N * KS;       // [N]      lse of the head's rows
  float* rs = ls + N;            // [N]      rowsum (K3) or delta (K4)
  float* rows = rs + N;          // [W][2][N] per-warp rows
  uint32_t* bits = reinterpret_cast<uint32_t*>(rows + W * 2 * N);  // [N][NW], K3

  const size_t bh = blockIdx.x;
  const size_t head = bh * N * DH;
  const float* qh = static_cast<const float*>(a.q) + head;
  const float* kh = static_cast<const float*>(a.k) + head;
  const float* vh = static_cast<const float*>(a.v) + head;
  const float* gh = static_cast<const float*>(a.dout) + head;
  float* dqh = static_cast<float*>(a.dq) + head;
  float* dkh = static_cast<float*>(a.dk) + head;
  float* dvh = static_cast<float*>(a.dv) + head;

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    const int t = (idx / DH) * KS + idx % DH;
    qs[t] = qh[idx];
    ks[t] = kh[idx];
    vs[t] = vh[idx];
    gs[t] = gh[idx];
  }
  for (int t = threadIdx.x; t < N; t += blockDim.x) ls[t] = a.lse[bh * N + t];
  if constexpr (DROPOUT)
    for (int w = threadIdx.x; w < N * NW; w += blockDim.x) bits[w] = 0u;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pa = rows + warp * 2 * N;  // sigma, then pd (pass B)
  float* pb = pa + N;               // dp / dsigma, then ds

  if constexpr (!DROPOUT) {
    // delta_i = sum_d dO_id O_id, O in the input dtype as the forward wrote it
    const float* oh = static_cast<const float*>(a.o) + head;
    for (int i = warp; i < N; i += W) {
      float acc = 0.f;
      for (int d = lane; d < DH; d += 32) acc = fmaf(gs[i * KS + d], oh[i * DH + d], acc);
      acc = warp_sum(acc);
      if (lane == 0) rs[i] = acc;
    }
    __syncthreads();
  }

  // ---- pass A: one query row per warp -> (rowsum_i, keep bits,) dq_i ----
  for (int i = warp; i < N; i += W) {
    float q[DH], g[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      q[d] = qs[i * KS + d];  // one address per warp: broadcast
      g[d] = gs[i * KS + d];
    }
    const float li = ls[i];
    for (int j = lane; j < N; j += 32) {
      float sg = 0.f, dp = 0.f;
      if (dual_query_allowed(i, j, a.num_special)) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          acc = fmaf(q[d], ks[j * KS + d], acc);
          dp = fmaf(g[d], vs[j * KS + d], dp);
        }
        sg = expf(acc * a.scale - li);
      }
      pa[j] = sg;
      pb[j] = dp;
    }
    __syncwarp();
    float rsum;
    if constexpr (DROPOUT) {
      rsum = 0.f;
      const uint64_t e0 = (bh * N + i) * static_cast<uint64_t>(N);
      const uint64_t g_first = e0 >> 2, g_last = (e0 + N - 1) >> 2;
      for (uint64_t gi = g_first + lane; gi <= g_last; gi += 32) {
        const Philox4 r = philox_group(gi, 0u, a.s0, a.s1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t e = gi * 4 + k;
          if (e >= e0 && e < e0 + N) {
            const int j = static_cast<int>(e - e0);
            float dsg = 0.f;
            if ((r.w[k] >> 8) < a.thresh) {
              atomicOr(&bits[i * NW + (j >> 5)], 1u << (j & 31));  // integer: exact
              dsg = pb[j] * a.inv_keep;
            }
            pb[j] = dsg;
            rsum = fmaf(dsg, pa[j], rsum);
          }
        }
      }
      rsum = warp_sum(rsum);
      if (lane == 0) rs[i] = rsum;
      __syncwarp();
    } else {
      rsum = rs[i];
    }
    for (int j = lane; j < N; j += 32) pb[j] = pa[j] * (pb[j] - rsum) * a.scale;
    __syncwarp();
    for (int d = lane; d < DH; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(pb[j], ks[j * KS + d], acc);
      dqh[i * DH + d] = acc;
    }
    __syncwarp();  // pa, pb are reused by the warp's next row
  }
  __syncthreads();  // rs and bits are complete

  // ---- pass B: one key column per warp -> dv_j, dk_j ----
  const float ik = DROPOUT ? a.inv_keep : 1.f;
  for (int j = warp; j < N; j += W) {
    float k[DH], v[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      k[d] = ks[j * KS + d];
      v[d] = vs[j * KS + d];
    }
    for (int i = lane; i < N; i += 32) {
      float pd = 0.f, ds = 0.f;
      if (dual_query_allowed(i, j, a.num_special)) {
        float acc = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          acc = fmaf(qs[i * KS + d], k[d], acc);
          dp = fmaf(gs[i * KS + d], v[d], dp);
        }
        const float sg = expf(acc * a.scale - ls[i]);
        const bool keep = DROPOUT ? ((bits[i * NW + (j >> 5)] >> (j & 31)) & 1u) : true;
        pd = keep ? sg * ik : 0.f;
        const float dsg = keep ? dp * ik : 0.f;
        ds = sg * (dsg - rs[i]) * a.scale;
      }
      pa[i] = pd;
      pb[i] = ds;
    }
    __syncwarp();
    for (int d = lane; d < DH; d += 32) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < N; ++i) {
        dk = fmaf(pb[i], qs[i * KS + d], dk);
        dv = fmaf(pa[i], gs[i * KS + d], dv);
      }
      dkh[j * DH + d] = dk;
      dvh[j * DH + d] = dv;
    }
    __syncwarp();
  }
}

template <bool DROPOUT, typename T, int DH>
cudaError_t launch_fwd_t(int BH, const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(a.N, DH);
  cudaError_t err = allow_smem(attn_fwd_kernel<T, DH, DROPOUT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (a.N + kFwdRows - 1) / kFwdRows);
  attn_fwd_kernel<T, DH, DROPOUT><<<grid, kFwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool DROPOUT, int DH>
cudaError_t launch_bwd_t(int BH, const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(a.N, DH, DROPOUT);
  cudaError_t err = allow_smem(attn_bwd_kernel<DH, DROPOUT>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<DH, DROPOUT><<<BH, bwd_warps(DH) * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dh in {16, 32, 64} -> one instantiation
template <bool DROPOUT, typename T>
cudaError_t launch_dh(int DH, int BH, const FwdArgs& a, cudaStream_t st) {
  switch (DH) {
    case 16: return launch_fwd_t<DROPOUT, T, 16>(BH, a, st);
    case 32: return launch_fwd_t<DROPOUT, T, 32>(BH, a, st);
    case 64: return launch_fwd_t<DROPOUT, T, 64>(BH, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// float32 backward, Dh in {16, 32, 64}
template <bool DROPOUT>
cudaError_t launch_bwd(int DH, int BH, const BwdArgs& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return launch_bwd_t<DROPOUT, 16>(BH, a, st);
    case 32: return launch_bwd_t<DROPOUT, 32>(BH, a, st);
    case 64: return launch_bwd_t<DROPOUT, 64>(BH, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// forward; dtype: common.cuh's codes
template <bool DROPOUT>
cudaError_t launch(int dtype, int DH, int BH, const FwdArgs& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch_dh<DROPOUT, __nv_bfloat16>(DH, BH, a, st);
  if (dtype == kF32) return launch_dh<DROPOUT, float>(DH, BH, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace
