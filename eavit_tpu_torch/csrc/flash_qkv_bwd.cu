// K1b flash_qkv_bwd: the backward of attention from the raw qkv projection.
//
// Replaces the TPU kernel eavit_tpu/ops/flash_qkv.py `_bwd_kernel` (line 305,
// per-head math in `_head_bwd` at line 266, launched by `_bwd` at line 580;
// `_bwd_kernel_fori` and `_bwd_kernel_split` are other TPU head-loop
// schedules of the same math).
//
// What it computes, per batch row b and head h, from qkv [B, N, 3*H*Dh], the
// forward's row log-sum-exp lse [B, H, N] and dO [B, N, H*Dh]:
//   s      = q k^T * scale, with the dual-query mask when num_special > 0
//   sigma  = exp(s - lse)                         (0 where masked)
//   keep   = the forward's mask (Philox, philox.cuh, stream 0, element index
//            ((b*H + h)*N + i)*N + j); everything is kept at rate 0
//   pd     = keep ? sigma * inv_keep : 0
//   dv     = round_T(pd)^T dO
//   dpd    = dO v^T
//   dsigma = keep ? dpd * inv_keep : 0
//   rowsum = sum_j dsigma * sigma
//   ds     = round_T(sigma * (dsigma - rowsum) * scale)
//   dq     = ds k,   dk = ds^T q
// with T the input dtype and f32 accumulation everywhere. dq, dk and dv are
// written into the head's columns of one merged dqkv [B, N, 3*H*Dh] in T.
//
// What bounds it on an H100: bytes. At the flagship training shape (B = 256,
// N = 198, H = 8, Dh = 32, bf16) it must move 183 MB (qkv and dO read once,
// dqkv written once, lse) against 25.7 GFLOP of five products, far below the
// 295 FLOP/byte where the bf16 tensor cores would be the limit. The design
// answers that by reading each input once per (b, h) and keeping scores,
// probabilities and masks out of device memory: one block owns one head of
// one batch row and holds its q, k, v and dO in shared memory as f32.
//
// dk and dv are sums over query rows while dq is a sum over key columns, and
// blocks run concurrently, so nothing is accumulated across blocks. Inside
// the block the work is two passes, which makes every sum's order fixed (the
// result is deterministic, no atomics on floats):
//   pass A, one warp per query row i: s, dpd, the mask bits (one Philox call
//     per four consecutive elements; the keep bits of the whole head are kept
//     as an N x N bitmap in shared memory, 5.5 KB at N = 198), rowsum_i, ds,
//     dq_i;
//   pass B, one warp per key column j: s, dpd recomputed for the column, the
//     keep bit read from the bitmap, rowsum_i read from shared memory, then
//     dv_j and dk_j.
// The recompute costs two extra products (seven in all) and saves an N x N
// f32 buffer that would not fit beside the operands. That design computes on
// the CUDA cores in f32 and now serves float32 inputs only. bf16 inputs, the
// training path's, go to the tensor-core template of attn_bwd_mma.cuh with
// pd and ds rounded to bf16 as above (ROUND = true); see PERF.md for both
// designs' times.
#include <cstdint>

#include "attn_bwd_mma.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 16;  // rows (pass A) or columns (pass B) in flight

// float32 inputs; the roundings of pd and ds to the input dtype are identities
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    flash_qkv_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ lse,
                         const float* __restrict__ dout, float* __restrict__ dqkv, int N,
                         int H, float scale, int num_special, uint32_t thresh,
                         float inv_keep, uint32_t s0, uint32_t s1, int use_dropout) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KS = DH + 1;  // odd row stride: lane r reads row r conflict-free
  const int W = (N + 31) / 32;  // bitmap words per row
  float* qs = smem;             // [N][KS]
  float* ks = qs + N * KS;      // [N][KS]
  float* vs = ks + N * KS;      // [N][KS]
  float* gs = vs + N * KS;      // [N][KS]  dO
  float* ls = gs + N * KS;      // [N]      lse of the head's rows
  float* rs = ls + N;           // [N]      rowsum
  float* rows = rs + N;         // [kWarps][2][N] per-warp score rows
  uint32_t* bits = reinterpret_cast<uint32_t*>(rows + kWarps * 2 * N);  // [N][W]

  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = H * DH;
  const size_t tok_stride = 3 * static_cast<size_t>(inner);
  const float* base = qkv + static_cast<size_t>(b) * N * tok_stride;
  const float* gbase = dout + static_cast<size_t>(b) * N * inner;
  float* obase = dqkv + static_cast<size_t>(b) * N * tok_stride;

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    const int t = idx / DH, d = idx % DH;
    const float* tok = base + static_cast<size_t>(t) * tok_stride + h * DH + d;
    qs[t * KS + d] = tok[0];
    ks[t * KS + d] = tok[inner];
    vs[t * KS + d] = tok[2 * inner];
    gs[t * KS + d] = gbase[static_cast<size_t>(t) * inner + h * DH + d];
  }
  for (int t = threadIdx.x; t < N; t += blockDim.x)
    ls[t] = lse[(static_cast<size_t>(b) * H + h) * N + t];
  if (use_dropout)
    for (int w = threadIdx.x; w < N * W; w += blockDim.x) bits[w] = 0u;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pa = rows + warp * 2 * N;  // sigma, then pd (pass B)
  float* pb = pa + N;               // dpd / dsigma, then ds

  // ---- pass A: one query row per warp -> rowsum_i, keep bits, dq_i ----
  for (int i = warp; i < N; i += kWarps) {
    float q[DH], g[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      q[d] = qs[i * KS + d];  // one address per warp: broadcast
      g[d] = gs[i * KS + d];
    }
    const float li = ls[i];
    float rsum = 0.f;
    for (int j = lane; j < N; j += 32) {
      float sg = 0.f, dp = 0.f;
      if (dual_query_allowed(i, j, num_special)) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          acc = fmaf(q[d], ks[j * KS + d], acc);
          dp = fmaf(g[d], vs[j * KS + d], dp);
        }
        sg = expf(acc * scale - li);
      }
      pa[j] = sg;
      pb[j] = dp;
      if (!use_dropout) rsum = fmaf(dp, sg, rsum);
    }
    __syncwarp();
    if (use_dropout) {
      // one Philox call per group of four consecutive mask elements
      const uint64_t e0 =
          ((static_cast<uint64_t>(b) * H + h) * N + i) * static_cast<uint64_t>(N);
      const uint64_t g_first = e0 >> 2, g_last = (e0 + N - 1) >> 2;
      for (uint64_t gi = g_first + lane; gi <= g_last; gi += 32) {
        const Philox4 r = philox_group(gi, 0u, s0, s1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t e = gi * 4 + k;
          if (e >= e0 && e < e0 + N) {
            const int j = static_cast<int>(e - e0);
            float dsg = 0.f;
            if ((r.w[k] >> 8) < thresh) {
              atomicOr(&bits[i * W + (j >> 5)], 1u << (j & 31));
              dsg = pb[j] * inv_keep;
            }
            pb[j] = dsg;
            rsum = fmaf(dsg, pa[j], rsum);
          }
        }
      }
    }
    rsum = warp_sum(rsum);
    __syncwarp();
    for (int j = lane; j < N; j += 32)
      pb[j] = pa[j] * (pb[j] - rsum) * scale;
    if (lane == 0) rs[i] = rsum;
    __syncwarp();
    float* dq = obase + static_cast<size_t>(i) * tok_stride + h * DH;
    for (int d = lane; d < DH; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(pb[j], ks[j * KS + d], acc);
      dq[d] = acc;
    }
    __syncwarp();  // pa, pb are reused by the warp's next row
  }
  __syncthreads();  // rs and bits are complete

  // ---- pass B: one key column per warp -> dv_j, dk_j ----
  for (int j = warp; j < N; j += kWarps) {
    float k[DH], v[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      k[d] = ks[j * KS + d];
      v[d] = vs[j * KS + d];
    }
    for (int i = lane; i < N; i += 32) {
      float pd = 0.f, ds = 0.f;
      if (dual_query_allowed(i, j, num_special)) {
        float acc = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          acc = fmaf(qs[i * KS + d], k[d], acc);
          dp = fmaf(gs[i * KS + d], v[d], dp);
        }
        const float sg = expf(acc * scale - ls[i]);
        bool keep = true;
        if (use_dropout) keep = (bits[i * W + (j >> 5)] >> (j & 31)) & 1u;
        const float ik = use_dropout ? inv_keep : 1.f;
        pd = keep ? sg * ik : 0.f;
        const float dsg = keep ? dp * ik : 0.f;
        ds = sg * (dsg - rs[i]) * scale;
      }
      pa[i] = pd;
      pb[i] = ds;
    }
    __syncwarp();
    float* tok = obase + static_cast<size_t>(j) * tok_stride + h * DH;
    for (int d = lane; d < DH; d += 32) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < N; ++i) {
        dk = fmaf(pb[i], qs[i * KS + d], dk);
        dv = fmaf(pa[i], gs[i * KS + d], dv);
      }
      tok[inner + d] = dk;
      tok[2 * inner + d] = dv;
    }
    __syncwarp();
  }
}

size_t bwd_smem_bytes(int N, int DH) {
  const size_t n = static_cast<size_t>(N);
  return sizeof(float) * (4 * n * (DH + 1) + 2 * n + kWarps * 2 * n) +
         sizeof(uint32_t) * n * ((n + 31) / 32);
}

template <int DH>
cudaError_t launch_bwd(const void* qkv, const void* lse, const void* dout, void* dqkv,
                       int B, int N, int H, float scale, int num_special,
                       uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                       int use_dropout, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(N, DH);
  cudaError_t err = allow_smem(flash_qkv_bwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  flash_qkv_bwd_kernel<DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<float*>(dqkv), N, H, scale,
      num_special, thresh, inv_keep, s0, s1, use_dropout);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int DH, const void* qkv, const void* lse, const void* dout,
                         void* dqkv, int B, int N, int H, float scale, int num_special,
                         uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                         int use_dropout, cudaStream_t stream) {
  switch (DH) {
    case 16:
      return launch_bwd<16>(qkv, lse, dout, dqkv, B, N, H, scale, num_special, thresh,
                            inv_keep, s0, s1, use_dropout, stream);
    case 32:
      return launch_bwd<32>(qkv, lse, dout, dqkv, B, N, H, scale, num_special, thresh,
                            inv_keep, s0, s1, use_dropout, stream);
    case 64:
      return launch_bwd<64>(qkv, lse, dout, dqkv, B, N, H, scale, num_special, thresh,
                            inv_keep, s0, s1, use_dropout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core kernel on the merged layout, pd and ds rounded
cudaError_t launch_bf16(int DH, const void* qkv, const void* lse, const void* dout,
                        void* dqkv, int B, int N, int H, float scale, int num_special,
                        uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                        int use_dropout, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const long long inner = static_cast<long long>(H) * DH, tok = 3 * inner;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  MmaBwdArgs a{x, x + inner, x + 2 * inner, static_cast<const bf16*>(dout), nullptr,
               dx, dx + inner, dx + 2 * inner, static_cast<const float*>(lse),
               N * tok, DH, tok, N * inner, DH, inner,
               B, H, N, scale, num_special, thresh, inv_keep, s0, s1};
  return use_dropout ? launch_mma_bwd<true, true>(DH, a, stream)
                     : launch_mma_bwd<true, false>(DH, a, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes the backward needs for a sequence of N tokens in the
// given dtype (common.cuh's codes; bf16 counts the keep bitmap, which a
// dropout-free launch leaves out).
size_t eavit_flash_qkv_bwd_smem(int N, int DH, int dtype) {
  return dtype == kBF16 ? mma_bwd_smem_bytes(N, DH, true) : bwd_smem_bytes(N, DH);
}

// Returns the cudaError_t of the launch (0 on success). B <= 65535.
int eavit_flash_qkv_bwd(const void* qkv, const void* lse, const void* dout, void* dqkv,
                        int B, int N, int H, int DH, int dtype, float scale,
                        int num_special, uint32_t thresh, float inv_keep, uint32_t s0,
                        uint32_t s1, int use_dropout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 65535) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    return launch_bf16(DH, qkv, lse, dout, dqkv, B, N, H, scale, num_special, thresh,
                       inv_keep, s0, s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return dispatch_f32(DH, qkv, lse, dout, dqkv, B, N, H, scale, num_special, thresh,
                        inv_keep, s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
