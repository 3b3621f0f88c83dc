// K1f flash_qkv_fwd and K1r flash_qkv_bits.
//
// Replaces the TPU kernel eavit_tpu/ops/flash_qkv.py `_fwd_kernel` (line 242,
// launched by `_fwd` at line 531; `_fwd_kernel_fori` and `_fwd_kernel_split`
// are other TPU head-loop schedules of the same math) and its mask replay
// `_bits_kernel` (line 683, launched at line 715).
//
// What it computes, per batch row b and head h, from the raw qkv projection
// [B, N, 3*H*Dh] (q at column h*Dh, k at H*Dh + h*Dh, v at 2*H*Dh + h*Dh):
//   s = q k^T * scale in f32, with the dual-query mask when num_special > 0
//   sigma = softmax(s); lse = max + log(sum)
//   sigma' = keep ? sigma * 2^24/thresh : 0   (Philox, philox.cuh, stream 0,
//            element index ((b*H + h)*N + i)*N + j)
//   o = round_to_input_dtype(sigma') v with f32 accumulation
// o is written into columns h*Dh .. of [B, N, H*Dh] (the head merge happens
// in the kernel, as on the TPU), lse into [B, H, N].
//
// What bounds it on an H100: bytes. At the flagship act shape (B=64, N=198,
// H=8, Dh=32, bf16) it must move 26 MB (qkv read once, o and lse written
// once) against 2.6 GFLOP, far below the 295 FLOP/byte where bf16 tensor
// cores would be the limit. Both designs read qkv once per (b, h) or query
// tile and never write scores, probabilities or masks to device memory, and
// draw the mask bits in registers, one Philox call per four elements:
//   bf16 (the act and training paths): the tensor-core template of
//     attn_fwd_mma.cuh, one block per (b, h) with q, k and v in shared memory
//     as bf16, two sweeps of mma.sync over 16 x 16 tiles;
//   float32: the CUDA-core kernel below. K and V of one head stay in shared
//     memory (N*(2*Dh+1) floats), each warp owns one query row at a time and
//     keeps its scores in a shared-memory row, all in f32.
// See PERF.md for their measured times.
#include <cstdint>

#include "attn_fwd_mma.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 8;          // query rows in flight per block
constexpr int kRowsPerBlock = 64;  // query tile of one block

// float32 inputs; the rounding of sigma' to the input dtype is the identity
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    flash_qkv_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                         float* __restrict__ lse, int N, int H, float scale,
                         int num_special, uint32_t thresh, float inv_keep,
                         uint32_t s0, uint32_t s1, int use_dropout) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KS = DH + 1;  // odd row stride: lane j reads row j conflict-free
  float* ks = smem;           // [N][KS]
  float* vs = ks + N * KS;    // [N][DH]
  float* ps = vs + N * DH;    // [kWarps][N]: one row of scores per warp

  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = H * DH;
  const size_t tok_stride = 3 * static_cast<size_t>(inner);
  const float* base = qkv + static_cast<size_t>(b) * N * tok_stride;

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH;
    const float* tok = base + static_cast<size_t>(j) * tok_stride;
    ks[j * KS + d] = tok[inner + h * DH + d];
    vs[j * DH + d] = tok[2 * inner + h * DH + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * N;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int i = row0 + warp; i < row_end; i += kWarps) {
    const float* qrow = base + static_cast<size_t>(i) * tok_stride + h * DH;
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = qrow[d];  // one address per warp

    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = -INFINITY;
      if (dual_query_allowed(i, j, num_special)) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc = fmaf(q[d], ks[j * KS + d], acc);
        s = acc * scale;
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

    if (use_dropout) {
      // one Philox call per group of four consecutive mask elements
      const uint64_t e0 =
          ((static_cast<uint64_t>(b) * H + h) * N + i) * static_cast<uint64_t>(N);
      const uint64_t g_first = e0 >> 2, g_last = (e0 + N - 1) >> 2;
      for (uint64_t g = g_first + lane; g <= g_last; g += 32) {
        const Philox4 r = philox_group(g, 0u, s0, s1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t e = g * 4 + k;
          if (e >= e0 && e < e0 + N) {
            const int j = static_cast<int>(e - e0);
            const float sg = p[j] / l;
            p[j] = (r.w[k] >> 8) < thresh ? sg * inv_keep : 0.f;
          }
        }
      }
    } else {
      for (int j = lane; j < N; j += 32) p[j] = p[j] / l;
    }
    __syncwarp();

    float* orow = o + (static_cast<size_t>(b) * N + i) * inner + h * DH;
    for (int d = lane; d < DH; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], vs[j * DH + d], acc);
      orow[d] = acc;
    }
    if (lane == 0) lse[(static_cast<size_t>(b) * H + h) * N + i] = m + logf(l);
    __syncwarp();  // p is reused by the warp's next row
  }
}

__global__ void flash_qkv_bits_kernel(int32_t* __restrict__ out, uint64_t numel,
                                      uint32_t s0, uint32_t s1) {
  bits24_grid_stride(out, numel, 0u, s0, s1);
}

size_t fwd_smem_bytes(int N, int DH) {
  return sizeof(float) * (static_cast<size_t>(N) * (2 * DH + 1) +
                          static_cast<size_t>(kWarps) * N);
}

template <int DH>
cudaError_t launch_fwd(const void* qkv, void* o, void* lse, int B, int N, int H,
                       float scale, int num_special, uint32_t thresh,
                       float inv_keep, uint32_t s0, uint32_t s1, int use_dropout,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(N, DH);
  cudaError_t err = allow_smem(flash_qkv_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  flash_qkv_fwd_kernel<DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(o), static_cast<float*>(lse), N,
      H, scale, num_special, thresh, inv_keep, s0, s1, use_dropout);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int DH, const void* qkv, void* o, void* lse, int B, int N,
                         int H, float scale, int num_special, uint32_t thresh,
                         float inv_keep, uint32_t s0, uint32_t s1, int use_dropout,
                         cudaStream_t stream) {
  switch (DH) {
    case 16:
      return launch_fwd<16>(qkv, o, lse, B, N, H, scale, num_special, thresh,
                            inv_keep, s0, s1, use_dropout, stream);
    case 32:
      return launch_fwd<32>(qkv, o, lse, B, N, H, scale, num_special, thresh,
                            inv_keep, s0, s1, use_dropout, stream);
    case 64:
      return launch_fwd<64>(qkv, o, lse, B, N, H, scale, num_special, thresh,
                            inv_keep, s0, s1, use_dropout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core kernel on the merged layout
cudaError_t launch_bf16(int DH, const void* qkv, void* o, void* lse, int B, int N, int H,
                        float scale, int num_special, uint32_t thresh, float inv_keep,
                        uint32_t s0, uint32_t s1, int use_dropout, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const long long inner = static_cast<long long>(H) * DH, tok = 3 * inner;
  const bf16* x = static_cast<const bf16*>(qkv);
  MmaFwdArgs a{x, x + inner, x + 2 * inner, static_cast<bf16*>(o), static_cast<float*>(lse),
               N * tok, DH, tok, N * inner, DH, inner,
               B, H, N, scale, num_special, thresh, inv_keep, s0, s1};
  return use_dropout ? launch_mma_fwd<true>(DH, a, stream)
                     : launch_mma_fwd<false>(DH, a, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes the forward needs for a sequence of N tokens in the
// given dtype (common.cuh's codes; bf16 counts the keep bitmaps, which a
// dropout-free launch leaves out).
size_t eavit_flash_qkv_fwd_smem(int N, int DH, int dtype) {
  return dtype == kBF16 ? mma_fwd_smem_bytes(N, DH, true) : fwd_smem_bytes(N, DH);
}

// Returns the cudaError_t of the launch (0 on success).
int eavit_flash_qkv_fwd(const void* qkv, void* o, void* lse, int B, int N, int H,
                        int DH, int dtype, float scale, int num_special,
                        uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                        int use_dropout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return launch_bf16(DH, qkv, o, lse, B, N, H, scale, num_special, thresh, inv_keep, s0,
                       s1, use_dropout, st);
  }
  if (dtype == kF32) {
    return dispatch_f32(DH, qkv, o, lse, B, N, H, scale, num_special, thresh, inv_keep,
                        s0, s1, use_dropout, st);
  }
  return cudaErrorInvalidValue;
}

int eavit_flash_qkv_bits(void* out, unsigned long long numel, uint32_t s0,
                         uint32_t s1, void* stream) {
  const int threads = 256;
  flash_qkv_bits_kernel<<<bits_grid((numel + 3) / 4, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), numel, s0, s1);
  return cudaGetLastError();
}

}  // extern "C"
