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
// cores would be the limit. Both forms stream K and V through shared memory
// in fixed tiles, so they take any N; neither writes scores, probabilities or
// masks to device memory, and draw each group of the mask once, one Philox
// call per four elements:
//   bf16 (the act and training paths): the tensor-core template of
//     attn_fwd_mma.cuh (ROUND: sigma' rounded to bf16), two sweeps of
//     mma.sync over 16 x 16 blocks; where the head fits in shared memory and
//     N <= 256 the wrapper runs its whole-head form instead,
//     attn_fwd_head.cuh, which is the faster one at the flagship N = 198;
//   float32: the CUDA-core template of flash_stream.cuh with dropout on the
//     merged layout, an online softmax (the rounding to float32 is the
//     identity).
// See PERF.md for their measured times.
#include <cstdint>

#include "attn_fwd_head.cuh"
#include "attn_fwd_mma.cuh"
#include "flash_stream.cuh"

namespace {

__global__ void flash_qkv_bits_kernel(int32_t* __restrict__ out, uint64_t numel,
                                      uint32_t s0, uint32_t s1) {
  bits24_grid_stride(out, numel, 0u, s0, s1);
}

}  // namespace

extern "C" {

// Shared-memory bytes of the forward at head width DH in the given dtype
// (common.cuh's codes), whatever N is.
size_t eavit_flash_qkv_fwd_smem(int DH, int dtype) {
  return dtype == kBF16 ? mma_fwd_smem_by_dh(DH) : stream_smem_by_dh(kFwd, DH);
}

// Returns the cudaError_t of the launch (0 on success).
int eavit_flash_qkv_fwd(const void* qkv, void* o, void* lse, int B, int N, int H,
                        int DH, int dtype, float scale, int num_special,
                        uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                        int use_dropout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long inner = static_cast<long long>(H) * DH, tok = 3 * inner;
  if (dtype == kBF16) {
    using bf16 = __nv_bfloat16;
    const bf16* x = static_cast<const bf16*>(qkv);
    MmaFwdArgs a{x, x + inner, x + 2 * inner, static_cast<bf16*>(o), static_cast<float*>(lse),
                 N * tok, DH, tok, N * inner, DH, inner,
                 B, H, N, scale, num_special, thresh, inv_keep, s0, s1};
    return use_dropout ? launch_mma_fwd<true, true>(DH, a, st)
                       : launch_mma_fwd<true, false>(DH, a, st);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(qkv);
  StreamArgs a{};
  a.q = x, a.k = x + inner, a.v = x + 2 * inner, a.out = o, a.lse_out = static_cast<float*>(lse);
  a.H = H, a.N = N, a.scale = scale, a.num_special = num_special;
  a.x_batch = N * tok, a.x_head = DH, a.x_tok = tok;
  a.g_batch = N * inner, a.g_head = DH, a.g_tok = inner;
  a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
  return use_dropout ? launch_stream<kFwd, true, kGiven, true>(DH, B * H, a, st)
                     : launch_stream<kFwd, false, kGiven, true>(DH, B * H, a, st);
}

// The whole-head bf16 kernel (attn_fwd_head.cuh), which the wrapper runs
// where it fits: its shared memory at N tokens, then the launch.
size_t eavit_flash_qkv_fwd_head_smem(int N, int DH) { return head_fwd_smem_bytes(N, DH, true); }

int eavit_flash_qkv_fwd_head(const void* qkv, void* o, void* lse, int B, int N, int H, int DH,
                             float scale, int num_special, uint32_t thresh, float inv_keep,
                             uint32_t s0, uint32_t s1, int use_dropout, void* stream) {
  using bf16 = __nv_bfloat16;
  const long long inner = static_cast<long long>(H) * DH, tok = 3 * inner;
  const bf16* x = static_cast<const bf16*>(qkv);
  MmaFwdArgs a{x, x + inner, x + 2 * inner, static_cast<bf16*>(o), static_cast<float*>(lse),
               N * tok, DH, tok, N * inner, DH, inner,
               B, H, N, scale, num_special, thresh, inv_keep, s0, s1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return use_dropout ? launch_head_fwd<true>(DH, a, st) : launch_head_fwd<false>(DH, a, st);
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
