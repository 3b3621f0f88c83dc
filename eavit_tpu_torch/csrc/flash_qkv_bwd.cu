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
// keeps scores, probabilities and masks out of device memory and streams
// its operands, so that it takes any N: FlashAttention-2's split into a dq
// pass (query chunks, K/V streamed; rowsum from a first sweep, written to a
// [B, H, N] f32 scratch) and a dk/dv pass (key chunks, Q/dO streamed with
// their lse and rowsum), each output with one owner and no float atomics.
// bf16 inputs, the training path's, run the tensor-core template of
// attn_bwd_mma.cuh with pd and ds rounded to bf16 (ROUND = true); float32
// inputs the CUDA-core template of flash_stream.cuh, where the roundings are
// identities. Where a bf16 head fits in shared memory and N <= 256 the
// wrapper runs the whole-head form of the template instead,
// attn_bwd_head.cuh: one kernel that draws the mask once per head, the
// faster one at the flagship N = 198. See PERF.md for the times.
#include <cstdint>

#include "attn_bwd_head.cuh"
#include "attn_bwd_mma.cuh"
#include "flash_stream.cuh"

extern "C" {

// Shared-memory bytes of the backward's two kernels at head width DH in the
// given dtype (common.cuh's codes), whatever N is; which: 0 = dq, 1 = dk/dv.
size_t eavit_flash_qkv_bwd_smem(int DH, int dtype, int which) {
  return dtype == kBF16 ? mma_bwd_smem_by_dh(DH, which)
                        : stream_smem_by_dh(which == 0 ? kDq : kDkv, DH);
}

// Returns the cudaError_t of its launches (0 on success); rowsum is a
// [B, H, N] f32 scratch.
int eavit_flash_qkv_bwd(const void* qkv, const void* lse, const void* dout, void* dqkv,
                        void* rowsum, int B, int N, int H, int DH, int dtype, float scale,
                        int num_special, uint32_t thresh, float inv_keep, uint32_t s0,
                        uint32_t s1, int use_dropout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long inner = static_cast<long long>(H) * DH, tok = 3 * inner;
  if (dtype == kBF16) {
    using bf16 = __nv_bfloat16;
    const bf16* x = static_cast<const bf16*>(qkv);
    bf16* dx = static_cast<bf16*>(dqkv);
    MmaBwdArgs a{x, x + inner, x + 2 * inner, static_cast<const bf16*>(dout), nullptr,
                 dx, dx + inner, dx + 2 * inner, static_cast<const float*>(lse),
                 static_cast<float*>(rowsum), static_cast<float*>(rowsum), N * tok, DH, tok, N * inner, DH, inner,
                 B, H, N, scale, num_special, thresh, inv_keep, s0, s1};
    return use_dropout ? launch_mma_bwd<true, true>(DH, a, st)
                       : launch_mma_bwd<true, false>(DH, a, st);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(qkv);
  float* dx = static_cast<float*>(dqkv);
  StreamArgs a{};
  a.q = x, a.k = x + inner, a.v = x + 2 * inner, a.dout = dout;
  a.lse = static_cast<const float*>(lse), a.rowterm = static_cast<float*>(rowsum);
  a.dq = dx, a.dk = dx + inner, a.dv = dx + 2 * inner;
  a.H = H, a.N = N, a.scale = scale, a.num_special = num_special;
  a.x_batch = N * tok, a.x_head = DH, a.x_tok = tok;
  a.g_batch = N * inner, a.g_head = DH, a.g_tok = inner;
  a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
  return use_dropout ? launch_stream_bwd_f32<true, kRowsum, true>(DH, B * H, a, st)
                     : launch_stream_bwd_f32<false, kRowsum, true>(DH, B * H, a, st);
}

// The whole-head bf16 kernel (attn_bwd_head.cuh), which the wrapper runs
// where it fits: its shared memory at N tokens, then the launch (B <= 65535).
size_t eavit_flash_qkv_bwd_head_smem(int N, int DH) { return head_bwd_smem_bytes(N, DH, true); }

int eavit_flash_qkv_bwd_head(const void* qkv, const void* lse, const void* dout, void* dqkv,
                             int B, int N, int H, int DH, float scale, int num_special,
                             uint32_t thresh, float inv_keep, uint32_t s0, uint32_t s1,
                             int use_dropout, void* stream) {
  using bf16 = __nv_bfloat16;
  const long long inner = static_cast<long long>(H) * DH, tok = 3 * inner;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  MmaBwdArgs a{x, x + inner, x + 2 * inner, static_cast<const bf16*>(dout), nullptr,
               dx, dx + inner, dx + 2 * inner, static_cast<const float*>(lse), nullptr,
               nullptr, N * tok, DH, tok, N * inner, DH, inner,
               B, H, N, scale, num_special, thresh, inv_keep, s0, s1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return use_dropout ? launch_head_bwd<true, true>(DH, a, st)
                     : launch_head_bwd<true, false>(DH, a, st);
}

}  // extern "C"
