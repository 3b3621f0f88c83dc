// K4f flash_fwd and K4b flash_bwd: flash attention on [B, H, N, Dh] with the
// dual-query mask and no dropout.
//
// Replaces the TPU kernels eavit_tpu/ops/flash.py `_fwd_kernel` (line 74,
// launched by `_fwd` at line 125) and `_bwd_kernel` (line 147, launched by
// `_bwd` at line 217). The forward takes f32 scores, p = exp(s - m) and o =
// (p v) / l with p unrounded; the backward p = exp(s - lse), delta = sum(dO *
// O) per row from the O the forward wrote (flash.py:179), ds = p (dO v^T -
// delta) scale, and writes dq, dk and dv once each.
//
// bf16 inputs run the tensor-core templates: the forward attn_fwd_mma.cuh at
// rate 0 with sigma = p / l kept f32 as hi + lo bf16 terms (ROUND = false),
// the backward attn_bwd_mma.cuh with p and ds as hi + lo terms, no mask and
// delta from O (kDeltaFromO). float32 inputs run the CUDA-core template of
// flash_stream.cuh (the forward is K5f's instantiation, the dq pass sums
// delta from O). All stream their operands, so they take any N. Where a
// bf16 head fits in shared memory and N <= 256 the wrapper runs the
// backward's whole-head form instead, attn_bwd_head.cuh, the faster one at
// the flagship N = 198.
//
// What bounds them on an H100: bytes. At the flagship minibatch ([256, 8, 198,
// 32] bf16) the forward must move 105 MB (q, k, v read once, o and lse written
// once) against 5.1 GFLOP, the backward 209 MB (q, k, v, o, dO, lse read,
// dq, dk, dv written) against 12.8 GFLOP of five products: far below the 295
// FLOP/byte where the bf16 tensor cores would be the limit. The design keeps
// scores and probabilities out of device memory; see PERF.md for the times.
#include "attn_bwd_head.cuh"
#include "attn_bwd_mma.cuh"
#include "attn_fwd_mma.cuh"
#include "flash_stream.cuh"

extern "C" {

// Shared-memory bytes of each kernel at head width DH in the given dtype
// (common.cuh's codes), whatever N is; the backward's which: 0 = dq, 1 = dk/dv.
size_t eavit_flash_fwd_smem(int DH, int dtype) {
  return dtype == kBF16 ? mma_fwd_smem_by_dh(DH) : stream_smem_by_dh(kFwd, DH);
}
size_t eavit_flash_bwd_smem(int DH, int dtype, int which) {
  return dtype == kBF16 ? mma_bwd_smem_by_dh(DH, which)
                        : stream_smem_by_dh(which == 0 ? kDq : kDkv, DH);
}

// Each returns the cudaError_t of its launches (0 on success). BH = B * H.
int eavit_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int BH, int N, int DH, int dtype, float scale, int num_special,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using bf16 = __nv_bfloat16;
    MmaFwdArgs a{};
    a.q = static_cast<const bf16*>(q), a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v), a.o = static_cast<bf16*>(o);
    a.lse = static_cast<float*>(lse), a.scale = scale, a.num_special = num_special;
    mma_head_major(a, BH, N, DH);
    a.o_batch = a.x_batch, a.o_head = 0, a.o_tok = DH;
    return launch_mma_fwd<false, false>(DH, a, st);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = o, a.lse_out = static_cast<float*>(lse);
  a.N = N, a.scale = scale, a.num_special = num_special;
  head_major(a, N, DH);
  return launch_stream<kFwd>(DH, BH, a, st);
}

// delta: a [BH, N] f32 scratch
int eavit_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* lse, const void* dout, void* dq, void* dk, void* dv,
                    void* delta, int BH, int N, int DH, int dtype, float scale,
                    int num_special, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    MmaBwdArgs a =
        mma_bwd_head_major(q, k, v, dout, lse, dq, dk, dv, BH, N, DH, scale, num_special);
    a.o = static_cast<const __nv_bfloat16*>(o);
    a.rowterm = a.rowterm_out = static_cast<float*>(delta);
    return launch_mma_bwd<false, false, kDeltaFromO>(DH, a, st);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.dout = dout, a.lse = static_cast<const float*>(lse);
  a.rowterm = static_cast<float*>(delta), a.dq = dq, a.dk = dk, a.dv = dv;
  a.N = N, a.scale = scale, a.num_special = num_special;
  head_major(a, N, DH);
  return launch_stream_bwd_f32<false, kDeltaFromO>(DH, BH, a, st);
}

// The whole-head bf16 K4b (attn_bwd_head.cuh), which the wrapper runs where
// it fits: its shared memory at N tokens, then the launch.
size_t eavit_flash_bwd_head_smem(int N, int DH) { return head_bwd_smem_bytes(N, DH, false); }

int eavit_flash_bwd_head(const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* dq, void* dk, void* dv,
                         int BH, int N, int DH, float scale, int num_special, void* stream) {
  MmaBwdArgs a =
      mma_bwd_head_major(q, k, v, dout, lse, dq, dk, dv, BH, N, DH, scale, num_special);
  a.o = static_cast<const __nv_bfloat16*>(o);
  return launch_head_bwd<false, false, true>(DH, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
