// K4f flash_fwd and K4b flash_bwd: flash attention on [B, H, N, Dh] with the
// dual-query mask and no dropout.
//
// Replaces the TPU kernels eavit_tpu/ops/flash.py `_fwd_kernel` (line 74,
// launched by `_fwd` at line 125) and `_bwd_kernel` (line 147, launched by
// `_bwd` at line 217). The forward, and the backward for float32 inputs, are
// the DROPOUT = false instantiations of flash_attn.cuh, which documents the
// math and the design. The backward for bf16 inputs is the tensor-core
// template of attn_bwd_mma.cuh with p and ds kept f32 as hi + lo bf16 terms
// (ROUND = false), no mask, and delta = sum(dO * O) from the given O
// (DELTA_FROM_O).
//
// What bounds them on an H100: bytes. At the flagship minibatch ([256, 8, 198,
// 32] bf16) the forward must move 105 MB (q, k, v read once, o and lse written
// once) against 5.1 GFLOP, the backward 209 MB (q, k, v, o, dO, lse read,
// dq, dk, dv written) against 12.8 GFLOP of five products: far below the 295
// FLOP/byte where the bf16 tensor cores would be the limit. The design keeps
// scores and probabilities out of device memory and reads each input once per
// block. The forward and the float32 backward compute on the CUDA cores in
// f32; see PERF.md for the times.
#include "attn_bwd_mma.cuh"
#include "flash_attn.cuh"

extern "C" {

// Shared-memory bytes each kernel needs for a sequence of N tokens.
size_t eavit_flash_fwd_smem(int N, int DH) { return fwd_smem_bytes(N, DH); }
// The backward's depends on the dtype (common.cuh's codes).
size_t eavit_flash_bwd_smem(int N, int DH, int dtype) {
  return dtype == kBF16 ? mma_bwd_smem_bytes(N, DH, false) : bwd_smem_bytes(N, DH, false);
}

// Each returns the cudaError_t of its launch (0 on success). BH = B * H.
int eavit_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int BH, int N, int DH, int dtype, float scale, int num_special,
                    void* stream) {
  FwdArgs a{q, k, v, o, static_cast<float*>(lse), N, scale, num_special, 0u, 1.f, 0u, 0u};
  return launch<false>(dtype, DH, BH, a, stream);
}

int eavit_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* lse, const void* dout, void* dq, void* dk, void* dv,
                    int BH, int N, int DH, int dtype, float scale, int num_special,
                    void* stream) {
  if (dtype == kBF16) {  // the tensor-core kernel, one (b, h) row of [BH, N, Dh] each
    using bf16 = __nv_bfloat16;
    const long long head = static_cast<long long>(N) * DH;
    MmaBwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                 static_cast<const bf16*>(o), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv), static_cast<const float*>(lse), head, 0, DH, head, 0,
                 DH, BH, 1, N, scale, num_special, 0u, 1.f, 0u, 0u};
    return launch_mma_bwd<false, false, true>(DH, a, static_cast<cudaStream_t>(stream));
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv,
            N, scale, num_special, 0u, 1.f, 0u, 0u};
  return launch_bwd<false>(DH, BH, a, stream);
}

}  // extern "C"
