// K3f flash_dropout_fwd, K3b flash_dropout_bwd and K3r flash_dropout_bits:
// flash attention on [B, H, N, Dh] with probability dropout in the kernel.
//
// Replaces the TPU kernels eavit_tpu/ops/flash_dropout.py `_fwd_kernel` (line
// 123, launched by `_fwd` at line 225), `_bwd_kernel` (line 150, launched by
// `_bwd` at line 254) and the mask replay `_bits_kernel` (line 327, launched
// by `dropout_raw_bits` at line 349). The forward and backward are the
// DROPOUT = true instantiations of flash_attn.cuh, which documents the math
// and the design. The TPU kernels seed the core PRNG per grid cell, which
// ties the mask to the blocking; here the mask is Philox on the element's
// logical index (ops/kernel_prng.py), so the backward regenerates it with its
// own tiling and never stores it.
//
// What bounds them on an H100: bytes. At the flagship minibatch ([256, 8, 198,
// 32] bf16) the forward must move 105 MB against 5.1 GFLOP, the backward 183 MB
// (q, k, v, dO, lse read, dq, dk, dv written; no O) against 12.8 GFLOP of five
// products, far below the bf16 tensor cores' 295 FLOP/byte. The mask costs no
// bytes: it is drawn in registers, one Philox call per four elements. The
// forward, and the backward for float32 inputs, compute on the CUDA cores in
// f32; the backward for bf16 inputs is the tensor-core template of
// attn_bwd_mma.cuh with pd and ds kept f32 as hi + lo bf16 terms (ROUND =
// false). See PERF.md for the times.
#include "attn_bwd_mma.cuh"
#include "flash_attn.cuh"

namespace {

__global__ void flash_dropout_bits_kernel(int32_t* __restrict__ out, uint64_t numel,
                                          uint32_t s0, uint32_t s1) {
  bits24_grid_stride(out, numel, 0u, s0, s1);
}

}  // namespace

extern "C" {

// Shared-memory bytes each kernel needs for a sequence of N tokens.
size_t eavit_flash_dropout_fwd_smem(int N, int DH) { return fwd_smem_bytes(N, DH); }
size_t eavit_flash_dropout_bwd_smem(int N, int DH, int dtype) {
  return dtype == kBF16 ? mma_bwd_smem_bytes(N, DH, true) : bwd_smem_bytes(N, DH, true);
}

// Each returns the cudaError_t of its launch (0 on success). BH = B * H; the
// keep threshold and inverse scale follow ops/kernel_prng.py.
int eavit_flash_dropout_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int BH, int N, int DH, int dtype, float scale,
                            int num_special, uint32_t thresh, float inv_keep,
                            uint32_t s0, uint32_t s1, void* stream) {
  FwdArgs a{q, k, v, o, static_cast<float*>(lse), N, scale, num_special,
            thresh, inv_keep, s0, s1};
  return launch<true>(dtype, DH, BH, a, stream);
}

int eavit_flash_dropout_bwd(const void* q, const void* k, const void* v,
                            const void* lse, const void* dout, void* dq, void* dk,
                            void* dv, int BH, int N, int DH, int dtype, float scale,
                            int num_special, uint32_t thresh, float inv_keep,
                            uint32_t s0, uint32_t s1, void* stream) {
  if (dtype == kBF16) {  // the tensor-core kernel, one (b, h) row of [BH, N, Dh] each
    using bf16 = __nv_bfloat16;
    const long long head = static_cast<long long>(N) * DH;
    MmaBwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout), nullptr,
                 static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(lse), head, 0, DH, head, 0, DH,
                 BH, 1, N, scale, num_special, thresh, inv_keep, s0, s1};
    return launch_mma_bwd<false, true>(DH, a, static_cast<cudaStream_t>(stream));
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, nullptr, static_cast<const float*>(lse), dout, dq, dk, dv,
            N, scale, num_special, thresh, inv_keep, s0, s1};
  return launch_bwd<true>(DH, BH, a, stream);
}

int eavit_flash_dropout_bits(void* out, unsigned long long numel, uint32_t s0,
                             uint32_t s1, void* stream) {
  const int threads = 256;
  flash_dropout_bits_kernel<<<bits_grid((numel + 3) / 4, threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), numel, s0, s1);
  return cudaGetLastError();
}

}  // extern "C"
