// K3f flash_dropout_fwd, K3b flash_dropout_bwd and K3r flash_dropout_bits:
// flash attention on [B, H, N, Dh] with probability dropout in the kernel.
//
// Replaces the TPU kernels eavit_tpu/ops/flash_dropout.py `_fwd_kernel` (line
// 123, launched by `_fwd` at line 225), `_bwd_kernel` (line 150, launched by
// `_bwd` at line 254) and the mask replay `_bits_kernel` (line 327, launched
// by `dropout_raw_bits` at line 349). The forward: f32 scores, sigma = p / l,
// pd = keep ? sigma * inv_keep : 0, o = pd v with pd unrounded. The backward,
// from q, k, v, lse and dO (no O is saved): dv = pd^T dO, dsigma = keep ?
// (dO v^T) * inv_keep : 0, rowsum = sum(dsigma * sigma) (the delta trick is
// wrong under dropout), ds = sigma (dsigma - rowsum) scale. The TPU kernels
// seed the core PRNG per grid cell, which ties the mask to the blocking; here
// the mask is Philox on the element's logical index (ops/kernel_prng.py), so
// every kernel regenerates it with its own tiling and none stores it.
//
// bf16 inputs run the tensor-core templates (attn_fwd_mma.cuh with DROPOUT,
// attn_bwd_mma.cuh), with sigma', pd and ds kept f32 as hi + lo bf16 terms
// (ROUND = false); float32 inputs the CUDA-core template of
// flash_stream.cuh. All stream their operands, so they take any N. Where a
// bf16 head fits in shared memory and N <= 256 the wrapper runs the
// backward's whole-head form instead, attn_bwd_head.cuh, the faster one at
// the flagship N = 198.
//
// What bounds them on an H100: bytes. At the flagship minibatch ([256, 8, 198,
// 32] bf16) the forward must move 105 MB against 5.1 GFLOP, the backward 183 MB
// (q, k, v, dO, lse read, dq, dk, dv written; no O) against 12.8 GFLOP of five
// products, far below the bf16 tensor cores' 295 FLOP/byte. The mask costs no
// bytes: it is drawn in registers, one Philox call per four elements. See
// PERF.md for the times.
#include "attn_bwd_head.cuh"
#include "attn_bwd_mma.cuh"
#include "attn_fwd_mma.cuh"
#include "flash_stream.cuh"

namespace {

__global__ void flash_dropout_bits_kernel(int32_t* __restrict__ out, uint64_t numel,
                                          uint32_t s0, uint32_t s1) {
  bits24_grid_stride(out, numel, 0u, s0, s1);
}

}  // namespace

extern "C" {

// Shared-memory bytes of each kernel at head width DH in the given dtype
// (common.cuh's codes), whatever N is; the backward's which: 0 = dq, 1 = dk/dv.
size_t eavit_flash_dropout_fwd_smem(int DH, int dtype) {
  return dtype == kBF16 ? mma_fwd_smem_by_dh(DH) : stream_smem_by_dh(kFwd, DH);
}
size_t eavit_flash_dropout_bwd_smem(int DH, int dtype, int which) {
  return dtype == kBF16 ? mma_bwd_smem_by_dh(DH, which)
                        : stream_smem_by_dh(which == 0 ? kDq : kDkv, DH);
}

// Each returns the cudaError_t of its launches (0 on success). BH = B * H; the
// keep threshold and inverse scale follow ops/kernel_prng.py.
int eavit_flash_dropout_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int BH, int N, int DH, int dtype, float scale,
                            int num_special, uint32_t thresh, float inv_keep,
                            uint32_t s0, uint32_t s1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using bf16 = __nv_bfloat16;
    MmaFwdArgs a{};
    a.q = static_cast<const bf16*>(q), a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v), a.o = static_cast<bf16*>(o);
    a.lse = static_cast<float*>(lse), a.scale = scale, a.num_special = num_special;
    a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
    mma_head_major(a, BH, N, DH);
    a.o_batch = a.x_batch, a.o_head = 0, a.o_tok = DH;
    return launch_mma_fwd<false, true>(DH, a, st);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = o, a.lse_out = static_cast<float*>(lse);
  a.N = N, a.scale = scale, a.num_special = num_special;
  a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
  head_major(a, N, DH);
  return launch_stream<kFwd, true>(DH, BH, a, st);
}

// rowsum: a [BH, N] f32 scratch
int eavit_flash_dropout_bwd(const void* q, const void* k, const void* v,
                            const void* lse, const void* dout, void* dq, void* dk,
                            void* dv, void* rowsum, int BH, int N, int DH, int dtype,
                            float scale, int num_special, uint32_t thresh, float inv_keep,
                            uint32_t s0, uint32_t s1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    MmaBwdArgs a =
        mma_bwd_head_major(q, k, v, dout, lse, dq, dk, dv, BH, N, DH, scale, num_special);
    a.rowterm = a.rowterm_out = static_cast<float*>(rowsum);
    a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
    return launch_mma_bwd<false, true>(DH, a, st);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = static_cast<const float*>(lse);
  a.rowterm = static_cast<float*>(rowsum), a.dq = dq, a.dk = dk, a.dv = dv;
  a.N = N, a.scale = scale, a.num_special = num_special;
  a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
  head_major(a, N, DH);
  return launch_stream_bwd_f32<true, kRowsum>(DH, BH, a, st);
}

// The whole-head bf16 K3b (attn_bwd_head.cuh), which the wrapper runs where
// it fits: its shared memory at N tokens, then the launch.
size_t eavit_flash_dropout_bwd_head_smem(int N, int DH) {
  return head_bwd_smem_bytes(N, DH, true);
}

int eavit_flash_dropout_bwd_head(const void* q, const void* k, const void* v,
                                 const void* lse, const void* dout, void* dq, void* dk,
                                 void* dv, int BH, int N, int DH, float scale,
                                 int num_special, uint32_t thresh, float inv_keep,
                                 uint32_t s0, uint32_t s1, void* stream) {
  MmaBwdArgs a =
      mma_bwd_head_major(q, k, v, dout, lse, dq, dk, dv, BH, N, DH, scale, num_special);
  a.thresh = thresh, a.inv_keep = inv_keep, a.s0 = s0, a.s1 = s1;
  return launch_head_bwd<false, true>(DH, a, static_cast<cudaStream_t>(stream));
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
