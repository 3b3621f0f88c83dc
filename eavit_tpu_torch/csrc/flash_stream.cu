// K5f flash_stream_fwd, K5q flash_stream_dq and K5kv flash_stream_dkv: flash
// attention on [B, H, N, Dh] that streams K/V (forward, dq) or Q/dO (dk, dv)
// through shared memory in fixed tiles, so that no buffer grows with N.
//
// Replaces the TPU kernels eavit_tpu/ops/flash_stream.py `_fwd_kernel` (line
// 99, launched by `_fwd` at line 159), `_bwd_dq_kernel` (line 183, launched by
// `_bwd` at line 285) and `_bwd_dkv_kernel` (line 221, launched at line 304).
// The math is theirs: the forward's online softmax, then dq = ds k (K5q) and
// dk = ds^T q, dv = p^T dO (K5kv) with ds = p (dO v^T - delta) scale and
// delta = sum(dO * O) per row computed outside, from the rounded O the
// forward returned (flash_stream.py:273-274). Inputs are contiguous
// [B*H, N, Dh], bf16 or f32. Which template runs which dtype:
//   K5f, bf16: the tensor-core forward attn_fwd_mma.cuh in its one-sweep
//     mode (ONE_SWEEP: the online softmax, p as hi + lo bf16 terms), which
//     computes the function K4f's two sweeps compute at rate 0;
//   K5f, float32: flash_stream.cuh's CUDA-core template without dropout
//     (its online softmax), whose float32 form K4f shares;
//   K5q and K5kv, bf16: the tensor-core backward attn_bwd_mma.cuh, its dq
//     kernel and its dk/dv kernel launched alone, no dropout, p and ds kept
//     f32 as hi + lo bf16 terms (ROUND = false, as K4b), the row term the
//     caller's delta (kGiven), which neither kernel writes;
//   K5q and K5kv, float32: flash_stream.cuh's CUDA-core dq and dk/dv passes
//     with the row term given, the template that float32 K1b, K3b and K4b
//     share.
//
// What bounds them on an H100: bytes at the flagship's N. At [256, 8, 198, 32]
// bf16 the forward must move 105 MB against 10 GFLOP, the dq pass 133 MB
// against 15 GFLOP, the dk/dv pass 159 MB against 20 GFLOP, all below the
// bf16 tensor cores' 295 FLOP/byte; past N of about 1,000 at Dh = 64 the
// operations bound instead. The designs keep scores and probabilities out of
// device memory and read each operand once per block; every bf16 product
// runs on the tensor cores (mma.sync), the float32 passes on the CUDA cores in
// f32. See PERF.md for the measured times.
#include "attn_bwd_mma.cuh"
#include "attn_fwd_mma.cuh"
#include "flash_stream.cuh"

namespace {

// the float32 K5f, K5q and K5kv; dtype: common.cuh's codes
template <int W>
int launch_f32(int dtype, int DH, int BH, StreamArgs a, void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  head_major(a, a.N, DH);
  return launch_stream<W>(DH, BH, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Shared-memory bytes of each kernel at head width DH in the given dtype
// (common.cuh's codes), whatever N is.
size_t eavit_flash_stream_fwd_smem(int DH, int dtype) {
  return dtype == kBF16 ? mma_fwd_smem_by_dh(DH) : stream_smem_by_dh(kFwd, DH);
}
size_t eavit_flash_stream_dq_smem(int DH, int dtype) {
  return dtype == kBF16 ? mma_bwd_smem_by_dh(DH, 0) : stream_smem_by_dh(kDq, DH);
}
size_t eavit_flash_stream_dkv_smem(int DH, int dtype) {
  return dtype == kBF16 ? mma_bwd_smem_by_dh(DH, 1) : stream_smem_by_dh(kDkv, DH);
}

// Each returns the cudaError_t of its launch (0 on success). BH = B * H.
int eavit_flash_stream_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int N, int DH, int dtype, float scale, int num_special,
                           void* stream) {
  if (dtype == kBF16) {
    using bf16 = __nv_bfloat16;
    MmaFwdArgs a{};
    a.q = static_cast<const bf16*>(q), a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v), a.o = static_cast<bf16*>(o);
    a.lse = static_cast<float*>(lse), a.scale = scale, a.num_special = num_special;
    mma_head_major(a, BH, N, DH);
    a.o_batch = a.x_batch, a.o_head = 0, a.o_tok = DH;
    return launch_mma_fwd<false, false, true>(DH, a, static_cast<cudaStream_t>(stream));
  }
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = o, a.lse_out = static_cast<float*>(lse);
  a.N = N, a.scale = scale, a.num_special = num_special;
  return launch_f32<kFwd>(dtype, DH, BH, a, stream);
}

int eavit_flash_stream_dq(const void* q, const void* k, const void* v, const void* lse,
                          const void* delta, const void* dout, void* dq, int BH, int N,
                          int DH, int dtype, float scale, int num_special, void* stream) {
  if (dtype == kBF16) {
    MmaBwdArgs a = mma_bwd_head_major(q, k, v, dout, lse, dq, nullptr, nullptr, BH, N, DH,
                                      scale, num_special);
    a.rowterm = static_cast<const float*>(delta);
    return launch_mma_dq<false, false, kGiven>(DH, a, static_cast<cudaStream_t>(stream));
  }
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta), a.dq = dq;
  a.N = N, a.scale = scale, a.num_special = num_special;
  return launch_f32<kDq>(dtype, DH, BH, a, stream);
}

int eavit_flash_stream_dkv(const void* q, const void* k, const void* v, const void* lse,
                           const void* delta, const void* dout, void* dk, void* dv, int BH,
                           int N, int DH, int dtype, float scale, int num_special,
                           void* stream) {
  if (dtype == kBF16) {
    MmaBwdArgs a = mma_bwd_head_major(q, k, v, dout, lse, nullptr, dk, dv, BH, N, DH,
                                      scale, num_special);
    a.rowterm = static_cast<const float*>(delta);
    return launch_mma_dkv<false, false>(DH, a, static_cast<cudaStream_t>(stream));
  }
  StreamArgs a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta), a.dk = dk, a.dv = dv;
  a.N = N, a.scale = scale, a.num_special = num_special;
  return launch_f32<kDkv>(dtype, DH, BH, a, stream);
}

}  // extern "C"
