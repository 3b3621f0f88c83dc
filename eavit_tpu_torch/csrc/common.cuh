// Small helpers shared by the port's kernels: element-type conversion, warp
// reductions and the dual-query mask.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (ops/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

// How an attention backward's dq kernel finds the row term of ds = p (dp -
// term) scale: given by the caller (K5, delta = sum(dO * O) outside), delta
// summed from the forward's O (K4b), or rowsum = sum_j dsigma p from a first
// sweep over the keys (K1b, K3b). Both backward templates take it
// (flash_stream.cuh, attn_bwd_mma.cuh).
enum RowTerm : int { kGiven = 0, kDeltaFromO = 1, kRowsum = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back: where the JAX kernels cast an operand
// to the input dtype before a dot with f32 accumulation.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The dual-query shared-KV mask (ops/attention.py dual_query_allowed): with
// num_special tokens first in the sequence, patch row i attends to patch
// columns only, special row i to itself and the patches.
__device__ __forceinline__ bool dual_query_allowed(int i, int j, int num_special) {
  if (num_special <= 0) return true;
  return i >= num_special ? j >= num_special : (j == i || j >= num_special);
}

// Launches above 48 KB of dynamic shared memory need the opt-in attribute.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
