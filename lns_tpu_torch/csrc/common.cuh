// Shared helpers of the hand-written Hopper kernels (built with nvcc into one
// shared library with a plain C interface; see kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace lns {

// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxDynamicSmem = 232448;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ld(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA cast
}
template <> __device__ __forceinline__ __half cvt<__half>(float v) { return __float2half_rn(v); }

// Round an f32 value to the storage dtype T and back: marks the points where
// the reference computation holds a value in its activation dtype.
template <typename T> __device__ __forceinline__ float rnd(float v) { return ld(cvt<T>(v)); }

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxDynamicSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lns
