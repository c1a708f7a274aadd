// Shared by the kernel sources: the error-string export every library
// carries, so the ctypes wrapper can turn a cudaError_t into a message, and
// the storage types the kernels read and write.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define SOL_EXPORT extern "C" __attribute__((visibility("default")))

SOL_EXPORT const char* sol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every kernel reads its operands in their storage type (float, bf16 or
// f16), computes and keeps its state in f32, and rounds once to the
// output's type at the store: the JAX kernels' cast points.  to_f32 and
// from_f32 are those two casts; on float both are the identity.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// M(type, suffix) once per storage type: each kernel exports one entry per
// type, sol_<kernel>_f32, _bf16 and _f16, which the wrapper picks by the
// tensors' dtype (kernels/dtypes.py, SUFFIX)
#define SOL_FOR_EACH_DTYPE(M) M(float, f32) M(__nv_bfloat16, bf16) M(__half, f16)
