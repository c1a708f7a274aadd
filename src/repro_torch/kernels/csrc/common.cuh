// Shared by the kernel sources: the error-string export every library
// carries, so the ctypes wrapper can turn a cudaError_t into a message.
#pragma once
#include <cuda_runtime.h>

#define SOL_EXPORT extern "C" __attribute__((visibility("default")))

SOL_EXPORT const char* sol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
