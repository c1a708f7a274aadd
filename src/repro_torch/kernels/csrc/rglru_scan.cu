// RG-LRU linear recurrence for Hopper, SIMT; f32, bf16 and f16 storage.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_call (the
// Pallas kernel behind pallas.rglru_scan).
//
// Computes h_t = a_t * h_{t-1} + b_t per channel over T, starting from h0,
// and writes every h_t and the last state h_last.  a, b and h are (B,T,D)
// contiguous (channels innermost), h0 and h_last (B,D), all in one storage
// type T: each a_t and b_t is read in T, the state h is an f32 register,
// and each h_t and h_last is rounded once to T at its store (JAX's
// rglru_scan/kernel.py:23-33).
//
// What bounds it on this card: bytes.  Each step reads a_t and b_t and
// writes h_t, two FLOPs per 3*sizeof(T) bytes, so the bound is
// 3*sizeof(T)*B*T*D bytes over 3.35 TB/s.  The recurrence is sequential in T, so the time is latency:
// T dependent steps, each a fused multiply-add on a value in a register.
// Design: one thread per (b, channel), holding h in an f32 register while
// it walks T.  The threads of a warp take adjacent channels, so each load
// of a_t or b_t and each store of h_t is one coalesced access (128 bytes
// of f32, 64 of bf16 or f16).  The
// loads do not depend on h, so the unrolled loop issues several steps'
// loads ahead of the chain of FMAs.  At B*D = 16384 threads (B 4, D 4096)
// the card holds them all at once, under one wave of 132 SMs; a chunked
// parallel scan over T, which would give more threads, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;     // threads per block: 4 warps of channels

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ h0, T* __restrict__ h,
                  T* __restrict__ h_last, int T_len, int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const long long bi = blockIdx.y;
  const long long base = bi * T_len * static_cast<long long>(D) + d;
  float state = to_f32(h0[bi * D + d]);
#pragma unroll 8
  for (int t = 0; t < T_len; ++t) {
    const long long off = base + static_cast<long long>(t) * D;
    state = fmaf(to_f32(a[off]), state, to_f32(b[off]));
    h[off] = from_f32<T>(state);
  }
  h_last[bi * D + d] = from_f32<T>(state);
}

template <typename T>
int launch(const T* a, const T* b, const T* h0, T* h, T* h_last, int B,
           int T_len, int D, void* stream) {
  if (B == 0 || D == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((D + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, h_last, T_len, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sol_rglru_scan_f32, _bf16 and _f16: every operand in that type
#define SOL_RGLRU(T, SUFFIX)                                                 \
  SOL_EXPORT int sol_rglru_scan_##SUFFIX(const T* a, const T* b,             \
                                         const T* h0, T* h, T* h_last, int B, \
                                         int T_len, int D, void* stream) {    \
    return launch<T>(a, b, h0, h, h_last, B, T_len, D, stream);              \
  }
SOL_FOR_EACH_DTYPE(SOL_RGLRU)
#undef SOL_RGLRU
