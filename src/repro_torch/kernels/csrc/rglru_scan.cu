// RG-LRU linear recurrence for Hopper, f32, SIMT.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_call (the
// Pallas kernel behind pallas.rglru_scan).
//
// Computes h_t = a_t * h_{t-1} + b_t per channel over T, starting from h0,
// and writes every h_t and the last state h_last.  a, b and h are (B,T,D)
// contiguous (channels innermost), h0 and h_last (B,D).
//
// What bounds it on this card: bytes.  Each step reads a_t and b_t and
// writes h_t, two FLOPs per 12 bytes, so the bound is 12*B*T*D bytes over
// 3.35 TB/s.  The recurrence is sequential in T, so the time is latency:
// T dependent steps, each a fused multiply-add on a value in a register.
// Design: one thread per (b, channel), holding h in an f32 register while
// it walks T.  The threads of a warp take adjacent channels, so each load
// of a_t or b_t and each store of h_t is one coalesced 128-byte access.  The
// loads do not depend on h, so the unrolled loop issues several steps'
// loads ahead of the chain of FMAs.  At B*D = 16384 threads (B 4, D 4096)
// the card holds them all at once, under one wave of 132 SMs; a chunked
// parallel scan over T, which would give more threads, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;     // threads per block: 4 warps of channels

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int T, int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const long long bi = blockIdx.y;
  const long long base = bi * T * static_cast<long long>(D) + d;
  float state = h0[bi * D + d];
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const long long off = base + static_cast<long long>(t) * D;
    state = fmaf(a[off], state, b[off]);
    h[off] = state;
  }
  h_last[bi * D + d] = state;
}

}  // namespace

SOL_EXPORT int sol_rglru_scan_f32(const float* a, const float* b,
                                  const float* h0, float* h, float* h_last,
                                  int B, int T, int D, void* stream) {
  if (B == 0 || D == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((D + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, h_last, T, D);
  return static_cast<int>(cudaGetLastError());
}
