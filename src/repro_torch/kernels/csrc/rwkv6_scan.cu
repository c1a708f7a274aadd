// RWKV6 WKV recurrence for Hopper, f32, SIMT.
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py, rwkv6_scan_call (the
// Pallas kernel behind pallas.rwkv6_scan).
//
// Per (b, h), over t = 0..T-1, with the (hd x hd) state S starting at s0:
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(w_t[i]) * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w (the log decay, <= 0) and o are (B,T,H,hd) contiguous; u is
// (H,hd); s0 and s_last are (B,H,hd,hd) f32.  A very negative w makes
// expf underflow to 0, which is the exact limit of the decay.
//
// What bounds it on this card: bytes (five (B,T,H,hd) tensors read or
// written once, plus the two states), about 1.3 FLOP per byte at hd 64.
// The recurrence is sequential in T, so the time is latency: T steps, each
// a chain of hd FMAs per thread.
// Design: one block per (b, h) with one thread per state column j: thread
// j keeps column j of S in registers for the whole walk, so the state never
// touches memory between s0 and s_last.  Each step stages r_t, k_t and
// exp(w_t) in shared memory (double-buffered, so one barrier per step
// suffices), and every thread reads them as broadcasts; there is no
// reduction across threads.  The next step's inputs are loaded into
// registers before the barrier, so their latency overlaps this step's
// arithmetic.  The block is HDP threads, hd rounded up to a power of two
// (16..128); padded lanes carry zeros and store nothing.  At B 4, H 32 the
// grid is 128 blocks of 64 threads: under one block per SM.  Chunking T
// into parallel pieces (the chunked form of _wkv_chunked) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

template <int HDP>
__global__ void __launch_bounds__(HDP)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ o, float* __restrict__ s_last, int T,
                  int H, int hd) {
  __shared__ float r_s[2][HDP], k_s[2][HDP], e_s[2][HDP], u_s[HDP];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const long long bi = blockIdx.y;
  const bool live = j < hd;
  const long long row = static_cast<long long>(H) * hd;     // one t step
  const long long seq0 = bi * T * row + static_cast<long long>(h) * hd;
  const long long st0 = (bi * H + h) * static_cast<long long>(hd) * hd;

  u_s[j] = live ? u[h * hd + j] : 0.f;
  float S[HDP];
#pragma unroll
  for (int i = 0; i < HDP; ++i)
    S[i] = (live && i < hd) ? s0[st0 + static_cast<long long>(i) * hd + j]
                            : 0.f;

  float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
  if (live && T > 0) {
    rn = r[seq0 + j]; kn = k[seq0 + j]; wn = w[seq0 + j]; vn = v[seq0 + j];
  }
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    r_s[buf][j] = rn;
    k_s[buf][j] = kn;
    e_s[buf][j] = live ? expf(wn) : 0.f;
    const float vj = vn;
    if (live && t + 1 < T) {
      const long long nx = seq0 + (t + 1) * row + j;
      rn = r[nx]; kn = k[nx]; wn = w[nx]; vn = v[nx];
    }
    __syncthreads();
    float acc = 0.f, bonus = 0.f;
#pragma unroll
    for (int i = 0; i < HDP; ++i) {
      const float ri = r_s[buf][i], ki = k_s[buf][i];
      acc = fmaf(ri, S[i], acc);
      bonus = fmaf(ri * u_s[i], ki, bonus);
      S[i] = fmaf(e_s[buf][i], S[i], ki * vj);
    }
    if (live) o[seq0 + t * row + j] = fmaf(bonus, vj, acc);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < HDP; ++i)
      if (i < hd) s_last[st0 + static_cast<long long>(i) * hd + j] = S[i];
  }
}

template <int HDP>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* o, float* s_last, int B,
           int T, int H, int hd, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv6_scan_kernel<HDP><<<grid, HDP, 0, stream>>>(r, k, v, w, u, s0, o,
                                                   s_last, T, H, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SOL_EXPORT int sol_rwkv6_scan_f32(const float* r, const float* k,
                                  const float* v, const float* w,
                                  const float* u, const float* s0, float* o,
                                  float* s_last, int B, int T, int H, int hd,
                                  void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B > 65535 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 16) return launch<16>(r, k, v, w, u, s0, o, s_last, B, T, H, hd, s);
  if (hd <= 32) return launch<32>(r, k, v, w, u, s0, o, s_last, B, T, H, hd, s);
  if (hd <= 64) return launch<64>(r, k, v, w, u, s0, o, s_last, B, T, H, hd, s);
  if (hd <= 128)
    return launch<128>(r, k, v, w, u, s0, o, s_last, B, T, H, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
