// RWKV6 WKV recurrence for Hopper, SIMT; f32, bf16 and f16 storage.
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py, rwkv6_scan_call (the
// Pallas kernel behind pallas.rwkv6_scan).
//
// Per (b, h), over t = 0..T-1, with the (hd x hd) state S starting at s0:
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(w_t[i]) * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w (the log decay, <= 0) and o are (B,T,H,hd) contiguous; u is
// (H,hd); s0 and s_last are (B,H,hd,hd).  r, k, v, w, u and o share one
// storage type T, read in T and computed in f32; the decay is expf of the
// f32 value of w, and o is rounded once to T at its store.  The state is
// f32 throughout: s0 is read in T or in f32 (s0_f32), and s_last is always
// f32, as JAX's out_shape (rwkv6_scan/kernel.py:34-52, :75).  A very
// negative w makes expf underflow to 0, which is the exact limit of the
// decay.
//
// What bounds it on this card: bytes (five (B,T,H,hd) tensors read or
// written once, plus the two states), about 1.3 FLOP per byte at hd 64 in
// f32 (2.5 in bf16).
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

template <typename T, int HDP>
__global__ void __launch_bounds__(HDP)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const T* __restrict__ u, const void* __restrict__ s0,
                  int s0_f32, T* __restrict__ o, float* __restrict__ s_last,
                  int T_len, int H, int hd) {
  __shared__ float r_s[2][HDP], k_s[2][HDP], e_s[2][HDP], u_s[HDP];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const long long bi = blockIdx.y;
  const bool live = j < hd;
  const long long row = static_cast<long long>(H) * hd;     // one t step
  const long long seq0 = bi * T_len * row + static_cast<long long>(h) * hd;
  const long long st0 = (bi * H + h) * static_cast<long long>(hd) * hd;

  u_s[j] = live ? to_f32(u[h * hd + j]) : 0.f;
  const float* s0f = static_cast<const float*>(s0);
  const T* s0t = static_cast<const T*>(s0);
  float S[HDP];
#pragma unroll
  for (int i = 0; i < HDP; ++i) {
    const long long at = st0 + static_cast<long long>(i) * hd + j;
    S[i] = (live && i < hd) ? (s0_f32 ? s0f[at] : to_f32(s0t[at])) : 0.f;
  }

  float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
  if (live && T_len > 0) {
    rn = to_f32(r[seq0 + j]); kn = to_f32(k[seq0 + j]);
    wn = to_f32(w[seq0 + j]); vn = to_f32(v[seq0 + j]);
  }
  for (int t = 0; t < T_len; ++t) {
    const int buf = t & 1;
    r_s[buf][j] = rn;
    k_s[buf][j] = kn;
    e_s[buf][j] = live ? expf(wn) : 0.f;
    const float vj = vn;
    if (live && t + 1 < T_len) {
      const long long nx = seq0 + (t + 1) * row + j;
      rn = to_f32(r[nx]); kn = to_f32(k[nx]);
      wn = to_f32(w[nx]); vn = to_f32(v[nx]);
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
    if (live) o[seq0 + t * row + j] = from_f32<T>(fmaf(bonus, vj, acc));
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < HDP; ++i)
      if (i < hd) s_last[st0 + static_cast<long long>(i) * hd + j] = S[i];
  }
}

template <typename T, int HDP>
int launch(const T* r, const T* k, const T* v, const T* w, const T* u,
           const void* s0, int s0_f32, T* o, float* s_last, int B, int T_len,
           int H, int hd, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv6_scan_kernel<T, HDP><<<grid, HDP, 0, stream>>>(
      r, k, v, w, u, s0, s0_f32, o, s_last, T_len, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* r, const T* k, const T* v, const T* w, const T* u,
             const void* s0, int s0_f32, T* o, float* s_last, int B,
             int T_len, int H, int hd, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B > 65535 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SOL_HDP(P) \
  return launch<T, P>(r, k, v, w, u, s0, s0_f32, o, s_last, B, T_len, H, hd, s)
  if (hd <= 16) SOL_HDP(16);
  if (hd <= 32) SOL_HDP(32);
  if (hd <= 64) SOL_HDP(64);
  if (hd <= 128) SOL_HDP(128);
#undef SOL_HDP
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// sol_rwkv6_scan_f32, _bf16 and _f16: r, k, v, w, u and o in that type, s0
// in it or in f32 (s0_f32), s_last f32
#define SOL_RWKV6(T, SUFFIX)                                                 \
  SOL_EXPORT int sol_rwkv6_scan_##SUFFIX(                                    \
      const T* r, const T* k, const T* v, const T* w, const T* u,            \
      const void* s0, int s0_f32, T* o, float* s_last, int B, int T_len,     \
      int H, int hd, void* stream) {                                         \
    return dispatch<T>(r, k, v, w, u, s0, s0_f32, o, s_last, B, T_len, H,    \
                       hd, stream);                                          \
  }
SOL_FOR_EACH_DTYPE(SOL_RWKV6)
#undef SOL_RWKV6
