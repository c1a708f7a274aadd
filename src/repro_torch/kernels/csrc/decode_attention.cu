// Single-token decode attention for Hopper, SIMT; f32, bf16 and f16
// storage.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// decode_attention_call (the Pallas kernel behind pallas.decode_attention).
//
// For each sequence b, the query row of every head attends the cache rows
// [0, lens[b]) (within the window when one is set), then the step's own
// (k_new, v_new) pair at position lens[b] is folded into the softmax.  The
// operands are the node's tensors, read through their strides: q (B,1,H,hd),
// cache k/v (B,S,KV,hd), k_new/v_new (B,1,KV,hd), lens (B,) int32; the
// output (B,1,H,hd) is contiguous.  q, the cache, k_new, v_new and o share
// one storage type T, read in T and converted to f32 as they are staged;
// scores, softmax and accumulator are f32, and o is rounded once to T at
// its store (JAX's decode_attention/kernel.py:44-91).  lens is int32.
//
// What bounds it on this card: reading the valid cache rows once (2 * len
// * hd elements of T per kv head) — a few FLOPs per byte, so memory-bound.
// Design: one block per (b, kv head), 128 threads, covering the whole group
// of H/KV query heads, so every cache row is read once for all of them.
// The loop stops at lens[b]: bucket padding past it is never read, and
// lens[b] = 0 (batch padding) skips the loop and returns exactly v_new.
// K/V stream through shared memory in 64-row tiles; scores, the running
// max/sum/correction and the output accumulator live in shared memory; the
// f32 online softmax keeps a fully masked row at max = -inf without NaNs.
// Split-KV (several blocks per sequence with a combine step, to fill 132
// SMs when B*KV is small) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BK = 64;      // cache rows per tile
constexpr int NT = 128;     // threads: 4 warps
constexpr int NW = NT / 32;

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ kn,
              const T* __restrict__ vn, const int* __restrict__ lens,
              T* __restrict__ o, int S, int H, int G, long long q_sb,
              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              long long kn_sb, long long kn_sh, long long vn_sb,
              long long vn_sh, int window, float cap, float scale) {
  constexpr int KP = HD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                 // G x HD (pre-scaled)
  float* Os = Qs + G * HD;          // G x HD accumulator
  float* Ks = Os + G * HD;          // BK x KP
  float* Vs = Ks + BK * KP;         // BK x HD
  float* Ps = Vs + BK * HD;         // G x BK
  float* Mrow = Ps + G * BK;        // G
  float* Lrow = Mrow + G;           // G
  float* Crow = Lrow + G;           // G

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int h0 = kvh * G;
  const int L = min(max(lens[b], 0), S);
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int e = tid; e < G * HD; e += NT) {
    const int g = e / HD, d = e % HD;
    Qs[e] = to_f32(q[b * q_sb + (h0 + g) * q_sh + d]) * scale;
    Os[e] = 0.f;
  }
  if (tid < G) {
    Mrow[tid] = -INFINITY;
    Lrow[tid] = 0.f;
  }
  const int lo = window ? max(0, L - window) / BK : 0;
  const int hi = (L + BK - 1) / BK;
  __syncthreads();

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    for (int e = tid; e < BK * HD; e += NT) {
      const int c = e / HD, d = e % HD;
      const bool in = k0 + c < L;
      Ks[c * KP + d] = in ? to_f32(kb[(k0 + c) * k_ss + d]) : 0.f;
      Vs[c * HD + d] = in ? to_f32(vb[(k0 + c) * v_ss + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < G * BK; e += NT) {
      const int g = e / BK, c = e % BK, pos = k0 + c;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) x = fmaf(Qs[g * HD + d], Ks[c * KP + d], x);
      if (cap > 0.f) x = tanhf(x / cap) * cap;
      bool ok = pos < L;
      if (window) ok = ok && (L - pos) < window;
      Ps[e] = ok ? x : -INFINITY;
    }
    __syncthreads();
    // online softmax: one warp per head row, 2 keys per lane
    for (int g = warp; g < G; g += NW) {
      float* prow = Ps + g * BK;
      float mx = fmaxf(prow[lane], prow[lane + 32]);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Mrow[g];
      const float m_new = fmaxf(m_old, mx);
      float p0 = 0.f, p1 = 0.f;
      if (m_new != -INFINITY) {
        p0 = expf(prow[lane] - m_new);
        p1 = expf(prow[lane + 32] - m_new);
      }
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        Crow[g] = corr;
        Lrow[g] = Lrow[g] * corr + sum;
        Mrow[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += NT) {
      const int g = e / HD, d = e % HD;
      float a = Os[e] * Crow[g];
      const float* prow = Ps + g * BK;
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a = fmaf(prow[c], Vs[c * HD + d], a);
      Os[e] = a;
    }
    __syncthreads();
  }

  // fold in the new (k, v) pair at position L: distance 0, always visible
  const T* knb = kn + b * kn_sb + kvh * kn_sh;
  const T* vnb = vn + b * vn_sb + kvh * vn_sh;
  for (int g = warp; g < G; g += NW) {
    float x = 0.f;
    for (int d = lane; d < HD; d += 32)
      x = fmaf(Qs[g * HD + d], to_f32(knb[d]), x);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (cap > 0.f) x = tanhf(x / cap) * cap;
    const float m = Mrow[g];
    const float m_fin = fmaxf(m, x);
    const float corr = expf(m - m_fin);       // 0 when m = -inf
    const float pn = expf(x - m_fin);
    const float inv = 1.f / fmaxf(Lrow[g] * corr + pn, 1e-30f);
    T* ob = o + ((long long)b * H + h0 + g) * HD;
    for (int d = lane; d < HD; d += 32)
      ob[d] = from_f32<T>((Os[g * HD + d] * corr + pn * to_f32(vnb[d])) * inv);
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, const T* kn, const T* vn,
           const int* lens, T* o, int B, int S, int H,
           int KV, long long q_sb, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long kn_sb, long long kn_sh,
           long long vn_sb, long long vn_sh, int window, float cap,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) *
      (2 * G * HD + BK * (HD + 1) + BK * HD + G * BK + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KV, B);
  decode_kernel<T, HD><<<grid, NT, smem, stream>>>(
      q, k, v, kn, vn, lens, o, S, H, G, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, kn_sb, kn_sh, vn_sb, vn_sh, window, cap,
      1.f / sqrtf((float)HD));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const T* kn, const T* vn,
             const int* lens, T* o, int B, int S, int H, int KV, int hd,
             long long q_sb, long long q_sh, long long k_sb, long long k_ss,
             long long k_sh, long long v_sb, long long v_ss, long long v_sh,
             long long kn_sb, long long kn_sh, long long vn_sb,
             long long vn_sh, int window, float cap, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SOL_DECODE(HD_)                                                     \
  return launch<T, HD_>(q, k, v, kn, vn, lens, o, B, S, H, KV, q_sb, q_sh,  \
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kn_sb, kn_sh,       \
                     vn_sb, vn_sh, window, cap, s)
  switch (hd) {
    case 16: SOL_DECODE(16);
    case 32: SOL_DECODE(32);
    case 64: SOL_DECODE(64);
    case 128: SOL_DECODE(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SOL_DECODE
}

}  // namespace

// sol_decode_attention_f32, _bf16 and _f16: q, the cache, k_new, v_new and
// o in that type, lens int32
#define SOL_DECODE_ENTRY(T, SUFFIX)                                          \
  SOL_EXPORT int sol_decode_attention_##SUFFIX(                              \
      const T* q, const T* k, const T* v, const T* kn, const T* vn,          \
      const int* lens, T* o, int B, int S, int H, int KV, int hd,            \
      long long q_sb, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,        \
      long long kn_sb, long long kn_sh, long long vn_sb, long long vn_sh,    \
      int window, float cap, void* stream) {                                 \
    return dispatch<T>(q, k, v, kn, vn, lens, o, B, S, H, KV, hd, q_sb,      \
                       q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kn_sb,      \
                       kn_sh, vn_sb, vn_sh, window, cap, stream);            \
  }
SOL_FOR_EACH_DTYPE(SOL_DECODE_ENTRY)
#undef SOL_DECODE_ENTRY
