// Causal GQA flash attention forward for Hopper, SIMT; f32, bf16 and f16
// storage.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_call (the Pallas kernel behind pallas.flash_attention).
//
// Computes o = softmax(mask(cap(q k^T / sqrt(hd)))) v per (batch, q head),
// the kv head being h / (H / KV).  q, k, v and o are the node's BSHD
// tensors, read and written through their strides, so no transpose or pad
// copy is made.  The kv loop is bounded by causality (tiles past the last
// query row of the block are never loaded) and by the window; padded keys
// (position >= S) are masked; a tanh softcap applies when cap > 0.  q, k, v
// and o share one storage type T: each element is converted to f32 as it
// is staged into shared memory, the scores, softmax and accumulator are
// f32, and o is rounded once to T at its store (JAX's
// flash_attention/kernel.py:38-79).  The tiles stay f32 in shared memory,
// so one layout serves the three types.
//
// What bounds it on this card: 4*B*H*S^2*hd FLOPs against reading q, k, v
// and writing o once — at the serving prefill (B 4, S 128, H 12, hd 128)
// it is compute-bound for f32 outside the tensor cores.  Design: one
// block per (b, q head, 64-query tile), 256 threads.  The Q tile (pre-
// scaled) stays in shared memory; K and V stream through shared memory in
// 64-row tiles; each thread owns a 4x4 patch of the score tile and a 4 x
// hd/16 patch of the output accumulator (registers); the f32 online softmax
// keeps a running max, sum and correction per query row in shared memory.
// Fully masked rows keep max = -inf and contribute nothing (no -inf - -inf).
// The tiles need ~116 KB of shared memory at hd 128, above the 48 KB static
// limit, so the launch raises the block's dynamic shared memory limit with
// cudaFuncSetAttribute.  Tensor-core (wgmma) tiles, TMA and a pipelined
// ring of K/V stages are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BKV = 64;    // keys per streamed tile
constexpr int NT = 256;    // threads: 16 x 16

struct Strides {           // element strides of a BSHD tensor (d stride 1)
  long long b, s, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int H,
                 int group, int S, int causal, int window, float cap,
                 float scale) {
  constexpr int QP = HD + 1;          // padded rows: no bank conflicts
  constexpr int TD = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x QP
  float* Ks = Qs + BQ * QP;           // BKV x QP
  float* Vs = Ks + BKV * QP;          // BKV x HD
  float* Ps = Vs + BKV * HD;          // BQ x (BKV + 1)
  float* Mrow = Ps + BQ * (BKV + 1);  // running max per row
  float* Lrow = Mrow + BQ;            // running sum per row
  float* Crow = Lrow + BQ;            // this tile's correction per row

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * QP + d] =
        (q0 + r < S) ? to_f32(qb[(q0 + r) * qs.s + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    Mrow[tid] = -INFINITY;
    Lrow[tid] = 0.f;
  }
  float acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;

  const int nk = (S + BKV - 1) / BKV;
  int lo = 0, hi = nk;
  if (causal) {
    hi = min(nk, (q0 + BQ + BKV - 1) / BKV);
    if (window) lo = max(0, q0 - window) / BKV;
  }
  __syncthreads();

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BKV;
    for (int e = tid; e < BKV * HD; e += NT) {
      const int c = e / HD, d = e % HD;
      const bool in = k0 + c < S;
      Ks[c * QP + d] = in ? to_f32(kb[(k0 + c) * ks.s + d]) : 0.f;
      Vs[c * HD + d] = in ? to_f32(vb[(k0 + c) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16i, keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float x = sc[i][j];
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        bool ok = kpos < S;
        if (causal) ok = ok && qpos >= kpos;
        if (window) ok = ok && (qpos - kpos) < window;
        Ps[r * (BKV + 1) + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* prow = Ps + r * (BKV + 1) + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = Mrow[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (m_new == -INFINITY) {
#pragma unroll
        for (int c = 0; c < 16; ++c) prow[c] = 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float p = expf(prow[c] - m_new);
          prow[c] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        Crow[r] = corr;
        Lrow[r] = Lrow[r] * corr + sum;
        Mrow[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = Crow[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float inv = 1.f / fmaxf(Lrow[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      ob[(q0 + r) * os.s + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* o,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int KV, int S, int causal, int window, float cap,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)HD);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      q, k, v, o, qs, ks, vs, os, H, H / KV, S, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
             int KV, int hd, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long o_sb, long long o_ss,
             long long o_sh, int causal, int window, float cap,
             void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SOL_HD(HD_) \
  return launch<T, HD_>(q, k, v, o, qs, ks, vs, os, B, H, KV, S, causal, \
                        window, cap, s)
  switch (hd) {
    case 16: SOL_HD(16);
    case 32: SOL_HD(32);
    case 64: SOL_HD(64);
    case 128: SOL_HD(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SOL_HD
}

}  // namespace

// sol_flash_attention_f32, _bf16 and _f16: q (B,S,H,hd), k/v (B,S,KV,hd),
// o (B,S,H,hd), all in that type; strides in elements, the hd stride 1.
// Returns a cudaError_t (cudaErrorInvalidValue for an hd the kernel is not
// instantiated for).
#define SOL_FLASH(T, SUFFIX)                                                 \
  SOL_EXPORT int sol_flash_attention_##SUFFIX(                               \
      const T* q, const T* k, const T* v, T* o, int B, int S, int H, int KV, \
      int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh,        \
      int causal, int window, float cap, void* stream) {                     \
    return dispatch<T>(q, k, v, o, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb,  \
                       k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,       \
                       causal, window, cap, stream);                         \
  }
SOL_FOR_EACH_DTYPE(SOL_FLASH)
#undef SOL_FLASH
