// RG-LRU linear recurrence for Hopper, chunked over T; f32, bf16 and f16
// storage.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_call (the
// Pallas kernel behind pallas.rglru_scan).
//
// Computes h_t = a_t * h_{t-1} + b_t per channel over T, starting from h0,
// and writes every h_t and the last state h_last.  a, b and h are (B,T,D)
// contiguous (channels innermost), h0 and h_last (B,D), all in one storage
// type T: each a_t and b_t is read in T, the state is f32, and each h_t
// and h_last is rounded once to T at its store (JAX's
// rglru_scan/kernel.py:23-33).
//
// What bounds it on this card: bytes.  Each step reads a_t and b_t and
// writes h_t, two FLOPs per 3*sizeof(T) bytes, so the bound is
// 3*sizeof(T)*B*T*D bytes over 3.35 TB/s.  Reaching it takes ~3 MB of
// loads in flight across the card; one thread per (b, channel) walking all
// of T keeps about a third of that in flight.
// Design: T is split across the threads of a block, so a and b are still
// read once.  A block takes LANES*4 channels of one sequence; a thread
// takes 4 of them (one 16-byte load in f32, 8 bytes in bf16 and f16) and
// one chunk of CHUNK steps, so a warp holds 32/LANES chunks side by side and
// each row it reads is LANES*4 channels long.  Per tile of `chunks` chunks:
//   1. every thread loads its chunk's steps of a and b into registers,
//      all at once, and walks them from zero: its chunk's local state h_c
//      and product A_c = prod a_t (padded steps past T are a = 1, b = 0);
//   2. (A_c, h_c) go through shared memory, and one thread per channel
//      combines them in chunk order, seeded with the carried state: each
//      chunk's incoming h_in(c), and h_in(c+1) = A_c*h_in(c) + h_c;
//   3. every thread walks its registers again from h_in(c) and stores h_t.
// The next tile starts from the last chunk's combined state.  h_last is
// the h of step T-1 as its thread computed it (h0 for T 0).  rglru_plan()
// in kernels/rglru_scan/kernel.py picks LANES and the chunks of a tile
// from the shapes alone.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int VEC = 4;          // channels a thread
constexpr int CHUNK = 8;        // steps a thread holds (rglru_plan's CHUNK)
constexpr int MAX_CHUNKS = 16;  // chunks a tile holds

// VEC values of T as they lie in memory: one 16-byte (f32) or 8-byte load
template <typename T>
using Raw = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* __restrict__ p) {
  return __ldg(reinterpret_cast<const Raw<T>*>(p));
}

// the VEC values of T in r, widened to f32
template <typename T>
__device__ __forceinline__ void unpack(const Raw<T>& r, float (&x)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  } else {
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      } else {
        x[2 * i] = __half2float(
            __ushort_as_half(static_cast<unsigned short>(w[i] & 0xFFFFu)));
        x[2 * i + 1] = __half2float(
            __ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
      }
    }
  }
}

// the first `n` of VEC f32 values rounded to T and stored at p; `vec`: p
// is VEC-value aligned and n is VEC (one store)
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, bool vec, int n,
                                          const float (&x)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      uint32_t w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t lo, hi;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i]));
          hi = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1]));
        } else {
          lo = __half_as_ushort(__float2half_rn(x[2 * i]));
          hi = __half_as_ushort(__float2half_rn(x[2 * i + 1]));
        }
        w[i] = lo | (hi << 16);
      }
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (i < n) p[i] = from_f32<T>(x[i]);
}

template <typename T, int LANES>
__global__ void __launch_bounds__(MAX_CHUNKS * 32)
rglru_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ h0, T* __restrict__ h,
                   T* __restrict__ h_last, int T_len, int D, int chunks,
                   int vec_ok) {
  constexpr int CH = LANES * VEC;         // channels of the block
  constexpr int PER_WARP = 32 / LANES;    // chunks a warp holds
  __shared__ float A_s[MAX_CHUNKS][CH], H_s[MAX_CHUNKS][CH], carry_s[CH];
  const int tid = threadIdx.x, lane = tid & 31;
  const int cl = lane % LANES;
  const int ck = (tid >> 5) * PER_WARP + lane / LANES;   // chunk in a tile
  const int ch0 = blockIdx.x * CH;
  const int c0 = ch0 + cl * VEC;                         // first channel
  const int nv = max(0, min(VEC, D - c0));               // channels < D
  const bool vec = vec_ok && nv == VEC;
  const long long bi = blockIdx.y;
  const long long base = bi * T_len * static_cast<long long>(D) + c0;
  for (int i = tid; i < CH; i += blockDim.x)
    carry_s[i] = ch0 + i < D ? to_f32(h0[bi * D + ch0 + i]) : 0.f;
  const int span = chunks * CHUNK;
  for (int t0 = 0; t0 < T_len; t0 += span) {
    const int ts = t0 + ck * CHUNK;
    // every step's loads first, converted after, so that all 2*CHUNK loads
    // are in flight together; steps past T (and channels past D) are a = 1,
    // b = 0
    float av[CHUNK][VEC], bv[CHUNK][VEC];
    if (vec) {
      // 16-bit values stay packed until every load is out; f32 ones land
      // in av, bv as they are (a packed copy would spill at 128 registers)
      Raw<T> ra[sizeof(T) == 4 ? 1 : CHUNK], rb[sizeof(T) == 4 ? 1 : CHUNK];
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        if (ts + s < T_len) {
          const long long off = base + static_cast<long long>(ts + s) * D;
          if constexpr (sizeof(T) == 4) {
            unpack<T>(load_raw(a + off), av[s]);
            unpack<T>(load_raw(b + off), bv[s]);
          } else {
            ra[s] = load_raw(a + off);
            rb[s] = load_raw(b + off);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        if (ts + s < T_len) {
          if constexpr (sizeof(T) != 4) {
            unpack<T>(ra[s], av[s]);
            unpack<T>(rb[s], bv[s]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) av[s][q] = 1.f, bv[s][q] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        const bool in = ts + s < T_len;
        const long long off = base + static_cast<long long>(ts + s) * D;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          av[s][q] = in && q < nv ? to_f32(a[off + q]) : 1.f;
          bv[s][q] = in && q < nv ? to_f32(b[off + q]) : 0.f;
        }
      }
    }
    float hl[VEC], pa[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) hl[v] = 0.f, pa[v] = 1.f;
#pragma unroll
    for (int s = 0; s < CHUNK; ++s)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        hl[v] = fmaf(av[s][v], hl[v], bv[s][v]);
        pa[v] *= av[s][v];
      }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      A_s[ck][cl * VEC + v] = pa[v];
      H_s[ck][cl * VEC + v] = hl[v];
    }
    __syncthreads();
    for (int i = tid; i < CH; i += blockDim.x) {   // the carry, in order
      float hc = carry_s[i];
      for (int c = 0; c < chunks; ++c) {
        const float pc = A_s[c][i], lc = H_s[c][i];
        H_s[c][i] = hc;
        hc = fmaf(pc, hc, lc);
      }
      carry_s[i] = hc;
    }
    __syncthreads();
    float hv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) hv[v] = H_s[ck][cl * VEC + v];
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) hv[v] = fmaf(av[s][v], hv[v], bv[s][v]);
      const int t = ts + s;
      if (t < T_len && nv > 0) {
        store_vec(h + base + static_cast<long long>(t) * D, vec, nv, hv);
        if (t == T_len - 1) store_vec(h_last + bi * D + c0, vec, nv, hv);
      }
    }
    __syncthreads();                // the next tile rewrites A_s and H_s
  }
  for (int i = tid; T_len == 0 && i < CH && ch0 + i < D; i += blockDim.x)
    h_last[bi * D + ch0 + i] = h0[bi * D + ch0 + i];
}

template <typename T, int LANES>
int launch(const T* a, const T* b, const T* h0, T* h, T* h_last, int B,
           int T_len, int D, int chunks, int vec, cudaStream_t stream) {
  const int per_warp = 32 / LANES;
  if (chunks < 1 || chunks > MAX_CHUNKS || chunks % per_warp)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((D + LANES * VEC - 1) / (LANES * VEC), B);
  rglru_chunk_kernel<T, LANES><<<grid, chunks / per_warp * 32, 0, stream>>>(
      a, b, h0, h, h_last, T_len, D, chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* a, const T* b, const T* h0, T* h, T* h_last, int B,
             int T_len, int D, int chunk, int lanes, int chunks, int vec,
             void* stream) {
  if (B == 0 || D == 0) return 0;
  if (B > 65535 || T_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk != CHUNK) return static_cast<int>(cudaErrorInvalidValue);
#define SOL_LANES(LN)                                                    \
  if (lanes == LN)                                                       \
    return launch<T, LN>(a, b, h0, h, h_last, B, T_len, D, chunks, vec, s);
  SOL_LANES(32) SOL_LANES(16) SOL_LANES(8) SOL_LANES(4)
#undef SOL_LANES
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// sol_rglru_scan_f32, _bf16 and _f16: every operand in that type; chunk
// (CHUNK steps), lanes (4..32) and chunks (a tile's) from rglru_plan()
#define SOL_RGLRU(T, SUFFIX)                                                 \
  SOL_EXPORT int sol_rglru_scan_##SUFFIX(                                    \
      const T* a, const T* b, const T* h0, T* h, T* h_last, int B,           \
      int T_len, int D, int chunk, int lanes, int chunks, int vec,           \
      void* stream) {                                                        \
    return dispatch<T>(a, b, h0, h, h_last, B, T_len, D, chunk, lanes,       \
                       chunks, vec, stream);                                 \
  }
SOL_FOR_EACH_DTYPE(SOL_RGLRU)
#undef SOL_RGLRU
