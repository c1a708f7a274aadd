// RWKV6 WKV recurrence for Hopper, chunked over T; f32, bf16 and f16
// storage.
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
// What bounds it on this card: bytes of the call (five (B,T,H,hd) tensors
// read or written once, plus the two states), about 1.3 FLOP per byte at
// hd 64 in f32 (2.5 in bf16).  The recurrence is sequential in T, so a
// walk over all of T per (b, h) is latency: at B 4, H 32 such a walk fills
// 128 blocks of 2 warps, and each step waits on a barrier.
// Design: T is cut into chunks (rwkv6_plan() in kernels/rwkv6_scan/
// kernel.py, from the shapes alone), and the scan runs in three passes:
//   1. chunk states, grid (chunks-1, H, B): each block walks its chunk
//      from a zero state and writes the chunk's own state dS_c and decay
//      D_c = prod exp(w_t) (f32, product of the exps in step order) to an
//      f32 workspace;
//   2. carry, one thread per state entry: S_in(1) = D_0 (.)rows s0 + dS_0,
//      S_in(c+1) = D_c (.)rows S_in(c) + dS_c in chunk order, written over
//      dS_c;
//   3. output, grid (chunks, H, B): each block walks its chunk again from
//      S_in(c) (s0 for the first) and writes o; the last chunk's final
//      state is s_last.
// With one chunk, passes 1 and 2 do not run.  Each chunk's walk is the
// step recurrence, exact and in order.  A block stages a tile of its
// chunk's steps at once in shared memory (r, k, exp(w), v in f32; 16-byte
// loads, issued in batches before any is converted, where rows are 16-byte
// aligned), so the walk has no barrier per step; each step's bonus
// r_t . (u (.) k_t) is computed once for the block after staging, one warp
// a step.  With one thread per state column every thread would read all
// of r_t, k_t and exp(w_t) each step: 48 float4 reads for 192 FMAs at hd
// 64, which set the pace on the H100.  So a block's HDP threads (the head
// dim rounded up to 32, 64 or 128; padded rows and columns carry zeros)
// each hold a block of S: HDP/4 rows of one of 4 row groups g by 4
// columns 4*jc.. (thread j: g = j & 3, jc = j >> 2), and each float4 of
// r, k or exp(w) serves 4 columns (13 reads a step at hd 64).  The 4 row
// groups' partial sums of o_t meet in a reduce-scatter of 3 shuffles among
// lanes g, which leaves column 4*jc + g with thread j.  o_t goes back into
// v's slot of the tile, which only those lanes read, and leaves in 16-byte
// stores after the walk.  What still holds the walk back is the latency of
// its shared-memory reads at ~12 warps a SM (PERF.md, the scans).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int CARRY_THREADS = 256;
constexpr int CARRY_BATCH = 8;   // chunk states a carry thread loads at once

// 16 bytes of T at p (16-byte aligned), as they lie in memory
template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the 16 / sizeof(T) values of T in raw, widened to f32 (exp of each with
// EXP) and stored at dst: the staging's conversion, one array at a time so
// that only the raw loads are live together
template <typename T, bool EXP>
__device__ __forceinline__ void stage16(uint4 raw, float* dst) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x[2];
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[0] = __uint_as_float(w[i] << 16);
      x[1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      x[0] = __half2float(
          __ushort_as_half(static_cast<unsigned short>(w[i] & 0xFFFFu)));
      x[1] = __half2float(
          __ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
    }
    constexpr int N = sizeof(T) == 4 ? 1 : 2;
#pragma unroll
    for (int e = 0; e < N; ++e) dst[N * i + e] = EXP ? expf(x[e]) : x[e];
  }
}

// 16 / sizeof(T) f32 values rounded to T and stored at p (16-byte aligned)
template <typename T>
__device__ __forceinline__ void store16(T* __restrict__ p, const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(x[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i]))) |
             (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1])))
              << 16);
    } else {
      w[i] = static_cast<uint32_t>(
                 __half_as_ushort(__float2half_rn(x[2 * i]))) |
             (static_cast<uint32_t>(
                  __half_as_ushort(__float2half_rn(x[2 * i + 1])))
              << 16);
    }
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ float read_s0(const void* s0, int s0_f32,
                                         long long at) {
  return s0_f32 ? static_cast<const float*>(s0)[at]
                : to_f32(static_cast<const T*>(s0)[at]);
}

// Shared-memory rows of r, k and exp(w): the HDP values of a step in 4
// row groups of RI = HDP/4, each group followed by 4 unused floats, so the
// 4 groups' float4 reads of one instruction fall in distinct banks
template <int HDP>
struct RowLayout {
  static constexpr int RI = HDP / 4;           // rows a thread holds
  static constexpr int STRIDE = HDP + 16;      // floats of one step's row
  __device__ static int pos(int i) { return i + (i / RI) * 4; }
};

// Passes 1 (OUT false: the chunk's own state and decay into the workspace)
// and 3 (OUT true: o from the chunk's incoming state; s_last from the last
// chunk).  Thread j holds the RI x 4 block of S at rows g*RI.., columns
// 4*jc.. (g = j & 3, jc = j >> 2).  Shared memory, f32: k and exp(w) rows
// (RowLayout), v rows (HDP values) of `tile` steps, then for OUT r rows
// (RowLayout), the steps' bonus and u.
template <typename T, int HDP, bool OUT>
__global__ void __launch_bounds__(HDP)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const T* __restrict__ u, const void* __restrict__ s0,
                   int s0_f32, float* __restrict__ ws,
                   float* __restrict__ dec, T* __restrict__ o,
                   float* __restrict__ s_last, int T_len, int H, int hd,
                   int chunk, int nc, int tile, int vec) {
  using RL = RowLayout<HDP>;
  constexpr int RI = RL::RI, RS = RL::STRIDE;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* e_s = k_s + tile * RS;
  float* v_s = e_s + tile * RS;
  float* r_s = v_s + tile * HDP;            // OUT only, as the two below
  float* b_s = r_s + tile * RS;
  float* u_s = b_s + tile;
  const int j = threadIdx.x;
  const int g = j & 3, jc = j >> 2;         // row group, column group
  const int c = blockIdx.x, h = blockIdx.y;
  const long long bi = blockIdx.z;
  const long long row = static_cast<long long>(H) * hd;     // one t step
  const long long seq0 = bi * T_len * row + static_cast<long long>(h) * hd;
  const long long bh = bi * H + h;
  const long long st = static_cast<long long>(hd) * hd;
  const int t0 = c * chunk, t1 = min(T_len, t0 + chunk);

  // padded rows and columns i >= hd stay zero: staging writes only i < hd
  for (int q = j; q < tile * HDP; q += HDP) {
    const int s = q / HDP, i = q - s * HDP;
    if (i < hd) continue;
    k_s[s * RS + RL::pos(i)] = 0.f;
    e_s[s * RS + RL::pos(i)] = 0.f;
    v_s[q] = 0.f;
    if (OUT) r_s[s * RS + RL::pos(i)] = 0.f;
  }
  if (OUT) u_s[j] = j < hd ? to_f32(u[h * hd + j]) : 0.f;

  // the incoming state: zero (pass 1), s0 (first chunk) or S_in(c)
  float S[RI][4];
  const float* in = (OUT && c > 0) ? ws + (bh * (nc - 1) + c - 1) * st
                                   : nullptr;
#pragma unroll
  for (int ri = 0; ri < RI; ++ri)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int i = g * RI + ri, jj = 4 * jc + cc;
      const long long at = static_cast<long long>(i) * hd + jj;
      S[ri][cc] = (!OUT || i >= hd || jj >= hd) ? 0.f
                  : in ? in[at] : read_s0<T>(s0, s0_f32, bh * st + at);
    }

  const int per_row = vec ? hd * static_cast<int>(sizeof(T)) / 16 : hd;
  constexpr int VE = 16 / sizeof(T);
  float dj = 1.f;                 // pass 1: prod of exp(w) of row j
  for (int ts = t0; ts < t1; ts += tile) {
    const int n = min(tile, t1 - ts);
    // stage n steps: every thread converts its share to f32.  Loads go
    // out in batches of NB vectors of each array, all issued before any is
    // converted, so that their latency overlaps
    if (vec) {          // VE values in one row group: RI is a multiple of VE
      constexpr int NB = 4;
      for (int q0 = j; q0 < n * per_row; q0 += NB * HDP) {
        uint4 raw[NB][4];
#pragma unroll
        for (int bq = 0; bq < NB; ++bq) {
          const int q = q0 + bq * HDP;
          if (q < n * per_row) {
            const int s = q / per_row, i = (q - s * per_row) * VE;
            const long long gq =
                seq0 + static_cast<long long>(ts + s) * row + i;
            raw[bq][0] = load16(k + gq);
            raw[bq][1] = load16(w + gq);
            raw[bq][2] = load16(v + gq);
            if constexpr (OUT) raw[bq][3] = load16(r + gq);
          }
        }
#pragma unroll
        for (int bq = 0; bq < NB; ++bq) {
          const int q = q0 + bq * HDP;
          if (q < n * per_row) {
            const int s = q / per_row, i = (q - s * per_row) * VE;
            const int at = s * RS + RL::pos(i);
            stage16<T, false>(raw[bq][0], k_s + at);
            stage16<T, true>(raw[bq][1], e_s + at);
            stage16<T, false>(raw[bq][2], v_s + s * HDP + i);
            if constexpr (OUT) stage16<T, false>(raw[bq][3], r_s + at);
          }
        }
      }
    } else {
      for (int q = j; q < n * per_row; q += HDP) {
        const int s = q / per_row;
        const long long gq = seq0 + static_cast<long long>(ts + s) * row;
        const int i = q - s * per_row;
        const int at = s * RS + RL::pos(i);
        k_s[at] = to_f32(k[gq + i]);
        e_s[at] = expf(to_f32(w[gq + i]));
        v_s[s * HDP + i] = to_f32(v[gq + i]);
        if (OUT) r_s[at] = to_f32(r[gq + i]);
      }
    }
    __syncthreads();
    if (OUT) {                    // the bonus r_t . (u (.) k_t), a warp a step
      const int lane = j & 31;
      for (int s = j >> 5; s < n; s += HDP / 32) {
        float p = 0.f;
        for (int i = lane; i < hd; i += 32)
          p = fmaf(r_s[s * RS + RL::pos(i)] * u_s[i], k_s[s * RS + RL::pos(i)],
                   p);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, m);
        if (lane == 0) b_s[s] = p;
      }
      __syncthreads();
    }
    for (int s = 0; s < n; ++s) {
      const float4 vv = reinterpret_cast<const float4*>(v_s + s * HDP)[jc];
      const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
      const int base = s * RS + g * (RI + 4);
      const float4* k4 = reinterpret_cast<const float4*>(k_s + base);
      const float4* e4 = reinterpret_cast<const float4*>(e_s + base);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < RI / 4; ++m) {
        const float4 kk = k4[m], ee = e4[m];
        const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
        const float eq[4] = {ee.x, ee.y, ee.z, ee.w};
        float rq[4];
        if constexpr (OUT) {
          const float4 rr = reinterpret_cast<const float4*>(r_s + base)[m];
          rq[0] = rr.x; rq[1] = rr.y; rq[2] = rr.z; rq[3] = rr.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float& sv = S[4 * m + q][cc];
            if constexpr (OUT) acc[cc] = fmaf(rq[q], sv, acc[cc]);
            sv = fmaf(eq[q], sv, kq[q] * vc[cc]);
          }
      }
      if constexpr (OUT) {
        // the 4 row groups' sums, reduce-scattered over lanes g: thread
        // (jc, g) ends with column 4*jc + g
        const bool hi2 = g & 2, hi1 = g & 1;
        float k0 = hi2 ? acc[2] : acc[0], k1 = hi2 ? acc[3] : acc[1];
        k0 += __shfl_xor_sync(0xffffffffu, hi2 ? acc[0] : acc[2], 2);
        k1 += __shfl_xor_sync(0xffffffffu, hi2 ? acc[1] : acc[3], 2);
        float mine = hi1 ? k1 : k0;
        mine += __shfl_xor_sync(0xffffffffu, hi1 ? k0 : k1, 1);
        // o_t into v's slot of step s, which only this warp's lanes of jc
        // read, and read above
        const float vg = g == 0 ? vv.x : g == 1 ? vv.y : g == 2 ? vv.z : vv.w;
        v_s[s * HDP + 4 * jc + g] = fmaf(b_s[s], vg, mine);
      }
    }
    if (!OUT && j < hd) {
      for (int s = 0; s < n; ++s) dj *= e_s[s * RS + RL::pos(j)];
    }
    __syncthreads();
    if (OUT) {                    // o of the tile, from v's slots
      for (int q = j; q < n * per_row; q += HDP) {
        const int s = q / per_row;
        const long long gq = seq0 + static_cast<long long>(ts + s) * row;
        if (vec) {
          const int i = (q - s * per_row) * VE;
          store16(o + gq + i, v_s + s * HDP + i);
        } else {
          const int i = q - s * per_row;
          o[gq + i] = from_f32<T>(v_s[s * HDP + i]);
        }
      }
      __syncthreads();            // the next tile restages the rows
    }
  }
  float* out = OUT ? (c == nc - 1 ? s_last + bh * st : nullptr)
                   : ws + (bh * (nc - 1) + c) * st;
  if (out) {
#pragma unroll
    for (int ri = 0; ri < RI; ++ri)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = g * RI + ri, jj = 4 * jc + cc;
        if (i < hd && jj < hd) out[static_cast<long long>(i) * hd + jj] =
            S[ri][cc];
      }
  }
  if (!OUT && j < hd) dec[(bh * (nc - 1) + c) * hd + j] = dj;
}

// Pass 2: one thread per state entry (i, j) of one (b, h) walks the chunks
// in order, S <- D_c[i] * S + dS_c[i][j], writing each S_in(c+1) over dS_c
template <typename T>
__global__ void __launch_bounds__(CARRY_THREADS)
rwkv6_carry_kernel(const void* __restrict__ s0, int s0_f32,
                   float* __restrict__ ws, const float* __restrict__ dec,
                   int H, int hd, int nc) {
  const int e = blockIdx.x * CARRY_THREADS + threadIdx.x;
  const long long st = static_cast<long long>(hd) * hd;
  if (e >= st) return;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const int i = e / hd;
  float S = read_s0<T>(s0, s0_f32, bh * st + e);
  float* p = ws + bh * (nc - 1) * st + e;
  const float* d = dec + bh * (nc - 1) * hd + i;
  for (int c0 = 0; c0 < nc - 1; c0 += CARRY_BATCH) {
    float ds[CARRY_BATCH], dc[CARRY_BATCH];
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      const bool in = c0 + q < nc - 1;
      ds[q] = in ? p[(c0 + q) * st] : 0.f;
      dc[q] = in ? d[(c0 + q) * hd] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      if (c0 + q >= nc - 1) break;
      S = fmaf(dc[q], S, ds[q]);
      p[(c0 + q) * st] = S;
    }
  }
}

template <typename T, int HDP>
int launch(const T* r, const T* k, const T* v, const T* w, const T* u,
           const void* s0, int s0_f32, T* o, float* s_last, float* ws,
           float* dec, int B, int T_len, int H, int hd, int chunk, int nc,
           int tile, int vec, cudaStream_t stream) {
  constexpr int RS = RowLayout<HDP>::STRIDE;
  const size_t in_bytes = sizeof(float) * tile * (2 * RS + HDP);
  const size_t out_bytes =
      in_bytes + sizeof(float) * (tile * (RS + 1) + HDP);
  cudaError_t err;
  if (nc > 1) {
    err = cudaFuncSetAttribute(rwkv6_chunk_kernel<T, HDP, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(in_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    rwkv6_chunk_kernel<T, HDP, false>
        <<<dim3(nc - 1, H, B), HDP, in_bytes, stream>>>(
            r, k, v, w, u, s0, s0_f32, ws, dec, o, s_last, T_len, H, hd,
            chunk, nc, tile, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int entries = hd * hd;
    rwkv6_carry_kernel<T><<<dim3((entries + CARRY_THREADS - 1) /
                                     CARRY_THREADS, H, B),
                            CARRY_THREADS, 0, stream>>>(s0, s0_f32, ws, dec,
                                                        H, hd, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(rwkv6_chunk_kernel<T, HDP, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(out_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_chunk_kernel<T, HDP, true><<<dim3(nc, H, B), HDP, out_bytes,
                                     stream>>>(
      r, k, v, w, u, s0, s0_f32, ws, dec, o, s_last, T_len, H, hd, chunk, nc,
      tile, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* r, const T* k, const T* v, const T* w, const T* u,
             const void* s0, int s0_f32, T* o, float* s_last, float* ws,
             float* dec, int B, int T_len, int H, int hd, int chunk, int nc,
             int tile, int vec, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B > 65535 || H > 65535 || hd < 1 || chunk < 1 || tile < 1 ||
      T_len < 0 || nc != max(1, (T_len + chunk - 1) / chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SOL_HDP(P)                                                          \
  return launch<T, P>(r, k, v, w, u, s0, s0_f32, o, s_last, ws, dec, B,    \
                      T_len, H, hd, chunk, nc, tile, vec, s)
  if (hd <= 32) SOL_HDP(32);
  if (hd <= 64) SOL_HDP(64);
  if (hd <= 128) SOL_HDP(128);
#undef SOL_HDP
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// sol_rwkv6_scan_f32, _bf16 and _f16: r, k, v, w, u and o in that type, s0
// in it or in f32 (s0_f32), s_last f32; ws and dec the f32 workspace of
// chunk states and decays; chunk, nc and tile from rwkv6_plan(); vec: rows
// of hd values are 16-byte aligned
#define SOL_RWKV6(T, SUFFIX)                                                 \
  SOL_EXPORT int sol_rwkv6_scan_##SUFFIX(                                    \
      const T* r, const T* k, const T* v, const T* w, const T* u,            \
      const void* s0, int s0_f32, T* o, float* s_last, float* ws,            \
      float* dec, int B, int T_len, int H, int hd, int chunk, int nc,        \
      int tile, int vec, void* stream) {                                     \
    return dispatch<T>(r, k, v, w, u, s0, s0_f32, o, s_last, ws, dec, B,     \
                       T_len, H, hd, chunk, nc, tile, vec, stream);          \
  }
SOL_FOR_EACH_DTYPE(SOL_RWKV6)
#undef SOL_RWKV6
