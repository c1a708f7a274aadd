// Single-token decode attention for Hopper as flash-decoding: a split-KV
// pass and a combine pass; f32, bf16 and f16 storage.
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
// one storage type T, widened to f32 as they are read; scores, softmax,
// partials and accumulator are f32, and o is rounded once to T at its
// store (JAX's decode_attention/kernel.py:44-91).
//
// What bounds it on this card: reading the valid cache rows once (2 * len
// * hd values of T per kv head), a few FLOPs per byte: memory, and at the
// serving buckets (a few hundred KB) the latency of a launch.
//
// Design.  decode_split_kernel: grid (splits, KV, B); block s takes cache
// rows [s * chunk, (s + 1) * chunk) for the whole GQA group, so every row
// is read once for all H/KV query heads, and exits at once where the chunk
// lies at or past lens[b] or below the window.  The split count and chunk
// come from the shapes alone (decode_plan in kernels/decode_attention/
// kernel.py), so the host reads nothing from the device.  Warp w owns the
// group's heads w, w + NW, ... (its q slices in registers); its lanes split
// hd into 16-byte pieces, so a row is HD / VEC lanes and a warp steps over
// 32 * VEC / HD rows at once.  Rows load with 16-byte vector loads straight
// to registers, a tile's eight steps of K and V rows at once; the dot
// products are warp-shuffle sums over hd; each warp keeps an online
// softmax (max, sum, accumulator) per head in registers and writes f32
// partials (m, l, acc) of its split to a workspace the wrapper allocates;
// an empty split writes m = -inf, l = 0.  decode_combine_kernel: grid
// (H, B), a thread per output value; merges the head's splits in split
// order (eight splits' loads in flight at once), folds in (k_new, v_new)
// last as JAX does, and rounds o once.  With lens[b] = 0 every split is
// empty and o is exactly v_new.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_GROUP = 16;      // query heads per kv head
constexpr int MAX_SPLITS = 128;    // splits the combine's shared memory holds
constexpr int NSTEP = 8;           // row steps of a warp per tile

// 16 bytes of T at p, as they lie in memory; `vec`: p is 16-byte aligned
// (one vector load), else one value at a time
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
    const unsigned* u = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(u + i);
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(__ldg(u + 2 * i)) |
             (static_cast<uint32_t>(__ldg(u + 2 * i + 1)) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 16 / sizeof(T) values of T in r, widened to f32
template <typename T>
__device__ __forceinline__ void unpack(uint4 r, float (&x)[16 / sizeof(T)]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      x[2 * i] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i] & 0xFFFFu)));
      x[2 * i + 1] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i] >> 16)));
    }
  }
}

template <typename T, int HD, int GW>
__global__ void __launch_bounds__(128)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int S, int G, int splits,
                    int chunk, long long q_sb, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, int window, float cap,
                    float scale, int vec) {
  constexpr int VEC = 16 / sizeof(T);   // values per 16-byte load
  constexpr int LPR = HD / VEC;         // lanes per cache row
  constexpr int RPP = 32 / LPR;         // rows per warp step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int L = min(max(lens[b], 0), S);
  const int first = window ? max(0, L - window + 1) : 0;
  const int c0 = max(sp * chunk, first), c1 = min(sp * chunk + chunk, L);
  const long long pidx =
      ((static_cast<long long>(b) * gridDim.y + kvh) * splits + sp) * G;
  if (c0 >= c1) {        // no row of this split is visible
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      part_m[pidx + g] = -INFINITY;
      part_l[pidx + g] = 0.f;
    }
    return;
  }

  const int rg = lane / LPR, dl = (lane % LPR) * VEC;
  const T* kb = k + b * k_sb + kvh * k_sh + dl;
  const T* vb = v + b * v_sb + kvh * v_sh + dl;
  float qv[GW][VEC], acc[GW][VEC], m[GW], l[GW];
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    const int g = warp + nw * j;
    if (g < G) {
      unpack<T>(load_raw(q + b * q_sb + (kvh * G + g) * q_sh + dl, vec),
                qv[j]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
    m[j] = -INFINITY;
    l[j] = 0.f;
  }

  for (int r0 = c0; r0 < c1; r0 += NSTEP * RPP) {
    // the tile's K and V rows, all in flight at once
    uint4 kr[NSTEP], vr[NSTEP];
#pragma unroll
    for (int i = 0; i < NSTEP; ++i) {
      const int row = r0 + i * RPP + rg;
      const bool in = row < c1;
      kr[i] = in ? load_raw(kb + row * k_ss, vec) : make_uint4(0, 0, 0, 0);
      vr[i] = in ? load_raw(vb + row * v_ss, vec) : make_uint4(0, 0, 0, 0);
    }
    float s[NSTEP][GW];
#pragma unroll
    for (int i = 0; i < NSTEP; ++i) {
      const int row = r0 + i * RPP + rg;
      float kf[VEC];
      unpack<T>(kr[i], kf);
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) x = fmaf(qv[j][e], kf[e], x);
#pragma unroll
        for (int off = LPR / 2; off; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        x *= scale;
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        s[i][j] = row < c1 ? x : -INFINITY;
      }
    }
    // online softmax per head over the tile's rows; row r0 is visible, so
    // the tile's max is finite
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      float mx = s[0][j];
#pragma unroll
      for (int i = 1; i < NSTEP; ++i) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[j], mx);
      const float corr = expf(m[j] - m_new);       // 0 when m = -inf
      m[j] = m_new;
      l[j] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] *= corr;
#pragma unroll
      for (int i = 0; i < NSTEP; ++i) {
        const float p = expf(s[i][j] - m_new);     // 0 for a masked row
        s[i][j] = p;
        l[j] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < NSTEP; ++i) {
      float vf[VEC];      // a row past c1 is zeros, with p = 0
      unpack<T>(vr[i], vf);
#pragma unroll
      for (int j = 0; j < GW; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(s[i][j], vf[e], acc[j][e]);
    }
  }

  // sum the row groups' shares, then the first row group writes
#pragma unroll
  for (int j = 0; j < GW; ++j) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
    }
    const int g = warp + nw * j;
    if (rg == 0 && g < G) {
      float* pa = part_acc + (pidx + g) * HD + dl;
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(pa + e) =
            make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
      if (dl == 0) {
        part_m[pidx + g] = m[j];
        part_l[pidx + g] = l[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                      const T* __restrict__ vn,
                      const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l, T* __restrict__ o,
                      int KV, int G, int HD, int splits, long long q_sb,
                      long long q_sh, long long kn_sb, long long kn_sh,
                      long long vn_sb, long long vn_sh, float cap,
                      float scale) {
  __shared__ float w[MAX_SPLITS + 1];       // [splits]: the new pair's
  __shared__ float inv_l;
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int kvh = h / G, g = h % G;
  // partial (s, g) of (b, kvh) sits at base + s * G + g
  const long long base =
      (static_cast<long long>(b) * KV + kvh) * splits * G + g;
  const T* vnb = vn + b * vn_sb + kvh * vn_sh;

  if (tid < 32) {        // one warp: the new pair's score, the weights
    const T* qh = q + b * q_sb + h * q_sh;
    const T* knb = kn + b * kn_sb + kvh * kn_sh;
    float x = 0.f;
    for (int d = lane; d < HD; d += 32)
      x = fmaf(to_f32(qh[d]), to_f32(knb[d]), x);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    x *= scale;
    if (cap > 0.f) x = tanhf(x / cap) * cap;
    float mx = x;
    for (int s = lane; s < splits; s += 32)
      mx = fmaxf(mx, part_m[base + s * G]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float ms = part_m[base + s * G];
      const float ws = ms == -INFINITY ? 0.f : expf(ms - mx);
      w[s] = ws;
      sum = fmaf(ws, part_l[base + s * G], sum);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float wn = expf(x - mx);
      w[splits] = wn;
      inv_l = 1.f / fmaxf(sum + wn, 1e-30f);
    }
  }
  __syncthreads();
  for (int d = tid; d < HD; d += blockDim.x) {
    const float* pa = part_acc + base * HD + d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {      // in split order
      const float ws = w[s];
      if (ws > 0.f) a = fmaf(ws, pa[s * G * HD], a);
    }
    a = fmaf(w[splits], to_f32(vnb[d]), a);
    o[(static_cast<long long>(b) * H + h) * HD + d] = from_f32<T>(a * inv_l);
  }
}

template <typename T, int HD, int GW>
int launch_split(const T* q, const T* k, const T* v, const int* lens,
                 float* ws, int B, int S, int KV, int G, int nw, int splits,
                 int chunk, long long q_sb, long long q_sh, long long k_sb,
                 long long k_ss, long long k_sh, long long v_sb,
                 long long v_ss, long long v_sh, int window, float cap,
                 int vec, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * KV * splits * G;
  dim3 grid(splits, KV, B);
  decode_split_kernel<T, HD, GW><<<grid, 32 * nw, 0, stream>>>(
      q, k, v, lens, ws, ws + n * HD, ws + n * (HD + 1), S, G, splits, chunk,
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, window, cap,
      1.f / sqrtf((float)HD), vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, const int* lens, float* ws,
              int B, int S, int KV, int G, int splits, int chunk,
              long long q_sb, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              int window, float cap, int vec, cudaStream_t stream) {
  // up to 4 warps, each with ceil(G / warps) heads
#define SOL_SPLIT(GW_, NW_)                                                 \
  return launch_split<T, HD, GW_>(q, k, v, lens, ws, B, S, KV, G, NW_,     \
                                  splits, chunk, q_sb, q_sh, k_sb, k_ss,   \
                                  k_sh, v_sb, v_ss, v_sh, window, cap, vec, \
                                  stream)
  if (G <= 4) SOL_SPLIT(1, G);
  if (G <= 8) SOL_SPLIT(2, 4);
  SOL_SPLIT(4, 4);
#undef SOL_SPLIT
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const T* kn, const T* vn,
             const int* lens, T* o, float* ws, int B, int S, int H, int KV,
             int hd, int splits, int chunk, long long q_sb, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long kn_sb,
             long long kn_sh, long long vn_sb, long long vn_sh, int window,
             float cap, int vec, void* stream) {
  if (B == 0 || H == 0) return 0;
  const int G = H / KV;
  if (G < 1 || G > MAX_GROUP || splits < 1 || splits > MAX_SPLITS ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define SOL_DECODE(HD_)                                                     \
  err = launch_hd<T, HD_>(q, k, v, lens, ws, B, S, KV, G, splits, chunk,    \
                          q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,   \
                          window, cap, vec, s);                             \
  break
  switch (hd) {
    case 16: SOL_DECODE(16);
    case 32: SOL_DECODE(32);
    case 64: SOL_DECODE(64);
    case 128: SOL_DECODE(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SOL_DECODE
  if (err) return err;
  const long long n = static_cast<long long>(B) * KV * splits * G;
  decode_combine_kernel<T><<<dim3(H, B), hd < 32 ? 32 : hd, 0, s>>>(
      q, kn, vn, ws, ws + n * hd, ws + n * (hd + 1), o, KV, G, hd, splits,
      q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh, cap, 1.f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sol_decode_attention_f32, _bf16 and _f16: q, the cache, k_new, v_new and
// o in that type, lens int32; ws: f32 workspace of B*KV*splits*(H/KV)*(hd+2)
// values (the partial accumulators, then the maxima, then the sums); the
// cache rows [s * chunk, (s + 1) * chunk) are split s's.  vec: q's and the
// cache's bases and strides are 16-byte aligned (16-byte loads).
#define SOL_DECODE_ENTRY(T, SUFFIX)                                          \
  SOL_EXPORT int sol_decode_attention_##SUFFIX(                              \
      const T* q, const T* k, const T* v, const T* kn, const T* vn,          \
      const int* lens, T* o, float* ws, int B, int S, int H, int KV, int hd, \
      int splits, int chunk, long long q_sb, long long q_sh, long long k_sb, \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long kn_sb, long long kn_sh, long long vn_sb,     \
      long long vn_sh, int window, float cap, int vec, void* stream) {       \
    return dispatch<T>(q, k, v, kn, vn, lens, o, ws, B, S, H, KV, hd,        \
                       splits, chunk, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,    \
                       v_ss, v_sh, kn_sb, kn_sh, vn_sb, vn_sh, window, cap,  \
                       vec, stream);                                         \
  }
SOL_FOR_EACH_DTYPE(SOL_DECODE_ENTRY)
#undef SOL_DECODE_ENTRY
