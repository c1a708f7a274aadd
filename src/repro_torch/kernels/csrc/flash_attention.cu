// Causal GQA flash attention forward for Hopper on the tensor cores
// (mma.sync); f32, bf16 and f16 storage.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_call (the Pallas kernel behind pallas.flash_attention).
//
// Computes o = softmax(mask(cap(q k^T / sqrt(hd)))) v per (batch, q head),
// the kv head being h / (H / KV).  q, k, v and o are the node's BSHD
// tensors, read and written through their strides, so no transpose or pad
// copy is made.  The kv loop is bounded by causality (tiles past the last
// query row of the block are never loaded) and by the window; padded keys
// (position >= S) are masked; a tanh softcap applies when cap > 0.  Fully
// masked rows keep max = -inf and contribute nothing (no -inf - -inf).
// The scores, softmax and accumulator are f32 and o is rounded once to T
// at its store, as JAX's kernel does (flash_attention/kernel.py:38-79).
//
// What bounds it on this card: 4*B*H*S^2/2*hd FLOPs of products against
// reading q, k, v and writing o once.  At the serving prefill (B 4, S 128,
// H 12, hd 128) that is a few microseconds of tensor-core work spread over
// ~100 blocks, so the time is the latency of each block's serial walk over
// its key tiles, not a rate.
//
// Design (FlashAttention-2's layout): a block holds NW warps, each warp
// owns 16 query rows (NW is a template parameter, 4 by default: 64 rows a
// block, 96 blocks at the serving prefill, up to two on an SM; 2 is the
// tuned alternative, 32 rows a block, twice the blocks and half the causal
// walk of the longest one), and the block walks key tiles of BKV rows (64
// for 16-bit types, 32 for f32).  Q, K and V sit in shared
// memory in the storage type, their rows padded by 16 bytes so fragment
// loads hit distinct banks; K and V arrive through a cp.async
// double-buffered ring (tile t+1 lands while tile t is computed).  In bf16
// and f16 the scores are mma.sync.m16n8k16 products with f32
// accumulators, operands loaded with ldmatrix (V with ldmatrix.trans);
// products of two 16-bit values are exact in f32.  The softmax scale
// multiplies the f32 scores, so q is never rounded after scaling.  The
// online softmax (running max, sum and correction per row) stays in
// registers in the accumulator layout, reduced over each row's quad of
// lanes by shuffles; the score fragments turn into P·V's A fragments in
// registers, with no P tile in shared memory.  P must be rounded to T for
// the second product, where JAX keeps it in f32: it is split as
// P = P_hi + P_lo, both in T, and both products go into the one f32
// accumulator, which keeps ~16 bits of P (the 16-bit counterpart of the
// matmul's 3xTF32 split; P_hi alone misses one rounding step of T).  In
// f32 the same structure runs mma.sync.m16n8k8 in 3xTF32 (matmul.cu's
// split: small*big + big*small + big*big, each TF32 value rounded to
// nearest), with operands read from shared memory in the fragment layout
// and P·V's key order permuted so the score fragments serve as A without
// shuffles.  o is written to the warp's own Q rows in shared memory and
// copied out in 16-byte stores.  wgmma, TMA and warp specialisation are
// later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

struct Strides {           // element strides of a BSHD tensor (d stride 1)
  long long b, s, h;
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b on one m16n8k16 tile of 16-bit operands, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// d += a b on one m16n8k8 tile of TF32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, each a TF32 value rounded to nearest (matmul.cu)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// (x0, x1) as two values of T in one register, x0 at the lower half, and
// the same pair's rounding remainders in T
template <typename T>
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const __nv_bfloat162 l = __floats2bfloat162_rn(
        x0 - __low2float(h), x1 - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    const __half2 l = __floats2half2_rn(x0 - __low2float(h),
                                        x1 - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <typename T>
struct Cfg {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int BKV = HALF ? 64 : 32;      // keys per tile
  static constexpr int PAD = 16 / sizeof(T);      // 16 bytes per row
};

// rows [row0, row0 + n) of a (S, HD) operand with row stride rs into
// shared rows of LD elements; rows at or past S are zero.  With `vec` the
// copy is 16-byte cp.async (bases and strides 16-byte aligned), else one
// value at a time through registers.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int row0, int n, int S, bool vec,
                                          int tid, int nt) {
  constexpr int LD = HD + Cfg<T>::PAD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;                   // 16-byte chunks per row
  if (vec) {
    for (int c = tid; c < n * CPR; c += nt) {
      const int r = c / CPR, e = (c % CPR) * VEC;
      const bool in = row0 + r < S;
      cp_async16(dst + r * LD + e, in ? src + (row0 + r) * rs + e : src,
                 in ? 16 : 0);
    }
  } else {
    for (int c = tid; c < n * HD; c += nt) {
      const int r = c / HD, e = c % HD;
      dst[r * LD + e] =
          row0 + r < S ? src[(row0 + r) * rs + e] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int HD, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int group, int S,
                 int causal, int window, float cap, float scale, int vec) {
  using C = Cfg<T>;
  constexpr int BQ = 16 * NW;         // query rows a block
  constexpr int BKV = C::BKV;
  constexpr int LD = HD + C::PAD;
  constexpr int NT = NW * 32;
  constexpr int NS = BKV / 8;         // score n-tiles of 8 keys
  constexpr int NO = HD / 8;          // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);         // BQ x LD
  T* KV = Qs + BQ * LD;                           // 2 stages of K, V tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the q tiles with the most key tiles start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int q0 = qt * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  const int nk = (S + BKV - 1) / BKV;
  int lo = 0, hi = nk;
  if (causal) {
    hi = min(nk, (q0 + BQ + BKV - 1) / BKV);
    if (window) lo = max(0, q0 - window) / BKV;
  }

  auto stage = [&](int tile, int st) {
    T* Ks = KV + 2 * st * BKV * LD;
    load_rows<T, HD>(Ks, kb, ks.s, tile * BKV, BKV, S, vec, tid, NT);
    load_rows<T, HD>(Ks + BKV * LD, vb, vs.s, tile * BKV, BKV, S, vec, tid,
                     NT);
  };
  load_rows<T, HD>(Qs, qb, qs.s, q0, BQ, S, vec, tid, NT);
  if (lo < hi) stage(lo, 0);
  cp_async_commit();

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the running sum
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int r0 = warp * 16;
  const float sl2 = scale * LOG2E;

  for (int it = lo; it < hi; ++it) {
    const int st = (it - lo) & 1;
    if (it + 1 < hi) {
      stage(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = KV + 2 * st * BKV * LD;
    const T* Vs = Ks + BKV * LD;

    // scores of the warp's 16 rows against the tile's keys:
    // sacc[j] = rows g, g + 8 x keys 8j + 2t, 8j + 2t + 1
    float sacc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    if constexpr (C::HALF) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + (r0 + (lane & 15)) * LD + kc * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) * LD +
                              kc * 16 + ((lane >> 3) & 1) * 8);
          mma16<T>(sacc[2 * jp], a, bk[0], bk[1]);
          mma16<T>(sacc[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    } else {
#pragma unroll 4
      for (int kc = 0; kc < HD / 8; ++kc) {
        const float* Qf = reinterpret_cast<const float*>(Qs);
        const float* Kf = reinterpret_cast<const float*>(Ks);
        uint32_t ab[4], as[4];
        const int c = kc * 8 + t;
        split_tf32(Qf[(r0 + g) * LD + c], ab[0], as[0]);
        split_tf32(Qf[(r0 + g + 8) * LD + c], ab[1], as[1]);
        split_tf32(Qf[(r0 + g) * LD + c + 4], ab[2], as[2]);
        split_tf32(Qf[(r0 + g + 8) * LD + c + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          uint32_t b0, b0s, b1, b1s;
          split_tf32(Kf[(8 * j + g) * LD + c], b0, b0s);
          split_tf32(Kf[(8 * j + g) * LD + c + 4], b1, b1s);
          mma_tf32(sacc[j], as, b0, b1);
          mma_tf32(sacc[j], ab, b0s, b1s);
          mma_tf32(sacc[j], ab, b0, b1);
        }
      }
    }

    // scale (in f32, then to log2 units), softcap, mask
    const int k0 = it * BKV;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + g + (e >> 1) * 8;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = sacc[j][e];
        if (cap > 0.f)
          x = tanhf(x * scale / cap) * cap * LOG2E;
        else
          x *= sl2;
        bool ok = key < S;
        if (causal) ok = ok && row >= key;
        if (window) ok = ok && (row - key) < window;
        sacc[j][e] = ok ? x : -INFINITY;
      }

    // online softmax per row, in registers: the quad of lanes that share
    // a row reduce by shuffles
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sacc[j][2 * rh], sacc[j][2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[rh], mx);
      float corr = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {
#pragma unroll
        for (int j = 0; j < NS; ++j) sacc[j][2 * rh] = sacc[j][2 * rh + 1] = 0.f;
      } else {
        corr = exp2f(m_r[rh] - m_new);          // 0 when m_r = -inf
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * rh; e < 2 * rh + 2; ++e) {
            const float p = exp2f(sacc[j][e] - m_new);
            sacc[j][e] = p;
            sum += p;
          }
      }
      m_r[rh] = m_new;
      l_r[rh] = l_r[rh] * corr + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        oacc[n][2 * rh] *= corr;
        oacc[n][2 * rh + 1] *= corr;
      }
    }

    // o += P V
    if constexpr (C::HALF) {
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        uint32_t ph[4], pl[4];
        pack_split<T>(sacc[2 * c][0], sacc[2 * c][1], ph[0], pl[0]);
        pack_split<T>(sacc[2 * c][2], sacc[2 * c][3], ph[1], pl[1]);
        pack_split<T>(sacc[2 * c + 1][0], sacc[2 * c + 1][1], ph[2], pl[2]);
        pack_split<T>(sacc[2 * c + 1][2], sacc[2 * c + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vs + (16 * c + (lane & 15)) * LD + 16 * np +
                                    (lane >> 4) * 8);
          mma16<T>(oacc[2 * np], pl, bv[0], bv[1]);
          mma16<T>(oacc[2 * np], ph, bv[0], bv[1]);
          mma16<T>(oacc[2 * np + 1], pl, bv[2], bv[3]);
          mma16<T>(oacc[2 * np + 1], ph, bv[2], bv[3]);
        }
      }
    } else {
      // keys 8j + 2t and 8j + 2t + 1 stand at k indices t and t + 4 of
      // the m16n8k8 step, so sacc[j] is its A fragment as it is
      const float* Vf = reinterpret_cast<const float*>(Vs);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t ab[4], as[4];
        split_tf32(sacc[j][0], ab[0], as[0]);
        split_tf32(sacc[j][2], ab[1], as[1]);
        split_tf32(sacc[j][1], ab[2], as[2]);
        split_tf32(sacc[j][3], ab[3], as[3]);
        const float* v0 = Vf + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b0s, b1, b1s;
          split_tf32(v0[8 * n], b0, b0s);
          split_tf32(v0[LD + 8 * n], b1, b1s);
          mma_tf32(oacc[n], as, b0, b1);
          mma_tf32(oacc[n], ab, b0s, b1s);
          mma_tf32(oacc[n], ab, b0, b1);
        }
      }
    }
    __syncthreads();      // the stage is refilled by the next iteration
  }

  // o = acc / l, rounded to T into the warp's own Q rows (no other warp
  // reads them), then copied out a row at a time in 16-byte stores
  T* Os = Qs + r0 * LD;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float l = l_r[rh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = Os + (g + 8 * rh) * LD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      orow[8 * n] = from_f32<T>(oacc[n][2 * rh] * inv);
      orow[8 * n + 1] = from_f32<T>(oacc[n][2 * rh + 1] * inv);
    }
  }
  __syncwarp();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  T* ob = o + b * os.b + h * os.h;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, e = (c % CPR) * VEC;
    const int row = q0 + r0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(ob + row * os.s + e) =
          *reinterpret_cast<const uint4*>(Os + r * LD + e);
  }
}

// shared memory of a block: the Q tile and two stages of K and V tiles
// (flash_attention/kernel.py's flash_smem_bytes computes the same)
template <typename T, int HD, int NW>
int launch(const T* q, const T* k, const T* v, T* o, Strides qs, Strides ks,
           Strides vs, Strides os, int B, int H, int KV, int S, int causal,
           int window, float cap, int vec, cudaStream_t stream) {
  using C = Cfg<T>;
  constexpr int BQ = 16 * NW;
  const size_t smem = sizeof(T) * (HD + C::PAD) * (BQ + 4 * C::BKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, HD, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)HD);
  flash_mma_kernel<T, HD, NW><<<grid, NW * 32, smem, stream>>>(
      q, k, v, o, qs, ks, vs, os, H / KV, S, causal, window, cap, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NW>
int dispatch_hd(const T* q, const T* k, const T* v, T* o, Strides qs,
                Strides ks, Strides vs, Strides os, int B, int S, int H,
                int KV, int hd, int causal, int window, float cap, int vec,
                cudaStream_t s) {
#define SOL_HD(HD_)                                                          \
  return launch<T, HD_, NW>(q, k, v, o, qs, ks, vs, os, B, H, KV, S, causal, \
                            window, cap, vec, s)
  switch (hd) {
    case 16: SOL_HD(16);
    case 32: SOL_HD(32);
    case 64: SOL_HD(64);
    case 128: SOL_HD(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SOL_HD
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
             int KV, int hd, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long o_sb, long long o_ss,
             long long o_sh, int causal, int window, float cap, int block_q,
             int vec, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_q) {
    case 64:
      return dispatch_hd<T, 4>(q, k, v, o, qs, ks, vs, os, B, S, H, KV, hd,
                               causal, window, cap, vec, s);
    case 32:
      return dispatch_hd<T, 2>(q, k, v, o, qs, ks, vs, os, B, S, H, KV, hd,
                               causal, window, cap, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// sol_flash_attention_f32, _bf16 and _f16: q (B,S,H,hd), k/v (B,S,KV,hd),
// o (B,S,H,hd), all in that type; strides in elements, the hd stride 1.
// block_q: query rows a block, 64 (4 warps) or 32 (2 warps).
// vec: q's, k's and v's bases and row strides are 16-byte aligned (16-byte
// copies); o's must be (the wrapper allocates it contiguous).
// Returns a cudaError_t (cudaErrorInvalidValue for an hd or block_q the
// kernel is not instantiated for).
#define SOL_FLASH(T, SUFFIX)                                                 \
  SOL_EXPORT int sol_flash_attention_##SUFFIX(                               \
      const T* q, const T* k, const T* v, T* o, int B, int S, int H, int KV, \
      int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh,        \
      int causal, int window, float cap, int block_q, int vec,               \
      void* stream) {                                                        \
    return dispatch<T>(q, k, v, o, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb,  \
                       k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,       \
                       causal, window, cap, block_q, vec, stream);           \
  }
SOL_FOR_EACH_DTYPE(SOL_FLASH)
#undef SOL_FLASH
