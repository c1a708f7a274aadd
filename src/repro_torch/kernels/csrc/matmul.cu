// Matrix products for Hopper in f32, bf16 and f16 storage: a tensor-core
// kernel for the large products and a bandwidth-bound kernel for the
// skinny ones.
//
// Replaces: src/repro/kernels/matmul/kernel.py, matmul_call (the Pallas
// MXU matmul behind pallas.linear_mxu and pallas.matmul_mxu).
//
// Computes C(M,N) = A(M,K) @ B(K,N) with A, B and C in one storage type T
// and an f32 accumulator, rounded once to T at the store (JAX's
// matmul/kernel.py:78,82).  In f32 the product is f32-accurate.  A is
// row-major with row stride lda.  B element (k,n) sits at
// B[k*ldb_k + n*ldb_n] with ldb_k == 1 (a Linear weight stored (out,in) =
// (N,K), read in place as its transpose: the 233 M-float LM head is never
// copied) or ldb_n == 1 (an (in,out) weight).  The host picks the kernel,
// the split of K, the grid and the copy width (kernels/matmul/kernel.py,
// plan()); this file launches what it is given.
//
// tc_kernel, for M > 16 and N > 16.  Bound by operations.  Each product
// runs on the tensor cores as 3xTF32: every operand value x is split into
// big = tf32(x) and small = tf32(x - big), rounded to nearest by
// cvt.rna.tf32.f32 (the tensor cores would truncate the low 13 mantissa
// bits themselves), and the f32 accumulator takes a_small*b_big +
// a_big*b_small + a_big*b_big.  That keeps the error at ~2^-21 of the
// output's scale, as an f32 SGEMM, where one TF32 pass gives ~5e-4; the
// ceiling is 495/3 = 165 TFLOP/s of f32-accurate products against the
// 67 TFLOP/s of f32 outside the tensor cores.  The tensor cores also
// round each accumulation toward zero, which chained over all of K drifts
// by ~1e-8 * K of the output's scale; so every 4 slabs of 32 k sum into
// a second register tile that is added to the accumulator in f32.
//
// Instruction: wgmma.mma_async m64n128k8 tf32, A from registers, B from
// shared memory.  wgmma takes TF32 operands only K-major, so B, an
// (out,in) weight (K-contiguous) or an (in,out) one (N-contiguous) alike,
// is split once per block into big and small tiles in wgmma's K-major
// layout without swizzle; A's fragments are read with ldmatrix and split
// in registers by the warp that uses them.  Tiles: 128x128 per block of
// two warpgroups, 64 rows each.  Copy engine: cp.async, 16-byte copies
// where base and row stride allow it (else a 4-byte variant of the same
// kernel), into a 4-stage ring of raw slabs; ragged edges are zero-filled
// by the copies (src-size below the copy size), never padded by copying
// an operand; raw rows are padded by 4 or 8 floats, so reading them is
// free of bank conflicts.  The k steps stream through the tensor cores:
// each step's three wgmmas are one group, each step has its own A
// registers, and up to four groups are in flight; between slabs the block
// splits the next slab's B into the other of two buffers.  Blocks walk
// the output tiles in groups of 8 tile rows, so the blocks in flight
// share their A and B panels in L2.  Where the tiles leave SMs idle,
// blockIdx.y splits K.
//
// skinny_kernel, for M <= 16 or N <= 16 (decode rows, the LM head, the
// LoRA products).  Bound by bytes: one read of the large operand.  The
// small operand S (R <= 16 rows: x, or w transposed) sits in shared
// memory for the block's K range; the large operand L is streamed once
// with 16-byte loads, neighbouring threads on neighbouring addresses:
// where L is K-contiguous, a warp walks the K of 1-4 columns and reduces
// across its lanes; where L is column-contiguous, each lane owns 4
// consecutive columns, the 8 warps take every 8th k, and the block adds
// their partials in shared memory in a fixed order.  N <= 16 runs as the
// transposed product C^T = B^T A^T, so x is the streamed operand.
//
// tc16_kernel, bf16 and f16 (T of 2 bytes) for M > 16 and N > 16: the
// 16-bit tensor cores, wgmma m64n128k16 with f32 accumulators (989 TFLOP/s
// dense, against TF32's 495).  Products of two bf16 or f16 values are
// exact in f32, so no split is needed; the second accumulator tile is
// still promoted every 4 slabs of 64 k, since the accumulation truncates
// as K grows.  A's fragments come from its raw slab by ldmatrix.  16-bit
// wgmma also reads an MN-major B (imm-trans-b), so both weight
// orientations are copied straight into wgmma's layout and nothing passes
// over B in shared memory.  The skinny kernel widens the small operand
// into its f32 shared-memory copy and streams the large one in T, half
// the bytes of f32; its 16-byte loads stay packed until their FMAs, and
// below 8 rows a warp walks two columns at once, so a lane keeps as many
// bytes in flight as in f32.  Copies move 16 bytes (8 values) where the
// base and row stride are 16-byte aligned, else 4 (2 values) where they
// are 4-byte aligned, else 2 bytes, one value at a time: cp.async has no
// 2-byte form, so that path loads and stores through registers.  plan()
// picks the width.
//
// Split K writes f32 partial sums to a workspace; reduce_splits adds them
// in split order, so the result does not depend on scheduling, and rounds
// the sum once to T.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC values of T from src to dst; the first `valid` come from src, the
// rest are zeros (valid 0 reads nothing).  16 and 4 bytes go through
// cp.async; 2 bytes (one bf16 or f16 value) through a register, visible to
// the block after the barrier that follows the copy's wait.
template <typename T, int VEC>
__device__ __forceinline__ void cp_async(T* dst, const T* src, int valid) {
  constexpr int BYTES = VEC * static_cast<int>(sizeof(T));
  const int bytes = static_cast<int>(sizeof(T)) * valid;
  if constexpr (BYTES == 16) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else if constexpr (BYTES == 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    static_assert(BYTES == 2, "copies of 16, 4 or 2 bytes");
    const unsigned short v =
        valid > 0 ? *reinterpret_cast<const unsigned short*>(src) : 0;
    *reinterpret_cast<unsigned short*>(dst) = v;
  }
}

// a bf16 or f16 value from its bits
template <typename T>
__device__ __forceinline__ float half_bits(unsigned short b);
template <>
__device__ __forceinline__ float half_bits<__nv_bfloat16>(unsigned short b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
template <>
__device__ __forceinline__ float half_bits<__half>(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}

// the two values of T packed in w, the one at the lower address first
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = half_bits<T>(static_cast<unsigned short>(w & 0xFFFFu));
  hi = half_bits<T>(static_cast<unsigned short>(w >> 16));
}

// one value of T from global memory (read-only path), widened to f32
template <typename T>
__device__ __forceinline__ float ld1(const T* p) {
  if constexpr (sizeof(T) == 4)
    return __ldg(p);
  else
    return half_bits<T>(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// four 8x4 f32 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; lane l gets word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// x = big + small, each a TF32 value rounded to nearest
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// the warp's share of a 128x128 tile: accumulator i is row g (+8 for
// i % 4 >= 2), column 8 * (i / 4) + 2t (+1 for odd i) of the warp's 16
// rows, rounded to OutT (T, or f32 into the split-K workspace)
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           OutT* out, int M, int N, int r0,
                                           int c0, int g, int t) {
  const bool pairs = (N % 2) == 0;    // (c, c+1) is one 8- or 4-byte store
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = r0 + g + 8 * ((i / 2) % 2);
    const int c = c0 + 8 * (i / 4) + 2 * t;
    if (r >= M || c >= N) continue;
    OutT* o = out + (long long)r * N + c;
    if (pairs) {
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
      } else {
        __align__(4) OutT two[2] = {from_f32<OutT>(acc[i]),
                                    from_f32<OutT>(acc[i + 1])};
        *reinterpret_cast<uint32_t*>(o) = *reinterpret_cast<uint32_t*>(two);
      }
    } else {
      o[0] = from_f32<OutT>(acc[i]);
      if (c + 1 < N) o[1] = from_f32<OutT>(acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, NT = 256;
constexpr int PROMOTE = 4;            // slabs summed into `part` at a time
constexpr int GROUP_M = 8;            // tile rows walked together
constexpr int LDK = BK + 4;           // row stride of a K-contiguous tile
constexpr int LDN = BN + 8;           // row stride of an N-contiguous tile
constexpr int A_FLOATS = BM * LDK;
// B's split halves for one slab, each in wgmma's K-major layout without
// swizzle: 8x4 "core matrices" of 128 contiguous bytes (8 n rows of 4 k),
// the two k halves of a k step KHALF_BYTES apart, the 16 groups of 8 n
// NGROUP_BYTES apart, the four k steps STEP_BYTES apart
constexpr int SPLIT_FLOATS = BN * BK;
constexpr int KHALF_BYTES = 128, NGROUP_BYTES = 256, STEP_BYTES = 4096;

template <bool B_KMAJOR>
__host__ __device__ constexpr int stage_floats() {
  return A_FLOATS + (B_KMAJOR ? BN * LDK : BK * LDN);
}

template <bool B_KMAJOR>
__host__ __device__ constexpr int smem_bytes() {
  return (STAGES * stage_floats<B_KMAJOR>() + 4 * SPLIT_FLOATS) * 4;
}

// 128 rows x BK of a K-contiguous operand: element (r, k) at G[r*ld + k]
template <int VEC>
__device__ __forceinline__ void load_k_tile(float* s, const float* G,
                                            long long ld, int r0, int rows,
                                            int k0, int k_end) {
  constexpr int PER_ROW = BK / VEC;
  for (int e = threadIdx.x; e < 128 * PER_ROW; e += NT) {
    const int r = e / PER_ROW, kk = (e % PER_ROW) * VEC;
    const int gr = r0 + r, gk = k0 + kk;
    const int valid = gr < rows ? max(0, min(VEC, k_end - gk)) : 0;
    cp_async<float, VEC>(s + r * LDK + kk,
                  valid > 0 ? G + (long long)gr * ld + gk : G, valid);
  }
}

// BK x BN of B with unit column stride: element (k, n) at B[k*ldb_k + n]
template <int VEC>
__device__ __forceinline__ void load_n_tile(float* s, const float* B,
                                            long long ldb_k, int n0, int N,
                                            int k0, int k_end) {
  constexpr int PER_ROW = BN / VEC;
  for (int e = threadIdx.x; e < BK * PER_ROW; e += NT) {
    const int kk = e / PER_ROW, nn = (e % PER_ROW) * VEC;
    const int gk = k0 + kk, gn = n0 + nn;
    const int valid = gk < k_end ? max(0, min(VEC, N - gn)) : 0;
    cp_async<float, VEC>(s + kk * LDN + nn,
                  valid > 0 ? B + (long long)gk * ldb_k + gn : B, valid);
  }
}

// Split the slab's B tile (raw f32, either layout) into its big and small
// TF32 halves in wgmma's layout.  Each thread takes 4 runs of 4 k for one
// n; neighbouring threads take neighbouring n, so a quarter warp writes
// one whole core matrix.
template <bool B_KMAJOR>
__device__ __forceinline__ void split_b(const float* Bs, float* big,
                                        float* small) {
#pragma unroll
  for (int q = threadIdx.x; q < BN * BK / 4; q += NT) {
    const int n = q % BN, k = (q / BN) * 4;
    float v[4];
    if constexpr (B_KMAJOR) {
      const float4 r = *reinterpret_cast<const float4*>(Bs + n * LDK + k);
      v[0] = r.x;
      v[1] = r.y;
      v[2] = r.z;
      v[3] = r.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = Bs[(k + e) * LDN + n];
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    const int off = ((k / 8) * STEP_BYTES + (n / 8) * NGROUP_BYTES +
                     ((k / 4) % 2) * KHALF_BYTES + (n % 8) * 16) / 4;
    *reinterpret_cast<uint4*>(big + off) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// wgmma's shared-memory matrix descriptor: K-major, no swizzle; the
// leading byte offset is the k-half stride, the stride byte offset the
// 8-row-group stride
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (uint64_t(KHALF_BYTES >> 4) << 16) |
         (uint64_t(NGROUP_BYTES >> 4) << 32);
}

// d(64x128) (+)= a(64x8, registers) @ b(8x128, shared), TF32 in, f32 out;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the fence, commit and wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ldb: B's stride between n (B_KMAJOR) or between k (otherwise)
template <bool B_KMAJOR, int VEC>
__global__ void __launch_bounds__(NT, 1)
tc_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int N, int K, long long lda,
          long long ldb, int k_chunk) {
  extern __shared__ __align__(128) float smem[];
  constexpr int SF = stage_floats<B_KMAJOR>();
  // split B, double-buffered: slab t's halves at split + (t % 2) * 2 *
  // SPLIT_FLOATS, big first
  float* split = smem + STAGES * SF;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int slabs = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_slab = [&](int slab) {
    float* s = smem + (slab % STAGES) * SF;
    const int k0 = k_begin + slab * BK;
    load_k_tile<VEC>(s, A, lda, m0, M, k0, k_end);
    if constexpr (B_KMAJOR)
      load_k_tile<VEC>(s + A_FLOATS, B, ldb, n0, N, k0, k_end);
    else
      load_n_tile<VEC>(s + A_FLOATS, B, ldb, n0, N, k0, k_end);
  };
  auto split_slab = [&](int slab) {
    float* big = split + (slab % 2) * 2 * SPLIT_FLOATS;
    split_b<B_KMAJOR>(smem + (slab % STAGES) * SF + A_FLOATS, big,
                      big + SPLIT_FLOATS);
    // written by every thread, read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // two warpgroups, 64 rows each; a warp's A fragments cover 16 rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix rows: lane l addresses row l % 8 of 8x4 matrix l / 8
  const int lm_row = lane % 8 + ((lane / 8) % 2) * 8;   // rows +8
  const int lm_col = (lane / 16) * 4;                   // k +4
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // The k steps of all slabs stream through the tensor cores: each step's
  // three wgmmas are one group, each of a slab's four steps has its own A
  // registers, and up to four groups are in flight.  After a slab's last
  // step the block splits the next slab's B into the other buffer; the
  // copies of the two slabs after it are in flight meanwhile.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs) load_slab(s);
    cp_async_commit();
  }
  if (slabs > 0) {
    cp_async_wait<STAGES - 2>();      // slab 0 has landed (own copies)
    __syncthreads();                  // everyone's
    split_slab(0);
    __syncthreads();
  }
  uint32_t a_big[4][4], a_small[4][4];
  fence_regs(part);
  for (int slab = 0; slab < slabs; ++slab) {
    const float* As = smem + (slab % STAGES) * SF;
    const float* big = split + (slab % 2) * 2 * SPLIT_FLOATS;
    const int steps = min(BK, k_end - (k_begin + slab * BK) + 7) / 8;
    // PROMOTE slabs sum into `part`, which is then added to `acc` in f32
    if (slab > 0 && slab % PROMOTE == 0) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      fence_regs(part);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < steps) {
        uint32_t r[4];
        ldmatrix_x4(r, As + (wrow + lm_row) * LDK + s * 8 + lm_col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(r[e]), a_big[s][e],
                     a_small[s][e]);
        const uint64_t d_big = b_desc(big + s * (STEP_BYTES / 4));
        const uint64_t d_small =
            b_desc(big + SPLIT_FLOATS + s * (STEP_BYTES / 4));
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_tf32(part, a_small[s], d_big,
                   slab % PROMOTE != 0 || s > 0);
        wgmma_tf32(part, a_big[s], d_small, 1);
        wgmma_tf32(part, a_big[s], d_big, 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // all but the newest 3 groups are done: the A slot of the next
        // step, last used 4 groups back, is free
        asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory");
      }
    }
    if (slab + 1 < slabs) {
      // only this slab's groups may still be in flight, so slab - 1's
      // split buffer and raw stage are free once every thread is here
      cp_async_wait<STAGES - 3>();    // slab + 1 has landed (own copies)
      __syncthreads();                // everyone's
      if (slab + STAGES - 1 < slabs) load_slab(slab + STAGES - 1);
      cp_async_commit();
      split_slab(slab + 1);
      __syncthreads();                // slab + 1's halves are written
    }
  }
  if (slabs > 0) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // accumulator i: row g (+8 for i % 4 >= 2), column 8 * (i / 4) + 2t (+1
  // for odd i) of the warp's 16 rows
  float* out = C + (long long)blockIdx.y * M * N;
  const bool pairs = (N % 2) == 0;    // (c, c+1) is one 8-byte store
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = m0 + wrow + g + 8 * ((i / 2) % 2);
    const int c = n0 + 8 * (i / 4) + 2 * t;
    if (r >= M || c >= N) continue;
    float* o = out + (long long)r * N + c;
    if (pairs) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
    } else {
      o[0] = acc[i];
      if (c + 1 < N) o[1] = acc[i + 1];
    }
  }
}

template <bool B_KMAJOR, int VEC>
cudaError_t launch(const float* A, const float* B, float* C, int M, int N,
                   int K, long long lda, long long ldb, int k_chunk,
                   dim3 grid, cudaStream_t s) {
  static bool configured = false;
  constexpr int bytes = smem_bytes<B_KMAJOR>();
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tc_kernel<B_KMAJOR, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  tc_kernel<B_KMAJOR, VEC><<<grid, NT, bytes, s>>>(A, B, C, M, N, K, lda, ldb,
                                                   k_chunk);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// 16-bit tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc16 {

// bf16 and f16 on the 16-bit tensor cores: wgmma m64n128k16, A (64 rows a
// warpgroup) from registers by ldmatrix, B from shared memory, f32
// accumulators.  Tiles 128x128 per block of two warpgroups, 64 k a slab
// (four k16 steps), a 4-stage cp.async ring.  B needs no pass of its own:
// the copies write it straight into wgmma's layout without swizzle, core
// matrices of 8 rows of 16 bytes (8 values) laid out contiguously.  An
// (out,in) weight is K-major: a core matrix's rows are 8 n, its 16 bytes
// run along k.  An (in,out) weight is MN-major, read transposed by wgmma
// (imm-trans-b): rows are 8 k, the 16 bytes run along n.  In both, the two
// 8-deep k halves of a k16 step sit KHALF_BYTES apart (the descriptor's
// leading byte offset), the 16 groups of 8 n NGROUP_BYTES apart (its
// stride byte offset), the four k16 steps STEP_BYTES apart.  The second
// accumulator tile is promoted every 4 slabs (256 k), as in the f32 kernel.
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, NT = 256;
constexpr int PROMOTE = 4;
constexpr int GROUP_M = 8;
constexpr int LDA = BK + 8;           // A's row stride in values: 144 bytes
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BN * BK;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int KHALF_BYTES = 128, NGROUP_BYTES = 256, STEP_BYTES = 4096;

// where B's (n, k) value of a slab sits, in values
template <bool B_KMAJOR>
__device__ __forceinline__ int b_offset(int n, int k) {
  const int core = (k / 16) * STEP_BYTES + (n / 8) * NGROUP_BYTES +
                   ((k / 8) % 2) * KHALF_BYTES;
  const int in = B_KMAJOR ? (n % 8) * 16 + (k % 8) * 2
                          : (k % 8) * 16 + (n % 8) * 2;
  return (core + in) / 2;
}

// the slab's B: element (k, n) at B[n*ldb + k] (B_KMAJOR) or B[k*ldb + n]
template <typename T, bool B_KMAJOR, int VEC>
__device__ __forceinline__ void load_b(T* s, const T* B, long long ldb,
                                       int n0, int N, int k0, int k_end) {
  if constexpr (B_KMAJOR) {
    constexpr int PER_ROW = BK / VEC;
    for (int e = threadIdx.x; e < BN * PER_ROW; e += NT) {
      const int n = e / PER_ROW, kk = (e % PER_ROW) * VEC;
      const int gn = n0 + n, gk = k0 + kk;
      const int valid = gn < N ? max(0, min(VEC, k_end - gk)) : 0;
      cp_async<T, VEC>(s + b_offset<true>(n, kk),
                       valid > 0 ? B + (long long)gn * ldb + gk : B, valid);
    }
  } else {
    constexpr int PER_ROW = BN / VEC;
    for (int e = threadIdx.x; e < BK * PER_ROW; e += NT) {
      const int kk = e / PER_ROW, n = (e % PER_ROW) * VEC;
      const int gk = k0 + kk, gn = n0 + n;
      const int valid = gk < k_end ? max(0, min(VEC, N - gn)) : 0;
      cp_async<T, VEC>(s + b_offset<false>(n, kk),
                       valid > 0 ? B + (long long)gk * ldb + gn : B, valid);
    }
  }
}

// the slab's A, row-major with row stride LDA: element (r, k) at
// A[r*lda + k]
template <typename T, int VEC>
__device__ __forceinline__ void load_a(T* s, const T* A, long long lda,
                                       int m0, int M, int k0, int k_end) {
  constexpr int PER_ROW = BK / VEC;
  for (int e = threadIdx.x; e < BM * PER_ROW; e += NT) {
    const int r = e / PER_ROW, kk = (e % PER_ROW) * VEC;
    const int gr = m0 + r, gk = k0 + kk;
    const int valid = gr < M ? max(0, min(VEC, k_end - gk)) : 0;
    cp_async<T, VEC>(s + r * LDA + kk,
                     valid > 0 ? A + (long long)gr * lda + gk : A, valid);
  }
}

__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (uint64_t(KHALF_BYTES >> 4) << 16) |
         (uint64_t(NGROUP_BYTES >> 4) << 32);
}

// d(64x128) (+)= a(64x16, registers) @ b(16x128, shared); scale_d 0
// overwrites d; TRANS_B 1 reads an MN-major B
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma16(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
#define SOL_WGMMA16(TYPE)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),  \
        "n"(TRANS_B))
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    SOL_WGMMA16("bf16");
  else
    SOL_WGMMA16("f16");
#undef SOL_WGMMA16
}

// ldb: B's stride between n (B_KMAJOR) or between k (otherwise).  The
// output goes to C in T, or, with a workspace W, as f32 to split
// blockIdx.y of W.
template <typename T, bool B_KMAJOR, int VEC>
__global__ void __launch_bounds__(NT, 1)
tc16_kernel(const T* __restrict__ A, const T* __restrict__ B,
            T* __restrict__ C, float* __restrict__ W, int M, int N, int K,
            long long lda, long long ldb, int k_chunk) {
  extern __shared__ __align__(128) float smem[];
  T* smem16 = reinterpret_cast<T*>(smem);
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int slabs = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_slab = [&](int slab) {
    T* s = smem16 + (slab % STAGES) * STAGE_ELEMS;
    const int k0 = k_begin + slab * BK;
    load_a<T, VEC>(s, A, lda, m0, M, k0, k_end);
    load_b<T, B_KMAJOR, VEC>(s + A_ELEMS, B, ldb, n0, N, k0, k_end);
  };
  // a slab's copies (cp.async or stores: the generic proxy) are made
  // visible to wgmma (the async proxy), then to every thread
  auto landed = [&]() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix: lanes 0-15 address the warp's 16 rows at k, lanes 16-31 the
  // same rows at k + 8; the four 8x8 matrices are the m16k16 fragment
  const int lm_row = lane % 16, lm_col = (lane / 16) * 8;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs) load_slab(s);
    cp_async_commit();
  }
  if (slabs > 0) {
    cp_async_wait<STAGES - 2>();
    landed();
  }
  uint32_t a[4][4];
  tc::fence_regs(part);
  for (int slab = 0; slab < slabs; ++slab) {
    const T* As = smem16 + (slab % STAGES) * STAGE_ELEMS;
    const T* Bs = As + A_ELEMS;
    const int steps = min(BK, k_end - (k_begin + slab * BK) + 15) / 16;
    if (slab > 0 && slab % PROMOTE == 0) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      tc::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      tc::fence_regs(part);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < steps) {
        ldmatrix_x4(a[s], As + (wrow + lm_row) * LDA + s * 16 + lm_col);
        const uint64_t desc = b_desc(Bs + s * (STEP_BYTES / 2));
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma16<T, B_KMAJOR ? 0 : 1>(part, a[s], desc,
                                     slab % PROMOTE != 0 || s > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // all but the newest 3 groups are done: the A registers of the
        // next step, last used 4 groups back, are free
        asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory");
      }
    }
    if (slab + 1 < slabs) {
      // only this slab's groups may still be in flight, so slab - 1's
      // stage is free once every thread is here
      cp_async_wait<STAGES - 3>();
      landed();
      if (slab + STAGES - 1 < slabs) load_slab(slab + STAGES - 1);
      cp_async_commit();
    }
  }
  if (slabs > 0) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tc::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  if (W != nullptr)
    store_tile(acc, W + (long long)blockIdx.y * M * N, M, N, m0 + wrow,
               n0, g, t);
  else
    store_tile(acc, C, M, N, m0 + wrow, n0, g, t);
}

template <typename T, bool B_KMAJOR, int VEC>
cudaError_t launch(const T* A, const T* B, T* C, float* W, int M, int N,
                   int K, long long lda, long long ldb, int k_chunk,
                   dim3 grid, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tc16_kernel<T, B_KMAJOR, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  tc16_kernel<T, B_KMAJOR, VEC><<<grid, NT, SMEM_BYTES, s>>>(
      A, B, C, W, M, N, K, lda, ldb, k_chunk);
  return cudaGetLastError();
}

// vec: values per copy, 8 (16 bytes), 2 (4 bytes) or 1 (2 bytes)
template <typename T, bool B_KMAJOR>
cudaError_t launch_vec(int vec, const T* A, const T* B, T* C, float* W,
                       int M, int N, int K, long long lda, long long ldb,
                       int k_chunk, dim3 grid, cudaStream_t s) {
  switch (vec) {
    case 8: return launch<T, B_KMAJOR, 8>(A, B, C, W, M, N, K, lda, ldb,
                                          k_chunk, grid, s);
    case 2: return launch<T, B_KMAJOR, 2>(A, B, C, W, M, N, K, lda, ldb,
                                          k_chunk, grid, s);
    case 1: return launch<T, B_KMAJOR, 1>(A, B, C, W, M, N, K, lda, ldb,
                                          k_chunk, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc16

// ---------------------------------------------------------------------------
// skinny kernel
// ---------------------------------------------------------------------------

namespace sk {

constexpr int NT = 256, WARPS = 8;
constexpr int UNROLL = 4;             // loads in flight per lane and column
constexpr int S_FLOATS = 8192;        // R x K-range of S: 32 KB at most
constexpr int RED_FLOATS = 4096;      // column-contiguous partials: 16 KB

// S's rows in shared memory are padded to a multiple of KPAD floats, so a
// lane's VEC-wide read of a row stays inside it
template <int VEC>
__host__ __device__ constexpr int kpad() {
  return VEC > 4 ? VEC : 4;
}

// VEC values of T from global memory (read-only path), widened to f32;
// 16-byte loads need a 16-byte-aligned address, 4-byte ones 4
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const T* p) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (sizeof(T) == 2 && VEC == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2<T>(q.x, v[0], v[1]);
    unpack2<T>(q.y, v[2], v[3]);
    unpack2<T>(q.z, v[4], v[5]);
    unpack2<T>(q.w, v[6], v[7]);
  } else if constexpr (sizeof(T) == 2 && VEC == 2) {
    unpack2<T>(__ldg(reinterpret_cast<const unsigned*>(p)), v[0], v[1]);
  } else {
    static_assert(VEC == 1, "loads of 16, 4 or one value");
    v[0] = ld1(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec_shared(float (&v)[VEC],
                                                const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

// A lane's load of VEC values of T as it arrives, widened to f32 at use:
// f32 loads arrive as floats, while 16-byte loads of bf16 or f16 stay
// packed in 4 registers until their FMAs, so a lane keeps as many loads in
// flight in as few registers as f32 does
template <typename T, int VEC>
struct Packed {
  float v[VEC];
  __device__ __forceinline__ void load(const T* p) { load_vec<T, VEC>(v, p); }
  // the first n < VEC values, zeros after
  __device__ __forceinline__ void tail(const T* p, int n) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = e < n ? ld1(p + e) : 0.f;
  }
  __device__ __forceinline__ void widen(float (&out)[VEC]) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = v[e];
  }
};

template <typename T>
struct Packed<T, 8> {
  uint4 q;
  __device__ __forceinline__ void load(const T* p) {
    q = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void tail(const T* p, int n) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
      const uint32_t lo = 2 * e < n ? __ldg(h + 2 * e) : 0u;
      const uint32_t hi = 2 * e + 1 < n ? __ldg(h + 2 * e + 1) : 0u;
      w[e] = lo | (hi << 16);
    }
    q = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void widen(float (&out)[8]) const {
    unpack2<T>(q.x, out[0], out[1]);
    unpack2<T>(q.y, out[2], out[3]);
    unpack2<T>(q.z, out[4], out[5]);
    unpack2<T>(q.w, out[6], out[7]);
  }
};

// columns per warp on K-contiguous L: enough that the R reads of S from
// shared memory per 16-byte load of L stay below L's own rate; a 16-byte
// load of bf16 or f16 (VEC 8) covers half the K of f32's, so below 8 rows
// a warp walks two columns at once to keep as many bytes in flight
template <int R, int VEC>
__host__ __device__ constexpr int cols_per_warp() {
  return R >= 16 ? 4 : (R >= 8 || VEC > 4 ? 2 : 1);
}

// S element (r, k) at S[r*ls_r + k*ls_k], `rows` of R real; L element
// (c, k) at L[c*ll_c + k*ll_k] with ll_k == 1 (L_KMAJOR) or ll_c == 1;
// out (r, c) at O[r*lo_r + c*lo_c] in T, or, with a workspace W, as f32 at
// W[blockIdx.y * split_stride + r*lo_r + c*lo_c]
template <typename T, int R, int VEC, bool L_KMAJOR>
__global__ void __launch_bounds__(NT)
skinny_kernel(const T* __restrict__ S, long long ls_r, long long ls_k,
              int rows, const T* __restrict__ L, long long ll_c,
              long long ll_k, int cols, T* __restrict__ O,
              float* __restrict__ W, long long lo_r, long long lo_c,
              long long split_stride, int K, int k_chunk, int kc_stride) {
  extern __shared__ __align__(128) float smem[];
  constexpr int KP = kpad<VEC>();
  const int k_begin = blockIdx.y * k_chunk;
  const int kc = max(0, min(K, k_begin + k_chunk) - k_begin);
  const int kcp = (kc + KP - 1) & ~(KP - 1);  // row stride of S in shared
  float* Ss = smem;                   // [R][kcp], widened to f32
  if (ls_k == 1) {                    // walk S in its own memory order
#pragma unroll 8
    for (int e = threadIdx.x; e < R * kcp; e += NT) {
      const int r = e / kcp, kk = e % kcp;
      Ss[e] = (r < rows && kk < kc) ? to_f32(S[r * ls_r + (k_begin + kk)])
                                    : 0.f;
    }
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < R * kcp; e += NT) {
      const int kk = e / R, r = e % R;
      Ss[r * kcp + kk] =
          (r < rows && kk < kc)
              ? to_f32(S[r * ls_r + (long long)(k_begin + kk) * ls_k])
              : 0.f;
    }
  }
  __syncthreads();
  if (W != nullptr) W += blockIdx.y * split_stride;
  auto put = [&](long long at, float val) {
    if (W != nullptr)
      W[at] = val;
    else
      O[at] = from_f32<T>(val);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if constexpr (L_KMAJOR) {
    constexpr int CPW = cols_per_warp<R, VEC>();
    constexpr int STEP = 32 * VEC;    // K a warp reads per load
    const int groups = (cols + WARPS * CPW - 1) / (WARPS * CPW);
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      const int c0 = (grp * WARPS + warp) * CPW;
      const T* lp[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c)   // a column past the end re-reads the
        lp[c] = L + (long long)min(c0 + c, cols - 1) * ll_c + k_begin;
      float acc[R][CPW];              // last one and is not stored
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CPW; ++c) acc[r][c] = 0.f;
      // KU steps at a time, every load issued before the first use (past
      // the end: zeros, and no use), so each lane keeps KU * CPW = 16 loads
      // in flight: 64 registers for 16-byte loads, 32 for 4-byte loads of
      // bf16 or f16, 16 for single values
      constexpr int KU = 16 / CPW;
      for (int kk = VEC * lane; kk < kc; kk += KU * STEP) {
        Packed<T, VEC> w[KU][CPW];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = kk + u * STEP;
#pragma unroll
          for (int c = 0; c < CPW; ++c) {
            if (k + VEC <= kc)
              w[u][c].load(lp[c] + k);
            else                      // K's tail
              w[u][c].tail(lp[c] + k, max(0, kc - k));
          }
        }
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = kk + u * STEP;
          if (k >= kc) break;         // S is zero-padded to kcp only
          float wv[CPW][VEC];
#pragma unroll
          for (int c = 0; c < CPW; ++c) w[u][c].widen(wv[c]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float sv[VEC];
            load_vec_shared<VEC>(sv, Ss + r * kcp + k);
#pragma unroll
            for (int c = 0; c < CPW; ++c)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[r][c] += sv[e] * wv[c][e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CPW; ++c)
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          if (c0 + c >= cols) break;
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < rows) put(r * lo_r + (long long)(c0 + c) * lo_c, acc[r][c]);
        }
      }
    }
  } else {
    constexpr int WIDTH = 32 * VEC;                 // columns per group
    constexpr int RCH = (RED_FLOATS / (WARPS * WIDTH)) < R
                            ? RED_FLOATS / (WARPS * WIDTH) : R;
    static_assert(RCH >= 1, "the partials of one row fit the buffer");
    float* red = smem + R * kc_stride;              // [WARPS][RCH][WIDTH]
    const int groups = (cols + WIDTH - 1) / WIDTH;
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      const int c = grp * WIDTH + lane * VEC;
      const bool whole = c + VEC <= cols;           // else N's tail
      float acc[R][VEC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
      // UNROLL rows of L at a time (every 8th, this warp's), loads first
      int kk = warp;
      for (; kk + (UNROLL - 1) * WARPS < kc; kk += UNROLL * WARPS) {
        float w[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const T* p = L + (long long)(k_begin + kk + u * WARPS) * ll_k + c;
          if (whole) {
            load_vec<T, VEC>(w[u], p);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) w[u][e] = c + e < cols ? ld1(p + e) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float sv = Ss[r * kcp + kk + u * WARPS];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] += sv * w[u][e];
          }
      }
      for (; kk < kc; kk += WARPS) {
        const T* p = L + (long long)(k_begin + kk) * ll_k + c;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float w = c + e < cols ? ld1(p + e) : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][e] += Ss[r * kcp + kk] * w;
        }
      }
      // the 8 warps' partials, added in warp order, RCH rows at a time
#pragma unroll
      for (int r0 = 0; r0 < R; r0 += RCH) {
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < RCH; ++rr)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            red[(warp * RCH + rr) * WIDTH + lane * VEC + e] = acc[r0 + rr][e];
        __syncthreads();
        for (int i = threadIdx.x; i < RCH * WIDTH; i += NT) {
          const int rr = i / WIDTH, cc = i % WIDTH;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += red[(w * RCH + rr) * WIDTH + cc];
          const int r = r0 + rr, col = grp * WIDTH + cc;
          if (r < rows && col < cols) put(r * lo_r + (long long)col * lo_c, sum);
        }
      }
    }
  }
}

template <typename T, int R, int VEC, bool L_KMAJOR>
cudaError_t launch(const T* S, long long ls_r, long long ls_k, int rows,
                   const T* L, long long ll_c, long long ll_k, int cols,
                   T* O, float* W, long long lo_r, long long lo_c,
                   long long split_stride, int K, int k_chunk, dim3 grid,
                   cudaStream_t s) {
  constexpr int KP = kpad<VEC>();
  const int kc_stride = ((K < k_chunk ? K : k_chunk) + KP - 1) & ~(KP - 1);
  if (R * kc_stride > S_FLOATS) return cudaErrorInvalidValue;
  const int floats = R * kc_stride + (L_KMAJOR ? 0 : RED_FLOATS);
  skinny_kernel<T, R, VEC, L_KMAJOR><<<grid, NT, floats * 4, s>>>(
      S, ls_r, ls_k, rows, L, ll_c, ll_k, cols, O, W, lo_r, lo_c,
      split_stride, K, k_chunk, kc_stride);
  return cudaGetLastError();
}

// vec: values of T per load, as for the tensor-core kernel
template <typename T, int R>
cudaError_t launch_r(int vec, int l_kmajor, const T* S, long long ls_r,
                     long long ls_k, int rows, const T* L, long long ll_c,
                     long long ll_k, int cols, T* O, float* W,
                     long long lo_r, long long lo_c, long long split_stride,
                     int K, int k_chunk, dim3 grid, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T), V4 = 4 / sizeof(T);
#define SOL_SKINNY(V, KM)                                                  \
  return launch<T, R, V, KM>(S, ls_r, ls_k, rows, L, ll_c, ll_k, cols, O,  \
                             W, lo_r, lo_c, split_stride, K, k_chunk, grid, \
                             s)
  if (vec == V16) {
    if (l_kmajor) SOL_SKINNY(V16, true);
    SOL_SKINNY(V16, false);
  }
  if (vec == V4) {
    if (l_kmajor) SOL_SKINNY(V4, true);
    SOL_SKINNY(V4, false);
  }
  if constexpr (sizeof(T) == 2) {
    if (vec == 1) {
      if (l_kmajor) SOL_SKINNY(1, true);
      SOL_SKINNY(1, false);
    }
  }
#undef SOL_SKINNY
  return cudaErrorInvalidValue;
}

}  // namespace sk

// C = sum over the split-K partials, added in split order (deterministic)
// and rounded once to T
template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws,
                              T* __restrict__ C, long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    C[i] = from_f32<T>(s);
  }
}

template <typename T>
cudaError_t reduce(const float* ws, T* C, long long mn, int splits,
                   cudaStream_t s) {
  const long long want = (mn + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_splits<T><<<blocks, 256, 0, s>>>(ws, C, mn, splits);
  return cudaGetLastError();
}

// Tensor-core product.  ldb is B's stride between n where b_kmajor (an
// (out,in) weight), else between k.  grid_x must be the number of 128x128
// output tiles; splits > 1 splits K in chunks of k_chunk (a multiple of
// the kernel's slab, 32 for f32 and 64 for bf16 and f16) and needs an f32
// workspace of splits*M*N.  vec is the values of T per copy: 16 bytes need
// A, B and their row strides 16-byte aligned, 4 bytes 4-byte aligned.
template <typename T>
int matmul_tc(const T* A, const T* B, T* C, float* workspace, int M, int N,
              int K, long long lda, long long ldb, int b_kmajor, int vec,
              int splits, int k_chunk, int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  constexpr int SLAB = sizeof(T) == 4 ? tc::BK : tc16::BK;
  if (splits < 1 || k_chunk % SLAB != 0 || (splits > 1 && !workspace))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, splits);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    float* target = splits > 1 ? workspace : C;
    if (b_kmajor)
      err = vec == 4 ? tc::launch<true, 4>(A, B, target, M, N, K, lda, ldb,
                                           k_chunk, grid, s)
                     : tc::launch<true, 1>(A, B, target, M, N, K, lda, ldb,
                                           k_chunk, grid, s);
    else
      err = vec == 4 ? tc::launch<false, 4>(A, B, target, M, N, K, lda, ldb,
                                            k_chunk, grid, s)
                     : tc::launch<false, 1>(A, B, target, M, N, K, lda, ldb,
                                            k_chunk, grid, s);
  } else {
    float* W = splits > 1 ? workspace : nullptr;
    err = b_kmajor ? tc16::launch_vec<T, true>(vec, A, B, C, W, M, N, K, lda,
                                               ldb, k_chunk, grid, s)
                   : tc16::launch_vec<T, false>(vec, A, B, C, W, M, N, K,
                                                lda, ldb, k_chunk, grid, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce<T>(workspace, C, (long long)M * N, splits,
                                    s));
}

// Skinny product, C (M,N) contiguous.  S (R_pad >= rows rows, R_pad in
// {1,2,4,8,16}) is held in shared memory, L streamed; out (r, c) at
// C[r*lo_r + c*lo_c].  Each block takes K range blockIdx.y*k_chunk (a
// multiple of 8, R_pad*k_chunk <= 8192) and walks column groups from
// blockIdx.x by grid_x.  splits > 1 needs an f32 workspace of splits*M*N.
template <typename T>
int matmul_skinny(const T* S, long long ls_r, long long ls_k, int rows,
                  const T* L, long long ll_c, long long ll_k, int cols, T* C,
                  float* workspace, long long lo_r, long long lo_c, int M,
                  int N, int K, int r_pad, int vec, int l_kmajor, int splits,
                  int k_chunk, int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || k_chunk < 1 || k_chunk % 8 != 0 || rows > r_pad ||
      (splits > 1 && !workspace))
    return static_cast<int>(cudaErrorInvalidValue);
  float* W = splits > 1 ? workspace : nullptr;
  const long long stride = splits > 1 ? (long long)M * N : 0;
  const dim3 grid(grid_x, splits);
  cudaError_t err;
#define SOL_R(RP)                                                          \
  sk::launch_r<T, RP>(vec, l_kmajor, S, ls_r, ls_k, rows, L, ll_c, ll_k,   \
                      cols, C, W, lo_r, lo_c, stride, K, k_chunk, grid, s)
  switch (r_pad) {
    case 1: err = SOL_R(1); break;
    case 2: err = SOL_R(2); break;
    case 4: err = SOL_R(4); break;
    case 8: err = SOL_R(8); break;
    case 16: err = SOL_R(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SOL_R
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce<T>(workspace, C, (long long)M * N, splits,
                                    s));
}

}  // namespace

// sol_matmul_tc_f32, _bf16 and _f16, and sol_matmul_skinny_<type>: A, B
// (S, L) and C in that type, the workspace f32
#define SOL_MATMUL(T, SUFFIX)                                                \
  SOL_EXPORT int sol_matmul_tc_##SUFFIX(                                     \
      const T* A, const T* B, T* C, float* workspace, int M, int N, int K,   \
      long long lda, long long ldb, int b_kmajor, int vec, int splits,       \
      int k_chunk, int grid_x, void* stream) {                               \
    return matmul_tc<T>(A, B, C, workspace, M, N, K, lda, ldb, b_kmajor,     \
                        vec, splits, k_chunk, grid_x, stream);               \
  }                                                                          \
  SOL_EXPORT int sol_matmul_skinny_##SUFFIX(                                 \
      const T* S, long long ls_r, long long ls_k, int rows, const T* L,      \
      long long ll_c, long long ll_k, int cols, T* C, float* workspace,      \
      long long lo_r, long long lo_c, int M, int N, int K, int r_pad,        \
      int vec, int l_kmajor, int splits, int k_chunk, int grid_x,            \
      void* stream) {                                                        \
    return matmul_skinny<T>(S, ls_r, ls_k, rows, L, ll_c, ll_k, cols, C,     \
                            workspace, lo_r, lo_c, M, N, K, r_pad, vec,      \
                            l_kmajor, splits, k_chunk, grid_x, stream);      \
  }
SOL_FOR_EACH_DTYPE(SOL_MATMUL)
#undef SOL_MATMUL
