// f32 tiled GEMM for Hopper, SIMT (CUDA cores).
//
// Replaces: src/repro/kernels/matmul/kernel.py, matmul_call (the Pallas
// MXU matmul behind pallas.linear_mxu and pallas.matmul_mxu).
//
// Computes C(M,N) = A(M,K) @ B(K,N) in f32 with an f32 accumulator.  A is
// row-major with row stride lda.  B is read through two strides (ldb_k,
// ldb_n), so a Linear weight stored (out,in) = (N,K) is read in place as
// its transpose: the 233 M-float LM head is never copied per call.  Ragged
// edges are masked (zero-filled tiles in shared memory, masked stores)
// instead of padded copies.
//
// What bounds it on this card: at serving shapes M = B*S <= 1024 and
// K in {1536, 6144} the product is compute-bound for f32 outside the
// tensor cores (67 TFLOP/s peak); at decode, M = 1..4, it is bound by
// reading B once (3.35 TB/s).  The FMA path keeps f32 parity with the
// reference (the tensor cores would run f32 as TF32, ~1e-3 relative).
//
// Design: 64x64 output tiles, 256 threads each computing 4x4 outputs from
// 16-deep slabs of A (stored transposed) and B in shared memory.  Small M
// (decode, M <= 16) uses 16x64 tiles, so a row tile wastes at most 15 of
// 16 rows instead of 63 of 64 (rows >= M are never loaded, they are zeros
// in shared memory), and splits K across gridDim.z when the N tiles alone
// would leave SMs idle; the partial sums go to a workspace and a second,
// deterministic kernel adds them in a fixed order.  wgmma, TMA and a
// pipelined ring of stages are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;   // threads per block: 16 x 16

template <int BM>
__global__ void __launch_bounds__(NT)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K, long long lda,
             long long ldb_k, long long ldb_n, int k_chunk) {
  constexpr int TM = BM / 16;                 // rows per thread
  constexpr int TN = BN / 16;                 // cols per thread
  __shared__ float As[BK][BM + 4];            // transposed A slab
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // A slab (BM x BK): consecutive threads walk k, A's contiguous dim
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      const int kk = e % BK, mm = e / BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < k_end) ? A[(long long)gm * lda + gk] : 0.f;
    }
    // B slab (BK x BN): consecutive threads walk B's contiguous dim
    if (ldb_n == 1) {
#pragma unroll
      for (int e = tid; e < BK * BN; e += NT) {
        const int nn = e % BN, kk = e / BN;
        const int gn = n0 + nn, gk = k0 + kk;
        Bs[kk][nn] = (gn < N && gk < k_end)
                         ? B[(long long)gk * ldb_k + gn] : 0.f;
      }
    } else {
#pragma unroll
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e % BK, nn = e / BK;
        const int gn = n0 + nn, gk = k0 + kk;
        Bs[kk][nn] = (gn < N && gk < k_end)
                         ? B[(long long)gk * ldb_k + (long long)gn * ldb_n]
                         : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = C + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

// C = sum over the split-K partials, added in split order (deterministic)
__global__ void reduce_splits(const float* __restrict__ ws,
                              float* __restrict__ C, long long mn,
                              int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    C[i] = s;
  }
}

}  // namespace

// A (M,K) row stride lda; B element (k,n) at B[k*ldb_k + n*ldb_n]; C (M,N)
// contiguous.  splits > 1 needs a workspace of splits*M*N floats.
SOL_EXPORT int sol_matmul_f32(const float* A, const float* B, float* C,
                              float* workspace, int M, int N, int K,
                              long long lda, long long ldb_k,
                              long long ldb_n, int splits, int small_m,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1) splits = 1;
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  splits = K > 0 ? (K + k_chunk - 1) / k_chunk : 1;
  float* target = splits > 1 ? workspace : C;
  if (small_m) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    sgemm_kernel<16><<<grid, NT, 0, s>>>(A, B, target, M, N, K, lda, ldb_k,
                                         ldb_n, k_chunk);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    sgemm_kernel<64><<<grid, NT, 0, s>>>(A, B, target, M, N, K, lda, ldb_k,
                                         ldb_n, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  reduce_splits<<<blocks, 256, 0, s>>>(workspace, C, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
