// C = A^T B for Hopper (sm_90a): the paper's METG benchmark task (§3).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` in
// src/repro/kernels/tiled_matmul/kernel.py (launched by
// `tiled_matmul_pallas`), and computes what it computes:
//   C[m][n] = sum_k A[k][m] B[k][n]
// with A (K, M) and B (K, N) both read with k as the leading (row) dimension,
// all of one type T (float or bf16) and contiguous; the sum is held in fp32
// registers and C (M, N) is written once, cast to T.  Ragged edges in M, N
// and K are masked, so no block size has to divide the shape (the Pallas
// assert on divisibility is a TPU tiling constraint and is not carried over).
//
// What bounds it on an H100 SXM: 2 K M N FLOPs against (K M + K N + M N)
// elements moved.  In fp32 the FLOPs run at the non-tensor fp32 rate, 67
// TFLOP/s (H100 data sheet); at the METG ladder's square n = 4096 that is
// 1.37e11 FLOP = 2.05 ms against 201 MB = 0.060 ms at 3.35 TB/s, so it is
// bound by operations at every size of the ladder (n = 256: 0.5 us against
// 0.23 us).  In bf16 the bound is the dense tensor-core rate, 989 TFLOP/s.
// What the design does about it: this first version does its FLOPs as plain
// fp32 FMAs on the CUDA cores in both types (no TF32, no tensor cores; the
// JAX reference is exact fp32 and the paper's workload is single precision):
//   * one block of 256 threads per 64 x 64 tile of C, each thread holding a
//     4 x 4 sub-tile of fp32 accumulators in registers, so one shared-memory
//     load feeds 4 FMAs;
//   * a loop over k in slices of 16 stages A[k0:k0+16, m0:m0+64] and
//     B[k0:k0+16, n0:n0+64] in shared memory as fp32; a row of either is
//     contiguous in device memory (A's layout is already the one A^T wants),
//     so neighbouring threads load neighbouring elements and no transpose is
//     needed; out-of-range elements are staged as 0;
//   * like the Pallas kernel's per-block dot added to its VMEM accumulator,
//     each k-slice is summed into a partial tile that is then added to the
//     accumulator, which keeps the fp32 rounding of long sums down.
// Tensor cores (wgmma) for bf16, cp.async/TMA double buffering, larger
// register tiles for fp32 and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;   // C tile and k-slice
constexpr int TM = 4, TN = 4;              // per-thread sub-tile of C
constexpr int NTHREADS = (BM / TM) * (BN / TN);
static_assert(NTHREADS == 256, "16 x 16 threads");
static_assert((BK * BM) % NTHREADS == 0 && (BK * BN) % NTHREADS == 0, "");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// Stage rows k0..k0+BK-1, columns c0..c0+W-1 of the (K, cols) matrix X into
// s[BK][W] as fp32; neighbouring threads take neighbouring columns.
template <typename T, int W>
__device__ __forceinline__ void stage(float (*s)[W], const T* __restrict__ X,
                                      int k0, int c0, int K, int cols) {
#pragma unroll
  for (int i = 0; i < BK * W / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int kk = idx / W, cc = idx % W;
    const int k = k0 + kk, c = c0 + cc;
    s[kk][cc] = (k < K && c < cols)
                    ? to_f(X[static_cast<size_t>(k) * cols + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
matmul_tn(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
          int K, int M, int N) {
  __shared__ __align__(16) float sA[BK][BM];
  __shared__ __align__(16) float sB[BK][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<T, BM>(sA, A, k0, m0, K, M);
    stage<T, BN>(sB, B, k0, n0, K, N);
    __syncthreads();
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // A's 4 rows are one warp-wide broadcast, B's 4 columns 16 bytes a lane
      const float4 a4 = *reinterpret_cast<const float4*>(&sA[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sB[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();   // every thread has read this slice
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) C[static_cast<size_t>(m) * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int K, int M, int N,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_tn<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      K, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for A, B and C.  K >= 0, M and N > 0,
// ceil(M / 64) <= 65535.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tiled_matmul_tn(const void* a, const void* b, void* c,
                               int dtype, int K, int M, int N, void* stream) {
  if (K < 0 || M <= 0 || N <= 0 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, K, M, N, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, K, M, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
