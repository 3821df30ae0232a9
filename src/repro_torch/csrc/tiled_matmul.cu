// C = A^T B for Hopper (sm_90a): the paper's METG benchmark task (§3).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` in
// src/repro/kernels/tiled_matmul/kernel.py (launched by
// `tiled_matmul_pallas`), and computes what it computes:
//   C[m][n] = sum_k A[k][m] B[k][n]
// with A (K, M) and B (K, N) both read with k as the leading (row) dimension,
// all of one type T (float or bf16) and contiguous; the sum is held in fp32
// registers and C (M, N) is written once, cast to T (bf16: round to nearest
// even).  Ragged edges in M, N and K are masked, so no block size has to
// divide the shape (the Pallas assert on divisibility is a TPU tiling
// constraint and is not carried over).
//
// What bounds it on an H100 SXM: 2 K M N FLOPs against (K M + K N + M N)
// elements moved, far above the card's FLOP/byte ridge once n >= 1024, so
// operations: in fp32 at the non-tensor fp32 rate, 67 TFLOP/s (n = 4096:
// 2.05 ms), in bf16 at the dense tensor-core rate, 989 TFLOP/s (0.139 ms).
// Two kernels, one launch each; `make_plan` picks one, with its tiling,
// from the type, shape and alignment (kernels/tiled_matmul/kernel.py `plan`
// states the same choice in Python):
//
//   * fp32 (the METG ladder's type) stays exact fp32 FMAs on the CUDA cores:
//     the JAX reference is exact fp32 and TF32 would lose ~3 digits.  A
//     block of 256 threads owns a BM x BN tile of C; each thread an 8 x 8
//     (or 4 x 4) sub-tile of fp32 accumulators fed by float4 shared-memory
//     reads.  k moves in stages of 16 rows of A and B, copied by cp.async
//     into a ring of 4 shared-memory stages, so three stages load while one
//     is summed.  Small products would leave most of the 132 SMs idle, so
//     the tile shrinks with the shape (128^2, 64^2, 32^2: the largest whose
//     grid has >= 132 blocks) and the small tiles split each stage's rows
//     over 4 groups of threads (in-block split-K) whose partial tiles are
//     added in shared memory in a fixed order: one launch, deterministic,
//     no atomics.
//   * bf16 runs on the tensor cores: `wgmma` m64n128k16, bf16 products
//     exact in fp32, fp32 accumulation.  A block of two warpgroups owns a
//     128 x 128 tile of C (64 rows each); k moves in stages of 64 rows
//     through a ring of 4 stages, two loading while the `wgmma`s of the
//     last one drain and the next one's issue.  A (K, M) and B (K, N) both
//     have their output dim contiguous, so both are MN-major operands
//     (transpose bits set) and land in shared memory as they lie in global
//     memory, in 64-wide swizzled panels (sm90.cuh).  The compute threads
//     issue the copies and the whole block meets at a barrier every stage,
//     which is what holds this version below the tensor-core rate.
//
// Staging: 16-byte cp.async where every row start is 16-byte aligned (M and
// N multiples of 16 bytes' worth of elements, 16-byte-aligned bases), with
// zero fill past the edges; otherwise 4-byte cp.async (one fp32, or a pair
// of bf16 where M and N are even); otherwise (bf16 with an odd M or N, whose
// rows start on 2-byte boundaries, which no async copy takes) the threads
// load elements and store them to shared memory.  Every shape launches one
// of these kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int STAGES = 4;
constexpr int MIN_BLOCKS = 132;   // SMs of an H100 SXM

enum Staging { VEC16 = 0, ASYNC4 = 1, ELEM = 2 };

// The number of k-stages of `depth` rows.
__host__ __device__ __forceinline__ int k_slices(int K, int depth) {
  return (K + depth - 1) / depth;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);   // operands as stored
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// ---------------------------------------------------------------- fp32 --

// Tile configurations of the fp32 kernel, largest first.
struct F32Config { int bm, bn, tm, tn, ksplit; };
constexpr F32Config F32_CONFIGS[3] = {
    {128, 128, 8, 8, 1}, {64, 64, 8, 8, 4}, {32, 32, 4, 4, 4}};
constexpr int F32_KS = 16;   // k rows per stage (split over the groups)

template <int BM, int BN, int TM, int TN, int KSPLIT>
struct F32Tile {
  static constexpr int GT = (BM / TM) * (BN / TN);   // threads per group
  static_assert(GT * KSPLIT == NTHREADS, "256 threads");
  static constexpr int KG = F32_KS / KSPLIT;         // rows per group
  static constexpr int RING = STAGES * F32_KS * (BM + BN);   // floats
  static constexpr int RED = (KSPLIT - 1) * BM * BN;         // floats
  static constexpr size_t SMEM =
      sizeof(float) * static_cast<size_t>(RING > RED ? RING : RED);
};

// Rows k0 .. k0+F32_KS-1, columns c0 .. c0+W-1 of the (K, cols) matrix X
// into s[F32_KS][W], zero past the edges.
template <int W, int ST>
__device__ __forceinline__ void f32_stage(float* s, const float* X, int k0,
                                          int c0, int K, int cols) {
  if constexpr (ST == VEC16) {
    constexpr int CHUNKS = F32_KS * W / 4;
#pragma unroll
    for (int i = threadIdx.x; i < CHUNKS; i += NTHREADS) {
      const int kk = i / (W / 4), cc = (i % (W / 4)) * 4;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < K && c < cols;
      sm90::cp_async16(s + kk * W + cc,
                       ok ? X + static_cast<size_t>(k) * cols + c : X, ok);
    }
  } else {
    constexpr int ELEMS = F32_KS * W;
#pragma unroll
    for (int i = threadIdx.x; i < ELEMS; i += NTHREADS) {
      const int kk = i / W, cc = i % W;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < K && c < cols;
      sm90::cp_async4(s + kk * W + cc,
                      ok ? X + static_cast<size_t>(k) * cols + c : X, ok);
    }
  }
}

template <int BM, int BN, int TM, int TN, int KSPLIT, int ST>
__global__ void __launch_bounds__(NTHREADS)
f32_tn(const float* __restrict__ A, const float* __restrict__ B,
       float* __restrict__ C, int K, int M, int N) {
  using Tl = F32Tile<BM, BN, TM, TN, KSPLIT>;
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);          // [STAGES][KS][BM]
  float* sB = sA + STAGES * F32_KS * BM;                 // [STAGES][KS][BN]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int grp = threadIdx.x / Tl::GT, tt = threadIdx.x % Tl::GT;
  const int tx = tt % (BN / TN), ty = tt / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = k_slices(K, F32_KS);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      f32_stage<BM, ST>(sA + s * F32_KS * BM, A, s * F32_KS, m0, K, M);
      f32_stage<BN, ST>(sB + s * F32_KS * BN, B, s * F32_KS, n0, K, N);
    }
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<STAGES - 2>();   // stage kt has landed
    __syncthreads();                     // ... for every thread, and all
                                         // are done with stage kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int s = nxt % STAGES;
      f32_stage<BM, ST>(sA + s * F32_KS * BM, A, nxt * F32_KS, m0, K, M);
      f32_stage<BN, ST>(sB + s * F32_KS * BN, B, nxt * F32_KS, n0, K, N);
    }
    sm90::cp_async_commit();
    const float* a_s = sA + (kt % STAGES) * F32_KS * BM + grp * Tl::KG * BM;
    const float* b_s = sB + (kt % STAGES) * F32_KS * BN + grp * Tl::KG * BN;
#pragma unroll
    for (int kk = 0; kk < Tl::KG; ++kk) {
      // thread rows c * (BM / (TM/4)) + 4 ty + e: for 8 x 8, two groups of
      // 4 half a tile apart, so a warp's float4 reads of B hit distinct
      // 16-byte columns and those of A are broadcasts
      float a[TM], b[TN];
#pragma unroll
      for (int c = 0; c < TM / 4; ++c) {
        const float4 v = lds4(a_s + kk * BM + c * (BM * 4 / TM) + ty * 4);
        a[4 * c] = v.x; a[4 * c + 1] = v.y; a[4 * c + 2] = v.z;
        a[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const float4 v = lds4(b_s + kk * BN + c * (BN * 4 / TN) + tx * 4);
        b[4 * c] = v.x; b[4 * c + 1] = v.y; b[4 * c + 2] = v.z;
        b[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // end of the k-slice
  }

  if constexpr (KSPLIT > 1) {
    // groups 1.. leave their partial tiles in shared memory (over the
    // ring, now idle); group 0 adds them in group order
    sm90::cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem4);
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          red[((grp - 1) * TM * TN + i * TN + j) * Tl::GT + tt] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int g = 1; g < KSPLIT; ++g)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += red[((g - 1) * TM * TN + i * TN + j) * Tl::GT + tt];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM * 4 / TM) + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * (BN * 4 / TN) + tx * 4 + j % 4;
      if (n < N) C[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- bf16 --

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64;
// per stage: A and B each two 64-wide panels of TC_BK rows of 128 bytes
constexpr int TC_PANEL = TC_BK * 128;                 // bytes
constexpr int TC_STAGE = 4 * TC_PANEL;                // A, then B
constexpr size_t TC_SMEM = STAGES * TC_STAGE + 1024;  // + alignment slack

// Rows k0 .. k0+TC_BK-1, columns c0 .. c0+127 of the (K, cols) bf16 matrix
// X into two swizzled panels at `s`, zero past the edges.
template <int ST>
__device__ __forceinline__ void tc_stage(uint8_t* s,
                                         const __nv_bfloat16* X, int k0,
                                         int c0, int K, int cols) {
  if constexpr (ST == VEC16) {
    // 64 rows x 16 chunks of 8 elements
#pragma unroll
    for (int i = threadIdx.x; i < TC_BK * 16; i += NTHREADS) {
      const int kk = i / 16, ch = i % 16;
      const int k = k0 + kk, c = c0 + ch * 8;
      const bool ok = k < K && c < cols;
      sm90::cp_async16(s + (ch / 8) * TC_PANEL + sm90::swizzled(kk, ch % 8),
                       ok ? X + static_cast<size_t>(k) * cols + c : X, ok);
    }
  } else if constexpr (ST == ASYNC4) {
    // 64 rows x 64 pairs of elements; cols is even, so a pair is wholly
    // inside or wholly past the edge
#pragma unroll
    for (int i = threadIdx.x; i < TC_BK * TC_BM / 2; i += NTHREADS) {
      const int kk = i / (TC_BM / 2), cc = (i % (TC_BM / 2)) * 2;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < K && c < cols;
      sm90::cp_async4(s + (cc / 64) * TC_PANEL
                          + sm90::swizzled(kk, (cc % 64) / 8) + (cc % 8) * 2,
                      ok ? X + static_cast<size_t>(k) * cols + c : X, ok);
    }
  } else {
    // a thread's column is fixed (NTHREADS is a multiple of TC_BM); its
    // rows go 8 loads at a time, issued before they are stored, so their
    // latencies overlap
    constexpr int ROWS = NTHREADS / TC_BM, BATCH = 8;
    const int cc = threadIdx.x % TC_BM, c = c0 + cc;
    uint8_t* col = s + (cc / 64) * TC_PANEL + (cc % 8) * 2;
#pragma unroll 1
    for (int kk0 = threadIdx.x / TC_BM; kk0 < TC_BK; kk0 += ROWS * BATCH) {
      __nv_bfloat16 v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int k = k0 + kk0 + j * ROWS;
        v[j] = (k < K && c < cols) ? X[static_cast<size_t>(k) * cols + c]
                                   : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int kk = kk0 + j * ROWS;
        *reinterpret_cast<__nv_bfloat16*>(
            col + sm90::swizzled(kk, (cc % 64) / 8)) = v[j];
      }
    }
  }
}

template <int ST>
__global__ void __launch_bounds__(NTHREADS)
bf16_tn(const __nv_bfloat16* __restrict__ A,
        const __nv_bfloat16* __restrict__ B, __nv_bfloat16* __restrict__ C,
        int K, int M, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int wg = threadIdx.x / 128;          // rows 64 wg .. 64 wg + 63
  const int t = threadIdx.x % 128;

  float acc[TC_BN / 2];
#pragma unroll
  for (int i = 0; i < TC_BN / 2; ++i) acc[i] = 0.f;

  const int nk = k_slices(K, TC_BK);
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) {
      tc_stage<ST>(smem + s * TC_STAGE, A, s * TC_BK, m0, K, M);
      tc_stage<ST>(smem + s * TC_STAGE + 2 * TC_PANEL, B, s * TC_BK, n0, K,
                   N);
    }
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<STAGES - 3>();   // stage kt has landed
    sm90::fence_proxy_async();
    __syncthreads();   // ... for every thread; every wgmma of stage kt - 2
                       // is done (each thread waited for it below)
    const int nxt = kt + STAGES - 2;
    if (nxt < nk) {
      uint8_t* s = smem + (nxt % STAGES) * TC_STAGE;
      tc_stage<ST>(s, A, nxt * TC_BK, m0, K, M);
      tc_stage<ST>(s + 2 * TC_PANEL, B, nxt * TC_BK, n0, K, N);
    }
    sm90::cp_async_commit();
    const uint8_t* sa = smem + (kt % STAGES) * TC_STAGE + wg * TC_PANEL;
    const uint8_t* sb = smem + (kt % STAGES) * TC_STAGE + 2 * TC_PANEL;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks)
      sm90::wgmma_ss<TC_BN, 1, 1>(
          acc, sm90::desc(sa + ks * 2048, TC_PANEL, 1024),
          sm90::desc(sb + ks * 2048, TC_PANEL, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // stage kt - 1's products are done
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  const int row = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = col + 8 * j + e;
        if (n < N) C[static_cast<size_t>(m) * N + n] =
            to_bf16(acc[4 * j + 2 * h + e]);
      }
    }
  }
}

// ------------------------------------------------------------ dispatch --

struct Plan {
  int route;    // 0: fp32 on the CUDA cores, 1: bf16 on the tensor cores
  int bm, bn, ksplit, staging;
  int blocks;
};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Plan make_plan(int dtype, int M, int N, const void* a, const void* b) {
  auto blocks = [&](int bm, int bn) {
    return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  if (dtype == 1) {
    const int st =
        M % 8 == 0 && N % 8 == 0 && aligned(a, 16) && aligned(b, 16) ? VEC16
        : M % 2 == 0 && N % 2 == 0 && aligned(a, 4) && aligned(b, 4) ? ASYNC4
        : ELEM;
    return {1, TC_BM, TC_BN, 1, st, blocks(TC_BM, TC_BN)};
  }
  const bool vec =
      M % 4 == 0 && N % 4 == 0 && aligned(a, 16) && aligned(b, 16);
  int c = 0;
  while (c < 2 && blocks(F32_CONFIGS[c].bm, F32_CONFIGS[c].bn) < MIN_BLOCKS)
    ++c;
  const F32Config& f = F32_CONFIGS[c];
  return {0, f.bm, f.bn, f.ksplit, vec ? VEC16 : ASYNC4, blocks(f.bm, f.bn)};
}

template <int BM, int BN, int TM, int TN, int KSPLIT>
int launch_f32(const Plan& p, const void* a, const void* b, void* c, int K,
               int M, int N, cudaStream_t stream) {
  const size_t smem = F32Tile<BM, BN, TM, TN, KSPLIT>::SMEM;
  auto kern = p.staging == VEC16 ? f32_tn<BM, BN, TM, TN, KSPLIT, VEC16>
                                 : f32_tn<BM, BN, TM, TN, KSPLIT, ASYNC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), K, M, N);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const Plan& p, const void* a, const void* b, void* c, int K,
                int M, int N, cudaStream_t stream) {
  auto kern = p.staging == VEC16    ? bf16_tn<VEC16>
              : p.staging == ASYNC4 ? bf16_tn<ASYNC4>
                                    : bf16_tn<ELEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TC_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  kern<<<grid, NTHREADS, TC_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
      K, M, N);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int dtype, int K, int M, int N) {
  return K >= 0 && M > 0 && N > 0 && (dtype == 0 || dtype == 1)
         && (M + 31) / 32 <= 65535;
}

}  // namespace

// The kernel and tiling a launch of these arguments takes: out[0] route
// (0 fp32 CUDA cores, 1 bf16 tensor cores), out[1..2] the block tile, out[3]
// the in-block k split, out[4] staging (0 cp.async 16 B, 1 cp.async 4 B,
// 2 element loads), out[5] the grid's blocks.  Returns 0, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int tiled_matmul_plan(int dtype, int K, int M, int N,
                                 const void* a, const void* b, int* out) {
  if (!valid(dtype, K, M, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(dtype, M, N, a, b);
  const int v[6] = {p.route, p.bm, p.bn, p.ksplit, p.staging, p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16, for A, B and C.  K >= 0, M and N > 0,
// ceil(M / 32) <= 65535.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tiled_matmul_tn(const void* a, const void* b, void* c,
                               int dtype, int K, int M, int N, void* stream) {
  if (!valid(dtype, K, M, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(dtype, M, N, a, b);
  if (p.route == 1) return launch_bf16(p, a, b, c, K, M, N, st);
  switch (p.bm) {
    case 128: return launch_f32<128, 128, 8, 8, 1>(p, a, b, c, K, M, N, st);
    case 64: return launch_f32<64, 64, 8, 8, 4>(p, a, b, c, K, M, N, st);
    default: return launch_f32<32, 32, 4, 4, 4>(p, a, b, c, K, M, N, st);
  }
}
