// Chunked Mamba2 SSD scan forward for Hopper (sm_90a), n_groups == 1.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/mamba2_ssd/kernel.py (launched by `ssd_pallas`), and
// computes the function of the JAX model's chunk step `_ssd_chunk`
// (src/repro/models/mamba2.py) scanned over the chunks from a zero state.
// Like the Pallas kernel it writes Y only; the final state stays inside.
//
// Function, for each batch row b and head h, over chunks of Q steps:
//   cum[t]  = sum_{s<=t} dA[s] within the chunk
//   M[t][j] = (C[t] . B[j]) exp(cum[t] - cum[j])   for j <= t, else 0
//   Y[t]    = sum_j M[t][j] x[j] + exp(cum[t]) S C[t]
//   S      <- exp(cum[Q-1]) S + sum_j exp(cum[Q-1] - cum[j]) x[j] B[j]^T
// with x = xdt (B, S, H, hd), dA (B, S, H), B and C (B, S, N) (the one
// group), all of one type T (float or bf16) and contiguous; S (hd x N)
// starts at 0; arithmetic in fp32; Y (B, S, H, hd) in T.  S % Q == 0 (the
// caller pads).
//
// What bounds it on an H100: at zamba2-2.7b's training shape (B 2, S 1024,
// H 80, hd 64, N 64, Q 64) the work is ~4.1e9 fp32 FLOPs (C.B^T and M.x
// over the lower triangle, C.S and the state update) against ~86 MB of
// inputs and output: 0.061 ms at 67 TFLOP/s against 0.026 ms at 3.35 TB/s,
// so it is bound by operations.  This first version does them as fp32 FMAs
// on the CUDA cores from shared memory (~1 load per FMA); C.B^T, M.x, C.S
// and x^T.B suit tensor cores, which is later work, and so is filling the
// card: the grid is one block per (b, h), 160 blocks at the main shape on
// 132 SMs, each walking its 16 chunks in order.
// What the design does:
//   * one block of 256 threads per (b, h) loops over the chunks (the Pallas
//     grid's sequential "arbitrary" axis) with the fp32 state in shared
//     memory; the Pallas kernel keeps all H heads in one program and shares
//     C.B^T between them, this one recomputes C.B^T per head;
//   * the mask is applied before the exponent: exp runs only for j <= t,
//     where cum[t] - cum[j] <= 0 (dA <= 0), and M's upper triangle is
//     exactly 0, so no overflow can reach a product;
//   * expf, not __expf: the fast version's error grows with the argument;
//   * each product is a thread-per-column loop (column = key j, value
//     column d, or state column n) over rows spaced by 256/columns, so one
//     load of the column operand serves all of a thread's rows and the row
//     operand is a warp broadcast; B and S rows are padded to N+1 floats so
//     a warp reading one column of them hits 32 banks.
// At Q = hd = N = 64 the tiles take 83,200 bytes of shared memory, above
// 48 KB, so the launch opts in; a refused launch is returned as an error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

struct Args {
  const void* x;    // xdt (B, S, H, HD)
  const void* dA;   // (B, S, H)
  const void* Bm;   // (B, S, N)
  const void* Cm;   // (B, S, N)
  void* y;          // (B, S, H, HD)
  int B, S, H;
};

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
  return __float2bfloat16(x);
}

template <int Q, int HD, int N>
constexpr size_t smem_bytes() {
  // x, B (padded), C, M, S (padded), cum, exp(cum), exp(cum[Q-1] - cum)
  return sizeof(float) * (size_t)(Q * HD + Q * (N + 1) + Q * N + Q * Q +
                                  HD * (N + 1) + 3 * Q);
}

template <typename T, int Q, int HD, int N>
__global__ void __launch_bounds__(NTHREADS) ssd_chunk_fwd(const Args a) {
  constexpr int NP = N + 1;               // padded row stride of B and S
  constexpr int MSTEP = NTHREADS / Q;     // M: column j, rows every MSTEP
  constexpr int MR = Q / MSTEP;
  constexpr int YSTEP = NTHREADS / HD;    // Y: column d, rows every YSTEP
  constexpr int YR = Q / YSTEP;
  constexpr int SSTEP = NTHREADS / N;     // S: column n, rows every SSTEP
  constexpr int SR = HD / SSTEP;
  static_assert(NTHREADS % Q == 0 && Q % MSTEP == 0 && NTHREADS % HD == 0 &&
                    Q % YSTEP == 0 && NTHREADS % N == 0 && HD % SSTEP == 0,
                "tile shape");

  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);   // Q x HD: x, then x dec
  float* sB = sX + Q * HD;                        // Q x NP
  float* sC = sB + Q * NP;                        // Q x N
  float* sM = sC + Q * N;                         // Q x Q
  float* sS = sM + Q * Q;                         // HD x NP state
  float* sCum = sS + HD * NP;                     // Q: dA, then its cumsum
  float* sE = sCum + Q;                           // Q: exp(cum)
  float* sD = sE + Q;                             // Q: exp(cum[Q-1] - cum)

  const T* X = static_cast<const T*>(a.x);
  const T* DA = static_cast<const T*>(a.dA);
  const T* Bg = static_cast<const T*>(a.Bm);
  const T* Cg = static_cast<const T*>(a.Cm);
  T* Y = static_cast<T*>(a.y);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const long long xstep = (long long)a.H * HD;                // t -> t+1
  const long long xbase = ((long long)b * a.S * a.H + h) * HD;  // (b,0,h,0)
  const long long dbase = (long long)b * a.S * a.H + h;
  const long long nbase = (long long)b * a.S * N;

  for (int i = tid; i < HD * NP; i += NTHREADS) sS[i] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += Q) {
    __syncthreads();   // the previous chunk no longer reads the tiles
    for (int i = tid; i < Q * HD; i += NTHREADS) {
      const int t = i / HD, d = i % HD;
      sX[i] = to_f(X[xbase + (long long)(c0 + t) * xstep + d]);
    }
    for (int i = tid; i < Q * N; i += NTHREADS) {
      const int t = i / N, n = i % N;
      const long long off = nbase + (long long)(c0 + t) * N + n;
      sB[t * NP + n] = to_f(Bg[off]);
      sC[i] = to_f(Cg[off]);
    }
    if (tid < Q) sCum[tid] = to_f(DA[dbase + (long long)(c0 + tid) * a.H]);
    __syncthreads();

    if (tid == 0) {   // in order, as the plain version's cumsum
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += sCum[t];
        sCum[t] = acc;
      }
    }
    __syncthreads();

    if (tid < Q) {
      sE[tid] = expf(sCum[tid]);
      sD[tid] = expf(sCum[Q - 1] - sCum[tid]);
    }
    {   // M[t][j] for this thread's column j and rows t
      const int j = tid % Q, r0 = tid / Q;
      float acc[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) acc[i] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float bj = sB[j * NP + n];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          acc[i] = fmaf(sC[(r0 + i * MSTEP) * N + n], bj, acc[i]);
      }
      const float cj = sCum[j];
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int t = r0 + i * MSTEP;
        sM[t * Q + j] = j <= t ? acc[i] * expf(sCum[t] - cj) : 0.f;
      }
    }
    __syncthreads();

    {   // Y[t][d] = M[t] . x[:, d] + exp(cum[t]) C[t] . S[d]
      const int d = tid % HD, r0 = tid / HD;
      float acc[YR], acs[YR];
#pragma unroll
      for (int i = 0; i < YR; ++i) acc[i] = acs[i] = 0.f;
#pragma unroll 8
      for (int j = 0; j < Q; ++j) {
        const float xj = sX[j * HD + d];
#pragma unroll
        for (int i = 0; i < YR; ++i)
          acc[i] = fmaf(sM[(r0 + i * YSTEP) * Q + j], xj, acc[i]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float sd = sS[d * NP + n];
#pragma unroll
        for (int i = 0; i < YR; ++i)
          acs[i] = fmaf(sC[(r0 + i * YSTEP) * N + n], sd, acs[i]);
      }
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int t = r0 + i * YSTEP;
        Y[xbase + (long long)(c0 + t) * xstep + d] =
            from_f<T>(acc[i] + acs[i] * sE[t]);
      }
    }
    __syncthreads();   // every thread has read x and the old state

    for (int i = tid; i < Q * HD; i += NTHREADS) sX[i] *= sD[i / HD];
    __syncthreads();

    {   // S[d][n] <- exp(cum[Q-1]) S[d][n] + sum_j x'[j][d] B[j][n]
      const int n = tid % N, r0 = tid / N;
      const float decay = sE[Q - 1];
      float s[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) s[i] = sS[(r0 + i * SSTEP) * NP + n] * decay;
#pragma unroll 8
      for (int j = 0; j < Q; ++j) {
        const float bj = sB[j * NP + n];
#pragma unroll
        for (int i = 0; i < SR; ++i)
          s[i] = fmaf(sX[j * HD + r0 + i * SSTEP], bj, s[i]);
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) sS[(r0 + i * SSTEP) * NP + n] = s[i];
    }
  }
}

template <typename T, int Q, int HD, int N>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<Q, HD, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_fwd<T, Q, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_fwd<T, Q, HD, N><<<a.B * a.H, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int N>
int launch_q(const Args& a, int q, cudaStream_t stream) {
  switch (q) {
    case 16: return launch<T, 16, HD, N>(a, stream);
    case 32: return launch<T, 32, HD, N>(a, stream);
    case 64: return launch<T, 64, HD, N>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// (hd, N): zamba2-2.7b's (64, 64) and the JAX kernel sweep's (16, 16) and
// (32, 8) (tests/test_kernels.py).
template <typename T>
int launch_shape(const Args& a, int hd, int n, int q, cudaStream_t stream) {
  if (hd == 64 && n == 64) return launch_q<T, 64, 64>(a, q, stream);
  if (hd == 16 && n == 16) return launch_q<T, 16, 16>(a, q, stream);
  if (hd == 32 && n == 8) return launch_q<T, 32, 8>(a, q, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every input and Y.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mamba2_ssd_fwd(const void* x, const void* dA, const void* Bm,
                       const void* Cm, void* y, int dtype, int B, int S,
                       int H, int hd, int n, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dA, Bm, Cm, y, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_shape<float>(a, hd, n, q, st);
  if (dtype == 1) return launch_shape<__nv_bfloat16>(a, hd, n, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
