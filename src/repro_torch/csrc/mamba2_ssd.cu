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
//
// The backward (`mamba2_ssd_bwd`, below) computes dx, d(dA), dB and dC from
// dY.  The JAX package has no backward kernel: its training differentiates
// the scan of `_ssd_chunk`, and so the port's plain version,
// `ssd_chunked_bwd` (kernels/mamba2_ssd/ref.py), writes that gradient out
// chunk by chunk.  The kernel computes the same terms (see there and
// `ssd_chunk_bwd`).

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

// ---------------------------------------------------------------- backward
//
// Per chunk, with cum, E[t] = exp(cum[t]), D[j] = exp(cum[Q-1] - cum[j]),
// L[t][j] = exp(cum[t] - cum[j]) (j <= t, else 0), G = C.B^T, M = G o L,
// S_in the state entering the chunk and dS the cotangent of the state
// leaving it (0 after the last chunk):
//   dM = dY.x^T (j <= t), dG = dM o L, P = dM o M
//   dx[j]  = sum_t M[t][j] dY[t] + D[j] dS B[j]
//   dC[t]  = sum_j dG[t][j] B[j] + E[t] dY[t].S_in      (per head)
//   dB[j]  = sum_t dG[t][j] C[t] + D[j] x[j].dS          (per head)
//   dcum[t] = sum_{j<t} P[t][j] - sum_{t'>t} P[t'][t] + E[t] C[t].(dY[t].S_in)
//             - R[t],  R[j] = D[j] x[j].(dS B[j]) for j < Q-1, R[Q-1] = 0
//   dcum[Q-1] += E[Q-1] <dS, S_in> + sum_{j<Q-1} R[j]
//   d(dA)  = the reverse in-chunk cumsum of dcum
//   dS    <- E[Q-1] dS + sum_t E[t] dY[t]^T C[t]
// P's diagonal and R[Q-1] (D[Q-1] = exp(0) = 1) enter dcum once with each
// sign; they are left out exactly, as in the plain version, rather than
// summed and cancelled in rounding.
//
// What bounds it on an H100: at zamba2-2.7b's training shape the function
// needs ~9.7e9 fp32 FLOPs (the forward's state walk, dY.x^T, M^T.dY,
// dG.B, dG^T.C over the lower triangle; dS.B, dY.S_in, x.dS and the dS
// update at hd x N x Q each) against ~0.13 GB of inputs and outputs:
// 0.14 ms at 67 TFLOP/s against 0.04 ms at 3.35 TB/s, so operations.  This
// first version follows the forward's design (CUDA-core FMAs from shared
// memory, one block per (b, h)), and is as far from that bound: ~2.1 ms
// on an H100 SXM at 700 W, 7 % of it.  The products suit tensor cores.
// What the design does:
//   * one 256-thread block per (b, h), two passes over its chunks: the
//     first walks forward, as the forward kernel does, and writes the state
//     entering each chunk to an fp32 scratch (B, H, chunks, hd, N); the
//     second walks back with dS in shared memory;
//   * dB and dC are shared by every head: each block writes its per-head
//     fp32 partials (B, S, H, N), and `ssd_head_sum` adds them over the
//     heads in head order, with no atomics, so a gradient is the same bit
//     for bit from run to run;
//   * every sum has a fixed order: the products are thread-per-column loops
//     (as in the forward), the row and column sums of P, R and the
//     inter-chunk term one thread per row in index order, <dS, S_in> and
//     the cumsums one thread in index order;
//   * the mask comes before the exponent and expf, not __expf, as in the
//     forward; all arithmetic is fp32 whatever T is;
//   * every tile's rows are padded to an odd number of floats, so a warp
//     reading a row or a column of any of them hits 32 banks.
// At Q = hd = N = 64 the tiles take 152,832 bytes of shared memory; the
// launch opts in.

struct BwdArgs {
  const void* x;    // xdt (B, S, H, HD)
  const void* dA;   // (B, S, H)
  const void* Bm;   // (B, S, N)
  const void* Cm;   // (B, S, N)
  const void* dy;   // (B, S, H, HD)
  void* dx;         // (B, S, H, HD)
  void* ddA;        // (B, S, H)
  float* states;    // (B, H, S / Q, HD, N) scratch: the state entering a chunk
  float* dBp;       // (B, S, H, N) per-head partials of dB
  float* dCp;       // (B, S, H, N) per-head partials of dC
  int B, S, H;
};

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

// row stride of the shared scratch tile W (P, then x o V, then C o U)
template <int Q, int HD, int N>
__host__ __device__ constexpr int bwd_wp() { return cmax(Q, cmax(HD, N)) + 1; }

template <int Q, int HD, int N>
constexpr size_t bwd_smem_bytes() {
  // x, dY (rows of HD+1); B, C (N+1); M, dG (Q+1); W; S_in, dS (N+1); eight
  // vectors of Q; one float a thread for <dS, S_in>
  return sizeof(float) *
         (size_t)(2 * Q * (HD + 1) + 2 * Q * (N + 1) + 2 * Q * (Q + 1) +
                  Q * bwd_wp<Q, HD, N>() + 2 * HD * (N + 1) + 8 * Q +
                  NTHREADS);
}

template <typename T, int Q, int HD, int N>
__global__ void __launch_bounds__(NTHREADS) ssd_chunk_bwd(const BwdArgs a) {
  constexpr int HDP = HD + 1, NP = N + 1, QP = Q + 1;
  constexpr int WP = bwd_wp<Q, HD, N>();
  constexpr int AST = NTHREADS / Q;     // Q x Q: column j, rows every AST
  constexpr int AR = Q / AST;
  constexpr int XST = NTHREADS / HD;    // dx: column d, rows j every XST
  constexpr int XR = Q / XST;
  constexpr int NST = NTHREADS / N;     // column n, rows every NST
  constexpr int NR = NST < Q ? Q / NST : 1;   // dB, dC: rows t or j < Q
  constexpr int SR = HD / NST;                // states: rows d < HD
  static_assert(NTHREADS % Q == 0 && Q % AST == 0 && NTHREADS % HD == 0 &&
                    Q % XST == 0 && NTHREADS % N == 0 &&
                    (NST >= Q || Q % NST == 0) && NST <= HD &&
                    HD % NST == 0 && 2 * Q <= NTHREADS,
                "tile shape");

  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);   // Q x HDP
  float* sDY = sX + Q * HDP;                      // Q x HDP
  float* sB = sDY + Q * HDP;                      // Q x NP
  float* sC = sB + Q * NP;                        // Q x NP
  float* sM = sC + Q * NP;                        // Q x QP
  float* sdG = sM + Q * QP;                       // Q x QP
  float* sW = sdG + Q * QP;                       // Q x WP
  float* sS = sW + Q * WP;                        // HD x NP: S_in
  float* sdS = sS + HD * NP;                      // HD x NP: dS
  float* sCum = sdS + HD * NP;                    // Q: dA, then its cumsum
  float* sE = sCum + Q;                           // Q: exp(cum)
  float* sD = sE + Q;                             // Q: exp(cum[Q-1] - cum)
  float* sRow = sD + Q;                           // Q: sum_{j<t} P[t][j]
  float* sCol = sRow + Q;                         // Q: sum_{t>j} P[t][j]
  float* sR = sCol + Q;                           // Q: R
  float* sI = sR + Q;                             // Q: inter-chunk term
  float* sRed = sCum + 8 * Q;                     // NTHREADS

  const T* X = static_cast<const T*>(a.x);
  const T* DA = static_cast<const T*>(a.dA);
  const T* Bg = static_cast<const T*>(a.Bm);
  const T* Cg = static_cast<const T*>(a.Cm);
  const T* DY = static_cast<const T*>(a.dy);
  T* DX = static_cast<T*>(a.dx);
  T* DDA = static_cast<T*>(a.ddA);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int nC = a.S / Q;
  const long long xstep = (long long)a.H * HD;
  const long long xbase = ((long long)b * a.S * a.H + h) * HD;
  const long long dbase = (long long)b * a.S * a.H + h;
  const long long nbase = (long long)b * a.S * N;
  // partials: (b, t, h, n) at pbase + t * H * N + n
  const long long pbase = ((long long)b * a.S * a.H + h) * N;
  const long long pstep = (long long)a.H * N;
  float* St = a.states + (long long)blockIdx.x * nC * HD * N;

  // ---- pass 1: the forward's state walk; St[c] = the state entering c
  for (int i = tid; i < HD * NP; i += NTHREADS) sS[i] = 0.f;
  for (int c = 0; c < nC; ++c) {
    const int c0 = c * Q;
    __syncthreads();
    for (int i = tid; i < Q * HD; i += NTHREADS) {
      const int t = i / HD, d = i % HD;
      sX[t * HDP + d] = to_f(X[xbase + (long long)(c0 + t) * xstep + d]);
    }
    for (int i = tid; i < Q * N; i += NTHREADS) {
      const int t = i / N, n = i % N;
      sB[t * NP + n] = to_f(Bg[nbase + (long long)(c0 + t) * N + n]);
    }
    if (tid < Q) sCum[tid] = to_f(DA[dbase + (long long)(c0 + tid) * a.H]);
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += sCum[t];
        sCum[t] = acc;
      }
    }
    __syncthreads();
    if (tid < Q) sD[tid] = expf(sCum[Q - 1] - sCum[tid]);
    __syncthreads();
    {
      const int n = tid % N, r0 = tid / N;
      float* dst = St + (long long)c * HD * N;
      float s[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        s[i] = sS[(r0 + i * NST) * NP + n];
        dst[(r0 + i * NST) * N + n] = s[i];
      }
      if (c + 1 < nC) {   // the last chunk's outgoing state is not needed
        const float decay = expf(sCum[Q - 1]);
#pragma unroll
        for (int i = 0; i < SR; ++i) s[i] *= decay;
#pragma unroll 8
        for (int j = 0; j < Q; ++j) {
          const float bj = sB[j * NP + n], dj = sD[j];
#pragma unroll
          for (int i = 0; i < SR; ++i)
            s[i] = fmaf(sX[j * HDP + r0 + i * NST] * dj, bj, s[i]);
        }
#pragma unroll
        for (int i = 0; i < SR; ++i) sS[(r0 + i * NST) * NP + n] = s[i];
      }
    }
  }

  // ---- pass 2: the chunks in reverse, dS carried in shared memory
  for (int i = tid; i < HD * NP; i += NTHREADS) sdS[i] = 0.f;
  for (int c = nC - 1; c >= 0; --c) {
    const int c0 = c * Q;
    __syncthreads();   // the previous chunk no longer reads the tiles
    for (int i = tid; i < Q * HD; i += NTHREADS) {
      const int t = i / HD, d = i % HD;
      const long long off = xbase + (long long)(c0 + t) * xstep + d;
      sX[t * HDP + d] = to_f(X[off]);
      sDY[t * HDP + d] = to_f(DY[off]);
    }
    for (int i = tid; i < Q * N; i += NTHREADS) {
      const int t = i / N, n = i % N;
      const long long off = nbase + (long long)(c0 + t) * N + n;
      sB[t * NP + n] = to_f(Bg[off]);
      sC[t * NP + n] = to_f(Cg[off]);
    }
    {
      const float* src = St + (long long)c * HD * N;
      for (int i = tid; i < HD * N; i += NTHREADS)
        sS[(i / N) * NP + i % N] = src[i];
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
    {   // M, dG and P for this thread's column j and rows t
      const int j = tid % Q, r0 = tid / Q;
      float g[AR], dm[AR];
#pragma unroll
      for (int i = 0; i < AR; ++i) g[i] = dm[i] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float bj = sB[j * NP + n];
#pragma unroll
        for (int i = 0; i < AR; ++i)
          g[i] = fmaf(sC[(r0 + i * AST) * NP + n], bj, g[i]);
      }
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float xj = sX[j * HDP + d];
#pragma unroll
        for (int i = 0; i < AR; ++i)
          dm[i] = fmaf(sDY[(r0 + i * AST) * HDP + d], xj, dm[i]);
      }
      const float cj = sCum[j];
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const int t = r0 + i * AST;
        float m = 0.f, dg = 0.f, p = 0.f;
        if (j <= t) {
          const float l = expf(sCum[t] - cj);
          m = g[i] * l;
          dg = dm[i] * l;
          if (j < t) p = dm[i] * m;
        }
        sM[t * QP + j] = m;
        sdG[t * QP + j] = dg;
        sW[t * WP + j] = p;
      }
    }
    __syncthreads();
    if (tid < Q) {   // row sums of P, strictly below the diagonal
      float acc = 0.f;
      for (int j = 0; j < tid; ++j) acc += sW[tid * WP + j];
      sRow[tid] = acc;
    } else if (tid < 2 * Q) {   // column sums
      const int j = tid - Q;
      float acc = 0.f;
      for (int t = j + 1; t < Q; ++t) acc += sW[t * WP + j];
      sCol[j] = acc;
    }
    __syncthreads();
    {   // dx[j][d] = sum_t M[t][j] dY[t][d] + D[j] dS[d] . B[j]
      const int d = tid % HD, r0 = tid / HD;
      float acc[XR], v[XR];
#pragma unroll
      for (int i = 0; i < XR; ++i) acc[i] = v[i] = 0.f;
#pragma unroll 8
      for (int t = 0; t < Q; ++t) {
        const float dy = sDY[t * HDP + d];
#pragma unroll
        for (int i = 0; i < XR; ++i)
          acc[i] = fmaf(sM[t * QP + r0 + i * XST], dy, acc[i]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float ds = sdS[d * NP + n];
#pragma unroll
        for (int i = 0; i < XR; ++i)
          v[i] = fmaf(sB[(r0 + i * XST) * NP + n], ds, v[i]);
      }
#pragma unroll
      for (int i = 0; i < XR; ++i) {
        const int j = r0 + i * XST;
        DX[xbase + (long long)(c0 + j) * xstep + d] =
            from_f<T>(acc[i] + sD[j] * v[i]);
        sW[j * WP + d] = sX[j * HDP + d] * v[i];
      }
    }
    __syncthreads();
    if (tid < Q - 1) {   // R[j] = D[j] x[j] . (dS B[j])
      float acc = 0.f;
      for (int d = 0; d < HD; ++d) acc += sW[tid * WP + d];
      sR[tid] = sD[tid] * acc;
    } else if (tid == Q - 1) {
      sR[tid] = 0.f;
    }
    __syncthreads();
    {   // dC[t][n] = sum_j dG[t][j] B[j][n] + E[t] dY[t] . S_in[:, n]
      const int n = tid % N, r0 = tid / N;
      if (r0 < Q) {
        float acc[NR], u[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = u[i] = 0.f;
#pragma unroll 8
        for (int j = 0; j < Q; ++j) {
          const float bj = sB[j * NP + n];
#pragma unroll
          for (int i = 0; i < NR; ++i)
            acc[i] = fmaf(sdG[(r0 + i * NST) * QP + j], bj, acc[i]);
        }
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          const float sd = sS[d * NP + n];
#pragma unroll
          for (int i = 0; i < NR; ++i)
            u[i] = fmaf(sDY[(r0 + i * NST) * HDP + d], sd, u[i]);
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int t = r0 + i * NST;
          a.dCp[pbase + (long long)(c0 + t) * pstep + n] =
              acc[i] + sE[t] * u[i];
          sW[t * WP + n] = sC[t * NP + n] * u[i];
        }
      }
    }
    __syncthreads();
    if (tid < Q) {   // the inter-chunk term E[t] C[t] . (dY[t] . S_in)
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc += sW[tid * WP + n];
      sI[tid] = sE[tid] * acc;
    }
    {   // dB[j][n] = sum_t dG[t][j] C[t][n] + D[j] x[j] . dS[:, n]
      const int n = tid % N, r0 = tid / N;
      if (r0 < Q) {
        float acc[NR], w[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = w[i] = 0.f;
#pragma unroll 8
        for (int t = 0; t < Q; ++t) {
          const float ct = sC[t * NP + n];
#pragma unroll
          for (int i = 0; i < NR; ++i)
            acc[i] = fmaf(sdG[t * QP + r0 + i * NST], ct, acc[i]);
        }
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          const float ds = sdS[d * NP + n];
#pragma unroll
          for (int i = 0; i < NR; ++i)
            w[i] = fmaf(sX[(r0 + i * NST) * HDP + d], ds, w[i]);
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int j = r0 + i * NST;
          a.dBp[pbase + (long long)(c0 + j) * pstep + n] =
              acc[i] + sD[j] * w[i];
        }
      }
    }
    __syncthreads();   // every read of the old dS is done
    {   // <dS, S_in>, then dS <- E[Q-1] dS + sum_t E[t] dY[t]^T C[t]
      const int n = tid % N, r0 = tid / N;
      const float decay = sE[Q - 1];
      float s[SR], dot = 0.f;
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float ds = sdS[(r0 + i * NST) * NP + n];
        dot = fmaf(ds, sS[(r0 + i * NST) * NP + n], dot);
        s[i] = ds * decay;
      }
      sRed[tid] = dot;
#pragma unroll 8
      for (int t = 0; t < Q; ++t) {
        const float ct = sC[t * NP + n], et = sE[t];
#pragma unroll
        for (int i = 0; i < SR; ++i)
          s[i] = fmaf(et * sDY[t * HDP + r0 + i * NST], ct, s[i]);
      }
#pragma unroll
      for (int i = 0; i < SR; ++i)
        sdS[(r0 + i * NST) * NP + n] = s[i];   // carried to the chunk before
    }
    __syncthreads();
    if (tid == 0) {   // dcum and its reverse cumsum, in index order
      float dot = 0.f, rsum = 0.f;
      for (int i = 0; i < NTHREADS; ++i) dot += sRed[i];
      for (int j = 0; j < Q - 1; ++j) rsum += sR[j];
      float acc = 0.f;
      for (int t = Q - 1; t >= 0; --t) {
        float dcum = sRow[t] - sCol[t] + sI[t] - sR[t];
        if (t == Q - 1) dcum += sE[Q - 1] * dot + rsum;
        acc += dcum;   // d(dA)[t] = sum_{t' >= t} dcum[t']
        DDA[dbase + (long long)(c0 + t) * a.H] = from_f<T>(acc);
      }
    }
  }
}

// dB and dC: the per-head partials summed over the heads in head order.
template <typename T>
__global__ void ssd_head_sum(const float* dBp, const float* dCp, T* dB, T* dC,
                             long long rows, int H, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * N) return;
  const long long src = (i / N) * H * N + i % N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dBp[src + (long long)h * N];
    sc += dCp[src + (long long)h * N];
  }
  dB[i] = from_f<T>(sb);
  dC[i] = from_f<T>(sc);
}

template <typename T, int Q, int HD, int N>
int launch_bwd(const BwdArgs& a, void* dB, void* dC, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<Q, HD, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd<T, Q, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_bwd<T, Q, HD, N><<<a.B * a.H, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)a.B * a.S;
  const long long blocks = (rows * N + NTHREADS - 1) / NTHREADS;
  ssd_head_sum<T><<<static_cast<unsigned>(blocks), NTHREADS, 0, stream>>>(
      a.dBp, a.dCp, static_cast<T*>(dB), static_cast<T*>(dC), rows, a.H, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int N>
int launch_bwd_q(const BwdArgs& a, void* dB, void* dC, int q,
                 cudaStream_t stream) {
  switch (q) {
    case 16: return launch_bwd<T, 16, HD, N>(a, dB, dC, stream);
    case 32: return launch_bwd<T, 32, HD, N>(a, dB, dC, stream);
    case 64: return launch_bwd<T, 64, HD, N>(a, dB, dC, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bwd_shape(const BwdArgs& a, void* dB, void* dC, int hd, int n,
                     int q, cudaStream_t stream) {
  if (hd == 64 && n == 64) return launch_bwd_q<T, 64, 64>(a, dB, dC, q, stream);
  if (hd == 16 && n == 16) return launch_bwd_q<T, 16, 16>(a, dB, dC, q, stream);
  if (hd == 32 && n == 8) return launch_bwd_q<T, 32, 8>(a, dB, dC, q, stream);
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


// The gradient of mamba2_ssd_fwd's Y with cotangent dy: dx, ddA in the
// inputs' shapes, dB, dC as (B, S, N), all in the inputs' type (dtype as
// above).  states (B, H, S / q, hd, n), dBp and dCp (B, S, H, n) are fp32
// scratch of the caller's.  Two launches on the stream: the per-(b, h)
// backward, then the sum over heads.  Returns cudaGetLastError() (0 on
// success).
extern "C" int mamba2_ssd_bwd(const void* x, const void* dA, const void* Bm,
                              const void* Cm, const void* dy, void* dx,
                              void* ddA, void* dB, void* dC, float* states,
                              float* dBp, float* dCp, int dtype, int B, int S,
                              int H, int hd, int n, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dA, Bm, Cm, dy, dx, ddA, states, dBp, dCp, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_shape<float>(a, dB, dC, hd, n, q, st);
  if (dtype == 1)
    return launch_bwd_shape<__nv_bfloat16>(a, dB, dC, hd, n, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
