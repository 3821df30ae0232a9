// Chunked RWKV6 WKV forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan/kernel.py (launched by `wkv6_pallas`), and
// computes the function of the JAX model's chunk step `_wkv_chunk`
// (src/repro/models/rwkv.py) scanned over the chunks, final state included
// (the Pallas kernel keeps its state in VMEM and writes only y).
//
// Function, for each batch row b and head h, over chunks of Q steps:
//   cumw[t] = sum_{s<=t} logw[s] within the chunk; ce[t] = cumw[t-1], ce[0] = 0
//   A[t][j] = sum_d r[t,d] k[j,d] exp(ce[t,d] - cumw[j,d])  for j < t, else 0
//   y[t]    = A[t] . v + (sum_d r[t,d] u[d] k[t,d]) v[t] + (r[t] exp(ce[t])).S
//   S      <- S exp(cumw[Q-1]) + sum_j (k[j] exp(cumw[Q-1] - cumw[j]))^T v[j]
// S (hd_k x hd_v) starts at the given initial state, or at 0.  All fp32:
// r, k, v, logw and y are (B, S, H, hd) contiguous, u (H, hd), the states
// (B, H, hd, hd).  S % Q == 0 (the caller pads).
//
// What bounds it on an H100: at rwkv6-1.6b's prefill shape (B 4, S 4224,
// H 32, hd 64, Q 64) the intra-chunk products need ~1.1e9 exps, which the
// special-function units issue at 16 per clock per SM (~0.26 ms), against
// ~1.6e10 fp32 FLOPs (~0.24 ms at 67 TFLOP/s) and 692 MB of inputs and
// output (~0.21 ms at 3.35 TB/s): the exps bound it, just.
// What holds this first version back: its grid is one block per (b, h),
// 128 blocks of 8 warps on 132 SMs, each walking its 66 chunks in order, so
// the SMs run one block each with little latency hidden; every operand
// comes from shared memory (~4 loads per exp); the tile loads do not overlap
// the arithmetic.  Making it fast is later work: the intra-chunk parts of
// all chunks do not depend on the state and can run in parallel, leaving
// only the state carried in order; A.v, r.S and k^T.v suit tensor cores.
// What the design does:
//   * one block of 256 threads per (b, h) loops over the chunks (the Pallas
//     grid's sequential "arbitrary" axis) with the state in shared memory;
//   * r, k and cumw rows are padded to hd+1 floats, so a warp reading one
//     column of 32 rows hits 32 banks;
//   * A's pairs are enumerated over the strict lower triangle only, so only
//     j < t is ever evaluated, where the exponent is <= 0; the diagonal and
//     upper triangle of A are set to exactly 0 once and never written;
//   * expf, not __expf: the fast version's error grows with the argument,
//     and the decay of thousands of steps runs through it;
//   * y and the state update: each thread owns one column c and every
//     (256/hd)-th row, so one load of v[j][c] serves all its rows and the
//     row operands are warp broadcasts.
// At hd 64 and Q 64 the tiles take 99,840 bytes of shared memory, above
// 48 KB, so the launch opts in; a refused launch is returned as an error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* logw;
  const float* u;
  const float* s0;   // nullptr: start from 0
  float* y;
  float* s_out;
  int B, S, H;
};

template <int Q, int HD>
constexpr size_t smem_bytes() {
  // r, k, cumw (padded) + v + A + S + beta (Q) + u, decay (HD)
  return sizeof(float) *
         (size_t)(3 * Q * (HD + 1) + Q * HD + Q * Q + HD * HD + Q + 2 * HD);
}

template <int Q, int HD>
__global__ void __launch_bounds__(NTHREADS) wkv6_fwd(const Args a) {
  constexpr int LDP = HD + 1;                // padded row stride
  constexpr int PAIRS = Q * (Q - 1) / 2;     // (t, j) with j < t
  constexpr int RSTEP = NTHREADS / HD;       // between a thread's rows
  constexpr int YR = Q / RSTEP;              // y rows per thread
  constexpr int SR = HD / RSTEP;             // state rows per thread
  constexpr int VEC_PER_ROW = HD / 4;
  constexpr int LOADS = (Q * VEC_PER_ROW + NTHREADS - 1) / NTHREADS;
  static_assert(NTHREADS % HD == 0 && Q % RSTEP == 0 && HD % RSTEP == 0,
                "tile shape");

  extern __shared__ float4 smem4[];
  float* sR = reinterpret_cast<float*>(smem4);   // Q x LDP: r, then r exp(ce)
  float* sK = sR + Q * LDP;                       // Q x LDP: k, then k dec_end
  float* sW = sK + Q * LDP;                       // Q x LDP: logw, then cumw
  float* sV = sW + Q * LDP;                       // Q x HD
  float* sA = sV + Q * HD;                        // Q x Q
  float* sS = sA + Q * Q;                         // HD x HD state
  float* sBeta = sS + HD * HD;                    // Q: bonus r.(u*k)
  float* sU = sBeta + Q;                          // HD
  float* sDec = sU + HD;                          // HD: exp(cumw[Q-1])

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const long long step = (long long)a.H * HD;               // t -> t+1
  const long long base = ((long long)b * a.S * a.H + h) * HD;  // (b,0,h,0)
  const long long sbase = (long long)blockIdx.x * HD * HD;     // (b,h,0,0)

  for (int i = tid; i < Q * Q; i += NTHREADS) sA[i] = 0.f;
  for (int i = tid; i < HD * HD; i += NTHREADS)
    sS[i] = a.s0 ? a.s0[sbase + i] : 0.f;
  for (int i = tid; i < HD; i += NTHREADS) sU[i] = a.u[h * HD + i];

  const int col = tid % HD;      // this thread's column of y and S
  const int row0 = tid / HD;     // its first row; then every RSTEP-th

  for (int c0 = 0; c0 < a.S; c0 += Q) {
    __syncthreads();   // the previous chunk no longer reads the tiles
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int i = tid + it * NTHREADS;
      if (i < Q * VEC_PER_ROW) {
        const int t = i / VEC_PER_ROW, d = (i % VEC_PER_ROW) * 4;
        const long long off = base + (long long)(c0 + t) * step + d;
        const float4 rr = *reinterpret_cast<const float4*>(a.r + off);
        const float4 kk = *reinterpret_cast<const float4*>(a.k + off);
        const float4 vv = *reinterpret_cast<const float4*>(a.v + off);
        const float4 ww = *reinterpret_cast<const float4*>(a.logw + off);
        float* pr = sR + t * LDP + d;
        float* pk = sK + t * LDP + d;
        float* pw = sW + t * LDP + d;
        pr[0] = rr.x; pr[1] = rr.y; pr[2] = rr.z; pr[3] = rr.w;
        pk[0] = kk.x; pk[1] = kk.y; pk[2] = kk.z; pk[3] = kk.w;
        pw[0] = ww.x; pw[1] = ww.y; pw[2] = ww.z; pw[3] = ww.w;
        *reinterpret_cast<float4*>(sV + t * HD + d) = vv;
      }
    }
    __syncthreads();

    // inclusive cumsum of logw over the chunk, one thread per channel
    if (tid < HD) {
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += sW[t * LDP + tid];
        sW[t * LDP + tid] = acc;
      }
    }
    __syncthreads();

    // A over the strict lower triangle: pair p -> row t, column j < t
    for (int p = tid; p < PAIRS; p += NTHREADS) {
      int t = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while (t * (t + 1) / 2 <= p) ++t;
      const int j = p - t * (t - 1) / 2;
      const float* rt = sR + t * LDP;
      const float* ce = sW + (t - 1) * LDP;
      const float* kj = sK + j * LDP;
      const float* cj = sW + j * LDP;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        acc = fmaf(rt[d] * kj[d], expf(ce[d] - cj[d]), acc);
      sA[t * Q + j] = acc;
    }
    // bonus coefficient of the diagonal
    for (int t = tid; t < Q; t += NTHREADS) {
      float acc = 0.f;
      for (int d = 0; d < HD; ++d)
        acc = fmaf(sR[t * LDP + d], sU[d] * sK[t * LDP + d], acc);
      sBeta[t] = acc;
    }
    __syncthreads();

    // r <- r exp(ce), k <- k exp(cumw[Q-1] - cumw), decay = exp(cumw[Q-1])
    const float* wlast = sW + (Q - 1) * LDP;
    for (int i = tid; i < Q * HD; i += NTHREADS) {
      const int t = i / HD, d = i % HD;
      if (t > 0) sR[t * LDP + d] *= expf(sW[(t - 1) * LDP + d]);
      sK[t * LDP + d] *= expf(wlast[d] - sW[t * LDP + d]);
    }
    for (int d = tid; d < HD; d += NTHREADS) sDec[d] = expf(wlast[d]);
    __syncthreads();

    // y[t][col] for this thread's rows
    float acc[YR];
#pragma unroll
    for (int i = 0; i < YR; ++i) {
      const int t = row0 + i * RSTEP;
      acc[i] = sBeta[t] * sV[t * HD + col];
    }
    for (int j = 0; j < Q; ++j) {
      const float vj = sV[j * HD + col];
#pragma unroll
      for (int i = 0; i < YR; ++i)
        acc[i] = fmaf(sA[(row0 + i * RSTEP) * Q + j], vj, acc[i]);
    }
    for (int d = 0; d < HD; ++d) {
      const float sd = sS[d * HD + col];
#pragma unroll
      for (int i = 0; i < YR; ++i)
        acc[i] = fmaf(sR[(row0 + i * RSTEP) * LDP + d], sd, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < YR; ++i)
      a.y[base + (long long)(c0 + row0 + i * RSTEP) * step + col] = acc[i];
    __syncthreads();   // every thread has read the old state

    // S[d][col] for this thread's rows d
    float s[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int d = row0 + i * RSTEP;
      s[i] = sS[d * HD + col] * sDec[d];
    }
    for (int j = 0; j < Q; ++j) {
      const float vj = sV[j * HD + col];
#pragma unroll
      for (int i = 0; i < SR; ++i)
        s[i] = fmaf(sK[j * LDP + row0 + i * RSTEP], vj, s[i]);
    }
#pragma unroll
    for (int i = 0; i < SR; ++i) sS[(row0 + i * RSTEP) * HD + col] = s[i];
  }
  __syncthreads();
  for (int i = tid; i < HD * HD; i += NTHREADS) a.s_out[sbase + i] = sS[i];
}

template <int Q, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<Q, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fwd<Q, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_fwd<Q, HD><<<a.B * a.H, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_q(const Args& a, int q, cudaStream_t stream) {
  switch (q) {
    case 16: return launch<16, HD>(a, stream);
    case 32: return launch<32, HD>(a, stream);
    case 64: return launch<64, HD>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// s0 may be null (zero initial state).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int wkv6_fwd_f32(const float* r, const float* k, const float* v,
                            const float* logw, const float* u, const float* s0,
                            float* y, float* s_out, int B, int S, int H,
                            int hd, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, logw, u, s0, y, s_out, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32) return launch_q<32>(a, q, st);
  if (hd == 64) return launch_q<64>(a, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
