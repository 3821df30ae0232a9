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
//
// The design: only the state carry depends on the order of the chunks, and
// it is one fma per state element and chunk, so the work is split in three
// launches, two of them parallel over every (b, h, chunk):
//   1. wkv6_chunk_state, one block per (b, h, c): the chunk's cumw, its
//      decay a_c = exp(cumw[Q-1]) and its own state term
//      dS_c = sum_j (k[j] exp(cumw[Q-1] - cumw[j]))^T v[j], written to an
//      fp32 scratch (B, H, nC, hd, hd) and (B, H, nC, hd);
//   2. wkv6_state_pass, one thread per 4 elements of each (b, h) state:
//      S_in[c+1] = diag(a_c) S_in[c] + dS_c over the chunks, in place in
//      the scratch (dS_c becomes S_in[c], the state entering chunk c), the
//      last state to the output;
//   3. wkv6_chunk_out, one block per (b, h, c): A, the bonus and
//      y = A.v + beta v + (r exp(ce)).S_in[c].
// At the main shape stages 1 and 3 run 8,448 blocks each, and stage 2
// 131,072 threads; the scratch is 138 MB, written once and read twice.
// Everything is exact fp32 on the CUDA cores:
//   * expf, not __expf: the fast version's error grows with the argument,
//     and the decay of thousands of steps runs through it.  expf is 8
//     instructions (one of them the MUFU exp2), so stage 3 is bound by
//     instruction issue at ~12 instructions an exp, not by the MUFU;
//   * stage 3 holds r, k and cumw transposed ((d, t) order, swizzled), so a
//     thread's tile of A, 4 rows t by 2 columns j, loads its operands as
//     one float4 or float2 each (ce[t] = cumw[t-1] from two float4s of
//     cumw): 5 shared loads for 8 exps.  The 4 x 2 tiles cover the strict
//     lower triangle below the diagonal 4 x 4 blocks (240 threads at
//     Q = 64); the diagonal blocks' 6 pairs j < t each take two threads
//     (half of d each), and beta the last Q threads, in a second loop that
//     every thread of a warp runs alike;
//   * the 4 x 4 tiles of y (and of dS in stage 1) load a float4 of each
//     operand for 16 FMAs; A.v stops at the tile's diagonal block;
//   * stage 3's A^T and S_in take the place of k and cumw once A is done,
//     and v that of logw once the cumsum is taken: 66,304 B of shared
//     memory at hd = Q = 64, so three blocks share an SM;
//   * stage 2 keeps 16 chunks' loads in flight a thread.
// A refused launch is returned as an error.

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
  float* states;     // (B, H, nC, hd, hd): dS of each chunk, then S_in
  float* decay;      // (B, H, nC, hd): exp(cumw[Q-1]) of each chunk
  int B, S, H;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][0..3] += x[i] * (y.x, y.y, y.z, y.w), i < 4
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 x,
                                       float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(xs[i], y.x, acc[i][0]);
    acc[i][1] = fmaf(xs[i], y.y, acc[i][1]);
    acc[i][2] = fmaf(xs[i], y.z, acc[i][2]);
    acc[i][3] = fmaf(xs[i], y.w, acc[i][3]);
  }
}

// Block (b, h, c), in the scratch's (b, h, c) order: the chunk's first
// element (b, c*Q, h, 0) in r, k, v, logw and y.
template <int Q, int HD>
__device__ __forceinline__ long long chunk_base(const Args& a,
                                                long long bhc) {
  const int nC = a.S / Q;
  const long long bh = bhc / nC;
  const int c = static_cast<int>(bhc % nC);
  const long long b = bh / a.H, h = bh % a.H;
  return ((b * a.S + (long long)c * Q) * a.H + h) * HD;
}

// Stage 1: k, v and logw (then cumw) of the chunk, row by row.
template <int Q, int HD>
constexpr size_t state_smem_bytes() {
  return sizeof(float) * (size_t)(3 * Q * HD);
}

template <int Q, int HD>
__global__ void __launch_bounds__(NTHREADS, 4) wkv6_chunk_state(
    const Args a) {
  constexpr int V4 = HD / 4;
  static_assert(HD <= NTHREADS, "one thread per channel");
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // Q x HD: k, then k~
  float* sV = sK + Q * HD;                        // Q x HD
  float* sW = sV + Q * HD;                        // Q x HD: logw, then cumw

  const int tid = threadIdx.x;
  const long long bhc = blockIdx.x;
  const long long step = (long long)a.H * HD;
  const long long base = chunk_base<Q, HD>(a, bhc);
  for (int i = tid; i < Q * V4; i += NTHREADS) {
    const int t = i / V4, d = (i % V4) * 4;
    const long long off = base + t * step + d;
    *reinterpret_cast<float4*>(sK + t * HD + d) = ldg4(a.k + off);
    *reinterpret_cast<float4*>(sV + t * HD + d) = ldg4(a.v + off);
    *reinterpret_cast<float4*>(sW + t * HD + d) = ldg4(a.logw + off);
  }
  __syncthreads();

  // inclusive cumsum of logw over the chunk, one thread per channel
  if (tid < HD) {
    float acc = 0.f;
    for (int t = 0; t < Q; ++t) {
      acc += sW[t * HD + tid];
      sW[t * HD + tid] = acc;
    }
    a.decay[bhc * HD + tid] = expf(acc);
  }
  __syncthreads();

  const float* wlast = sW + (Q - 1) * HD;
  for (int i = tid; i < Q * HD; i += NTHREADS)
    sK[i] *= expf(wlast[i % HD] - sW[i]);   // k exp(cumw[Q-1] - cumw[j])
  __syncthreads();

  // dS[d][e] = sum_j k~[j][d] v[j][e], a 4 x 4 tile of (d, e) a thread
  float* ds = a.states + bhc * HD * HD;
  for (int it = tid; it < V4 * V4; it += NTHREADS) {
    const int d0 = (it / V4) * 4, e0 = (it % V4) * 4;
    float acc[4][4] = {};
#pragma unroll 8
    for (int j = 0; j < Q; ++j)
      outer4(acc, lds4(sK + j * HD + d0), lds4(sV + j * HD + e0));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ds + (d0 + i) * HD + e0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Stage 2.  Thread (b, h, e) for each run of 4 of the hd x hd state
// elements (16-byte loads and stores, one row d of the state, so one
// decay a_c[d]): states[b, h, c] <- S_in[c] in place, U chunks' loads in
// flight before their stores; the last state to s_out.
__global__ void __launch_bounds__(NTHREADS, 2) wkv6_state_pass(
    float* __restrict__ states, const float* __restrict__ decay,
    const float* __restrict__ s0, float* __restrict__ s_out, int nC, int hd,
    long long total4) {
  constexpr int U = 16;
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= total4) return;
  const int hdd4 = hd * hd / 4;
  const long long bh = i / hdd4;
  const int e4 = static_cast<int>(i % hdd4);
  float4* s = reinterpret_cast<float4*>(states + bh * nC * hd * hd) + e4;
  const float* dec = decay + bh * nC * hd + e4 * 4 / hd;
  float4 acc = s0 ? reinterpret_cast<const float4*>(s0)[i]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nC; c0 += U) {
    float4 v[U];
    float av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c < nC) {
        v[u] = s[(long long)c * hdd4];
        av[u] = dec[(long long)c * hd];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c < nC) {
        s[(long long)c * hdd4] = acc;   // S_in[c], the state entering c
        acc = fma4(av[u], acc, v[u]);   // S_in[c+1] = a_c S_in[c] + dS_c
      }
    }
  }
  reinterpret_cast<float4*>(s_out)[i] = acc;
}

// Stage 3's shared memory: r^T (HD x Q; then r exp(ce)); k^T and cumw^T
// (HD x Q each; once A is done, A^T (Q x Q) and the entering state S_in
// (HD x HD) in their place, Q^2 + HD^2 >= 2 HD Q floats); logw row by row
// (padded to HD+1; then v, Q x HD); beta (Q), u (HD).  The (d, t) arrays
// are swizzled: element (d, t) lies at d*Q + (t ^ swz(d)), which keeps
// each run of 4 t (and pair of t) together and in order, so a float4 over
// t is one load, while the transposing stores and the cumsum's stores
// spread over the banks.
template <int Q, int HD>
__host__ __device__ constexpr int kv_region() {
  return Q * Q + HD * HD;
}

template <int Q, int HD>
constexpr size_t out_smem_bytes() {
  return sizeof(float) *
         (size_t)(HD * Q + kv_region<Q, HD>() + Q * (HD + 1) + Q + HD);
}

template <int Q>
__device__ __forceinline__ int swz(int d) {
  return ((d >> 2) & (Q / 4 - 1)) << 2;
}

// Stage 3, block (b, h, c).  Phases, each ended by a barrier: load r and k
// (transposed) and logw; the cumsum; A, beta and r exp(ce) into registers;
// A^T, beta and r exp(ce) stored, v and S_in loaded in the place of k, cumw
// and logw; y.  A's strict lower triangle is 4 x 2 tiles below the diagonal
// blocks, one a thread (240 at Q = 64), and the diagonal blocks' 6 pairs
// each, two threads a pair (half of d each), while the last Q threads sum
// beta: so no warp runs two different loops over d.
template <int Q, int HD>
__global__ void __launch_bounds__(NTHREADS, 3) wkv6_chunk_out(const Args a) {
  constexpr int G = Q / 4;                  // groups of 4 rows t
  constexpr int REGULAR = G * (G - 1);      // 4 x 2 tiles below the diagonal
  constexpr int DIAG = 2 * 6 * G;           // two threads a diagonal pair
  constexpr int V4 = HD / 4;
  constexpr int LDW = HD + 1;
  constexpr int RD = HD * Q / NTHREADS;     // elements of r exp(ce) a thread
  static_assert(REGULAR <= NTHREADS && DIAG + Q <= NTHREADS, "A's threads");
  static_assert(HD <= NTHREADS && RD >= 1 && HD * Q % NTHREADS == 0,
                "thread counts");
  extern __shared__ float4 smem4[];
  float* sRT = reinterpret_cast<float*>(smem4);   // HD x Q: r, then r exp(ce)
  float* sKT = sRT + HD * Q;                       // HD x Q: k
  float* sCW = sKT + HD * Q;                       // HD x Q: cumw
  float* sAT = sKT;                                // Q x Q: A^T, after A
  float* sS = sKT + Q * Q;                         // HD x HD: S_in, after A
  float* sW = sKT + kv_region<Q, HD>();            // Q x LDW: logw
  float* sV = sW;                                  // Q x HD: v, after A
  float* sBeta = sW + Q * LDW;                     // Q
  float* sU = sBeta + Q;                           // HD

  const int tid = threadIdx.x;
  const long long bhc = blockIdx.x;
  const long long step = (long long)a.H * HD;
  const long long base = chunk_base<Q, HD>(a, bhc);
  const int h = static_cast<int>((bhc / (a.S / Q)) % a.H);
  const float* s_in = a.states + bhc * HD * HD;
  // r and k transposed, logw row by row: lanes along d, one float4 each
  for (int i = tid; i < Q * V4; i += NTHREADS) {
    const int t = i / V4, d = (i % V4) * 4;
    const long long off = base + t * step + d;
    const float4 rr = ldg4(a.r + off), kk = ldg4(a.k + off),
                 ww = ldg4(a.logw + off);
    const int ts = t ^ swz<Q>(d);
    const float r4[4] = {rr.x, rr.y, rr.z, rr.w};
    const float k4[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      sRT[(d + m) * Q + ts] = r4[m];
      sKT[(d + m) * Q + ts] = k4[m];
    }
    float* pw = sW + t * LDW + d;
    pw[0] = ww.x; pw[1] = ww.y; pw[2] = ww.z; pw[3] = ww.w;
  }
  for (int d = tid; d < HD; d += NTHREADS) sU[d] = a.u[h * HD + d];
  __syncthreads();

  // inclusive cumsum of logw over the chunk, one thread per channel
  if (tid < HD) {
    float acc = 0.f;
    float* cw = sCW + tid * Q;
    const int s = swz<Q>(tid);
    for (int t = 0; t < Q; ++t) {
      acc += sW[t * LDW + tid];
      cw[t ^ s] = acc;
    }
  }
  __syncthreads();

  // the 4 x 2 tile of A of thread p < REGULAR: rows t0..t0+3 of group g,
  // columns j0, j0+1 < t0
  float acc[4][2] = {};
  int t0 = 0, j0 = 0;
  if (tid < REGULAR) {
    int g = static_cast<int>((1.f + sqrtf(1.f + 4.f * (float)tid)) * 0.5f);
    while (g * (g - 1) > tid) --g;
    while ((g + 1) * g <= tid) ++g;
    t0 = 4 * g;
    j0 = 2 * (tid - g * (g - 1));
    // 4 rows d share their swizzle: one address each per 4 d
    for (int d4 = 0; d4 < HD; d4 += 4) {
      const int s = swz<Q>(d4);
      const float* pr = sRT + d4 * Q + (t0 ^ s);
      const float* pt = sCW + d4 * Q + (t0 ^ s);
      const float* pp = sCW + d4 * Q + ((t0 - 4) ^ s);
      const float* pk = sKT + d4 * Q + (j0 ^ s);
      const float* pc = sCW + d4 * Q + (j0 ^ s);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 rr = lds4(pr + m * Q), wt = lds4(pt + m * Q),
                     wp = lds4(pp + m * Q);
        const float2 kk = lds2(pk + m * Q), cw = lds2(pc + m * Q);
        const float r4[4] = {rr.x, rr.y, rr.z, rr.w};
        const float c4[4] = {wp.w, wt.x, wt.y, wt.z};   // ce = cumw[t-1]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(r4[i] * kk.x, expf(c4[i] - cw.x), acc[i][0]);
          acc[i][1] = fmaf(r4[i] * kk.y, expf(c4[i] - cw.y), acc[i][1]);
        }
      }
    }
  }
  // a pair j < t of a diagonal block (t0 = 4 * (q / 6)), half of d a
  // thread; the last Q threads sum beta[t] = r[t].(u o k[t])
  float part = 0.f;
  const int q = tid / 2, half = tid % 2, tb = 4 * (q / 6), k = q % 6;
  const int ot = 1 + (k >= 1) + (k >= 3), oj = k - ot * (ot - 1) / 2;
  const int dt = tb + ot, dj = tb + oj;   // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
  if (tid < DIAG) {
#pragma unroll 4
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) {
      const int s = swz<Q>(d);
      part = fmaf(sRT[d * Q + (dt ^ s)] * sKT[d * Q + (dj ^ s)],
                  expf(sCW[d * Q + ((dt - 1) ^ s)] - sCW[d * Q + (dj ^ s)]),
                  part);
    }
  } else if (tid < DIAG + Q) {
    const int t = tid - DIAG;
    for (int d = 0; d < HD; ++d) {
      const int i = d * Q + (t ^ swz<Q>(d));
      part = fmaf(sRT[i], sU[d] * sKT[i], part);
    }
  }
  const float other = __shfl_xor_sync(0xffffffffu, part, 1);
  if (tid < DIAG) part += other;
  // r exp(ce) for RD elements (d, t), stored once every thread has read r
  float rd[RD];
#pragma unroll
  for (int m = 0; m < RD; ++m) {
    const int i = tid + m * NTHREADS, t = i % Q, d = i / Q, s = swz<Q>(d);
    rd[m] = sRT[d * Q + (t ^ s)] *
            expf(t ? sCW[d * Q + ((t - 1) ^ s)] : 0.f);
  }
  __syncthreads();   // every thread has read r^T, k^T and cumw^T

  if (tid < REGULAR) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      sts4(sAT + (j0 + jj) * Q + t0, acc[0][jj], acc[1][jj], acc[2][jj],
           acc[3][jj]);
  }
  if (tid < DIAG) {
    // half 0 stores A[dt][dj]; half 1 a 0 of the block's upper part,
    // A^T[j][t] for t <= j, j = t0..t0+2, and pair 0 zeros row t0+3
    if (half == 0) sAT[dj * Q + dt] = part;
    else sAT[(dt - 1) * Q + dj] = 0.f;
    if (k == 0 && half == 1) sts4(sAT + (tb + 3) * Q + tb, 0.f, 0.f, 0.f, 0.f);
  } else if (tid < DIAG + Q) {
    sBeta[tid - DIAG] = part;
  }
#pragma unroll
  for (int m = 0; m < RD; ++m) {
    const int i = tid + m * NTHREADS, t = i % Q, d = i / Q;
    sRT[d * Q + (t ^ swz<Q>(d))] = rd[m];
  }
  for (int i = tid; i < Q * V4; i += NTHREADS) {
    const int t = i / V4, d = (i % V4) * 4;
    *reinterpret_cast<float4*>(sV + t * HD + d) =
        ldg4(a.v + base + t * step + d);
  }
  for (int i = tid; i < HD * V4; i += NTHREADS)
    *reinterpret_cast<float4*>(sS + i * 4) = ldg4(s_in + i * 4);
  __syncthreads();

  // y[t][e] for a 4 x 4 tile of (t, e) a thread
  for (int it = tid; it < G * V4; it += NTHREADS) {
    const int tr = (it / V4) * 4, e0 = (it % V4) * 4;
    float out[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bt = sBeta[tr + i];   // the bonus r[t].(u o k[t])
      const float4 vt = lds4(sV + (tr + i) * HD + e0);
      out[i][0] = bt * vt.x; out[i][1] = bt * vt.y;
      out[i][2] = bt * vt.z; out[i][3] = bt * vt.w;
    }
    // A[t][j] = 0 for j >= t: the tile's rows need j < tr + 4
#pragma unroll 4
    for (int j = 0; j < tr + 4; ++j)
      outer4(out, lds4(sAT + j * Q + tr), lds4(sV + j * HD + e0));
#pragma unroll 8
    for (int d = 0; d < HD; ++d)
      outer4(out, lds4(sRT + d * Q + (tr ^ swz<Q>(d))),
             lds4(sS + d * HD + e0));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(a.y + base + (tr + i) * step + e0) =
          make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
  }
}

template <typename K>
cudaError_t opt_in(K* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int Q, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const int nC = a.S / Q;
  const unsigned blocks = static_cast<unsigned>(a.B * a.H * nC);
  const long long total4 = (long long)a.B * a.H * HD * HD / 4;
  const size_t smem1 = state_smem_bytes<Q, HD>();
  const size_t smem3 = out_smem_bytes<Q, HD>();
  cudaError_t err = opt_in(wkv6_chunk_state<Q, HD>, smem1);
  if (err == cudaSuccess) err = opt_in(wkv6_chunk_out<Q, HD>, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_chunk_state<Q, HD><<<blocks, NTHREADS, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv6_state_pass<<<static_cast<unsigned>((total4 + NTHREADS - 1) / NTHREADS),
                    NTHREADS, 0, stream>>>(a.states, a.decay, a.s0, a.s_out,
                                           nC, HD, total4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv6_chunk_out<Q, HD><<<blocks, NTHREADS, smem3, stream>>>(a);
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

// s0 may be null (zero initial state).  states (B, H, S/q, hd, hd) and
// decay (B, H, S/q, hd) are fp32 scratch; after the call states holds the
// state entering each chunk.  Three launches on the stream; returns
// cudaGetLastError() after the last (0 on success) or the first error.
extern "C" int wkv6_fwd_f32(const float* r, const float* k, const float* v,
                            const float* logw, const float* u, const float* s0,
                            float* y, float* s_out, float* states, float* decay,
                            int B, int S, int H, int hd, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || q <= 0 || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, logw, u, s0, y, s_out, states, decay, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32) return launch_q<32>(a, q, st);
  if (hd == 64) return launch_q<64>(a, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
