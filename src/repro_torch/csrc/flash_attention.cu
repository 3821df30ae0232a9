// Causal, windowed, soft-capped flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (launched by
// `flash_attention_pallas`), and computes the function of the JAX model's
// blockwise `flash_attention` in src/repro/models/attention.py.
//
// Function: o[b,s,h] = softmax_t(mask(softcap(scale * q[b,s,h] . k[b,t,g])))
// . v[b,t,g] with g = h / (Hq / G) (GQA without building the expanded K/V),
// mask = (t <= s) && (window <= 0 || s - t < window) && (t < T).
// m, l and the accumulator are fp32; Q.K^T accumulates in fp32 from the
// input-typed operands; P.V uses fp32 P and fp32 V.  Inputs are bf16 or fp32,
// addressed by strides (last dim contiguous); the output has q's type.
//
// What bounds it on an H100: at gemma2-2b's prefill shape (head_dim 256,
// S ~ 4k) the work is ~2*S^2*hd FLOPs per head against ~4*S*hd bytes, far
// above the card's ~295 FLOP/byte ridge, so it is bound by operations.
// This first version does them as fp32 FMAs on the CUDA cores (no tensor
// cores), so its own ceiling is the fp32 rate, not the bf16 tensor rate:
// wgmma/TMA are later work.  What the design does about the bound:
//   * one block per (64-query tile, q head, batch row) loops over only the
//     32-key tiles inside the causal and window band (the Pallas kernel's
//     `pl.when(needed)` skip); the heaviest (last) query tiles launch first;
//   * Q for the tile and one K and V tile live in shared memory as fp32
//     (132 KB at head_dim 256, above 48 KB, so the launch opts in);
//   * each warp owns 8 query rows; a lane owns one key column of the scores
//     and ceil(head_dim/32) output columns (lane + 32c < head_dim: at head
//     dim 80 the third column exists on lanes 0-15 only), so softmax
//     statistics are warp shuffles and the accumulator stays in registers;
//   * K rows are padded to head_dim+4 floats so the float4 reads of the
//     score loop are free of bank conflicts;
//   * tiles move in 16-byte loads staged in registers, and the next K/V
//     tile's loads are issued before the current tile is computed, so
//     their latency overlaps the arithmetic (a 16-byte-aligned base and
//     strides are required; the wrapper checks).
// A query row with no allowed key (not reachable on the causal path) writes
// zeros, guarded by max(l, 1e-37) as in the Pallas kernel.
// Head dims 32, 64, 80 (zamba2-2.7b's shared block), 128 and 256.  Training
// differentiates the plain blockwise version recomputed from q, k and v
// (kernels/flash_attention/ops.py): this file is the forward only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;   // query rows per warp
constexpr float NEG_INF = -2.0e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, Hq, G;
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long osb, oss, osh;
  float scale, softcap;
  int window;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// An (NROWS x HD) tile of T moved from global memory to registers in 16-byte
// pieces (all loads issued before any is used), then to shared memory as
// fp32 with row stride `ld`.  Rows at or past `n_rows` read as zeros.
template <typename T, int HD, int NROWS>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = HD / VEC;
  static constexpr int TOTAL = NROWS * PER_ROW;
  static constexpr int ITERS = (TOTAL + NTHREADS - 1) / NTHREADS;
  uint4 r[ITERS];

  __device__ __forceinline__ void load(const T* base, long long row_stride,
                                       int row0, int n_rows, int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int row = idx / PER_ROW, c = idx % PER_ROW;
      r[it] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < TOTAL && row0 + row < n_rows)
        r[it] = *reinterpret_cast<const uint4*>(
            base + (long long)(row0 + row) * row_stride + c * VEC);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int tid) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * NTHREADS;
      if (idx >= TOTAL) continue;
      const int row = idx / PER_ROW, c = idx % PER_ROW;
      float f[VEC];
      unpack(r[it], f);
      float4* p = reinterpret_cast<float4*>(dst + row * ld + c * VEC);
#pragma unroll
      for (int v = 0; v < VEC / 4; ++v)
        p[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
    }
  }
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 4) + BK * (HD + 4) + BK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_fwd(const Args a) {
  constexpr int LD = HD + 4;     // padded row stride of sQ and sK
  constexpr int DPL = (HD + 31) / 32;   // output columns per lane, the
                                        // last one guarded by lane + 32c < HD
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // BQ x LD
  float* sK = sQ + BQ * LD;                       // BK x LD
  float* sV = sK + BK * LD;                       // BK x HD

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // late tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.Hq / a.G);

  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + g * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + g * a.vsh;
  T* op = static_cast<T*>(a.o) + b * a.osb + h * a.osh;

  {
    Tile<T, HD, BQ> qt;
    qt.load(qp, a.qss, q0, a.S, tid);
    qt.store(sQ, LD, tid);
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // The band of keys any row of this tile may see.
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_end = min(q_last + 1, a.T);
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int row0 = q0 + warp * ROWS;

  // K/V tiles pass through registers: the next tile's loads are issued
  // before the current tile is computed, so they are in flight meanwhile.
  Tile<T, HD, BK> kt, vt;
  int k0 = (k_first / BK) * BK;
  if (k0 < k_end) {
    kt.load(kp, a.kss, k0, a.T, tid);
    vt.load(vp, a.vss, k0, a.T, tid);
  }
  for (; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    kt.store(sK, LD, tid);
    vt.store(sV, HD, tid);
    __syncthreads();
    if (k0 + BK < k_end) {
      kt.load(kp, a.kss, k0 + BK, a.T, tid);
      vt.load(vp, a.vss, k0 + BK, a.T, tid);
    }

    // Scores: lane = key column, one value for each of the warp's rows.
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(sK + lane * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(sQ + (warp * ROWS + r) * LD)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax; s[r] becomes the row's probability for this lane's key.
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = row0 + r;
      const bool ok = kpos < a.T && kpos <= qpos &&
                      (a.window <= 0 || qpos - kpos < a.window);
      float x = s[r] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }

    // acc[r][c] += sum_j p[r][j] * V[j][lane + 32c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        vv[c] = lane + 32 * c < HD ? sV[j * HD + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = row0 + r;
    if (qpos >= a.S) continue;
    const float den = fmaxf(l[r], 1e-37f);
    T* orow = op + (long long)qpos * a.oss;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < HD) orow[lane + 32 * c] = from_f<T>(acc[r][c] / den);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd<T, HD><<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int hd,
    int B, int S, int T, int Hq, int G,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || G <= 0 || Hq % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, B, S, T, Hq, G,
               qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
               scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
