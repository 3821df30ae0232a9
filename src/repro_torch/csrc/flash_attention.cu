// Causal or non-causal, windowed, soft-capped flash attention forward for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (launched by
// `flash_attention_pallas`), and computes the function of the JAX model's
// blockwise `flash_attention` in src/repro/models/attention.py.
//
// Function: o[b,s,h] = softmax_t(mask(softcap(scale * q[b,s,h] . k[b,t,g])))
// . v[b,t,g] with g = h / (Hq / G) (GQA without building the expanded K/V),
// mask = (!causal || t <= s) && (window <= 0 || s - t < window) && (t < T),
// the Pallas kernel's; the key length T may differ from the query length S
// (whisper's cross-attention: S decoder tokens against T = 1500 frames,
// causal = 0).  causal and window are runtime values, so every layer of a
// model shares one compiled kernel.  m, l and the accumulator are fp32;
// Q.K^T accumulates in fp32 from the input-typed operands; P.V multiplies
// fp32 P by V (the JAX default), or, with probs_bf16, P rounded to V's type
// (the JAX model's `probs_bf16` knob; only the bf16 route rounds: fp32 P is
// already V's type).  Inputs are bf16 or fp32, addressed by strides (last
// dim contiguous, 16-byte-aligned rows); the output has q's type.  Head dims
// 32, 64, 80 (zamba2-2.7b's shared block), 128 and 256 (gemma2-2b) for q, k
// and v alike, and q/k head dim 192 with v head dim 128 (DeepSeek-V2's MLA:
// 128 no-rope + 64 rope dims against 128 value dims).  V is staged at its
// own head dim, never padded to q's: padding would spend a third of the
// 192/128 pair's P.V products on zeros.
//
// What bounds it on an H100: at gemma2-2b's prefill shape (head_dim 256,
// S ~ 4k) the work is ~4*hd FLOPs per allowed (query, key) pair against
// ~4*S*hd bytes per head, far above the card's ~295 FLOP/byte ridge, so it
// is bound by operations: in bf16 by the tensor cores' 989 TFLOP/s.
//
// Two kernels, chosen by the input type:
//
// * bf16: `flash_fwd_tc`, on the tensor cores (sm90.cuh).  A block of two
//   warpgroups owns 128 query rows (64 each) of one (batch row, q head) and
//   walks the 64-key tiles inside the band (all T keys when not causal,
//   less those below the window; the Pallas kernel's `pl.when(needed)`
//   skip; a warpgroup skips a tile none of its rows sees); the heaviest
//   (last) query tiles launch first (neutral when not causal).
//   - Q is copied once; K/V tiles go through a ring of 2 shared-memory
//     stages by 16-byte cp.async (zero fill past T), the next tile's copy in
//     flight while the current one is computed (a third stage was slower
//     on an H100 at every head dim).  Up to hd 80 registers are held to 128
//     a thread so that two blocks share an SM and one's softmax overlaps
//     the other's wgmma; hd 256 has one block an SM.  Shared memory stays
//     bf16, in 64-wide swizzled panels: head dim 80 is padded to two panels
//     (128) and head dim 32 to one (64); no wgmma spans the padding, so it
//     is never read or cleared (Q.K^T stops at k-step hd/16, P.V's N is
//     hd_v).  Padding, not a 32-byte swizzle, keeps one layout and one
//     descriptor scheme for every head dim; it costs shared memory only.
//     hd 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB, one block an SM;
//     192/128: Q 48 KB + 2 x (K 24 KB + V 16 KB) = 129 KB, one block an SM
//     (Q.K^T runs 12 k-steps over 3 panels, P.V an n128 wgmma).
//   - S = Q.K^T: wgmma m64n64k16 per 16 of head dim, Q (A) and K (B) both
//     K-major from shared memory, fp32 accumulators (bf16 products are
//     exact in fp32, as in the Pallas kernel's fp32 dot).
//   - scale, softcap (cap * tanhf(x * (1/cap)): the accurate tanh, since
//     tanh.approx's ~2^-11 relative error is ~0.025 of a logit at cap 50;
//     multiplying by 1/cap, not dividing by cap, moves the argument by an
//     ulp at most and spares an IEEE division per score), the mask (only
//     on tiles that cross an edge of the band or of T) and the online
//     softmax run on the accumulator registers in fp32; exp as
//     exp2f((x - m) * log2 e); l is summed per thread and reduced over the
//     row's 4 lanes once at the end; beyond hd 80, O is rescaled only when
//     a row's max moved.  Softmax and wgmma of one warpgroup do not
//     overlap, and the two warpgroups of a block meet at a barrier every
//     key tile: at hd 256, where one block fills an SM, the tensor cores
//     idle while both warpgroups run their softmax (what bounds this
//     version).
//   - P.V with fp32 P on bf16 tensor cores: P = P_hi + P_lo with P_hi =
//     bf16(P) and P_lo = bf16(P - P_hi), each multiplied by V (two wgmma
//     m64n{hd_v}k16 per 16 keys, A from registers, V as an MN-major B operand
//     from shared memory, transpose bit set).  P_hi + P_lo carries 16
//     significant bits of P: ~1e-6 beyond one bf16 rounding of the result,
//     where P_hi alone is ~2e-3 off and P rounded to TF32 ~5e-4 (tolerance
//     1e-5; tests/test_torch_flash_attention_tc.py emulates all three).
//     With probs_bf16 the P_lo . V wgmma is skipped: bf16(P) is P_hi.
//   - Register layouts: the S accumulator of thread t holds, for key group
//     j (8 keys), s[4j], s[4j+1] at row r = 16 (t/32) + (t%32)/4, keys
//     8j + 2 (t%4) + {0,1}, and s[4j+2], s[4j+3] at row r + 8.  The A
//     fragment of the P.V k-step kt (keys 16kt .. 16kt+15) wants row r keys
//     2 (t%4) + {0,1}, row r + 8 the same, then both 8 keys further: that
//     is s[8kt .. 8kt+7] in order, so the conversion is a pairwise pack of
//     s[8kt+2i], s[8kt+2i+1] into register i, with no data movement
//     between threads.
//   - O (64 x hd fp32 per warpgroup) stays in registers: 128 a thread at
//     hd 256, with S (32) and the split P (32).
//
// * fp32: `flash_fwd_cuda_cores`, the first version's kernel (with the causal
//   flag since):
//   exact fp32 FMAs on the CUDA cores (tensor cores would round fp32 inputs
//   to TF32).  No bf16 path runs it; it serves fp32 callers such as the
//   fp32 training-step check.  One block per (64-query tile, q head, batch
//   row) over the 32-key tiles of the band; Q, K and V as fp32 in shared
//   memory (132 KB at hd 256); each warp owns 8 query rows, a lane one key
//   column of the scores and ceil(hd/32) output columns; K rows padded to
//   hd+4 floats; the next K/V tile's 16-byte loads issued before the
//   current tile is computed.
//
// A query row with no allowed key (reachable without causal and with a
// window, where s - (T - 1) >= window) writes zeros, guarded by max(l,
// 1e-37) as in the Pallas kernel.  Training differentiates the plain
// blockwise version recomputed from q, k and v
// (kernels/flash_attention/ops.py): this file is the forward only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


#include "common.cuh"
#include "sm90.cuh"

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
  int causal;       // 0: every key t < T may be seen
  int probs_bf16;   // bf16 route: P rounded to bf16 before P.V
};

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

// An (NROWS x HD) fp32 tile moved from global memory to registers in 16-byte
// pieces (all loads issued before any is used), then to shared memory as
// fp32 with row stride `ld`.  Rows at or past `n_rows` read as zeros.
template <int HD, int NROWS>
struct Tile {
  static constexpr int VEC = 4;
  static constexpr int PER_ROW = HD / VEC;
  static constexpr int TOTAL = NROWS * PER_ROW;
  static constexpr int ITERS = (TOTAL + NTHREADS - 1) / NTHREADS;
  uint4 r[ITERS];

  __device__ __forceinline__ void load(const float* base, long long row_stride,
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

template <int HD, int DV = HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 4) + BK * (HD + 4) + BK * DV);
}

// HD: q/k head dim; DV: v head dim (and the output's)
template <int HD, int DV = HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_cuda_cores(const Args a) {
  constexpr int LD = HD + 4;     // padded row stride of sQ and sK
  constexpr int DPL = (DV + 31) / 32;   // output columns per lane, the
                                        // last one guarded by lane + 32c < DV
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // BQ x LD
  float* sK = sQ + BQ * LD;                       // BK x LD
  float* sV = sK + BK * LD;                       // BK x DV

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // late tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.Hq / a.G);

  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + g * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + g * a.vsh;
  float* op = static_cast<float*>(a.o) + b * a.osb + h * a.osh;

  {
    Tile<HD, BQ> qt;
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
  const int k_end = a.causal ? min(q_last + 1, a.T) : a.T;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int row0 = q0 + warp * ROWS;

  // K/V tiles pass through registers: the next tile's loads are issued
  // before the current tile is computed, so they are in flight meanwhile.
  Tile<HD, BK> kt;
  Tile<DV, BK> vt;
  int k0 = (k_first / BK) * BK;
  if (k0 < k_end) {
    kt.load(kp, a.kss, k0, a.T, tid);
    vt.load(vp, a.vss, k0, a.T, tid);
  }
  for (; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    kt.store(sK, LD, tid);
    vt.store(sV, DV, tid);
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
      const bool ok = kpos < a.T && (!a.causal || kpos <= qpos) &&
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
        vv[c] = lane + 32 * c < DV ? sV[j * DV + lane + 32 * c] : 0.f;
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
    float* orow = op + (long long)qpos * a.oss;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < DV) orow[lane + 32 * c] = acc[r][c] / den;
  }
}

template <int HD, int DV>
int launch_cuda_cores(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_cuda_cores<HD, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_cuda_cores<HD, DV><<<grid, NTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16, tensor cores --

namespace tc {

constexpr int BQ = 128;        // query rows per block: two warpgroups
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// HD: q/k head dim; DV: v head dim (and the output's)
template <int HD, int DV = HD>
struct Shape {
  static constexpr int PANELS = (HD + 63) / 64;   // 64-wide panels of Q, K
  static constexpr int V_PANELS = (DV + 63) / 64;  // and of V
  // K/V ring depth: 2 (3 measured slower at every head dim), and two
  // blocks an SM where registers allow (up to hd 80: 128 a thread), so one
  // block's softmax overlaps the other's wgmma
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = HD <= 80 ? 2 : 1;
  static constexpr int Q_BYTES = PANELS * BQ * 128;
  static constexpr int K_BYTES = PANELS * BK * 128;    // one K tile
  static constexpr int V_BYTES = V_PANELS * BK * 128;  // one V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr size_t SMEM =
      Q_BYTES + STAGES * STAGE_BYTES + 1024;           // + alignment slack
};

// Rows row0 .. row0+NROWS-1 of a (rows, HD) bf16 matrix with row stride
// `ld` (elements) into swizzled panels of NROWS rows at `dst`, by 16-byte
// cp.async; rows at or past n_rows are zero-filled.
template <int HD, int NROWS>
__device__ __forceinline__ void load_rows(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0,
                                          int n_rows) {
  constexpr int CPR = HD / 8;   // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < NROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < n_rows;
    sm90::cp_async16(dst + (c / 8) * (NROWS * 128) + sm90::swizzled(r, c % 8),
                     ok ? src + (row0 + r) * ld + c * 8 : src, ok);
  }
}

__device__ __forceinline__ __nv_bfloat16 out_bf16(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// fp32 P as P_hi + P_lo, two registers of bf16 pairs each.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  hi = sm90::pack_bf16(p0, p1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = sm90::pack_bf16(p0 - h.x, p1 - h.y);
}

// O += P_hi . V + P_lo . V over one key tile (P_hi . V alone with
// probs_bf16, a value uniform over the block): A (P) from registers, V as
// an MN-major B operand from shared memory.  HD here is V's head dim.
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        uint32_t (&phi)[BK / 16][4],
                                        uint32_t (&plo)[BK / 16][4],
                                        const uint8_t* sV, bool probs_bf16) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    const uint64_t dv = sm90::desc(sV + kt * 2048, BK * 128, 1024);
    sm90::wgmma_rs<HD, 1>(o, phi[kt], dv, 1);
    if (!probs_bf16) sm90::wgmma_rs<HD, 1>(o, plo[kt], dv, 1);   // P_lo . V
  }
}

template <int HD, int DV>
__global__ void __launch_bounds__(THREADS, Shape<HD, DV>::MIN_BLOCKS)
flash_fwd_tc(const Args a) {
  using Sh = Shape<HD, DV>;
  constexpr int NS = BK / 2;    // S accumulators a thread
  constexpr int NO = DV / 2;    // O accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = sm90::align1024(smem_raw);
  uint8_t* sKV = sQ + Sh::Q_BYTES;   // stage s: K, then V

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // late tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.Hq / a.G);
  const auto* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb
                   + h * a.qsh;
  const auto* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb
                   + g * a.ksh;
  const auto* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb
                   + g * a.vsh;
  auto* op = static_cast<__nv_bfloat16*>(a.o) + b * a.osb + h * a.osh;

  // The band of key tiles any row of the block may see (none when the
  // window leaves every row without a key: n_tiles <= 0).
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_end = a.causal ? min(q_last + 1, a.T) : a.T;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int j0 = k_first / BK;
  const int n_tiles = (k_end + BK - 1) / BK - j0;

  // Q and the first STAGES - 1 K/V tiles, one commit group per tile
  load_rows<HD, BQ>(sQ, qp, a.qss, q0, a.S);
#pragma unroll
  for (int s = 0; s < Sh::STAGES - 1; ++s) {
    if (s < n_tiles) {
      uint8_t* dst = sKV + s * Sh::STAGE_BYTES;
      load_rows<HD, BK>(dst, kp, a.kss, (j0 + s) * BK, a.T);
      load_rows<DV, BK>(dst + Sh::K_BYTES, vp, a.vss, (j0 + s) * BK, a.T);
    }
    sm90::cp_async_commit();
  }

  // This warpgroup's rows wq0 .. wq_last; this thread's rows r0, r0 + 8
  // and first key column cq of each group of 8.
  const int wq0 = q0 + wg * 64;
  const int wq_last = min(wq0 + 63, a.S - 1);
  const int r0 = wq0 + (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const float cap = a.softcap, inv_cap = 1.f / cap;   // used if cap > 0

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (j0 + it) * BK;
    // the tile STAGES - 1 ahead goes into the stage tile it - 1 left
    const int nxt = it + Sh::STAGES - 1;
    if (nxt < n_tiles) {
      uint8_t* dst = sKV + (nxt % Sh::STAGES) * Sh::STAGE_BYTES;
      load_rows<HD, BK>(dst, kp, a.kss, (j0 + nxt) * BK, a.T);
      load_rows<DV, BK>(dst + Sh::K_BYTES, vp, a.vss, (j0 + nxt) * BK, a.T);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<Sh::STAGES - 1>();   // tile it has landed
    sm90::fence_proxy_async();
    __syncthreads();
    const uint8_t* sK = sKV + (it % Sh::STAGES) * Sh::STAGE_BYTES;
    const uint8_t* sV = sK + Sh::K_BYTES;
    const bool seen = wq0 < a.S && (!a.causal || k0 <= wq_last) &&
                      (a.window <= 0 || k0 + BK - 1 > wq0 - a.window);
    if (seen) {
      // S = Q . K^T
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss<BK, 0, 0>(
            s,
            sm90::desc(sQ + (kk / 4) * BQ * 128 + wg * 64 * 128
                       + (kk % 4) * 32, 16, 1024),
            sm90::desc(sK + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
            1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // Softcap, mask, online softmax; s becomes P.
      // no row of the warpgroup has a key of this tile masked: it lies
      // below the diagonal (or nothing is causal), inside T and the window
      const bool inside = (!a.causal || k0 + BK - 1 <= wq0) &&
                          k0 + BK <= a.T &&
                          (a.window <= 0 || wq_last - k0 < a.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hh = (i / 2) % 2;
        float x = s[i] * a.scale;
        if (cap > 0.f) x = cap * tanhf(x * inv_cap);
        if (!inside) {
          const int kpos = k0 + 8 * (i / 4) + cq + i % 2;
          const int qpos = r0 + 8 * hh;
          const bool ok = kpos < a.T && (!a.causal || kpos <= qpos) &&
                          (a.window <= 0 || qpos - kpos < a.window);
          x = ok ? x : NEG_INF;
        }
        s[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 2));
        alpha[hh] = exp2f((m[hh] - mx[hh]) * LOG2E);
        m[hh] = mx[hh];
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hh = (i / 2) % 2;
        const float p = s[i] == NEG_INF ? 0.f
                                        : exp2f((s[i] - m[hh]) * LOG2E);
        l[hh] += p;
        s[i] = p;
      }
      // Rescale O only when a row's max moved, except under the 128-register
      // cap of two blocks an SM, where the branch costs a spill.
      if (Sh::MIN_BLOCKS > 1 || alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
      }

      // O += P_hi . V + P_lo . V (P_hi . V with probs_bf16)
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_p(s[8 * kt + 2 * r], s[8 * kt + 2 * r + 1], phi[kt][r],
                  plo[kt][r]);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      pv_tile<DV>(o, phi, plo, sV, a.probs_bf16 != 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        sm90::fence_regs(phi[kt]);
        sm90::fence_regs(plo[kt]);
      }
    }
    __syncthreads();   // this stage is free for tile it + STAGES
  }
  // Q's copy is still in flight where the band holds no tile
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
    const int qpos = r0 + 8 * hh;
    if (qpos >= a.S) continue;
    const float den = fmaxf(l[hh], 1e-37f);
    __nv_bfloat16* orow = op + qpos * a.oss + cq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      __nv_bfloat162 v;
      v.x = out_bf16(o[4 * j + 2 * hh] / den);
      v.y = out_bf16(o[4 * j + 2 * hh + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = v;
    }
  }
}

template <int HD, int DV>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Shape<HD, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_tc<HD, DV><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int HD_, int DV_ = HD_>
struct Dims {
  static constexpr int HD = HD_, DV = DV_;
};

// fn(Dims<hd, hd_v>) for a (q/k, v) head-dim pair the kernels take: one
// head dim for all three, or MLA's 192/128.
template <typename Fn>
int with_hd(int hd, int hd_v, Fn&& fn) {
  if (hd == 192 && hd_v == 128) return fn(Dims<192, 128>());
  if (hd != hd_v) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return fn(Dims<32>());
    case 64: return fn(Dims<64>());
    case 80: return fn(Dims<80>());
    case 128: return fn(Dims<128>());
    case 256: return fn(Dims<256>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The kernel a launch of this type and head-dim pair takes (hd: q and k,
// hd_v: v and the output): out[0] route (0 fp32 on the CUDA cores, 1 bf16
// on the tensor cores), out[1] query rows and out[2] keys per tile, out[3]
// K/V stages in shared memory, out[4] threads a block, out[5] dynamic
// shared memory bytes.  Returns 0, or cudaErrorInvalidValue for a type or
// head-dim pair the kernels do not take.
extern "C" int flash_attention_route(int dtype, int hd, int hd_v, int* out) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_hd(hd, hd_v, [&](auto c) {
    constexpr int HD = decltype(c)::HD, DV = decltype(c)::DV;
    const int tc_v[6] = {1, tc::BQ, tc::BK, tc::Shape<HD, DV>::STAGES,
                         tc::THREADS,
                         static_cast<int>(tc::Shape<HD, DV>::SMEM)};
    const int cc_v[6] = {0, BQ, BK, 1, NTHREADS,
                         static_cast<int>(smem_bytes<HD, DV>())};
    for (int i = 0; i < 6; ++i) out[i] = dtype == 1 ? tc_v[i] : cc_v[i];
    return 0;
  });
}

// dtype: 0 = float32, 1 = bfloat16.  hd: q/k head dim; hd_v: v's and the
// output's.  Strides are in elements.  window <= 0: no window; causal 0:
// no causal mask; probs_bf16 1: P rounded to bf16 before P.V (bf16 only:
// the fp32 route's P is already V's type, so it changes nothing there).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int hd,
    int hd_v, int B, int S, int T, int Hq, int G,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, float softcap, int window, int causal, int probs_bf16,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || G <= 0 || Hq % G != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, B, S, T, Hq, G,
               qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
               scale, softcap, window, causal != 0, probs_bf16 != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_hd(hd, hd_v, [&](auto c) {
    constexpr int HD = decltype(c)::HD, DV = decltype(c)::DV;
    return dtype == 1 ? tc::launch<HD, DV>(a, st)
                      : launch_cuda_cores<HD, DV>(a, st);
  });
}
