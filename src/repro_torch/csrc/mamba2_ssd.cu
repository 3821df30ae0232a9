// Chunked Mamba2 SSD scan for Hopper (sm_90a), n_groups == 1: the forward
// and its gradient.
//
// The forward replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/mamba2_ssd/kernel.py (launched by `ssd_pallas`) and
// computes the function of the JAX model's chunk step `_ssd_chunk`
// (src/repro/models/mamba2.py) scanned over the chunks, as the oracle
// `ssd_ref` does: from a given initial state (or 0), Y and the final state.
//
// Function, for each batch row b and head h, over chunks of Q steps, with
// cum[t] = sum_{s<=t} dA[s] within the chunk, E[t] = exp(cum[t]),
// D[j] = exp(cum[Q-1] - cum[j]), L[t][j] = exp(cum[t] - cum[j]) for j <= t
// (else 0), G = C.B^T, M = G o L and S_in the state entering the chunk:
//   Y[t]    = sum_j M[t][j] x[j] + E[t] S_in C[t]
//   S_out   = E[Q-1] S_in + sum_j D[j] x[j] B[j]^T
// with x = xdt (B, S, H, hd), dA (B, S, H), B and C (B, S, N) (the one
// group), all of one type T (float or bf16), the states (hd x N) fp32;
// arithmetic in fp32; Y (B, S, H, hd) in T.  S % Q == 0 (the caller pads).
//
// The backward (`mamba2_ssd_bwd`) computes dx, d(dA), dB and dC from dY.
// The JAX package has no backward kernel: its training differentiates the
// scan of `_ssd_chunk`, and so the port's plain version, `ssd_chunked_bwd`
// (kernels/mamba2_ssd/ref.py), writes that gradient out chunk by chunk.
// With dS the cotangent of the state leaving a chunk (0 after the last):
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
// What bounds them on an H100, at zamba2-2.7b's training shape (B 2, S
// 1024, H 80, hd 64, N 64, Q 64; chip_smoke.py's ssd_bound and
// ssd_bwd_bound count the work): the forward needs ~3.4e9 fp32 FLOPs (C.B^T
// once for all heads, M.x over the lower triangle, C.S_in and the state
// walk) against ~86 MB of inputs and Y, 0.051 ms at 67 TFLOP/s against
// 0.026 ms at 3.35 TB/s; the backward ~9.7e9 FLOPs against ~0.13 GB, 0.14
// ms against 0.04.  Both are bound by operations at the fp32 rate, and by
// bytes once the products run on the tensor cores in 3xTF32 (three TF32
// products each, at 495 TFLOP/s).
// Only the state entering a chunk (and, backward, the cotangent of the
// state leaving it) depends on the order of the chunks, and both are linear
// recurrences with one scalar decay a_c = E[Q-1] per (chunk, head), so each
// direction runs in stages:
//   1. ssd_fwd_chunk_state / ssd_bwd_chunk_state, one block per (b, chunk,
//      head group): each chunk's own term of the recurrence, x^T.(D o B)
//      (hd x N, depth Q; backward also dY^T.(E o C)), and a_c, into fp32
//      scratch (B, H, chunks, hd, N) and (B, H, chunks); one device
//      function with a flag for the backward's half;
//   2. ssd_fwd_state_pass / ssd_bwd_state_pass, one thread per (b, h, run
//      of 4 state elements): one walk over the chunks, `walk`, in place on
//      stage 1's scratch.  Forward, S_in[0] = the initial state (or 0),
//      S_in[c+1] = a_c S_in[c] + x^T.(D o B), and the state after the last
//      chunk is the final state; backward, S_in from 0 and dS from the last
//      chunk back, dS[c-1] = a_c dS[c] + dY^T.(E o C);
//   3. ssd_fwd_chunk_out / ssd_bwd_chunk_grads, one block per (b, chunk,
//      head group): Y, or every gradient term above, for one chunk given
//      S_in (and dS);
//   4. backward only, ssd_head_sum adds the head groups' partials of dB
//      and dC.
// The forward's scratch after stage 2 is the backward's S_in bit for bit
// (zero initial state): stage 1's term and the walk are the same code.
// What the design does:
//   * a head group is 4, 2 or 1 heads (the largest that divides H, picked
//     by the launcher): 640 blocks of stages 1 and 3 at the main shape,
//     ~4.8 an SM, where one block per (b, h) would give 160; a block
//     loads B and C once and forms C.B^T once for its heads (the Pallas
//     kernel shares it over all heads); the backward adds its heads' dB and
//     dC in registers in head order, so the partials are (B, S, H / group,
//     N);
//   * every product runs on the tensor cores through one warp-level
//     helper, `warp_mma`: mma.sync m16n8k8 TF32 in 3xTF32 (each fp32
//     operand split as hi = tf32(v), lo = v - hi; lo.hi + hi.lo, then
//     hi.hi, into an fp32 sum), which keeps fp32 accuracy: what it drops is
//     ~2^-21 of a term (`split_tf32`).  mma.sync and not wgmma, because fp32
//     and TF32 wgmma read both operands K-major only, and the kernels read
//     x, dY, B, C, M, dG and the states along both of their dimensions.  A
//     warp computes a strip of 16 rows by up to 32 columns of an output;
//   * one shared-memory layout (`Tile`) serves a tile read along its rows
//     and along its columns without bank conflicts, so no tile is copied
//     or transposed;
//   * the in-chunk cumsum is a warp scan in two floats (`chunk_decays`), and
//     the other scalar parts are warp scans and reductions with a fixed
//     shuffle pattern, so every sum has one order and two runs give the
//     same bits, with no atomics;
//   * the mask is applied before the exponent: exp runs only for j <= t,
//     where cum[t] - cum[j] <= 0 (dA <= 0), and M's upper triangle is
//     exactly 0, so no overflow can reach a product; expf, not __expf: the
//     fast version's error grows with the argument; all arithmetic is fp32
//     whatever T is (bf16 tiles are converted as they are staged in shared
//     memory).
// Stages 1 and 3 copy the next head's tiles with cp.async while this head
// computes.  Forward, stage 3 forms every head's decays at once, one warp
// a head, and keeps M where B was once C.B^T is formed: 103,424 bytes at
// the main shape, two blocks an SM; the backward's stage 3 takes 216,096
// bytes of the 227 KB a block may have, one block of 8 warps an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NWARPS = NTHREADS / 32;

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

// One struct for the kernels of both directions; a direction leaves the
// other's pointers null.
struct Args {
  const void* x;    // xdt (B, S, H, HD)
  const void* dA;   // (B, S, H)
  const void* Bm;   // (B, S, N)
  const void* Cm;   // (B, S, N)
  const void* dy;   // backward: (B, S, H, HD)
  void* y;          // forward: Y (B, S, H, HD)
  void* dx;         // backward: (B, S, H, HD)
  void* ddA;        // backward: (B, S, H)
  float* states;    // (B, H, S / Q, HD, N): x^T.(D o B), then S_in
  float* dstates;   // backward: (B, H, S / Q, HD, N): dY^T.(E o C), then dS
  float* decay;     // (B, H, S / Q): a_c = exp(cum[Q-1])
  float* dBp;       // backward: (B, S, H / hg, N): the head groups' dB
  float* dCp;       // backward: (B, S, H / hg, N): their dC
  int B, S, H, hg;  // hg heads a block, hg in {1, 2, 4} dividing H
};

// The shared-memory tiles: fp32, rows of W = max(COLS, 32)
// floats, element (r, c) at r * W + (c ^ swz(r)).  mma.sync reads a tile
// along a row (lane (g, t) at (r0 + g, c0 + t), r0 % 8 == 0, c0 % 4 == 0)
// or along a column (lane at (r0 + t, c0 + g), r0 % 4 == 0, c0 % 8 == 0),
// g = lane / 4, t = lane % 4.  The XOR moves bits 2-4 of the column by
// (r & 4) | (r & 3) << 3: along a row the 8 values of g fall in 8 distinct
// groups of 4 banks, along a column the 4 values of t in 4 distinct groups
// of 8, so both reads hit 32 banks.  No padded stride does both: a stride
// of 4 (mod 32) floats suits rows, 8 suits columns, and x, dY, B, C, dG and
// the states are read both ways.  Aligned runs of 4 columns stay together, so a
// row is staged with 16-byte stores.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

template <int COLS>
struct Tile {
  static constexpr int W = COLS < 32 ? 32 : COLS;
  float* p;
  __device__ __forceinline__ float& operator()(int r, int c) const {
    return p[r * W + (c ^ swz(r))];
  }
};

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits), to nearest with
// ties away from zero, as cvt.rna.tf32.f32 rounds a finite v but in two
// integer operations where cvt takes four with its checks for Inf and NaN;
// lo = v - hi is exact, and the tensor cores read its top 19 bits (the
// low 13 of a TF32 operand are not read), so lo loses < 2^-21 |v|, the
// order of the lo.lo product that 3xTF32 drops.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Where a lane's fragment elements lie in a tile, less what the unrolled
// k-loop adds as a constant, so that every load is a register plus an
// immediate.  Along a row (lane (g, t) at (r0 + g, c0 + t), r0 % 8 == 0,
// c0 % 4 == 0): swz(r0 + g) = swz(g), and c0 + t = c0 | t, so the element
// is at r0 W + (c0 & ~31) + row_off[(c0 % 32) / 4] with the row base
// rbase in the offsets.  Along a column (lane at (r0 + t, c0 + g), r0 % 4
// == 0, c0 % 8 == 0): swz(r0 + t) = t << 3 | (r0 & 4), so the element is at
// r0 W + col_off[(r0 / 4) % 2][j] for c0 = cbase + 8 j.
template <int W>
__device__ __forceinline__ void row_offsets(int (&off)[8], int rbase) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    off[u] = (rbase + g) * W + (((4 * u) ^ swz(g)) | t);
}

template <int W, int NJ>
__device__ __forceinline__ void col_offsets(int (&off)[2][NJ], int cbase) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cbase + 8 * j;
      off[i][j] = t * W + (c & ~31) + (((c & 31) ^ (t << 3)) | (g ^ (4 * i)));
    }
}

// One warp: acc[j] += A[m0 .. m0+16) x B[:, n0 + 8j .. n0 + 8j + 8) over
// k < K, for j < NT, in 3xTF32.  A(i, k) is a(i, k), or a(k, i) when TA;
// B(k, n) is b(k, n), or b(n, k) when TB.  The m16n8k8 fragments: A at
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B at (k = t, n = g),
// (k = t + 4, n = g); acc at (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  The products of each block of 32 k are summed from 0
// and then added to acc in fp32, rounded to nearest: the tensor cores
// align and truncate the terms they add, and a long running sum inside
// them would take that truncation at its own scale at every k-step.  Only
// the blocks of 32 k that meet [k_lo, k_hi) are summed: the caller leaves
// out blocks whose A or B part is 0.  With BS, B's row k is scaled by
// bscale[k] as it is read.
template <int NT, int K, bool TA, bool TB, bool BS = false, int CA, int CB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], Tile<CA> a,
                                         Tile<CB> b, int m0, int n0,
                                         int k_lo = 0, int k_hi = K,
                                         const float* bscale = nullptr) {
  constexpr int WA = Tile<CA>::W, WB = Tile<CB>::W;
  int arow[8], acol[2][2], brow[8], bcol[2][NT];
  if constexpr (TA) col_offsets<WA>(acol, m0);
  else row_offsets<WA>(arow, m0);
  if constexpr (TB) row_offsets<WB>(brow, n0);
  else col_offsets<WB>(bcol, n0);
  // k in blocks of 32, the k-steps of a block unrolled
#pragma unroll 1
  for (int kb = k_lo & ~31; kb < k_hi; kb += 32) {
    const float* ap = a.p + (TA ? kb * WA : kb);
    const float* bp = b.p + (TB ? kb : kb * WB);
    float s[NT][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < (K < 32 ? K : 32); ks += 8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // m0 + g + 8 (i % 2), k + t + 4 (i / 2)
        const int h = i & 1, q = i >> 1;
        const float v = TA ? ap[(ks + 4 * q) * WA + acol[q][h]]
                           : ap[h * 8 * WA + arow[(ks >> 2) + q]];
        split_tf32(v, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {   // k + t + 4 i, column n0 + 8 j + g
          float v = TB ? bp[j * 8 * WB + brow[(ks >> 2) + i]]
                       : bp[(ks + 4 * i) * WB + bcol[i][j]];
          if constexpr (BS) v *= bscale[kb + ks + 4 * i + (threadIdx.x & 3)];
          split_tf32(v, bh[i], bl[i]);
        }
        mma_tf32(s[j], al, bh); mma_tf32(s[j], ah, bl);   // the lo terms
        mma_tf32(s[j], ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += s[j][i];
  }
}

// How NW warps cut an R x C product: strips of 16 rows by 8 NT columns,
// NT as large as leaves no warp idle, at most 4 and C / 8; warp w < COUNT
// takes the strip at (m0(w), n0(w)).
template <int R, int C, int NW>
struct Strips {
  static constexpr int FILL = R * C / (128 * NW);
  static constexpr int CAP = C / 8 < 4 ? C / 8 : 4;
  static constexpr int NT = FILL < 1 ? 1 : FILL > CAP ? CAP : FILL;
  static constexpr int ACROSS = C / (8 * NT);
  static constexpr int COUNT = (R / 16) * ACROSS;
  static_assert(R % 16 == 0 && C % (8 * NT) == 0 && COUNT <= NW,
                "strip shape");
  __device__ static int m0(int w) { return (w / ACROSS) * 16; }
  __device__ static int n0(int w) { return (w % ACROSS) * 8 * NT; }
};

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ROWS x COLS values of T (row r at src + r * stride; 16-byte aligned rows
// of fp32, 8-byte of bf16) into a tile, as fp32: fp32 by cp.async, which
// the caller waits for (cp_async_wait) before its barrier; bf16 by loads
// into registers, all issued before the first store.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage(Tile<COLS> dst, const T* src,
                                      long long stride) {
  constexpr int G4 = COLS / 4, PER = (ROWS * G4 + NTHREADS - 1) / NTHREADS;
  if constexpr (sizeof(T) == sizeof(float)) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * NTHREADS;
      if (i < ROWS * G4) {
        const int r = i / G4, c = (i % G4) * 4;
        sm90::cp_async16(&dst(r, c), src + r * stride + c, true);
      }
    }
  } else {
    float4 v[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * NTHREADS;
      if (i < ROWS * G4) v[p] = load4(src + (i / G4) * stride + (i % G4) * 4);
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * NTHREADS;
      if (i < ROWS * G4)
        *reinterpret_cast<float4*>(&dst(i / G4, (i % G4) * 4)) = v[p];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;   // the same bits in every lane
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// a + b = s + e exactly (TwoSum)
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// (ah + al) + (bh + bl) as h + l, |l| <= ulp(h) / 2: a sum in two floats
__device__ __forceinline__ void df_add(float ah, float al, float bh, float bl,
                                       float& h, float& l) {
  float s, e;
  two_sum(ah, bh, s, e);
  e += al + bl;
  h = s + e;
  l = e - (h - s);
}

// One warp: the in-chunk cumsum of dA (step t at dA[t * step]) as two
// floats, cum[t] = sCum[t] + sLo[t]; E[t] = exp(cum[t]) into sE and
// D[t] = exp(cum[Q-1] - cum[t]) into sD.  Every decay inside the chunk is
// exp(cum[t] - cum[j]), and in fast decay cum reaches hundreds while the
// decays that are not 0 have t - j of a few steps: in one float the
// difference would lose ~ulp(cum[t]) ~ 1e-5 to cancellation, which d(dA)'s
// own cancelling sums carry to the gradient.  In two floats the
// difference (sCum[t] - sCum[j]) + (sLo[t] - sLo[j]) is exact to ~ulp of
// itself.  Lane l holds steps l * PER .. l * PER + PER - 1; the lanes'
// sums are scanned Kogge-Stone, one fixed order, the same in stages 1 and
// 3.
template <int Q, typename T>
__device__ __forceinline__ void chunk_decays(const T* dA, long long step,
                                             float* sCum, float* sLo,
                                             float* sE, float* sD) {
  constexpr int PER = Q > 32 ? Q / 32 : 1;
  const int lane = threadIdx.x & 31;
  float rh[PER], rl[PER], ah = 0.f, al = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int t = lane * PER + e;
    df_add(ah, al, t < Q ? to_f(dA[t * step]) : 0.f, 0.f, ah, al);
    rh[e] = ah;
    rl[e] = al;
  }
  float ih = ah, il = al;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float uh = __shfl_up_sync(FULL, ih, o);
    const float ul = __shfl_up_sync(FULL, il, o);
    if (lane >= o) df_add(ih, il, uh, ul, ih, il);
  }
  float eh = __shfl_up_sync(FULL, ih, 1), el = __shfl_up_sync(FULL, il, 1);
  if (lane == 0) eh = el = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int t = lane * PER + e;
    if (t < Q) df_add(eh, el, rh[e], rl[e], sCum[t], sLo[t]);
  }
  __syncwarp();
  const float lh = sCum[Q - 1], ll = sLo[Q - 1];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int t = lane * PER + e;
    if (t < Q) {
      sE[t] = expf(sCum[t] + sLo[t]);
      sD[t] = expf((lh - sCum[t]) + (ll - sLo[t]));
    }
  }
}


// Head h's dA of the chunk starting at row row0 = b S + c Q into dA_s:
// fp32 by cp.async from warp 0, each lane the steps chunk_decays has it
// read; bf16 is read where it lies (head_decays).  The caller commits.
template <int Q, typename T>
__device__ __forceinline__ void fetch_dA(float* dA_s, const Args& a,
                                         long long row0, int h) {
  constexpr int PER = Q > 32 ? Q / 32 : 1;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (threadIdx.x < 32)
      for (int e = 0; e < PER; ++e) {
        const int t = threadIdx.x * PER + e;
        if (t < Q)
          sm90::cp_async4(dA_s + t,
                          static_cast<const T*>(a.dA) + (row0 + t) * a.H + h,
                          true);
      }
  }
}

// Head h's x rows (and, BWD, its dY rows) of that chunk into the tiles at
// xy (x, then dY), fp32 by cp.async, bf16 by loads, and its dA into dA_s
// (fetch_dA); the caller commits.
template <bool BWD, int Q, int HD, typename T>
__device__ __forceinline__ void fetch_xy(float* xy, float* dA_s,
                                         const Args& a, long long row0,
                                         int h) {
  const long long xstride = (long long)a.H * HD;
  stage<Q, HD>(Tile<HD>{xy},
               static_cast<const T*>(a.x) + (row0 * a.H + h) * HD, xstride);
  if constexpr (BWD)
    stage<Q, HD>(Tile<HD>{xy + Q * Tile<HD>::W},
                 static_cast<const T*>(a.dy) + (row0 * a.H + h) * HD,
                 xstride);
  fetch_dA<Q, T>(dA_s, a, row0, h);
}

// One warp: cum, E and D of head h from its dA as fetch_dA left it: in dA_s
// (fp32, once the copies have landed) or in device memory (bf16).
template <int Q, typename T>
__device__ __forceinline__ void head_decays(const float* dA_s,
                                            const Args& a, long long row0,
                                            int h, float* sCum, float* sLo,
                                            float* sE, float* sD) {
  if constexpr (sizeof(T) == sizeof(float)) {
    sm90::cp_async_wait<0>();
    chunk_decays<Q>(dA_s, 1, sCum, sLo, sE, sD);
  } else {
    chunk_decays<Q>(static_cast<const T*>(a.dA) + row0 * a.H + h, a.H, sCum,
                    sLo, sE, sD);
  }
}

template <int Q, int HD, int N, bool BWD>
constexpr size_t state_smem_bytes() {
  // B (and C, BWD) (Q x N); two sets (this head's and the next's) of x (and
  // dY, BWD) (Q x HD) and dA (Q); cum (two floats), E, D
  constexpr int XY = BWD ? 2 : 1;
  return sizeof(float) * (size_t)(XY * Q * Tile<N>::W +
                                  2 * XY * Q * Tile<HD>::W + 6 * Q);
}

// Stage 1 of either direction.  Block (b, c, group): for each head h of the
// group, x^T.(D o B) of chunk c into states[b, h, c] (and, BWD,
// dY^T.(E o C) into dstates[b, h, c]), and a_c into decay[b, h, c].  The
// next head's x (dY) and (fp32) dA are copied while this head computes;
// 99,840 bytes of tiles at the main shape backward, 50,688 forward; two
// blocks an SM (at three the forward's registers spill).
template <bool BWD, typename T, int Q, int HD, int N>
__device__ __forceinline__ void chunk_state(const Args& a) {
  using SO = Strips<HD, N, NWARPS>;
  constexpr int XY = BWD ? 2 : 1;
  constexpr int SET = XY * Q * Tile<HD>::W + Q;   // x (dY), dA
  extern __shared__ float4 smem4[];
  const Tile<N> sB{reinterpret_cast<float*>(smem4)};
  const Tile<N> sC{sB.p + Q * Tile<N>::W};      // BWD only
  float* const sets = sB.p + XY * Q * Tile<N>::W;
  float* sCum = sets + 2 * SET;
  float* sLo = sCum + Q;
  float* sE = sLo + Q;
  float* sD = sE + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int groups = a.H / a.hg, nC = a.S / Q;
  const int grp = blockIdx.x % groups;
  const int c = (blockIdx.x / groups) % nC;
  const int b = blockIdx.x / (groups * nC);
  const long long row0 = (long long)b * a.S + (long long)c * Q;   // (b, cQ)

  stage<Q, N>(sB, static_cast<const T*>(a.Bm) + row0 * N, N);
  if constexpr (BWD)
    stage<Q, N>(sC, static_cast<const T*>(a.Cm) + row0 * N, N);
  fetch_xy<BWD, Q, HD, T>(sets, sets + SET - Q, a, row0, grp * a.hg);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  if (warp == 0)
    head_decays<Q, T>(sets + SET - Q, a, row0, grp * a.hg, sCum, sLo, sE, sD);
  __syncthreads();
  for (int hh = 0; hh < a.hg; ++hh) {
    // head hh's x (dY), E and D are in place; the other set was last read
    // by the previous head, before its first barrier
    const int cur = hh & 1, h = grp * a.hg + hh;
    const long long bhc = ((long long)b * a.H + h) * nC + c;
    float* set = sets + cur * SET;
    if (hh + 1 < a.hg) {
      fetch_xy<BWD, Q, HD, T>(sets + (cur ^ 1) * SET,
                              sets + (cur ^ 1) * SET + SET - Q, a, row0,
                              h + 1);
      sm90::cp_async_commit();
    }
    if (tid == 0) a.decay[bhc] = sE[Q - 1];
    if (warp < SO::COUNT) {
      const int m0 = SO::m0(warp), n0 = SO::n0(warp);
      // x^T.(D o B) and (BWD) dY^T.(E o C), B and C scaled as they are read
      float ds[SO::NT][4];
      zero(ds);
      warp_mma<SO::NT, Q, true, false, true>(ds, Tile<HD>{set}, sB, m0, n0,
                                             0, Q, sD);
      float* st = a.states + bhc * HD * N;
#pragma unroll
      for (int j = 0; j < SO::NT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store2(st + (m0 + g + 8 * half) * N + n0 + 8 * j + 2 * t4,
                 ds[j][2 * half], ds[j][2 * half + 1]);
      if constexpr (BWD) {
        float dds[SO::NT][4];
        zero(dds);
        warp_mma<SO::NT, Q, true, false, true>(
            dds, Tile<HD>{set + Q * Tile<HD>::W}, sC, m0, n0, 0, Q, sE);
        float* dst = a.dstates + bhc * HD * N;
#pragma unroll
        for (int j = 0; j < SO::NT; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            store2(dst + (m0 + g + 8 * half) * N + n0 + 8 * j + 2 * t4,
                   dds[j][2 * half], dds[j][2 * half + 1]);
      }
    }
    __syncthreads();   // this head's tiles, E and D are read
    if (warp == 0 && hh + 1 < a.hg)
      head_decays<Q, T>(sets + (cur ^ 1) * SET + SET - Q, a, row0, h + 1,
                        sCum, sLo, sE, sD);
    sm90::cp_async_wait<0>();
    __syncthreads();   // the next head's tiles, E and D are in place
  }
}

template <typename T, int Q, int HD, int N>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_fwd_chunk_state(
    const Args a) {
  chunk_state<false, T, Q, HD, N>(a);
}

template <typename T, int Q, int HD, int N>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_bwd_chunk_state(
    const Args a) {
  chunk_state<true, T, Q, HD, N>(a);
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Stage 2's walk, for one run of 4 of a (b, h)'s hd x N state elements
// (16-byte loads and stores): chunk c's term p[c] (at p + c * hdn4, from
// stage 1) is replaced, in place, by the value entering c, acc, and then
// acc <- a_c acc + term; chunks in order, or from the last back with BACK.
// U chunks' loads are in flight before their stores (all of zamba2's 16).
// Returns the value after the walk's last chunk.
template <bool BACK>
__device__ __forceinline__ float4 walk(float4* p, const float* dec, int nC,
                                       int hdn4, float4 acc) {
  constexpr int U = 16;
  for (int c0 = 0; c0 < nC; c0 += U) {
    float4 v[U];
    float av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c0 + u, c = BACK ? nC - 1 - i : i;
      if (i < nC) {
        v[u] = p[(long long)c * hdn4];
        av[u] = dec[c];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c0 + u, c = BACK ? nC - 1 - i : i;
      if (i < nC) {
        p[(long long)c * hdn4] = acc;   // the value entering c
        acc = fma4(av[u], acc, v[u]);   // carried to the next chunk
      }
    }
  }
  return acc;
}

// Stage 2 forward.  Thread (b, h, e): states[b, h, c] <- S_in[c] from
// S_in[0] = init[b, h] (0 where init is null), and the state after the
// last chunk into final_state[b, h].
__global__ void __launch_bounds__(NTHREADS) ssd_fwd_state_pass(
    float* __restrict__ states, const float* __restrict__ decay,
    const float* __restrict__ init, float* __restrict__ final_state, int nC,
    int hdn, long long total4) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= total4) return;
  const int hdn4 = hdn / 4;
  const long long bh = i / hdn4;
  const int e = static_cast<int>(i % hdn4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init)   // S_in[0], the initial state
    acc = reinterpret_cast<const float4*>(init + bh * hdn)[e];
  acc = walk<false>(reinterpret_cast<float4*>(states + bh * nC * hdn) + e,
                    decay + bh * nC, nC, hdn4, acc);
  reinterpret_cast<float4*>(final_state + bh * hdn)[e] = acc;
}

// Stage 2 backward.  Thread (b, h, e): states[b, h, c] <- S_in[c] from 0,
// then dstates[b, h, c] <- dS[c] from the last chunk back, from 0.
__global__ void __launch_bounds__(NTHREADS) ssd_bwd_state_pass(
    float* __restrict__ states, float* __restrict__ dstates,
    const float* __restrict__ decay, int nC, int hdn, long long total4) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= total4) return;
  const int hdn4 = hdn / 4;
  const long long bh = i / hdn4;
  const int e = static_cast<int>(i % hdn4);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  walk<false>(reinterpret_cast<float4*>(states + bh * nC * hdn) + e,
              decay + bh * nC, nC, hdn4, zero4);
  walk<true>(reinterpret_cast<float4*>(dstates + bh * nC * hdn) + e,
             decay + bh * nC, nC, hdn4, zero4);
}

template <int Q, int HD, int N>
__host__ __device__ constexpr int out_bm_floats() {   // B, then M
  return Q * Tile<N>::W > Q * Tile<Q>::W ? Q * Tile<N>::W : Q * Tile<Q>::W;
}

template <int Q, int HD, int N>
constexpr size_t out_smem_bytes() {
  // C (Q x N); B, then M; two sets (this head's and the next's) of x
  // (Q x HD) and S_in (HD x N); for each of up to 4 heads its dA, cum (two
  // floats), E and D (Q each)
  return sizeof(float) *
         (size_t)(Q * Tile<N>::W + out_bm_floats<Q, HD, N>() +
                  2 * (Q * Tile<HD>::W + HD * Tile<N>::W) + 4 * 5 * Q);
}

// Stage 3 forward.  Block (b, c, group): C.B^T of chunk c once and every
// head's cum, E and D, then for each head of the group M = (C.B^T) o L and
// Y = E o (C.S_in^T) + M.x, into Y in T.  The next head's x and S_in are
// copied into a second set of tiles while this head computes.
template <typename T, int Q, int HD, int N>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_fwd_chunk_out(
    const Args a) {
  using SQ = Strips<Q, Q, NWARPS>;    // C.B^T and M
  using SY = Strips<Q, HD, NWARPS>;   // Y
  constexpr int SET = Q * Tile<HD>::W + HD * Tile<N>::W;   // x, S_in
  extern __shared__ float4 smem4[];
  const Tile<N> sC{reinterpret_cast<float*>(smem4)};
  const Tile<N> sB{sC.p + Q * Tile<N>::W};
  const Tile<Q> sM{sB.p};   // B's space, once C.B^T is in registers
  float* const sets = sB.p + out_bm_floats<Q, HD, N>();
  float* const sDA = sets + 2 * SET;   // head hh's dA at hh Q
  float* const sDec = sDA + 4 * Q;     // head hh's cum, its low part, E, D
  auto dec = [&](int hh, int k) { return sDec + (4 * hh + k) * Q; };

  T* Y = static_cast<T*>(a.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int groups = a.H / a.hg, nC = a.S / Q;
  const int grp = blockIdx.x % groups;
  const int c = (blockIdx.x / groups) % nC;
  const int b = blockIdx.x / (groups * nC);
  const long long row0 = (long long)b * a.S + (long long)c * Q;   // (b, cQ)

  // head hh's x and S_in into set `which`
  auto fetch = [&](int hh, int which) {
    const int h = grp * a.hg + hh;
    const long long bhc = ((long long)b * a.H + h) * nC + c;
    float* set = sets + which * SET;
    stage<Q, HD>(Tile<HD>{set},
                 static_cast<const T*>(a.x) + (row0 * a.H + h) * HD,
                 (long long)a.H * HD);
    stage<HD, N>(Tile<N>{set + Q * Tile<HD>::W}, a.states + bhc * HD * N, N);
    sm90::cp_async_commit();
  };

  stage<Q, N>(sC, static_cast<const T*>(a.Cm) + row0 * N, N);
  stage<Q, N>(sB, static_cast<const T*>(a.Bm) + row0 * N, N);
  for (int hh = 0; hh < a.hg; ++hh)
    fetch_dA<Q, T>(sDA + hh * Q, a, row0, grp * a.hg + hh);
  fetch(0, 0);
  sm90::cp_async_wait<0>();
  __syncthreads();
  if (warp < a.hg)   // warp hh: head hh's decays
    head_decays<Q, T>(sDA + warp * Q, a, row0, grp * a.hg + warp,
                      dec(warp, 0), dec(warp, 1), dec(warp, 2), dec(warp, 3));
  float gq[SQ::NT][4];   // this warp's strip of C.B^T, for every head
  zero(gq);
  // a strip wholly above the diagonal (j > t) is masked to 0: left out
  const bool above = SQ::n0(warp) >= SQ::m0(warp) + 16;
  if (warp < SQ::COUNT && !above)
    warp_mma<SQ::NT, N, false, true>(gq, sC, sB, SQ::m0(warp), SQ::n0(warp));
  __syncthreads();   // B is read: its space takes M; the decays are in place

  for (int hh = 0; hh < a.hg; ++hh) {
    // head hh's tiles are in place; set cur ^ 1 and M were last read by the
    // previous head's products, before its last barrier
    const int cur = hh & 1, h = grp * a.hg + hh;
    if (hh + 1 < a.hg) fetch(hh + 1, cur ^ 1);
    const float* sCum = dec(hh, 0);
    const float* sLo = dec(hh, 1);
    const float* sE = dec(hh, 2);
    float* set = sets + cur * SET;
    const Tile<HD> sX{set};
    const Tile<N> sS{set + Q * Tile<HD>::W};   // S_in

    if (warp < SQ::COUNT) {   // M = G o L, the mask before the exponent
      const int m0 = SQ::m0(warp), n0 = SQ::n0(warp);
#pragma unroll
      for (int j = 0; j < SQ::NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + g + (i >> 1) * 8;
          const int col = n0 + 8 * j + 2 * t4 + (i & 1);
          float m = 0.f;
          if (col <= r)
            m = gq[j][i] *
                expf((sCum[r] - sCum[col]) + (sLo[r] - sLo[col]));
          sM(r, col) = m;
        }
    }
    __syncthreads();   // M is in place

    if (warp < SY::COUNT) {   // Y = E o (C.S_in^T) + M.x
      const int m0 = SY::m0(warp), n0 = SY::n0(warp);
      float acc[SY::NT][4];
      zero(acc);
      warp_mma<SY::NT, N, false, true>(acc, sC, sS, m0, n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float et = sE[m0 + g + 8 * (i >> 1)];   // E[t] scales C.S_in^T
#pragma unroll
        for (int jj = 0; jj < SY::NT; ++jj) acc[jj][i] *= et;
      }
      warp_mma<SY::NT, Q, false, false>(acc, sM, sX, m0, n0, 0, m0 + 16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        T* dst = Y + ((row0 + m0 + g + 8 * half) * a.H + h) * HD;
#pragma unroll
        for (int jj = 0; jj < SY::NT; ++jj)
          store2(dst + n0 + 8 * jj + 2 * t4, acc[jj][2 * half],
                 acc[jj][2 * half + 1]);
      }
    }
    sm90::cp_async_wait<0>();
    __syncthreads();   // M and this head's tiles are read; the next head's
                       // tiles are in place
  }
}

template <int Q, int HD, int N>
constexpr size_t grads_smem_bytes() {
  // C, B (Q x N); two sets (this head's and the next's) of x, dY (Q x HD),
  // S_in, dS (HD x N) and dA (Q); M, dG, P (Q x Q); cum (two floats), E, D
  // and P's row and column sums (Q each); the partial sums of R and of the
  // inter-chunk term (Q per strip across); one float a warp
  return sizeof(float) *
         (size_t)(2 * Q * Tile<N>::W + 4 * Q * Tile<HD>::W +
                  4 * HD * Tile<N>::W + 3 * Q * Tile<Q>::W + 8 * Q +
                  Q * Strips<Q, HD, NWARPS>::ACROSS +
                  Q * Strips<Q, N, NWARPS>::ACROSS + NWARPS);
}

// Stage 3 backward.  Block (b, c, group): dx and d(dA) of chunk c for each
// head of the group, and the group's partials of dB and dC.  The next
// head's x, dY, S_in, dS and (fp32) dA are copied into a second set of
// tiles while this head computes: cp.async for fp32; bf16 is loaded and
// converted at once.
template <typename T, int Q, int HD, int N>
__global__ void __launch_bounds__(NTHREADS, 1) ssd_bwd_chunk_grads(
    const Args a) {
  using SQ = Strips<Q, Q, NWARPS>;    // C.B^T and dY.x^T
  using SX = Strips<Q, HD, NWARPS>;   // dx
  using SN = Strips<Q, N, NWARPS>;    // dB and dC
  constexpr int PER = Q > 32 ? Q / 32 : 1;
  extern __shared__ float4 smem4[];
  const Tile<N> sC{reinterpret_cast<float*>(smem4)};
  const Tile<N> sB{sC.p + Q * Tile<N>::W};
  // per head, two sets: x, dY (Q x HD), S_in, dS (HD x N), dA (Q)
  constexpr int SET = 2 * Q * Tile<HD>::W + 2 * HD * Tile<N>::W + Q;
  float* const sets = sB.p + Q * Tile<N>::W;
  const Tile<Q> sM{sets + 2 * SET};
  const Tile<Q> sdG{sM.p + Q * Tile<Q>::W};
  const Tile<Q> sP{sdG.p + Q * Tile<Q>::W};        // dM o M, strictly below
  float* sCum = sP.p + Q * Tile<Q>::W;
  float* sLo = sCum + Q;
  float* sE = sLo + Q;
  float* sD = sE + Q;
  float* sRow = sD + Q;                             // sum_{j<t} P[t][j]
  float* sCol = sRow + Q;                           // sum_{t>j} P[t][j]
  float* sRp = sCol + Q;         // R's partial sums, Q per dx strip across
  float* sIp = sRp + Q * SX::ACROSS;   // the inter-chunk term's, per dC strip
  float* sRed = sIp + Q * SN::ACROSS;  // <dS, S_in>, one partial a warp

  T* DX = static_cast<T*>(a.dx);
  T* DDA = static_cast<T*>(a.ddA);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int groups = a.H / a.hg, nC = a.S / Q;
  const int grp = blockIdx.x % groups;
  const int c = (blockIdx.x / groups) % nC;
  const int b = blockIdx.x / (groups * nC);
  const long long row0 = (long long)b * a.S + (long long)c * Q;   // (b, cQ)

  // head hh's x, dY, dA (fetch_xy), S_in and dS into set `which`
  auto fetch = [&](int hh, int which) {
    const int h = grp * a.hg + hh;
    const long long bhc = ((long long)b * a.H + h) * nC + c;
    float* set = sets + which * SET;
    fetch_xy<true, Q, HD, T>(set, set + SET - Q, a, row0, h);
    stage<HD, N>(Tile<N>{set + 2 * Q * Tile<HD>::W},
                          a.states + bhc * HD * N, N);
    stage<HD, N>(
        Tile<N>{set + 2 * Q * Tile<HD>::W + HD * Tile<N>::W},
        a.dstates + bhc * HD * N, N);
    sm90::cp_async_commit();
  };
  auto decays = [&](int hh, int which) {
    head_decays<Q, T>(sets + which * SET + SET - Q, a, row0,
                      grp * a.hg + hh, sCum, sLo, sE, sD);
  };

  stage<Q, N>(sC, static_cast<const T*>(a.Cm) + row0 * N, N);
  stage<Q, N>(sB, static_cast<const T*>(a.Bm) + row0 * N, N);
  fetch(0, 0);
  sm90::cp_async_wait<0>();
  if (warp == 0) decays(0, 0);
  __syncthreads();
  float gq[SQ::NT][4];   // this warp's strip of C.B^T, for every head
  zero(gq);
  // a strip wholly above the diagonal (j > t) is masked to 0: left out
  const bool above = SQ::n0(warp) >= SQ::m0(warp) + 16;
  if (warp < SQ::COUNT && !above)
    warp_mma<SQ::NT, N, false, true>(gq, sC, sB, SQ::m0(warp), SQ::n0(warp));
  float dBacc[SN::NT][4], dCacc[SN::NT][4];   // summed over the heads
  zero(dBacc);
  zero(dCacc);

  for (int hh = 0; hh < a.hg; ++hh) {
    // head hh's tiles, cum, E and D are in place (the barrier at the end of
    // the previous head's loop, or before it); set cur ^ 1 was last read by
    // the previous head's products, before its barrier ahead of d(dA)
    const int cur = hh & 1;
    const int h = grp * a.hg + hh;
    if (hh + 1 < a.hg) fetch(hh + 1, cur ^ 1);
    float* set = sets + cur * SET;
    const Tile<HD> sX{set};
    const Tile<HD> sDY{set + Q * Tile<HD>::W};
    const Tile<N> sS{set + 2 * Q * Tile<HD>::W};                  // S_in
    const Tile<N> sdS{set + 2 * Q * Tile<HD>::W + HD * Tile<N>::W};   // dS

    if (warp < SQ::COUNT) {   // M = G o L, dG = dM o L, P = dM o M (j < t)
      const int m0 = SQ::m0(warp), n0 = SQ::n0(warp);
      float dm[SQ::NT][4];
      zero(dm);
      if (!above) warp_mma<SQ::NT, HD, false, true>(dm, sDY, sX, m0, n0);
#pragma unroll
      for (int j = 0; j < SQ::NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + g + (i >> 1) * 8;
          const int col = n0 + 8 * j + 2 * t4 + (i & 1);
          float m = 0.f, dg = 0.f, p = 0.f;
          if (col <= r) {
            const float l =
                expf((sCum[r] - sCum[col]) + (sLo[r] - sLo[col]));
            m = gq[j][i] * l;
            dg = dm[j][i] * l;
            if (col < r) p = dm[j][i] * m;
          }
          sM(r, col) = m;
          sdG(r, col) = dg;
          sP(r, col) = p;
        }
    }
    __syncthreads();

    if (warp < SX::COUNT) {   // dx = M^T.dY + D o (B.dS^T); R's partials
      const int m0 = SX::m0(warp), n0 = SX::n0(warp);
      float acc[SX::NT][4], v[SX::NT][4];
      zero(acc);
      zero(v);
      warp_mma<SX::NT, Q, true, false>(acc, sM, sDY, m0, n0, m0);
      warp_mma<SX::NT, N, false, true>(v, sB, sdS, m0, n0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = m0 + g + 8 * half;
        const float dj = sD[j];
        T* dst = DX + ((row0 + j) * a.H + h) * HD;
        float rp = 0.f;
#pragma unroll
        for (int jj = 0; jj < SX::NT; ++jj) {
          const int d = n0 + 8 * jj + 2 * t4;
          const float v0 = v[jj][2 * half], v1 = v[jj][2 * half + 1];
          store2(dst + d, acc[jj][2 * half] + dj * v0,
                 acc[jj][2 * half + 1] + dj * v1);
          rp += sX(j, d) * v0 + sX(j, d + 1) * v1;
        }
        rp = quad_sum(rp);
        if (t4 == 0) sRp[(warp % SX::ACROSS) * Q + j] = rp;
      }
    }
    if (warp < SN::COUNT) {
      const int m0 = SN::m0(warp), n0 = SN::n0(warp);
      // dC += dG.B + E o (dY.S_in); the inter-chunk term's partials
      float u[SN::NT][4];
      zero(u);
      warp_mma<SN::NT, Q, false, false>(dCacc, sdG, sB, m0, n0, 0, m0 + 16);
      warp_mma<SN::NT, HD, false, false>(u, sDY, sS, m0, n0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        const float er = sE[r];
        float ip = 0.f;
#pragma unroll
        for (int jj = 0; jj < SN::NT; ++jj) {
          const int n = n0 + 8 * jj + 2 * t4;
          const float u0 = u[jj][2 * half], u1 = u[jj][2 * half + 1];
          dCacc[jj][2 * half] += er * u0;
          dCacc[jj][2 * half + 1] += er * u1;
          ip += sC(r, n) * u0 + sC(r, n + 1) * u1;
        }
        ip = quad_sum(ip);
        if (t4 == 0) sIp[(warp % SN::ACROSS) * Q + r] = ip;
      }
      // dB += dG^T.C + D o (x.dS)
      float w[SN::NT][4];
      zero(w);
      warp_mma<SN::NT, Q, true, false>(dBacc, sdG, sC, m0, n0, m0);
      warp_mma<SN::NT, HD, false, false>(w, sX, sdS, m0, n0);
#pragma unroll
      for (int jj = 0; jj < SN::NT; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dBacc[jj][i] += sD[m0 + g + (i >> 1) * 8] * w[jj][i];
    }
    for (int r = warp; r < Q; r += NWARPS) {   // P's row and column sums
      float rs = 0.f, cs = 0.f;
      for (int k = lane; k < Q; k += 32) {
        rs += sP(r, k);
        cs += sP(k, r);
      }
      rs = warp_sum(rs);
      cs = warp_sum(cs);
      if (lane == 0) {
        sRow[r] = rs;
        sCol[r] = cs;
      }
    }
    {   // <dS, S_in>
      float dot = 0.f;
      for (int i = tid; i < HD * N; i += NTHREADS)
        dot += sdS(i / N, i % N) * sS(i / N, i % N);
      dot = warp_sum(dot);
      if (lane == 0) sRed[warp] = dot;
    }
    __syncthreads();

    if (warp == 0) {   // dcum and its reverse cumsum, d(dA)
      float dot = 0.f;
      for (int w = 0; w < NWARPS; ++w) dot += sRed[w];
      float rv[PER], rpart = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int t = lane * PER + e;
        float r = 0.f;
        if (t < Q - 1) {   // R[Q-1] is left out
          float s = 0.f;
          for (int k = 0; k < SX::ACROSS; ++k) s += sRp[k * Q + t];
          r = sD[t] * s;
        }
        rv[e] = r;
        rpart += r;
      }
      const float rsum = warp_sum(rpart);
      float dc[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int t = lane * PER + e;
        dc[e] = 0.f;
        if (t < Q) {
          float ip = 0.f;
          for (int k = 0; k < SN::ACROSS; ++k) ip += sIp[k * Q + t];
          float v = sRow[t] - sCol[t] + sE[t] * ip - rv[e];
          if (t == Q - 1) v += sE[Q - 1] * dot + rsum;
          dc[e] = v;
        }
      }
      float run[PER], acc = 0.f;
#pragma unroll
      for (int e = PER - 1; e >= 0; --e) {
        acc += dc[e];
        run[e] = acc;
      }
      float incl = acc;   // suffix scan of the lanes' sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(FULL, incl, o);
        if (lane + o < 32) incl += u;
      }
      float excl = __shfl_down_sync(FULL, incl, 1);
      if (lane == 31) excl = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int t = lane * PER + e;
        if (t < Q)
          DDA[(row0 + t) * a.H + h] =
              from_f<T>(excl + run[e]);   // d(dA)[t]: the reverse cumsum
      }
      if (hh + 1 < a.hg) decays(hh + 1, cur ^ 1);
    }
    sm90::cp_async_wait<0>();
    __syncthreads();   // the next head's tiles, cum, E and D are in place
  }

  if (warp < SN::COUNT) {   // the group's partials of dB and dC
    const int m0 = SN::m0(warp), n0 = SN::n0(warp);
#pragma unroll
    for (int jj = 0; jj < SN::NT; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half, n = n0 + 8 * jj + 2 * t4;
        const long long off = ((row0 + r) * groups + grp) * N + n;
        store2(a.dBp + off, dBacc[jj][2 * half], dBacc[jj][2 * half + 1]);
        store2(a.dCp + off, dCacc[jj][2 * half], dCacc[jj][2 * half + 1]);
      }
  }
}

// dB and dC: the head groups' partials summed in group order.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) ssd_head_sum(
    const float* dBp, const float* dCp, T* dB, T* dC, long long rows,
    int groups, int N) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= rows * N) return;
  const long long src = (i / N) * groups * N + i % N;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < groups; ++k) {
    sb += dBp[src + (long long)k * N];
    sc += dCp[src + (long long)k * N];
  }
  dB[i] = from_f<T>(sb);
  dC[i] = from_f<T>(sc);
}

template <typename K>
cudaError_t opt_in(K* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int Q, int HD, int N>
int launch_fwd(const Args& a, const float* init, float* final_state,
               cudaStream_t stream) {
  const int nC = a.S / Q;
  const unsigned blocks = static_cast<unsigned>(a.B * nC * (a.H / a.hg));
  const long long total4 = (long long)a.B * a.H * HD * N / 4;
  const size_t smem1 = state_smem_bytes<Q, HD, N, false>();
  const size_t smem3 = out_smem_bytes<Q, HD, N>();
  cudaError_t err = opt_in(ssd_fwd_chunk_state<T, Q, HD, N>, smem1);
  if (err == cudaSuccess) err = opt_in(ssd_fwd_chunk_out<T, Q, HD, N>, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_chunk_state<T, Q, HD, N><<<blocks, NTHREADS, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_state_pass<<<static_cast<unsigned>((total4 + NTHREADS - 1) /
                                             NTHREADS),
                       NTHREADS, 0, stream>>>(a.states, a.decay, init,
                                              final_state, nC, HD * N, total4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_chunk_out<T, Q, HD, N><<<blocks, NTHREADS, smem3, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Q, int HD, int N>
int launch_bwd(const Args& a, void* dB, void* dC, cudaStream_t stream) {
  const int nC = a.S / Q;
  const unsigned blocks = static_cast<unsigned>(a.B * nC * (a.H / a.hg));
  const long long total4 = (long long)a.B * a.H * HD * N / 4;
  const long long rows = (long long)a.B * a.S;
  const size_t smem1 = state_smem_bytes<Q, HD, N, true>();
  const size_t smem3 = grads_smem_bytes<Q, HD, N>();
  cudaError_t err = opt_in(ssd_bwd_chunk_state<T, Q, HD, N>, smem1);
  if (err == cudaSuccess)
    err = opt_in(ssd_bwd_chunk_grads<T, Q, HD, N>, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_state<T, Q, HD, N><<<blocks, NTHREADS, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_pass<<<static_cast<unsigned>((total4 + NTHREADS - 1) /
                                             NTHREADS),
                       NTHREADS, 0, stream>>>(a.states, a.dstates, a.decay, nC,
                                              HD * N, total4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_grads<T, Q, HD, N><<<blocks, NTHREADS, smem3, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_head_sum<T><<<static_cast<unsigned>((rows * N + NTHREADS - 1) /
                                          NTHREADS),
                    NTHREADS, 0, stream>>>(a.dBp, a.dCp, static_cast<T*>(dB),
                                           static_cast<T*>(dC), rows,
                                           a.H / a.hg, N);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<HD>, Int<N>, Int<Q>) for the shapes the kernels are built for:
// (hd, N) zamba2-2.7b's (64, 64) and the JAX kernel sweep's (16, 16) and
// (32, 8) (tests/test_kernels.py); Q 16, 32 or 64.
template <typename F>
int dispatch(int hd, int n, int q, F&& f) {
  auto by_q = [&](auto hd_, auto n_) {
    switch (q) {
      case 16: return f(hd_, n_, Int<16>{});
      case 32: return f(hd_, n_, Int<32>{});
      case 64: return f(hd_, n_, Int<64>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (hd == 64 && n == 64) return by_q(Int<64>{}, Int<64>{});
  if (hd == 16 && n == 16) return by_q(Int<16>{}, Int<16>{});
  if (hd == 32 && n == 8) return by_q(Int<32>{}, Int<8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int B, int S, int H, int q, int hg) {
  return B <= 0 || S <= 0 || H <= 0 || q <= 0 || S % q != 0 ||
         (hg != 1 && hg != 2 && hg != 4) || H % hg != 0;
}

}  // namespace

// Y (B, S, H, hd) of xdt, dA, B and C, and the final state (B, H, hd, n,
// fp32), from the initial state init (B, H, hd, n, fp32; null: zeros).
// dtype: 0 = float32, 1 = bfloat16, for every input and Y; every row and
// state 16-byte aligned.  states (B, H, S / q, hd, n) and decay (B, H,
// S / q) are fp32 scratch of the caller's; after the call states holds the
// state entering each chunk.  hg heads a block (1, 2 or 4, dividing H).
// Three launches on the stream: the per-chunk state terms, the scan over
// the chunks, the per-chunk output.  Returns cudaGetLastError() after each
// (0 on success).
extern "C" int mamba2_ssd_fwd(const void* x, const void* dA, const void* Bm,
                              const void* Cm, void* y, const float* init,
                              float* final_state, float* states, float* decay,
                              int dtype, int B, int S, int H, int hd, int n,
                              int q, int hg, void* stream) {
  if (bad_shape(B, S, H, q, hg) || !final_state)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,      dA,      Bm,    Cm,      nullptr, y, nullptr, nullptr,
               states, nullptr, decay, nullptr, nullptr, B, S,       H,
               hg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(hd, n, q, [&](auto hd_, auto n_, auto q_) {
    constexpr int HD = decltype(hd_)::value, N = decltype(n_)::value,
                  Q = decltype(q_)::value;
    if (dtype == 0)
      return launch_fwd<float, Q, HD, N>(a, init, final_state, st);
    if (dtype == 1)
      return launch_fwd<__nv_bfloat16, Q, HD, N>(a, init, final_state, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// The gradient of mamba2_ssd_fwd's Y (zero initial state) with cotangent
// dy: dx, ddA in the inputs' shapes, dB, dC as (B, S, N), all in the
// inputs' type (dtype as above), every row 16-byte aligned.  states and
// dstates (B, H, S / q, hd, n), decay (B, H, S / q), dBp and dCp (B, S,
// H / hg, n) are fp32 scratch of the caller's; after the call states holds
// the state entering each chunk and dstates the cotangent of the state
// leaving it.  hg as above.  Four launches on the stream: the per-chunk
// state terms, the scan over the chunks, the per-chunk gradients, the sum
// over head groups.  Returns cudaGetLastError() (0 on success).
extern "C" int mamba2_ssd_bwd(const void* x, const void* dA, const void* Bm,
                              const void* Cm, const void* dy, void* dx,
                              void* ddA, void* dB, void* dC, float* states,
                              float* dstates, float* decay, float* dBp,
                              float* dCp, int dtype, int B, int S, int H,
                              int hd, int n, int q, int hg, void* stream) {
  if (bad_shape(B, S, H, q, hg))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,      dA,      Bm,    Cm,  dy,  nullptr, dx, ddA,
               states, dstates, decay, dBp, dCp, B,       S,  H,   hg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(hd, n, q, [&](auto hd_, auto n_, auto q_) {
    constexpr int HD = decltype(hd_)::value, N = decltype(n_)::value,
                  Q = decltype(q_)::value;
    if (dtype == 0) return launch_bwd<float, Q, HD, N>(a, dB, dC, st);
    if (dtype == 1) return launch_bwd<__nv_bfloat16, Q, HD, N>(a, dB, dC, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
