// Decode attention for Hopper (sm_90a): one new query token a batch row
// against the layer's K/V cache, read in place in the cache's own type.
//
// Replaces no TPU kernel: the JAX model computes this as two einsums
// (`decode_attention` in src/repro/models/attention.py), operands in the
// cache's dtype and fp32 accumulation.  The port's plain version
// (repro_torch/kernels/decode_attention/ref.py) cast the whole cache to fp32
// at every step to get the same arithmetic from PyTorch, a copy of 16 GB a
// step at deepseek-7b's batch of 8 x 4097 positions; this kernel reads the
// bf16 (or fp32) cache where it lies and writes no copy of it.
//
// Function, for each batch row b, group g and head h = g*M + m (M = Hq/G):
//   s[t] = scale * sum_d q[b,h,d] k[b,t,g,d]     (q in the cache's type,
//                                                 sums in fp32)
//   s[t] = cap * tanh(s[t] / cap)                (cap > 0)
//   allowed: t <= pos[b], and pos[b] - t < window (window > 0)
//   p[t] = round_E(exp(s[t] - max) / sum_t' exp(s[t'] - max)), over the
//          allowed keys; round_E rounds fp32 to the cache's type
//   o[b,h] = sum_t p[t] v[b,t,g]                 (fp32 sums, out's type)
// the plain version's function.  Masked keys have p = 0 exactly there
// (exp of -2e38), so the kernel skips them: it never reads a key past
// pos[b] or before the window.  pos[b] must lie in [0, T).
//
// What bounds it on an H100: bytes.  At deepseek-7b's (8, 4097, 32/32,
// 128) bf16 the cache is 537 MB a layer against 4 FLOPs a head and key
// element (~2 FLOP/B), so the least time is 0.160 ms at 3.35 TB/s.  The
// design moves nothing else of size:
//
//   1. decode_attn_scores, grid (chunks of T, G x row slices, B): a block
//      holds its group's query rows (up to MB of them, the row slice) in
//      registers and streams its chunk of K once for all of them.  LPK
//      lanes share a key row, 16 bytes each (one load at bf16 head dim
//      128: 16 lanes, two keys a warp), U keys a group in flight; the dot
//      products are summed over the lanes by shuffles.  The chunk's scores
//      go to shared memory, then to an fp32 score buffer (B, Hq, T), and
//      each row's chunk max and sum of exponentials to (B, Hq, chunks, 2).
//   2. decode_attn_pv, the same grid: the row's global max and sum from
//      the chunks' (l = sum_c l_c exp(m_c - m)), p for the chunk's keys
//      into shared memory, rounded to the cache's type, then V streamed
//      once, p.V summed in fp32 a lane's 16 bytes of columns at a time;
//      the key groups' sums meet by shuffles inside a warp and a tree over
//      the warps in shared memory, into a partial context (B, Hq, chunks,
//      hd).
//   3. decode_attn_out, one block per (h, b): the chunks' partial contexts
//      summed in chunk order, in the output's type.
// Every sum runs in a fixed order (no atomics), so a rerun is bit for bit.
// The chunk count is chosen by the caller from B, G, the row slices and T
// so that the grid holds at least ~2,048 blocks where chunks of 32 keys
// allow it (kernels/decode_attention/kernel.py `plan`).  The score buffer
// and the partials are ~1 % of the bytes at the shape above.  Head dims 32,
// 64, 80, 128 and 256; rows a block MB 1, 2, 4 or 8 (M above 8 takes
// several row slices, each reading K and V again); bf16 or fp32 caches.
// A refused launch is returned as an error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Args {
  const void* q;            // (B, Hq, hd) by strides, the cache's type
  const void* k;            // (B, T, G, hd) by strides
  const void* v;
  const long long* pos;     // (B,)
  float* scores;            // (B, Hq, T)
  float* stats;             // (B, Hq, chunks, 2): max, sum of exp
  float* part;              // (B, Hq, chunks, hd)
  void* out;                // (B, Hq, hd) by strides, the output's type
  int B, T, Hq, G, M, chunk, chunks, slices;
  long long qsb, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, osh;
  float scale, cap;
  int window;
};

template <typename E> struct Elem;

template <> struct Elem<float> {
  using Raw = float4;
  static constexpr int VEC = 4;
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
  __device__ static float round(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int VEC = 8;
  __device__ static void unpack(const Raw& r, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// How a block's threads cover a key row of head dim HD in type E.
template <typename E, int HD>
struct Layout {
  static constexpr int VEC = Elem<E>::VEC;        // elements in 16 bytes
  static constexpr int NVEC = HD / VEC;           // 16-byte pieces a row
  static constexpr int LPK = NVEC >= 32 ? 32 : NVEC > 16 ? 32
                             : NVEC > 8 ? 16 : NVEC > 4 ? 8 : 4;  // lanes a key
  static constexpr int NL = (NVEC + LPK - 1) / LPK;  // pieces a lane
  static constexpr int KG = THREADS / LPK;        // keys a block step
  static constexpr int U = NL >= 4 ? 1 : 4 / NL;  // block steps in flight
  static_assert(HD % VEC == 0, "head dim must fill 16-byte pieces");
};

// The allowed keys [lo, hi] of row b (empty when hi < lo) and the part of
// them in this block's chunk, [t0, t1].
struct Block {
  int b, g, h0, mc, c, c0, lo, hi, t0, t1;
};

template <int MB>
__device__ inline Block block_of(const Args& a) {
  Block k;
  k.c = blockIdx.x;
  k.g = blockIdx.y / a.slices;
  const int m0 = (blockIdx.y % a.slices) * MB;
  k.h0 = k.g * a.M + m0;
  k.mc = min(MB, a.M - m0);
  k.b = blockIdx.z;
  const long long p = a.pos[k.b];
  const long long hi = p < a.T - 1 ? p : a.T - 1;
  long long lo = a.window > 0 ? p - a.window + 1 : 0;
  if (lo < 0) lo = 0;
  k.lo = static_cast<int>(lo);
  k.hi = static_cast<int>(hi < -1 ? -1 : hi);
  k.c0 = k.c * a.chunk;
  k.t0 = max(k.c0, k.lo);
  k.t1 = min(k.c0 + a.chunk - 1, k.hi);
  return k;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Loads the U key rows of one block step for this lane (zeros past t1).
template <typename E, int HD>
__device__ inline void load_rows(const E* base, long long st, int t, int t1,
                                 int lane, typename Elem<E>::Raw (&raw)[
                                     Layout<E, HD>::U][Layout<E, HD>::NL]) {
  using L = Layout<E, HD>;
#pragma unroll
  for (int u = 0; u < L::U; ++u) {
    const int tu = t + u * L::KG;
#pragma unroll
    for (int i = 0; i < L::NL; ++i) {
      const int piece = lane + i * L::LPK;
      if (tu <= t1 && piece < L::NVEC)
        raw[u][i] = __ldcs(reinterpret_cast<const typename Elem<E>::Raw*>(
            base + tu * st + piece * L::VEC));
      else
        raw[u][i] = typename Elem<E>::Raw{};
    }
  }
}

template <typename E, int HD, int MB>
__global__ void __launch_bounds__(THREADS)
decode_attn_scores(const Args a) {
  using L = Layout<E, HD>;
  extern __shared__ float s_sh[];                 // MB x chunk
  const Block k = block_of<MB>(a);
  if (k.t0 > k.t1) return;
  const int tid = threadIdx.x, grp = tid / L::LPK, lane = tid % L::LPK;

  float qv[MB][L::NL * L::VEC];
  const E* q = static_cast<const E*>(a.q) + k.b * a.qsb + k.h0 * a.qsh;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < L::NL; ++i) {
      const int piece = lane + i * L::LPK;
      typename Elem<E>::Raw r{};
      if (m < k.mc && piece < L::NVEC)
        r = *reinterpret_cast<const typename Elem<E>::Raw*>(
            q + m * a.qsh + piece * L::VEC);
      Elem<E>::unpack(r, &qv[m][i * L::VEC]);
    }

  const E* kb = static_cast<const E*>(a.k) + k.b * a.ksb + k.g * a.ksg;
  for (int base = k.t0; base <= k.t1; base += L::KG * L::U) {
    typename Elem<E>::Raw raw[L::U][L::NL];
    load_rows<E, HD>(kb, a.kst, base + grp, k.t1, lane, raw);
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      float s[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) s[m] = 0.f;
#pragma unroll
      for (int i = 0; i < L::NL; ++i) {
        float kv[L::VEC];
        Elem<E>::unpack(raw[u][i], kv);
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int e = 0; e < L::VEC; ++e)
            s[m] = fmaf(qv[m][i * L::VEC + e], kv[e], s[m]);
      }
#pragma unroll
      for (int off = L::LPK / 2; off; off >>= 1)
#pragma unroll
        for (int m = 0; m < MB; ++m)
          s[m] += __shfl_xor_sync(0xffffffffu, s[m], off);
      const int t = base + grp + u * L::KG;
      if (t <= k.t1) {
#pragma unroll
        for (int m = 0; m < MB; ++m)
          if (m < k.mc && lane == m % L::LPK) {
            float x = s[m] * a.scale;
            if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
            s_sh[m * a.chunk + (t - k.c0)] = x;
          }
      }
    }
  }
  __syncthreads();

  // the chunk's max and sum of exp for each row; scores out, coalesced
  const int w = tid / 32, wl = tid % 32;
  for (int m = w; m < k.mc; m += WARPS) {
    const float* row = s_sh + m * a.chunk;
    float mx = -INFINITY;
    for (int t = k.t0 + wl; t <= k.t1; t += 32)
      mx = fmaxf(mx, row[t - k.c0]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int t = k.t0 + wl; t <= k.t1; t += 32) l += expf(row[t - k.c0] - mx);
    l = warp_sum(l);
    if (wl == 0) {
      float* st = a.stats + ((static_cast<long long>(k.b) * a.Hq + k.h0 + m)
                             * a.chunks + k.c) * 2;
      st[0] = mx;
      st[1] = l;
    }
  }
  const int n = k.t1 - k.t0 + 1;
  for (int idx = tid; idx < k.mc * n; idx += THREADS) {
    const int m = idx / n, t = k.t0 + idx % n;
    a.scores[(static_cast<long long>(k.b) * a.Hq + k.h0 + m) * a.T + t] =
        s_sh[m * a.chunk + (t - k.c0)];
  }
}

template <typename E, int HD, int MB>
__global__ void __launch_bounds__(THREADS)
decode_attn_pv(const Args a) {
  using L = Layout<E, HD>;
  constexpr int NC = L::NL * L::VEC;              // columns a lane
  extern __shared__ float smem[];  // p: MB x chunk; then 4 x MB x HD sums
  __shared__ float row_max[MB], row_sum[MB];
  const Block k = block_of<MB>(a);
  if (k.t0 > k.t1) return;
  const int tid = threadIdx.x, grp = tid / L::LPK, lane = tid % L::LPK;
  const int w = tid / 32, wl = tid % 32;

  // each row's max and sum over its chunks, in chunk order a lane
  const int c_lo = k.lo / a.chunk, c_hi = k.hi / a.chunk;
  for (int m = w; m < k.mc; m += WARPS) {
    const float* st = a.stats + (static_cast<long long>(k.b) * a.Hq + k.h0
                                 + m) * a.chunks * 2;
    float mx = -INFINITY;
    for (int c = c_lo + wl; c <= c_hi; c += 32) mx = fmaxf(mx, st[2 * c]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int c = c_lo + wl; c <= c_hi; c += 32)
      l += st[2 * c + 1] * expf(st[2 * c] - mx);
    l = warp_sum(l);
    if (wl == 0) {
      row_max[m] = mx;
      row_sum[m] = l;
    }
  }
  __syncthreads();

  float* p_sh = smem;
  const int n = k.t1 - k.t0 + 1;
  for (int idx = tid; idx < MB * n; idx += THREADS) {
    const int m = idx / n, t = k.t0 + idx % n;
    float p = 0.f;
    if (m < k.mc)
      p = Elem<E>::round(
          expf(a.scores[(static_cast<long long>(k.b) * a.Hq + k.h0 + m) * a.T
                        + t] - row_max[m]) / row_sum[m]);
    p_sh[m * a.chunk + (t - k.c0)] = p;
  }
  __syncthreads();

  float acc[MB][NC];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[m][j] = 0.f;
  const E* vb = static_cast<const E*>(a.v) + k.b * a.vsb + k.g * a.vsg;
  for (int base = k.t0; base <= k.t1; base += L::KG * L::U) {
    typename Elem<E>::Raw raw[L::U][L::NL];
    load_rows<E, HD>(vb, a.vst, base + grp, k.t1, lane, raw);
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int t = base + grp + u * L::KG;
      float p[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m)
        p[m] = t <= k.t1 ? p_sh[m * a.chunk + (t - k.c0)] : 0.f;
#pragma unroll
      for (int i = 0; i < L::NL; ++i) {
        float vv[L::VEC];
        Elem<E>::unpack(raw[u][i], vv);
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int e = 0; e < L::VEC; ++e)
            acc[m][i * L::VEC + e] = fmaf(p[m], vv[e], acc[m][i * L::VEC + e]);
      }
    }
  }

  // the key groups of a warp, then the warps: 4, 2, 1 into shared memory
#pragma unroll
  for (int off = L::LPK; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  __syncthreads();                                // p_sh is done with
  float* red = smem;                              // 4 x MB x HD
  const bool holder = wl < L::LPK;
#pragma unroll
  for (int half = WARPS / 2; half; half >>= 1) {
    if (w >= half && w < 2 * half && holder)
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int i = 0; i < L::NL; ++i) {
          const int piece = lane + i * L::LPK;
          if (piece < L::NVEC)
#pragma unroll
            for (int e = 0; e < L::VEC; ++e)
              red[((w - half) * MB + m) * HD + piece * L::VEC + e] =
                  acc[m][i * L::VEC + e];
        }
    __syncthreads();
    if (w < half && holder)
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int i = 0; i < L::NL; ++i) {
          const int piece = lane + i * L::LPK;
          if (piece < L::NVEC)
#pragma unroll
            for (int e = 0; e < L::VEC; ++e)
              acc[m][i * L::VEC + e] +=
                  red[(w * MB + m) * HD + piece * L::VEC + e];
        }
    __syncthreads();
  }
  if (w == 0 && holder)
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      if (m >= k.mc) break;
      float* dst = a.part + ((static_cast<long long>(k.b) * a.Hq + k.h0 + m)
                             * a.chunks + k.c) * HD;
#pragma unroll
      for (int i = 0; i < L::NL; ++i) {
        const int piece = lane + i * L::LPK;
        if (piece < L::NVEC)
#pragma unroll
          for (int e = 0; e < L::VEC; ++e)
            dst[piece * L::VEC + e] = acc[m][i * L::VEC + e];
      }
    }
}

// One block per (h, b), one thread a column: the row's chunks in order.
template <typename O>
__global__ void decode_attn_out(const Args a, int hd) {
  const int h = blockIdx.x, b = blockIdx.y, col = threadIdx.x;
  if (col >= hd) return;
  const long long p = a.pos[b];
  const long long hi = p < a.T - 1 ? p : a.T - 1;
  long long lo = a.window > 0 ? p - a.window + 1 : 0;
  if (lo < 0) lo = 0;
  float s = 0.f;
  if (lo <= hi) {
    const float* part = a.part + (static_cast<long long>(b) * a.Hq + h)
                                 * a.chunks * hd + col;
    for (int c = static_cast<int>(lo / a.chunk);
         c <= static_cast<int>(hi / a.chunk); ++c)
      s += part[static_cast<long long>(c) * hd];
  }
  store(static_cast<O*>(a.out) + b * a.osb + h * a.osh + col, s);
}

template <typename E, int HD, int MB>
int launch(const Args& a, int out_bf16, cudaStream_t st) {
  const dim3 grid(a.chunks, a.G * a.slices, a.B);
  const size_t p_bytes = sizeof(float) * MB * a.chunk;
  const size_t red_bytes = sizeof(float) * 4 * MB * HD;
  decode_attn_scores<E, HD, MB><<<grid, THREADS, p_bytes, st>>>(a);
  decode_attn_pv<E, HD, MB><<<grid, THREADS,
                              p_bytes > red_bytes ? p_bytes : red_bytes, st>>>(a);
  const dim3 grid_out(a.Hq, a.B);
  const int threads = (HD + 31) / 32 * 32;
  if (out_bf16)
    decode_attn_out<__nv_bfloat16><<<grid_out, threads, 0, st>>>(a, HD);
  else
    decode_attn_out<float><<<grid_out, threads, 0, st>>>(a, HD);
  return static_cast<int>(cudaGetLastError());
}

template <int V> struct Int { static constexpr int value = V; };

// fn(Int<hd>, Int<rows>) for the head dims and row counts compiled.
template <typename Fn>
int with_shape(int hd, int rows, Fn&& fn) {
  auto by_rows = [&](auto h) {
    switch (rows) {
      case 1: return fn(h, Int<1>());
      case 2: return fn(h, Int<2>());
      case 4: return fn(h, Int<4>());
      case 8: return fn(h, Int<8>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (hd) {
    case 32: return by_rows(Int<32>());
    case 64: return by_rows(Int<64>());
    case 80: return by_rows(Int<80>());
    case 128: return by_rows(Int<128>());
    case 256: return by_rows(Int<256>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: the cache's (and q's) type, 0 = float32, 1 = bfloat16; out_dtype
// the output's.  rows: query rows a block (1, 2, 4 or 8), slices: row
// slices a group (rows * slices >= Hq / G > rows * (slices - 1)); chunk:
// keys a block, chunks * chunk >= T.  work: fp32 scratch of B*Hq*T +
// B*Hq*chunks*(2 + hd) floats.  Strides are in elements.  window <= 0: no
// window; cap <= 0: no softcap.  device: the CUDA device the pointers and
// the stream belong to, made current for the launches if it is not (and
// the caller's restored).  Returns cudaGetLastError() after the launches
// (0 on success), or cudaErrorInvalidValue for what the kernels do not
// take.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const long long* pos,
    void* out, float* work, int dtype, int out_dtype, int hd, int B, int T,
    int Hq, int G, int rows, int slices, int chunk, int chunks,
    long long qsb, long long qsh, long long ksb, long long kst, long long ksg,
    long long vsb, long long vst, long long vsg, long long osb, long long osh,
    float scale, float cap, int window, int device, void* stream) {
  if (B <= 0 || T <= 0 || G <= 0 || Hq % G != 0 || chunk <= 0 ||
      static_cast<long long>(chunk) * chunks < T ||
      static_cast<long long>(chunk) * (chunks - 1) >= T ||
      rows * slices < Hq / G || rows * (slices - 1) >= Hq / G ||
      (dtype != 0 && dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long scores = static_cast<long long>(B) * Hq * T;
  const long long stats = static_cast<long long>(B) * Hq * chunks * 2;
  const Args a{q, k, v, pos, work, work + scores, work + scores + stats, out,
               B, T, Hq, G, Hq / G, chunk, chunks, slices,
               qsb, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, osh,
               scale, cap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int err = with_shape(hd, rows, [&](auto h, auto r) {
    constexpr int HD = decltype(h)::value, MB = decltype(r)::value;
    return dtype == 1 ? launch<__nv_bfloat16, HD, MB>(a, out_dtype, st)
                      : launch<float, HD, MB>(a, out_dtype, st);
  });
  if (prev != device) cudaSetDevice(prev);
  return err;
}
