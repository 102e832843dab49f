// Train-mode BatchNorm over (N, C) rows with C contiguous (the NHWC conv
// output viewed as rows), fused with its epilogue:
//   y = (x - mean) * (inv * scale) + bias  [then max(y, 0)],
//   inv = 1 / sqrt(max(E[x^2] - mean^2, 0) + eps),
// and the raw moments stats (C, 2) = [mean, E[x^2]] for the running
// averages.
//
// Replaces: rocket_tpu/ops/fused_conv.py
//   * _twopass_kernel (:102), launched by _run_twopass (pallas_call at
//     :160)  ->  rkt_bn_twopass (moments, finalize and normalise in one
//     launch);
//   * _normalize_kernel (:139), launched by _run_stats_xla (pallas_call
//     at :203)  ->  rkt_bn_normalize (normalise only; the caller computes
//     the moments and the (4, C) [mean, inv, inv*scale, bias] rows).
//
// The TPU program carries the per-channel sums in VMEM scratch across a
// grid that runs in order (phase 0 accumulates every row tile, phase 1
// re-reads each tile and writes y). Hopper's blocks run in parallel and in
// no order, so the sums cannot be carried from one block to the next.
// Here the two-pass schedule is one cooperative launch of G CTAs, every
// one resident (the launch is refused otherwise), in three phases split by
// two grid barriers on an integer arrival counter:
//   1. moments: CTA g walks a contiguous slab of rows. Each thread owns one
//      or two 16-byte vectors of channels (4 f32 or 8 bf16) in a row and
//      keeps f32 sum and sum of squares of them in registers, 16 vectors'
//      loads in flight; the CTA's rows are split among row groups of
//      threads, whose sums are then added per channel in a fixed order
//      through shared memory. CTA g writes its (2, C) partial to a (G, 2,
//      C) scratch buffer. The slab stays on the SM in part: its last step
//      of loads in registers (64 KB a CTA), and its first rows in shared
//      memory, as many as fit beside the other resident CTAs (G / SMs of
//      them: two at G = 264 on the H100, 89 KB of rows a CTA). Those rows
//      are loaded evict-first, so the L2 keeps the rest.
//   2. finalize: the channels are split over the CTAs, 32 a CTA: eight
//      groups of 32 threads each add a fixed run of the G partials in
//      order, and the eight sums are added in order; one thread per channel
//      writes stats and the (4, C) rows. No float atomics anywhere, so the
//      result does not depend on the order blocks run in: two launches on
//      the same input give the same bits (bitwise resume needs that).
//   3. normalise: every CTA stages mean, inv*scale and bias in shared
//      memory and walks its own slab back to front in 16-byte vectors: the
//      registers' rows, then the rows the moments read last (still in the
//      50 MB L2), then device memory, then shared memory; its loads are
//      evict-first (a last use), and y is stored as streaming (evict-first)
//      so neither pushes the L2's rows of x out.
// rkt_bn_normalize is the normalise pass alone, its own launch.
// Accumulation is in f32 for every operand type (f32, bf16, f16); y is
// written in x's type.
//
// Any C and any row stride. The kernels above move 16-byte vectors of
// whole channels, so they take a row only when C, the row stride ld and
// both pointers are whole vectors (the "vec" form, by far the common one:
// every conv width is a multiple of 8). Anything else runs the "any" form:
//   * row 9: twopass_any_kernel, the same three phases, barriers and
//     fixed-order sums, no slab kept on the SM, one element a load: rows
//     split over row groups of min(C, 256) lanes, a lane owning channels;
//   * row 10: normalize_any_kernel, one element a step, rows ld apart.
// C above kMaxC is not the kernels' concern: a launch covers at most
// kMaxC channels of rows ld apart, and the caller (ops/fused_conv.py)
// launches the channel chunks of a wider activation one after another on
// its stream. BatchNorm's channels are independent, so a chunk's result is
// the same as the whole's.
// Both grids come from the caller (ops/fused_conv.py chooses them): G fixes
// the slabs, and so the order the partials add in, so it is a constant
// there and does not follow the card.
//
// Bound on the H100: bytes. The function reads x once and writes y once
// (ResNet-18's widest CIFAR layer, (524288, 64) f32: 268 MB, 0.080 ms at
// 3.35 TB/s) and does ~7 flops per element, far below the card's balance
// point. x is read from device memory once, plus whatever of it neither
// the registers, the shared-memory slabs nor the L2 still hold when the
// normalise pass comes back to it (of the widest layer's 134 MB of x, 17
// MB, 24 MB and under 50 MB); every load is 16 bytes wide and coalesced,
// and nothing but the partials and the (4, C) rows is written between the
// passes. The barrier's counter is one per device and returns to zero at
// the end of every launch, so two launches of rkt_bn_twopass must not run
// at once on one device (the port issues them on one stream).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "launch_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 2048;     // widest channel count (ResNet-50's last stage)
constexpr int kInFlight = 16;   // vectors of loads in flight per thread in the moments phase
constexpr int kNormUnroll = 4;  // vectors in flight per thread in the normalise phase
constexpr int kRedCh = 32;      // channels a CTA finalizes
constexpr int kRedGroups = kThreads / kRedCh;
// Hopper's shared memory: what an SM holds for its resident CTAs, what the
// card reserves of it per CTA, and the most one CTA may opt into; row 9's
// static buf.
constexpr int kSmemPerSm = 233472, kSmemReserved = 1024, kSmemOptIn = 232448;
constexpr int kStaticSmem = 3 * kMaxC * 4;

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

// Vectors a thread owns per row: 2 only for f32 past 1024 channels.
int vecs_per_row(int c, int item) { return c / (16 / item) > kThreads ? 2 : 1; }

// Row 10's loads and stores: one 16-byte vector of channels to and from
// f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load16(const __half* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half* h = reinterpret_cast<const __half*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __half2float(h[i]);
}

__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store16(__half* p, const float* in) {
  uint4 v;
  __half* h = reinterpret_cast<__half*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2half_rn(in[i]);
  *reinterpret_cast<uint4*>(p) = v;
}

// One element to and from f32 (the "any" kernels).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(v);
  else
    return __float2bfloat16(v);
}

// Row 9 moves vectors as raw 16 bytes (kept so in its shared-memory slab
// and registers) and converts them in registers. Its loads carry an L2
// eviction policy (createpolicy): evict-first for the rows it keeps on the
// SM or reads for the last time, so that the L2 holds the other rows.
__device__ __forceinline__ uint64_t l2_policy(bool first) {
  uint64_t pol;
  if (first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, uint64_t pol) {
  uint4 r;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p), "l"(pol));
  return r;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  } else if constexpr (std::is_same<T, __half>::value) {
    const __half* h = reinterpret_cast<const __half*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __half2float(h[i]);
  } else {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                      __float_as_uint(in[3]));
  } else if constexpr (std::is_same<T, __half>::value) {
    uint4 v;
    __half* h = reinterpret_cast<__half*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2half_rn(in[i]);
    return v;
  } else {
    uint4 v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(in[i]);
    return v;
  }
}

// y = (x - mean) * (inv*scale) + bias [relu] on one vector of channels
// c0 .. c0 + V - 1; row holds mean, inv*scale and bias kMaxC apart.
template <typename T, bool kAct>
__device__ __forceinline__ uint4 normalize16(const uint4& v, const float* row, int c0) {
  constexpr int V = Vec<T>::kN;
  float f[V];
  unpack<T>(v, f);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float o = (f[i] - row[c0 + i]) * row[kMaxC + c0 + i] + row[2 * kMaxC + c0 + i];
    if (kAct) o = o < 0.f ? 0.f : o;  // max(o, 0), NaN kept as jnp.maximum keeps it
    f[i] = o;
  }
  return pack<T>(f);
}

// Element offset of vector v of a slab whose rows hold nv vectors of C
// channels, ld elements apart (packed rows: ld == C).
template <int V>
__device__ __forceinline__ long long vec_offset(long long v, int nv, int c, long long ld) {
  if (ld == c) return v * V;
  return (v / nv) * ld + (v % nv) * V;
}

// The grid barrier's arrival counter: zero between launches (the last CTA
// out of a launch resets it).
__device__ unsigned int g_arrivals;

// Every CTA of the grid arrives, and this one waits until `target` arrivals
// have been counted (the grid's CTAs times the barriers passed so far).
// Writes before it are seen by every CTA after it. A wait that outlasts
// 2^32 clock cycles (seconds) traps, so a lost arrival fails the launch
// instead of holding the card.
__device__ __forceinline__ void grid_barrier(unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&g_arrivals, 1u);
    const long long start = clock64();
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(&g_arrivals)
                   : "memory");
      if (clock64() - start > (1ll << 32)) __trap();
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// Phase 2 of row 9 (both forms): the channels split over the CTAs, kRedCh
// a CTA; group grp adds partials [grp * chunk, (grp + 1) * chunk) in order,
// then the groups add in order, and one thread per channel writes stats and
// the (4, C) rows. buf holds 2 * kThreads floats.
__device__ __forceinline__ void finalize_channels(const float* partial, const float* sc,
                                                  float* stats, float* mi, long long n, int c,
                                                  float eps, float* buf) {
  const int t = threadIdx.x;
  const unsigned int grid = gridDim.x;
  const int lc = t % kRedCh, grp = t / kRedCh;
  const int chunk = (static_cast<int>(grid) + kRedGroups - 1) / kRedGroups;
  const int g0 = grp * chunk, g1 = min(g0 + chunk, static_cast<int>(grid));
  const float nf = static_cast<float>(n);
  for (int b = blockIdx.x; b * kRedCh < c; b += grid) {
    const int ch = b * kRedCh + lc;
    float a = 0.f, qq = 0.f;
    if (ch < c) {
#pragma unroll 8
      for (int g = g0; g < g1; ++g) {
        a += __ldcg(partial + static_cast<long long>(2 * g) * c + ch);
        qq += __ldcg(partial + static_cast<long long>(2 * g + 1) * c + ch);
      }
    }
    buf[grp * kRedCh + lc] = a;
    buf[kThreads + grp * kRedCh + lc] = qq;
    __syncthreads();
    if (grp == 0 && ch < c) {
      float sa = 0.f, sq = 0.f;
      for (int g = 0; g < kRedGroups; ++g) {
        sa += buf[g * kRedCh + lc];
        sq += buf[kThreads + g * kRedCh + lc];
      }
      const float mean = sa / nf;
      const float ex2 = sq / nf;
      const float var = fmaxf(ex2 - __fmul_rn(mean, mean), 0.f);
      const float inv = 1.f / sqrtf(var + eps);
      stats[2 * ch] = mean;
      stats[2 * ch + 1] = ex2;
      mi[ch] = mean;
      mi[c + ch] = inv;
      mi[2 * c + ch] = __fmul_rn(inv, sc[ch]);
      mi[3 * c + ch] = sc[c + ch];
    }
    __syncthreads();
  }
}

// Row 9, one cooperative launch: moments, grid barrier, finalize, grid
// barrier, normalise (see the top of file). CTA g owns rows [g *
// rows_per_cta, ...) of x. It loads them in steps of kInFlight / kVecs
// rows a thread, the last step ending on its slab's last row; that step
// stays in registers between the phases, and the first cached_rows rows in
// the dynamic shared memory.
template <typename T, bool kAct, int kVecs>
__global__ void __launch_bounds__(kThreads, 2)
twopass_kernel(const T* __restrict__ x, const float* __restrict__ sc, T* __restrict__ y,
               float* __restrict__ stats, float* mi, float* partial, long long n, int c,
               long long ld, long long rows_per_cta, int cached_rows, float eps) {
  constexpr int V = Vec<T>::kN, kRows = kInFlight / kVecs;
  __shared__ __align__(16) float buf[3 * kMaxC];
  extern __shared__ uint4 slab[];
  const int t = threadIdx.x, nv = c / V;
  const unsigned int grid = gridDim.x;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long stop = begin + rows_per_cta < n ? begin + rows_per_cta : n;
  const int rows = stop > begin ? static_cast<int>(stop - begin) : 0;
  const T* xs = x + begin * ld;
  // Threads split as rp row groups of `lanes` threads; lane l owns vectors
  // l, l + lanes, ... of a row (rp * C <= kMaxC for both types). A step is
  // kRows rows of each group: `step` rows, the last starting at row `last`.
  const int lanes = nv < kThreads ? nv : kThreads;
  const int rp = kThreads / lanes;
  const int r0 = t / lanes, l = t % lanes;
  const int step = kRows * rp, last = rows - step;
  const uint64_t keep_l2 = l2_policy(false), pass_l2 = l2_policy(true);
  uint4 raw[kRows][kVecs];

  // 1. Moments of this CTA's rows.
  {
    float s[kVecs][V], q[kVecs][V];
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) s[j][i] = q[j][i] = 0.f;
    if (r0 < rp) {
      const int steps = (rows + step - 1) / step;
      for (int st = 0; st < steps; ++st) {
        const int base = rows - (steps - st) * step + r0;  // the first step may start before 0
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int j = 0; j < kVecs; ++j) {
            const int rr = base + u * rp, v = l + j * lanes;
            if (rr >= 0 && v < nv)
              raw[u][j] = load_raw(xs + static_cast<long long>(rr) * ld + v * V,
                                   rr < cached_rows || rr >= last ? pass_l2 : keep_l2);
          }
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int j = 0; j < kVecs; ++j) {
            const int rr = base + u * rp, v = l + j * lanes;
            if (rr >= 0 && v < nv) {
              if (rr < cached_rows) slab[rr * nv + v] = raw[u][j];
              float f[V];
              unpack<T>(raw[u][j], f);
#pragma unroll
              for (int i = 0; i < V; ++i) {
                s[j][i] += f[i];
                q[j][i] += f[i] * f[i];
              }
            }
          }
      }
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int v = l + j * lanes;
        if (v < nv) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            buf[r0 * c + v * V + i] = s[j][i];
            buf[kMaxC + r0 * c + v * V + i] = q[j][i];
          }
        }
      }
    }
    __syncthreads();
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * c;
    for (int ch = t; ch < c; ch += kThreads) {
      float a = 0.f, b = 0.f;
      for (int g = 0; g < rp; ++g) {  // the row groups, in order
        a += buf[g * c + ch];
        b += buf[kMaxC + g * c + ch];
      }
      out[ch] = a;
      out[c + ch] = b;
    }
  }
  grid_barrier(grid);

  // 2. Finalize (finalize_channels).
  finalize_channels(partial, sc, stats, mi, n, c, eps, buf);
  grid_barrier(2 * grid);
  // Out of the barriers: the last CTA out resets the counter for the next
  // launch (every CTA has passed both by then).
  if (t == 0 && atomicAdd(&g_arrivals, 1u) == 3 * grid - 1) atomicExch(&g_arrivals, 0u);

  // 3. Normalise this CTA's slab back to front: the last step from
  // registers, then rows [0, last) in chunks of kThreads * kNormUnroll
  // vectors from the end, each in order, the first cached_rows rows from
  // shared memory.
  for (int ch = t; ch < c; ch += kThreads) {
    buf[ch] = __ldcg(mi + ch);
    buf[kMaxC + ch] = __ldcg(mi + 2 * c + ch);
    buf[2 * kMaxC + ch] = __ldcg(mi + 3 * c + ch);
  }
  __syncthreads();
  T* ys = y + begin * ld;
  if (r0 < rp) {
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int rr = last + r0 + u * rp, v = l + j * lanes;
        if (rr >= 0 && v < nv)
          __stcs(reinterpret_cast<uint4*>(ys + static_cast<long long>(rr) * ld + v * V),
                 normalize16<T, kAct>(raw[u][j], buf, v * V));
      }
  }
  const int total = last > 0 ? last * nv : 0;
  const int cached = min(last, cached_rows) * nv;
  for (int hi = total; hi > 0; hi -= kThreads * kNormUnroll) {
    uint4 in[kNormUnroll];
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const int v = hi - kThreads * kNormUnroll + u * kThreads + t;
      if (v >= 0)
        in[u] = v < cached ? slab[v] : load_raw(xs + vec_offset<V>(v, nv, c, ld), pass_l2);
    }
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const int v = hi - kThreads * kNormUnroll + u * kThreads + t;
      if (v >= 0)
        __stcs(reinterpret_cast<uint4*>(ys + vec_offset<V>(v, nv, c, ld)),
               normalize16<T, kAct>(in[u], buf, (v % nv) * V));
    }
  }
}


// Channels a lane of row 9's "any" form owns: C <= kMaxC over kThreads lanes.
constexpr int kAnyCh = kMaxC / kThreads;

// y = (x - mean) * (inv*scale) + bias [relu] for one element of channel ch;
// row holds mean, inv*scale and bias kMaxC apart.
template <typename T, bool kAct>
__device__ __forceinline__ T normalize1(float f, const float* row, int ch) {
  float o = (f - row[ch]) * row[kMaxC + ch] + row[2 * kMaxC + ch];
  if (kAct) o = o < 0.f ? 0.f : o;  // max(o, 0), NaN kept as jnp.maximum keeps it
  return from_f32<T>(o);
}

// Row 9's "any" form (any C up to kMaxC, any row stride, any alignment):
// twopass_kernel's three phases, barriers and fixed-order sums, one
// element a load: rp row groups of min(C, kThreads) lanes, lane l owning
// channels l, l + lanes, ... of its rows.
template <typename T, bool kAct>
__global__ void __launch_bounds__(kThreads, 2)
twopass_any_kernel(const T* __restrict__ x, const float* __restrict__ sc, T* __restrict__ y,
                   float* __restrict__ stats, float* mi, float* partial, long long n, int c,
                   long long ld, long long rows_per_cta, float eps) {
  __shared__ __align__(16) float buf[3 * kMaxC];
  const int t = threadIdx.x;
  const unsigned int grid = gridDim.x;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long stop = begin + rows_per_cta < n ? begin + rows_per_cta : n;
  const long long rows = stop > begin ? stop - begin : 0;
  const T* xs = x + begin * ld;

  // 1. Moments of this CTA's rows.
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * c;
  {
    const int lanes = c < kThreads ? c : kThreads;
    const int rp = kThreads / lanes;
    const int r0 = t / lanes, l = t % lanes;
    float s[kAnyCh], q[kAnyCh];
#pragma unroll
    for (int j = 0; j < kAnyCh; ++j) s[j] = q[j] = 0.f;
    if (r0 < rp) {
      for (long long r = r0; r < rows; r += rp) {
        const T* row = xs + r * ld;
#pragma unroll
        for (int j = 0; j < kAnyCh; ++j) {
          const int ch = l + j * lanes;
          if (ch < c) {
            const float f = to_f32(row[ch]);
            s[j] += f;
            q[j] += f * f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kAnyCh; ++j) {
        const int ch = l + j * lanes;
        if (ch < c) {
          buf[r0 * c + ch] = s[j];
          buf[kMaxC + r0 * c + ch] = q[j];
        }
      }
    }
    __syncthreads();
    for (int ch = t; ch < c; ch += kThreads) {
      float a = 0.f, b = 0.f;
      for (int g = 0; g < rp; ++g) {  // the row groups, in order
        a += buf[g * c + ch];
        b += buf[kMaxC + g * c + ch];
      }
      out[ch] = a;
      out[c + ch] = b;
    }
  }
  grid_barrier(grid);
  // 2. Finalize.
  finalize_channels(partial, sc, stats, mi, n, c, eps, buf);
  grid_barrier(2 * grid);
  if (t == 0 && atomicAdd(&g_arrivals, 1u) == 3 * grid - 1) atomicExch(&g_arrivals, 0u);

  // 3. Normalise this CTA's rows, one element at a time.
  for (int ch = t; ch < c; ch += kThreads) {
    buf[ch] = __ldcg(mi + ch);
    buf[kMaxC + ch] = __ldcg(mi + 2 * c + ch);
    buf[2 * kMaxC + ch] = __ldcg(mi + 3 * c + ch);
  }
  __syncthreads();
  T* ys = y + begin * ld;
  const long long total = rows * c;
  for (long long e = t; e < total; e += kThreads) {
    const long long r = e / c;
    const int ch = static_cast<int>(e - r * c);
    ys[r * ld + ch] = normalize1<T, kAct>(to_f32(xs[r * ld + ch]), buf, ch);
  }
}

// Row 10, vec form (the whole of rkt_bn_normalize for whole-vector rows):
// y = (x - mean) * (inv*scale) + bias [relu], mi rows 0, 2 and 3 staged in
// shared memory; rows ld elements apart.
template <typename T, bool kAct>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ mi, T* __restrict__ y,
                 long long total_vecs, int c, long long ld) {
  constexpr int V = Vec<T>::kN;
  __shared__ float row[3][kMaxC];
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    row[0][ch] = mi[ch];
    row[1][ch] = mi[2 * c + ch];
    row[2][ch] = mi[3 * c + ch];
  }
  __syncthreads();
  const int nv = c / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < total_vecs;
       v += stride) {
    const int c0 = static_cast<int>(v % nv) * V;
    const long long off = vec_offset<V>(v, nv, c, ld);
    float f[V];
    load16(x + off, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float o = (f[i] - row[0][c0 + i]) * row[1][c0 + i] + row[2][c0 + i];
      if (kAct) o = o < 0.f ? 0.f : o;  // max(o, 0), NaN kept as jnp.maximum keeps it
      f[i] = o;
    }
    store16(y + off, f);
  }
}

// Row 10, any form: every element one at a time, rows ld apart.
template <typename T, bool kAct>
__global__ void __launch_bounds__(kThreads)
normalize_any_kernel(const T* __restrict__ x, const float* __restrict__ mi, T* __restrict__ y,
                     long long n, int c, long long ld) {
  __shared__ float row[3][kMaxC];
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    row[0][ch] = mi[ch];
    row[1][ch] = mi[2 * c + ch];
    row[2][ch] = mi[3 * c + ch];
  }
  __syncthreads();
  const long long total = n * c;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += stride) {
    const long long r = e / c;
    const int ch = static_cast<int>(e - r * c);
    float o = (to_f32(x[r * ld + ch]) - row[0][ch]) * row[1][ch] + row[2][ch];
    if (kAct) o = o < 0.f ? 0.f : o;
    y[r * ld + ch] = from_f32<T>(o);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether rows of C channels ld apart at x and y take the vec form.
template <typename T>
bool vec_ok(const void* x, const void* y, int c, long long ld) {
  constexpr int V = Vec<T>::kN;
  return c % V == 0 && ld % V == 0 && aligned16(x) && aligned16(y);
}

template <typename T>
int launch_normalize(const void* x, const float* mi, void* y, long long n, int c, long long ld,
                     int blocks, int act, int vec, cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec) {
    if (!vec_ok<T>(x, y, c, ld)) return static_cast<int>(cudaErrorInvalidValue);
    const long long total = n * (c / Vec<T>::kN);
    if (act)
      normalize_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xs, mi, ys, total, c, ld);
    else
      normalize_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xs, mi, ys, total, c, ld);
  } else {
    if (act)
      normalize_any_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xs, mi, ys, n, c, ld);
    else
      normalize_any_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xs, mi, ys, n, c, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// Row 9's slabs over `grid` CTAs on a card of `sms` SMs: rows per CTA, and
// how many of them its dynamic shared memory keeps: of the rows before the
// last step (which stays in registers), the whole rows that fit in a CTA's
// share of an SM once ceil(grid / sms) CTAs are resident on each.
struct Slabs {
  long long rows_per_cta;
  int cached_rows;
  size_t smem;  // the dynamic shared memory: cached_rows rows of x
};

Slabs slabs(long long n, int c, int grid, int item, int sms) {
  const long long rows = (n + grid - 1) / grid;
  const int nv = c / (16 / item), lanes = nv < kThreads ? nv : kThreads;
  const long long step = kInFlight / vecs_per_row(c, item) * (kThreads / lanes);
  const long long before = rows > step ? rows - step : 0;
  const int per_sm = (grid + sms - 1) / sms;
  const int share = kSmemPerSm / per_sm - kSmemReserved;
  const int budget = (share < kSmemOptIn ? share : kSmemOptIn) - kStaticSmem;
  const long long fit = budget > 0 ? budget / (static_cast<long long>(c) * item) : 0;
  const int cached = static_cast<int>(before < fit ? before : fit);
  return {rows, cached, static_cast<size_t>(cached) * c * item};
}

// The SMs of the current device.
int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

template <typename T>
using Twopass = void (*)(const T*, const float*, T*, float*, float*, float*, long long, int,
                         long long, long long, int, float);
template <typename T>
using TwopassAny = void (*)(const T*, const float*, T*, float*, float*, float*, long long, int,
                            long long, long long, float);

// Raise an instantiation's dynamic shared-memory cap to all a CTA may opt
// into beside its static buf, and ask for the largest carveout (the slabs
// need it), once per device.
template <typename T, bool kAct, int kVecs>
int prepare_twopass() {
  static unsigned long long ready = 0;  // a bit per device ordinal
  const auto kernel = twopass_kernel<T, kAct, kVecs>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready & bit) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemOptIn - kStaticSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready |= bit;
  return static_cast<int>(err);
}

// The vec instantiation for C channels (kVecs 2 only for f32 past 1024),
// prepared; returns the cudaError_t.
template <typename T>
int twopass_for(int c, int act, Twopass<T>* kernel) {
  if constexpr (sizeof(T) == 4) {
    if (vecs_per_row(c, sizeof(T)) == 2) {
      *kernel = act ? twopass_kernel<T, true, 2> : twopass_kernel<T, false, 2>;
      return act ? prepare_twopass<T, true, 2>() : prepare_twopass<T, false, 2>();
    }
  }
  *kernel = act ? twopass_kernel<T, true, 1> : twopass_kernel<T, false, 1>;
  return act ? prepare_twopass<T, true, 1>() : prepare_twopass<T, false, 1>();
}

template <typename T>
TwopassAny<T> twopass_any_for(int act) {
  return act ? twopass_any_kernel<T, true> : twopass_any_kernel<T, false>;
}

// One cooperative launch: the card refuses it (and nothing runs) unless
// all `grid` CTAs can be resident at once, which the grid barriers need.
template <typename T>
int run_twopass(const void* x, const float* sc, void* y, float* stats, float* mi, float* partial,
                long long n, int c, long long ld, int grid, float eps, int act, int vec,
                cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  cudaError_t launched;
  if (vec) {
    if (!vec_ok<T>(x, y, c, ld)) return static_cast<int>(cudaErrorInvalidValue);
    Twopass<T> kernel = nullptr;
    int sms = 0;
    int err = twopass_for<T>(c, act, &kernel);
    if (err == 0) err = device_sms(&sms);
    if (err != 0) return err;
    const Slabs sl = slabs(n, c, grid, sizeof(T), sms);
    if (sl.rows_per_cta * (c / Vec<T>::kN) > 0x7fffffffll)
      return static_cast<int>(cudaErrorInvalidValue);  // the slab's vector index is an int
    long long rows_per_cta = sl.rows_per_cta;
    int cached_rows = sl.cached_rows;
    void* args[] = {&xs, &sc, &ys, &stats, &mi, &partial, &n, &c, &ld, &rows_per_cta,
                    &cached_rows, &eps};
    launched = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                           dim3(kThreads), args, sl.smem, stream);
  } else {
    TwopassAny<T> kernel = twopass_any_for<T>(act);
    long long rows_per_cta = (n + grid - 1) / grid;
    void* args[] = {&xs, &sc, &ys, &stats, &mi, &partial, &n, &c, &ld, &rows_per_cta, &eps};
    launched = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                           dim3(kThreads), args, 0, stream);
  }
  if (launched != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return static_cast<int>(launched);
  }
  return static_cast<int>(cudaGetLastError());
}

// which 0: row 9's vec launch over `grid` CTAs; 1: row 10's vec normalise;
// 2: row 9's any form; 3: row 10's any form.
template <typename T>
int query(int which, long long n, int c, int grid, int act, long long* info) {
  if (which == 1) {
    if (act) return rkt_info::write(normalize_kernel<T, true>, dim3(grid), kThreads, 0, info);
    return rkt_info::write(normalize_kernel<T, false>, dim3(grid), kThreads, 0, info);
  }
  if (which == 3) {
    if (act) return rkt_info::write(normalize_any_kernel<T, true>, dim3(grid), kThreads, 0, info);
    return rkt_info::write(normalize_any_kernel<T, false>, dim3(grid), kThreads, 0, info);
  }
  if (which == 2) return rkt_info::write(twopass_any_for<T>(act), dim3(grid), kThreads, 0, info);
  Twopass<T> kernel = nullptr;
  int sms = 0;
  int err = twopass_for<T>(c, act, &kernel);
  if (err == 0) err = device_sms(&sms);
  if (err != 0) return err;
  return rkt_info::write(kernel, dim3(grid), kThreads, slabs(n, c, grid, sizeof(T), sms).smem,
                         info);
}

// Resident CTAs per SM of row 9's vec launch at these shapes (the
// cooperative launch needs grid <= this times the SMs); -1 when the card
// refuses.
template <typename T>
int resident(long long n, int c, int grid, int act) {
  Twopass<T> kernel = nullptr;
  int sms = 0, blocks = -1;
  if (twopass_for<T>(c, act, &kernel) != 0 || device_sms(&sms) != 0) return -1;
  const size_t smem = slabs(n, c, grid, sizeof(T), sms).smem;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

bool shape_ok(long long n, int c, long long ld) {
  return n >= 1 && c >= 1 && c <= kMaxC && ld >= c;
}

}  // namespace

// Row 9: x (N, C) rows ld elements apart, in the operand type (dtype 0
// f32, 1 bf16, 2 f16), sc (2, C) f32 = [scale, bias] -> y (N, C) rows ld
// apart in x's type, stats (C, 2) f32; mi (4, C) f32 and partial (grid, 2,
// C) f32 are scratch the caller allocates; grid is the CTAs of the launch,
// all resident at once; vec 1 asks for the vec form (whole 16-byte vectors,
// refused otherwise), 0 for the any form. Returns the cudaError_t of the
// launch (cudaErrorCooperativeLaunchTooLarge when the card cannot hold the
// grid).
extern "C" int rkt_bn_twopass(const void* x, const void* sc, void* y, void* stats, void* mi,
                              void* partial, long long n, int c, long long ld, int grid, float eps,
                              int act, int dtype, int vec, void* stream) {
  if (!shape_ok(n, c, ld) || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  float* st = static_cast<float*>(stats);
  float* m = static_cast<float*>(mi);
  float* p = static_cast<float*>(partial);
  if (dtype == 1)
    return run_twopass<__nv_bfloat16>(x, scf, y, st, m, p, n, c, ld, grid, eps, act, vec, s);
  if (dtype == 2) return run_twopass<__half>(x, scf, y, st, m, p, n, c, ld, grid, eps, act, vec, s);
  return run_twopass<float>(x, scf, y, st, m, p, n, c, ld, grid, eps, act, vec, s);
}

// Row 10: x (N, C) rows ld apart, mi (4, C) f32 = [mean, inv, inv*scale,
// bias] -> y, in grid CTAs; vec as for rkt_bn_twopass.
extern "C" int rkt_bn_normalize(const void* x, const void* mi, void* y, long long n, int c,
                                long long ld, int grid, int act, int dtype, int vec,
                                void* stream) {
  if (!shape_ok(n, c, ld) || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mi);
  if (dtype == 1) return launch_normalize<__nv_bfloat16>(x, m, y, n, c, ld, grid, act, vec, s);
  if (dtype == 2) return launch_normalize<__half>(x, m, y, n, c, ld, grid, act, vec, s);
  return launch_normalize<float>(x, m, y, n, c, ld, grid, act, vec, s);
}

// The launch geometry of rkt_bn_twopass (which 0 vec, 2 any) or
// rkt_bn_normalize (1 vec, 3 any) at these shapes over `grid` CTAs
// (launch_info.cuh).
extern "C" int rkt_bn_launch_info(int which, long long n, int c, int grid, int act, int dtype,
                                  long long* info) {
  if (!shape_ok(n, c, c) || grid < 1 || which < 0 || which > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return query<__nv_bfloat16>(which, n, c, grid, act, info);
  if (dtype == 2) return query<__half>(which, n, c, grid, act, info);
  return query<float>(which, n, c, grid, act, info);
}

// Resident CTAs per SM of rkt_bn_twopass's vec form at these shapes (the
// relu form); -1 when the card refuses it.
extern "C" int rkt_bn_twopass_resident(long long n, int c, int grid, int dtype) {
  if (!shape_ok(n, c, c) || grid < 1) return -1;
  if (dtype == 1) return resident<__nv_bfloat16>(n, c, grid, 1);
  if (dtype == 2) return resident<__half>(n, c, grid, 1);
  return resident<float>(n, c, grid, 1);
}
