// Train-mode BatchNorm over (N, C) rows with C contiguous (the NHWC conv
// output viewed as rows), fused with its epilogue:
//   y = (x - mean) * (inv * scale) + bias  [then max(y, 0)],
//   inv = 1 / sqrt(max(E[x^2] - mean^2, 0) + eps),
// and the raw moments stats (C, 2) = [mean, E[x^2]] for the running
// averages.
//
// Replaces: rocket_tpu/ops/fused_conv.py
//   * _twopass_kernel (:102), launched by _run_twopass (pallas_call at
//     :160)  ->  rkt_bn_twopass (moments, finalize, normalise);
//   * _normalize_kernel (:139), launched by _run_stats_xla (pallas_call
//     at :203)  ->  rkt_bn_normalize (normalise only; the caller computes
//     the moments and the (4, C) [mean, inv, inv*scale, bias] rows).
//
// The TPU program carries the per-channel sums in VMEM scratch across a
// grid that runs in order (phase 0 accumulates every row tile, phase 1
// re-reads each tile and writes y). Hopper's blocks run in parallel and in
// no order, so the sums cannot be carried from one block to the next.
// Here the two-pass schedule is three launches on one stream:
//   1. moments: G CTAs; CTA g walks a contiguous slab of rows. Each thread owns a few 16-byte vectors of channels (4 f32 or
//      8 bf16) and keeps f32 sum and sum of squares of them in registers;
//      the CTA's rows are split among row groups of threads, whose sums
//      are then added per channel in a fixed order through shared memory.
//      CTA g writes its (2, C) partial to a (G, 2, C) scratch buffer.
//   2. finalize: one thread per channel adds the G partials in order and
//      writes stats and the (4, C) rows. No float atomics anywhere, so the
//      result does not depend on the order blocks run in: two launches on
//      the same input give the same bits (bitwise resume needs that).
//   3. normalise: an elementwise pass over (N, C) in 16-byte vectors that
//      reads mean, inv*scale and bias from shared memory; also the whole
//      of rkt_bn_normalize.
// Accumulation is in f32 for both operand types; y is written in x's type.
// Both grids come from the caller (ops/fused_conv.py chooses them): the
// moments grid fixes the order the partials add in, so it is a constant
// there and does not follow the card.
//
// Bound on the H100: bytes. The function reads x once and writes y once
// (ResNet-18's widest CIFAR layer, (524288, 64) f32: 268 MB, 0.080 ms at
// 3.35 TB/s) and does ~6 flops per element, far below the card's balance
// point. This design reads x twice (the moments pass and the normalise
// pass: 1.5x the bound's bytes), keeps every load 16 bytes wide and
// coalesced, and writes nothing but the partials between the passes. One
// read of x (a slab kept in shared memory between the passes, or a
// persistent grid with a cluster reduction) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 2048;    // widest channel count (ResNet-50's last stage)
constexpr int kMaxVecs = 2;    // 16-byte vectors per thread per row: f32 C = 2048 is 512 vectors

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

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

// Pass 1: per-CTA partial sums over rows [g * rows_per_cta, ...) of x.
// Threads split as `rp` row groups of `lanes` threads; lane l owns vectors
// l, l + lanes, ... of a row. rp * C <= kMaxC for both types (see run_*).
template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, float* __restrict__ partial, long long n, int c,
               long long rows_per_cta) {
  constexpr int V = Vec<T>::kN;
  __shared__ float red[2][kMaxC];
  const int nv = c / V;
  const int lanes = nv < kThreads ? nv : kThreads;
  const int rp = kThreads / lanes;
  const int t = threadIdx.x;
  const int r0 = t / lanes, l = t % lanes;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long end = min(n, begin + rows_per_cta);
  float s[kMaxVecs][V], q[kMaxVecs][V];
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) s[j][i] = q[j][i] = 0.f;
  if (r0 < rp) {
#pragma unroll 4
    for (long long r = begin + r0; r < end; r += rp) {
      const T* row = x + r * c;
#pragma unroll
      for (int j = 0; j < kMaxVecs; ++j) {
        const int v = l + j * lanes;
        if (v < nv) {
          float f[V];
          load16(row + v * V, f);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s[j][i] += f[i];
            q[j][i] += f[i] * f[i];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j) {
      const int v = l + j * lanes;
      if (v < nv) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          red[0][r0 * c + v * V + i] = s[j][i];
          red[1][r0 * c + v * V + i] = q[j][i];
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * c;
  for (int ch = t; ch < c; ch += kThreads) {
    float a = 0.f, b = 0.f;
    for (int g = 0; g < rp; ++g) {  // the row groups, in order
      a += red[0][g * c + ch];
      b += red[1][g * c + ch];
    }
    out[ch] = a;
    out[c + ch] = b;
  }
}

// Pass 2: one thread per channel adds the G partials in order.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ partial, int g, const float* __restrict__ sc,
                float* __restrict__ stats, float* __restrict__ mi, int c, float nf, float eps) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  float s = 0.f, q = 0.f;
  for (int i = 0; i < g; ++i) {
    s += partial[static_cast<long long>(2 * i) * c + ch];
    q += partial[static_cast<long long>(2 * i + 1) * c + ch];
  }
  const float mean = s / nf;
  const float ex2 = q / nf;
  const float var = fmaxf(ex2 - __fmul_rn(mean, mean), 0.f);
  const float inv = 1.f / sqrtf(var + eps);
  stats[2 * ch] = mean;
  stats[2 * ch + 1] = ex2;
  mi[ch] = mean;
  mi[c + ch] = inv;
  mi[2 * c + ch] = __fmul_rn(inv, sc[ch]);
  mi[3 * c + ch] = sc[c + ch];
}

// Pass 3 (and the whole of rkt_bn_normalize): y = (x - mean) * (inv*scale)
// + bias [relu], mi rows 0, 2 and 3 staged in shared memory.
template <typename T, bool kAct>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ mi, T* __restrict__ y,
                 long long total_vecs, int c) {
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
    float f[V];
    load16(x + v * V, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float o = (f[i] - row[0][c0 + i]) * row[1][c0 + i] + row[2][c0 + i];
      if (kAct) o = o < 0.f ? 0.f : o;  // max(o, 0), NaN kept as jnp.maximum keeps it
      f[i] = o;
    }
    store16(y + v * V, f);
  }
}

template <typename T>
int launch_normalize(const void* x, const float* mi, void* y, long long n, int c, int blocks,
                     int act, cudaStream_t stream) {
  const long long total = n * c / Vec<T>::kN;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (act)
    normalize_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xs, mi, ys, total, c);
  else
    normalize_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xs, mi, ys, total, c);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2's CTAs: one thread per channel.
inline int finalize_ctas(int c) { return (c + kThreads - 1) / kThreads; }

template <typename T>
int run_twopass(const void* x, const float* sc, void* y, float* stats, float* mi, float* partial,
                long long n, int c, int grid, int norm_grid, float eps, int act,
                cudaStream_t stream) {
  const long long rows_per_cta = (n + grid - 1) / grid;
  moments_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), partial, n, c,
                                                   rows_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<finalize_ctas(c), kThreads, 0, stream>>>(
      partial, grid, sc, stats, mi, c, static_cast<float>(n), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_normalize<T>(x, mi, y, n, c, norm_grid, act, stream);
}

// which 0: the moments pass, 1: finalize, 2: normalize; grid is the CTAs
// the caller passes for passes 0 and 2.
template <typename T>
int query(int which, int c, int grid, int act, long long* info) {
  if (which == 0) return rkt_info::write(moments_kernel<T>, dim3(grid), kThreads, 0, info);
  if (which == 1)
    return rkt_info::write(finalize_kernel, dim3(finalize_ctas(c)), kThreads, 0, info);
  if (act) return rkt_info::write(normalize_kernel<T, true>, dim3(grid), kThreads, 0, info);
  return rkt_info::write(normalize_kernel<T, false>, dim3(grid), kThreads, 0, info);
}

bool shape_ok(long long n, int c) { return n >= 1 && c >= 8 && c <= kMaxC && c % 8 == 0; }

}  // namespace

// Row 9: x (N, C) in the operand type (dtype 0 f32, 1 bf16), sc (2, C) f32
// = [scale, bias] -> y (N, C) in x's type, stats (C, 2) f32; mi (4, C) f32
// and partial (grid, 2, C) f32 are scratch the caller allocates; grid and
// norm_grid are the CTAs of the moments and normalise passes. Returns the
// cudaError_t of the launches.
extern "C" int rkt_bn_twopass(const void* x, const void* sc, void* y, void* stats, void* mi,
                              void* partial, long long n, int c, int grid, int norm_grid,
                              float eps, int act, int dtype, void* stream) {
  if (!shape_ok(n, c) || grid < 1 || norm_grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  float* st = static_cast<float*>(stats);
  float* m = static_cast<float*>(mi);
  float* p = static_cast<float*>(partial);
  if (dtype == 1)
    return run_twopass<__nv_bfloat16>(x, scf, y, st, m, p, n, c, grid, norm_grid, eps, act, s);
  return run_twopass<float>(x, scf, y, st, m, p, n, c, grid, norm_grid, eps, act, s);
}

// Row 10: x (N, C), mi (4, C) f32 = [mean, inv, inv*scale, bias] -> y, in
// grid CTAs.
extern "C" int rkt_bn_normalize(const void* x, const void* mi, void* y, long long n, int c,
                                int grid, int act, int dtype, void* stream) {
  if (!shape_ok(n, c) || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mi);
  if (dtype == 1) return launch_normalize<__nv_bfloat16>(x, m, y, n, c, grid, act, s);
  return launch_normalize<float>(x, m, y, n, c, grid, act, s);
}

// The launch geometry of one pass of rkt_bn_twopass / rkt_bn_normalize
// (which as in query above) at these shapes (launch_info.cuh).
extern "C" int rkt_bn_launch_info(int which, int c, int grid, int act, int dtype,
                                  long long* info) {
  if (c < 8 || c > kMaxC || c % 8 || grid < 1 || which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return query<__nv_bfloat16>(which, c, grid, act, info);
  return query<float>(which, c, grid, act, info);
}
