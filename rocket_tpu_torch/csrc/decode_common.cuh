// Shared core of the two decode kernels: single-query-position GQA
// attention over n key rows, with an online (flash-style) softmax in f32.
//
// One CTA serves one (batch row or slot, kv head): the g = Hq / Hkv query
// rows of that kv head are answered from ONE pass over its key/value rows,
// so K/V are read from device memory once per kv head (native GQA, no
// head repeat). Rows are walked in tiles of kTile; a RowAddr functor maps
// a key row to its element offset, which is the only thing the paged and
// the contiguous layouts disagree on.
//
// Per tile:
//   1. row offsets into shared memory (one block-table lookup per row);
//   2. scores: one warp per key row, each lane holding up to 8 of the D
//      features of that row in registers, dotted with every query row and
//      reduced by shuffles;
//   3. statistics: one warp per query row updates the running max m and
//      denominator l and turns the tile's scores into exp(s - m);
//   4. accumulator: one thread per (query row, feature) rescales its f32
//      accumulator and adds p * v over the tile's rows — consecutive
//      threads read consecutive features, so V loads coalesce.
// The normalised output is written once, in the operands' dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rkt {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // key rows per online-softmax step
constexpr int kMaxDPerLane = 8;    // D <= 256 = 32 lanes x 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory one CTA needs for g query rows of width d.
inline size_t attend_smem_bytes(int g, int d) {
  return sizeof(long long) * kTile + sizeof(float) * (2 * g * d + g * kTile + 3 * g);
}

// q: the CTA's g query rows (contiguous, g x d); k, v: base pointers the
// RowAddr offsets index; n >= 1 visible key rows; out: g x d.
template <typename T, typename RowAddr>
__device__ void attend_rows(const T* q, const T* k, const T* v, const RowAddr& row, int n,
                            int g, int d, float scale, T* out, unsigned char* smem_raw) {
  long long* off_s = reinterpret_cast<long long*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(off_s + kTile);
  float* acc = q_s + g * d;
  float* p_s = acc + g * d;
  float* m_s = p_s + g * kTile;
  float* l_s = m_s + g;
  float* a_s = l_s + g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < g * d; i += kThreads) {
    q_s[i] = to_f32(q[i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  for (int base = 0; base < n; base += kTile) {
    const int rows = min(kTile, n - base);
    for (int t = tid; t < rows; t += kThreads) off_s[t] = row(base + t);
    __syncthreads();

    for (int t = warp; t < rows; t += kWarps) {
      const T* krow = k + off_s[t];
      float kreg[kMaxDPerLane];
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j) {
        const int dd = lane + 32 * j;
        kreg[j] = dd < d ? to_f32(krow[dd]) : 0.f;
      }
      for (int r = 0; r < g; ++r) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxDPerLane; ++j) {
          const int dd = lane + 32 * j;
          if (dd < d) s += q_s[r * d + dd] * kreg[j];
        }
        s = warp_sum(s);
        if (lane == 0) p_s[r * kTile + t] = s;
      }
    }
    __syncthreads();

    for (int r = warp; r < g; r += kWarps) {
      float* p = p_s + r * kTile;
      float mx = -INFINITY;
      for (int t = lane; t < rows; t += 32) mx = fmaxf(mx, p[t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[r], mx);
      float sum = 0.f;
      for (int t = lane; t < rows; t += 32) {
        const float e = __expf(p[t] - m_new);
        p[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = __expf(m_s[r] - m_new);  // 0 on the first tile
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * d; i += kThreads) {
      const int r = i / d, dd = i - r * d;
      const float* p = p_s + r * kTile;
      float a = acc[i] * a_s[r];
      for (int t = 0; t < rows; ++t) a += p[t] * to_f32(v[off_s[t] + dd]);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * d; i += kThreads) out[i] = from_f32<T>(acc[i] / l_s[i / d]);
}

// Launch helper: raise the dynamic shared-memory cap when a CTA needs more
// than the default 48 KB, launch on the caller's stream and return the
// launch status (a refused launch never runs, and a later synchronise
// would not report it).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rkt
