// Split-K core of the two decode attention kernels: paged_decode.cu (row 1,
// K/V rows in a block pool behind a block table) and decode_attention.cu
// (row 2, a dense (B, Hkv, T, D) cache). Both answer one query row per
// (slot or batch row, query head) over its visible key rows, softmax in
// f32, and both are bound by latency before bytes: one CTA walking a whole
// context alone waits on chains of dependent loads. So both split the
// context:
//
//   * Launch 1 (split) has one CTA per (row, kv head, chunk of kChunk = 64
//     key rows); the chunk count comes from the static shapes alone, so the
//     grid does not change from token to token. The CTA stages its chunk's
//     live K and V rows in shared memory with 16-byte cp.async copies (each
//     kernel finds its rows its own way) at a row stride of D * itemsize +
//     kRowPad bytes, and the g = Hq / Hkv query rows of its kv head in f32,
//     scaled by log2(e) / sqrt(D) (GQA is native: one pass over the chunk
//     serves all g heads).
//   * split_partial() then computes from shared memory with every thread
//     busy: two threads per key row for the scores (16-byte reads, one
//     shuffle), one warp per query head for the chunk's max m and sum l
//     (base 2), and for P.V one thread per (query head, feature) and row
//     group, the groups summed in a fixed order. It writes the unnormalised
//     f32 accumulator, m and l as the split's workspace record.
//   * Launch 2 (combine) has one CTA per (row, kv head): combine_splits()
//     folds the live records in split order (running max, rescaled sums)
//     and writes the output once, in the operand dtype. No atomics: two
//     calls give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rkt_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;    // key rows per split
constexpr int kRowPad = 16;   // bytes of padding per staged row
static_assert(kChunk == 2 * 32 && kThreads == 2 * kChunk, "two rows a lane, two threads a row");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of shared memory as f32: four floats or eight bf16.
__device__ __forceinline__ void load16(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
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

// Floats of one split's workspace record: g accumulator rows of d, then
// g maxima, then g sums.
__host__ __device__ inline int record_floats(int g, int d) { return g * (d + 2); }

// Elements of a staged K or V row (d and its padding).
template <typename T>
__host__ __device__ inline int row_ld(int d) {
  return d + kRowPad / static_cast<int>(sizeof(T));
}

// Dynamic shared memory of split_partial's operands: K and V of the chunk,
// q in f32, a score per (query head, row), the P.V row-group partials, and
// m and l per query head. A kernel may place more after it (SplitSmem::tail).
inline size_t split_smem(int g, int d, int itemsize) {
  const size_t row = static_cast<size_t>(d) * itemsize + kRowPad;
  return 2 * kChunk * row + sizeof(float) * (g * d + g * kChunk + kThreads + 2 * g);
}

// The split CTA's shared memory, carved as split_smem() sizes it.
template <typename T>
struct SplitSmem {
  T* k;
  T* v;
  float* q;
  float* s;    // g x kChunk scores, then probabilities
  float* red;  // P.V row-group partials
  float* ml;   // m of each query head, then l
  unsigned char* tail;
  __device__ SplitSmem(unsigned char* raw, int g, int d) {
    const int ld = row_ld<T>(d);
    k = reinterpret_cast<T*>(raw);
    v = k + kChunk * ld;
    q = reinterpret_cast<float*>(v + kChunk * ld);
    s = q + g * d;
    red = s + g * kChunk;
    ml = red + kThreads;
    tail = reinterpret_cast<unsigned char*>(ml + 2 * g);
  }
};

// The g query rows of a kv head (qg: g x d contiguous) into shared memory
// in f32, times scale2 = log2(e) / sqrt(D).
template <typename T>
__device__ __forceinline__ void stage_q(float* q_s, const T* qg, int g, int d, float scale2) {
  for (int i = threadIdx.x; i < g * d; i += kThreads) q_s[i] = to_f32(qg[i]) * scale2;
}

// After the chunk's `rows` (>= 1) live K/V rows and q are in sm (and a
// barrier): the chunk's scores, statistics and unnormalised P.V, written
// to rec (record_floats(g, d) floats). Every thread of the CTA calls it.
template <typename T>
__device__ void split_partial(const SplitSmem<T>& sm, int rows, int g, int d, float* rec) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte piece
  const int ld = row_ld<T>(d);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // Scores: threads 2r and 2r + 1 take the even and odd 16-byte pieces of
  // key row r; rows past the visible ones score -inf.
  {
    const int r = tid / 2, half = tid % 2;
    for (int j = 0; j < g; ++j) {
      float acc = 0.f;
      if (r < rows) {
        const T* krow = sm.k + r * ld;
        const float* qj = sm.q + j * d;
        for (int e = half * kVec; e < d; e += 2 * kVec) {
          float kf[kVec];
          load16(kf, krow + e);
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc = fmaf(qj[e + x], kf[x], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) sm.s[j * kChunk + r] = r < rows ? acc : -INFINITY;
    }
  }
  __syncthreads();

  // Softmax statistics of the chunk, one warp per query head (base 2; row
  // 0 of a live chunk is visible, so the max is finite).
  for (int j = warp; j < g; j += kWarps) {
    float* sj = sm.s + j * kChunk;
    const float a = sj[lane], b = sj[lane + 32];
    const float mx = warp_max(fmaxf(a, b));
    const float pa = exp2f(a - mx), pb = exp2f(b - mx);
    sj[lane] = pa;
    sj[lane + 32] = pb;
    const float sum = warp_sum(pa + pb);
    if (lane == 0) {
      sm.ml[j] = mx;
      sm.ml[g + j] = sum;
    }
  }
  __syncthreads();

  // P.V: element e = (query head j, feature dd); when g * d < kThreads the
  // rows are dealt to `groups` row groups per element, summed in order.
  const int elems = g * d;
  const int groups = max(1, kThreads / elems);
  if (groups > 1) {
    float a = 0.f;
    if (tid < groups * elems) {
      const int e = tid % elems, rg = tid / elems, j = e / d, dd = e - j * d;
      const float* pj = sm.s + j * kChunk;
      for (int r = rg; r < rows; r += groups) a = fmaf(pj[r], to_f32(sm.v[r * ld + dd]), a);
    }
    sm.red[tid] = a;
    __syncthreads();
    for (int e = tid; e < elems; e += kThreads) {
      float sum = 0.f;
      for (int rg = 0; rg < groups; ++rg) sum += sm.red[rg * elems + e];
      rec[e] = sum;
    }
  } else {
    for (int e = tid; e < elems; e += kThreads) {
      const int j = e / d, dd = e - j * d;
      const float* pj = sm.s + j * kChunk;
      float a = 0.f;
      for (int r = 0; r < rows; ++r) a = fmaf(pj[r], to_f32(sm.v[r * ld + dd]), a);
      rec[e] = a;
    }
  }
  for (int i = tid; i < 2 * g; i += kThreads) rec[elems + i] = sm.ml[i];
}

// Fold the `live` records of one (row, kv head) (the first at base, one
// every record_floats(g, d) floats) in split order and write its g output
// rows (og: g x d) once.
template <typename T>
__device__ void combine_splits(const float* base, int live, int g, int d, T* og) {
  const int elems = g * d, stride = record_floats(g, d);
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int j = e / d;
    float m = -INFINITY, l = 0.f, acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
      const float* rec = base + static_cast<long long>(c) * stride;
      const float mc = rec[elems + j], lc = rec[elems + g + j], ac = rec[e];
      const float m_new = fmaxf(m, mc);
      const float a_old = exp2f(m - m_new), a_c = exp2f(mc - m_new);
      l = l * a_old + lc * a_c;
      acc = acc * a_old + ac * a_c;
      m = m_new;
    }
    og[e] = from_f32<T>(acc / l);
  }
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Resident CTAs per SM (what 0) or registers per thread (what 1) of a
// kernel launched with kThreads threads and smem bytes of dynamic shared
// memory; -1 when the card refuses it.
template <typename Kernel>
int attribute(Kernel kernel, int what, size_t smem) {
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
  }
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace rkt_decode
