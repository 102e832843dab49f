// Paged-KV decode attention (C = 1) for the serving engine, split over the
// context ("flash-decoding").
//
// Replaces: rocket_tpu/ops/paged_attention.py, _decode_kernel (:137),
// launched by _paged_decode_pallas (:191, pallas_call at :230).
//
// Computes, for every slot s and query head, causal attention of the
// slot's one new query row (at global position pos[s]) over key positions
// [0, pos[s]] of its sequence, whose K/V rows live in the shared block
// pool k_pages / v_pages (NB, BL, Hkv, D) at block_table[s, t / BL], row
// t % BL. The slot's new K/V row was scattered into the pool before the
// launch, so position pos[s] is read from the pool like every other. A bad
// table id is clamped to a real block, never read out of bounds.
//
// Bound on the H100: bytes. Each (slot, kv head) reads its live K and V
// rows once (2 * (pos+1) * D * itemsize) plus q and out; the arithmetic is
// ~4 * g * D flops per key row, far below the card's ~295 flops/byte
// balance point. What held the first kernel back was latency, not
// bandwidth: one CTA per (slot, kv head) walked its whole context alone,
// reading K and V through chains of dependent 2-byte loads. Design:
//
//   * Split the context. Launch 1 (split) has one CTA per (slot, kv head,
//     chunk of kChunk = 64 key rows): n_split = ceil(MB * BL / 64) comes
//     from the static shapes alone, so nothing reads positions on the host.
//     A CTA whose chunk starts past pos[s] exits at once.
//   * Stage the chunk. One block-table lookup per page the chunk spans
//     (issued beside the read of pos[s]), then every live K and V row of
//     the chunk is in flight at once as 16-byte cp.async copies into
//     shared memory (a pool row of D elements is contiguous and 16-byte
//     aligned: D % 8 == 0). The q rows of the kv head are staged in f32
//     meanwhile, scaled by log2(e) / sqrt(D).
//   * Compute from shared memory with every thread busy: two threads per
//     key row for the scores (16-byte reads, one shuffle), one warp per
//     query head for the chunk's max and sum (base-2), and for P.V one
//     thread per (query head, feature) and row group, the groups summed in
//     a fixed order. GQA is native: the CTA serves the g = Hq / Hkv query
//     heads of its kv head from one pass over the chunk.
//   * Combine in a fixed order. Each live split writes its unnormalised
//     f32 accumulator, its max m and its sum l into a workspace; launch 2
//     (combine), one CTA per (slot, kv head), folds the live splits in
//     split order (running max, rescaled sums) and writes the output once,
//     in the operand dtype. No atomics: two calls give the same bits.
//
// Left for later: TMA page loads, wgmma for large g, a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch_info.cuh"
#include "mma_common.cuh"

namespace {

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

// Splits per (slot, kv head): from the static shapes alone.
inline int num_splits(int max_blocks, int block_len) {
  return (max_blocks * block_len + kChunk - 1) / kChunk;
}

// Floats of one split's workspace record: g accumulator rows of d, then
// g maxima, then g sums.
__host__ __device__ inline int record_floats(int g, int d) { return g * (d + 2); }

// Dynamic shared memory of one split CTA: K and V of the chunk (row stride
// d * itemsize + 16 bytes), q in f32, a score per (query head, row), the
// P.V row-group partials, m and l per query head, and the chunk's page ids.
inline size_t split_smem(int g, int d, int itemsize) {
  const size_t row = static_cast<size_t>(d) * itemsize + kRowPad;
  return 2 * kChunk * row + sizeof(float) * (g * d + g * kChunk + kThreads + 2 * g) +
         sizeof(int) * (kChunk + 4);
}

// The visible rows of slot s: [0, pos + 1), at least one, at most the
// table's MB * BL.
__device__ __forceinline__ int visible_rows(const int* positions, int s, int max_rows) {
  return max(1, min(positions[s] + 1, max_rows));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* q, const T* k_pages, const T* v_pages, const int* block_table,
                   const int* positions, float* part, int hq, int h_kv, int d, int num_blocks,
                   int block_len, int max_blocks, float scale2) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int g = hq / h_kv, ld = d + kRowPad / static_cast<int>(sizeof(T));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kChunk * ld;
  float* q_s = reinterpret_cast<float*>(v_s + kChunk * ld);
  float* s_s = q_s + g * d;     // g x kChunk scores, then probabilities
  float* red = s_s + g * kChunk;
  float* ml = red + kThreads;   // m of each query head, then l
  int* page_s = reinterpret_cast<int*>(ml + 2 * g);

  // The chunk's page ids and the slot's position are independent reads:
  // both are in flight before either is waited on.
  const int row0 = c * kChunk;
  const int page0 = row0 / block_len;
  const int pages = min((row0 + kChunk - 1) / block_len, max_blocks - 1) - page0 + 1;
  const int* table_row = block_table + static_cast<long long>(s) * max_blocks;
  const int blk = tid < pages ? table_row[page0 + tid] : 0;
  const int n = visible_rows(positions, s, max_blocks * block_len);
  if (row0 >= n) return;  // the chunk starts past the slot's position
  if (tid < pages) page_s[tid] = min(max(blk, 0), num_blocks - 1);
  const int rows = min(kChunk, n - row0);
  __syncthreads();

  // Every live K and V row of the chunk in flight at once.
  const int vecs = d / kVec;
  const long long head = static_cast<long long>(h) * d;
  for (int i = tid; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, e = (i - r * vecs) * kVec;
    const int row = row0 + r;
    const long long off =
        (static_cast<long long>(page_s[row / block_len - page0]) * block_len + row % block_len) *
            h_kv * d + head + e;
    rkt_mma::cp_async16(k_s + r * ld + e, k_pages + off, true);
    rkt_mma::cp_async16(v_s + r * ld + e, v_pages + off, true);
  }
  rkt_mma::cp_async_commit();
  const T* qg = q + (static_cast<long long>(s) * hq + static_cast<long long>(h) * g) * d;
  for (int i = tid; i < g * d; i += kThreads) q_s[i] = to_f32(qg[i]) * scale2;
  rkt_mma::cp_async_wait<0>();
  __syncthreads();

  // Scores: threads 2r and 2r + 1 take the even and odd 16-byte pieces of
  // key row r; rows past the position score -inf.
  {
    const int r = tid / 2, half = tid % 2;
    for (int j = 0; j < g; ++j) {
      float acc = 0.f;
      if (r < rows) {
        const T* krow = k_s + r * ld;
        const float* qj = q_s + j * d;
        for (int e = half * kVec; e < d; e += 2 * kVec) {
          float kf[kVec];
          load16(kf, krow + e);
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc = fmaf(qj[e + x], kf[x], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) s_s[j * kChunk + r] = r < rows ? acc : -INFINITY;
    }
  }
  __syncthreads();

  // Softmax statistics of the chunk, one warp per query head (base 2; row
  // 0 of a live chunk is visible, so the max is finite).
  for (int j = warp; j < g; j += kWarps) {
    float* sj = s_s + j * kChunk;
    const float a = sj[lane], b = sj[lane + 32];
    const float mx = warp_max(fmaxf(a, b));
    const float pa = exp2f(a - mx), pb = exp2f(b - mx);
    sj[lane] = pa;
    sj[lane + 32] = pb;
    const float sum = warp_sum(pa + pb);
    if (lane == 0) {
      ml[j] = mx;
      ml[g + j] = sum;
    }
  }
  __syncthreads();

  // P.V: element e = (query head j, feature dd); when g * d < kThreads the
  // rows are dealt to `groups` row groups per element, summed in order.
  const int elems = g * d;
  const int groups = max(1, kThreads / elems);
  float* rec = part + ((static_cast<long long>(s) * h_kv + h) * gridDim.z + c) *
                          record_floats(g, d);
  if (groups > 1) {
    float a = 0.f;
    if (tid < groups * elems) {
      const int e = tid % elems, rg = tid / elems, j = e / d, dd = e - j * d;
      const float* pj = s_s + j * kChunk;
      for (int r = rg; r < rows; r += groups) a = fmaf(pj[r], to_f32(v_s[r * ld + dd]), a);
    }
    red[tid] = a;
    __syncthreads();
    for (int e = tid; e < elems; e += kThreads) {
      float sum = 0.f;
      for (int rg = 0; rg < groups; ++rg) sum += red[rg * elems + e];
      rec[e] = sum;
    }
  } else {
    for (int e = tid; e < elems; e += kThreads) {
      const int j = e / d, dd = e - j * d;
      const float* pj = s_s + j * kChunk;
      float a = 0.f;
      for (int r = 0; r < rows; ++r) a = fmaf(pj[r], to_f32(v_s[r * ld + dd]), a);
      rec[e] = a;
    }
  }
  for (int i = tid; i < 2 * g; i += kThreads) rec[elems + i] = ml[i];
}

// Fold the live splits of each (slot, kv head) in split order and write
// the g output rows once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* part, const int* positions, T* out, int hq, int h_kv, int d,
                     int block_len, int max_blocks, int n_split) {
  const int s = blockIdx.x, h = blockIdx.y, g = hq / h_kv;
  const int n = visible_rows(positions, s, max_blocks * block_len);
  const int live = (n + kChunk - 1) / kChunk;
  const int elems = g * d, stride = record_floats(g, d);
  const float* base = part + (static_cast<long long>(s) * h_kv + h) * n_split * stride;
  T* og = out + (static_cast<long long>(s) * hq + static_cast<long long>(h) * g) * d;
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

// Launch 1: one CTA per (slot, kv head, split); launch 2: one per (slot,
// kv head).
inline dim3 split_grid(int num_slots, int h_kv, int max_blocks, int block_len) {
  return dim3(num_slots, h_kv, num_splits(max_blocks, block_len));
}
inline dim3 combine_grid(int num_slots, int h_kv) { return dim3(num_slots, h_kv); }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages, const int* block_table,
        const int* positions, void* out, float* workspace, int num_slots, int hq, int h_kv,
        int d, int num_blocks, int block_len, int max_blocks, float scale2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = split_smem(hq / h_kv, d, sizeof(T));
  cudaError_t err = prepare(paged_split_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_split_kernel<T><<<split_grid(num_slots, h_kv, max_blocks, block_len), kThreads, smem,
                          st>>>(static_cast<const T*>(q), static_cast<const T*>(k_pages),
                                static_cast<const T*>(v_pages), block_table, positions,
                                workspace, hq, h_kv, d, num_blocks, block_len, max_blocks,
                                scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<T><<<combine_grid(num_slots, h_kv), kThreads, 0, st>>>(
      workspace, positions, static_cast<T*>(out), hq, h_kv, d, block_len, max_blocks,
      num_splits(max_blocks, block_len));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int query(int which, int num_slots, int hq, int h_kv, int d, int max_blocks, int block_len,
          long long* info) {
  if (which == 0)
    return rkt_info::write(paged_split_kernel<T>,
                           split_grid(num_slots, h_kv, max_blocks, block_len), kThreads,
                           split_smem(hq / h_kv, d, sizeof(T)), info);
  return rkt_info::write(paged_combine_kernel<T>, combine_grid(num_slots, h_kv), kThreads, 0,
                         info);
}

// Resident CTAs per SM (what 0) or registers per thread (what 1) of the
// split (which 0) or combine (which 1) kernel; -1 when the card refuses it.
template <typename T>
int attribute(int which, int what, int g, int d) {
  const size_t smem = which == 0 ? split_smem(g, d, sizeof(T)) : 0;
  auto get = [&](auto kernel) {
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
  };
  return which == 0 ? get(paged_split_kernel<T>) : get(paged_combine_kernel<T>);
}

}  // namespace

// out (S, Hq, D) in the operand dtype; workspace: S * Hkv * n_split *
// g * (D + 2) floats (rkt_paged_decode_workspace), written and read here
// only. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches.
extern "C" int rkt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                const int* block_table, const int* positions, void* out,
                                float* workspace, int num_slots, int hq, int h_kv, int d,
                                int num_blocks, int block_len, int max_blocks, float scale2,
                                int dtype, void* stream) {
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_pages, v_pages, block_table, positions, out, workspace,
                              num_slots, hq, h_kv, d, num_blocks, block_len, max_blocks, scale2,
                              stream);
  return run<float>(q, k_pages, v_pages, block_table, positions, out, workspace, num_slots, hq,
                    h_kv, d, num_blocks, block_len, max_blocks, scale2, stream);
}

// Floats of the workspace rkt_paged_decode needs at these shapes.
extern "C" long long rkt_paged_decode_workspace(int num_slots, int hq, int h_kv, int d,
                                                int max_blocks, int block_len) {
  return static_cast<long long>(num_slots) * h_kv * num_splits(max_blocks, block_len) *
         record_floats(hq / h_kv, d);
}

// The launch geometry of rkt_paged_decode's split (which 0) or combine
// (which 1) launch at these shapes (launch_info.cuh).
extern "C" int rkt_paged_decode_launch_info(int which, int num_slots, int hq, int h_kv, int d,
                                            int max_blocks, int block_len, int dtype,
                                            long long* info) {
  if (dtype == 1)
    return query<__nv_bfloat16>(which, num_slots, hq, h_kv, d, max_blocks, block_len, info);
  return query<float>(which, num_slots, hq, h_kv, d, max_blocks, block_len, info);
}

// Resident CTAs per SM (what 0) or registers per thread (what 1) of the
// split (which 0) or combine (which 1) kernel for g query heads per kv
// head at head dim d; -1 when the card refuses it.
extern "C" int rkt_paged_decode_attribute(int which, int what, int g, int d, int dtype) {
  if (dtype == 1) return attribute<__nv_bfloat16>(which, what, g, d);
  return attribute<float>(which, what, g, d);
}
