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
//   * Split the context (decode_common.cuh, shared with row 2): one split
//     CTA per (slot, kv head, chunk of kChunk = 64 key rows), n_split =
//     ceil(MB * BL / 64) from the static shapes alone, so nothing reads
//     positions on the host. A CTA whose chunk starts past pos[s] exits at
//     once.
//   * Stage the chunk. One block-table lookup per page the chunk spans
//     (issued beside the read of pos[s]), then every live K and V row of
//     the chunk is in flight at once as 16-byte cp.async copies into
//     shared memory (a pool row of D elements is contiguous and 16-byte
//     aligned: D % 8 == 0). The q rows of the kv head are staged in f32
//     meanwhile, scaled by log2(e) / sqrt(D).
//   * Compute from shared memory and combine in a fixed order as
//     decode_common.cuh describes (split_partial, combine_splits): no
//     atomics, so two calls give the same bits.
//
// Left for later: TMA page loads, wgmma for large g, a persistent grid.
#include "decode_common.cuh"
#include "launch_info.cuh"
#include "mma_common.cuh"

namespace {

using namespace rkt_decode;

// Splits per (slot, kv head): from the static shapes alone.
inline int num_splits(int max_blocks, int block_len) {
  return (max_blocks * block_len + kChunk - 1) / kChunk;
}

// Dynamic shared memory of one split CTA: split_partial's operands, then
// the chunk's page ids.
inline size_t paged_smem(int g, int d, int itemsize) {
  return split_smem(g, d, itemsize) + sizeof(int) * (kChunk + 4);
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
  const int g = hq / h_kv, ld = row_ld<T>(d);
  const int tid = threadIdx.x;
  const SplitSmem<T> sm(smem, g, d);
  int* page_s = reinterpret_cast<int*>(sm.tail);

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
    rkt_mma::cp_async16(sm.k + r * ld + e, k_pages + off, true);
    rkt_mma::cp_async16(sm.v + r * ld + e, v_pages + off, true);
  }
  rkt_mma::cp_async_commit();
  stage_q(sm.q, q + (static_cast<long long>(s) * hq + static_cast<long long>(h) * g) * d, g, d,
          scale2);
  rkt_mma::cp_async_wait<0>();
  __syncthreads();
  split_partial(sm, rows, g, d,
                part + ((static_cast<long long>(s) * h_kv + h) * gridDim.z + c) *
                           record_floats(g, d));
}

// Fold the live splits of each (slot, kv head) in split order and write
// the g output rows once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* part, const int* positions, T* out, int hq, int h_kv, int d,
                     int block_len, int max_blocks, int n_split) {
  const int s = blockIdx.x, h = blockIdx.y, g = hq / h_kv;
  const int n = visible_rows(positions, s, max_blocks * block_len);
  combine_splits(part + (static_cast<long long>(s) * h_kv + h) * n_split * record_floats(g, d),
                 (n + kChunk - 1) / kChunk, g, d,
                 out + (static_cast<long long>(s) * hq + static_cast<long long>(h) * g) * d);
}

// Launch 1: one CTA per (slot, kv head, split); launch 2: one per (slot,
// kv head).
inline dim3 split_grid(int num_slots, int h_kv, int max_blocks, int block_len) {
  return dim3(num_slots, h_kv, num_splits(max_blocks, block_len));
}
inline dim3 combine_grid(int num_slots, int h_kv) { return dim3(num_slots, h_kv); }

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages, const int* block_table,
        const int* positions, void* out, float* workspace, int num_slots, int hq, int h_kv,
        int d, int num_blocks, int block_len, int max_blocks, float scale2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = paged_smem(hq / h_kv, d, sizeof(T));
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
                           paged_smem(hq / h_kv, d, sizeof(T)), info);
  return rkt_info::write(paged_combine_kernel<T>, combine_grid(num_slots, h_kv), kThreads, 0,
                         info);
}

template <typename T>
int kernel_attribute(int which, int what, int g, int d) {
  return which == 0 ? attribute(paged_split_kernel<T>, what, paged_smem(g, d, sizeof(T)))
                    : attribute(paged_combine_kernel<T>, what, 0);
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
  if (dtype == 1) return kernel_attribute<__nv_bfloat16>(which, what, g, d);
  return kernel_attribute<float>(which, what, g, d);
}
