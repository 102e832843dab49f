// Paged-KV decode attention (C = 1) for the serving engine.
//
// Replaces: rocket_tpu/ops/paged_attention.py, _decode_kernel (:137),
// launched by _paged_decode_pallas (:191, pallas_call at :230).
//
// Computes, for every slot s and query head, causal attention of the
// slot's one new query row (at global position pos[s]) over key positions
// [0, pos[s]] of its sequence, whose K/V rows live in the shared block
// pool k_pages / v_pages (NB, BL, Hkv, D) at block_table[s, t / BL], row
// t % BL. The slot's new K/V row was scattered into the pool before the
// launch, so position pos[s] is read from the pool like every other.
//
// Bound on the H100: bytes. Each (slot, kv head) reads its live K and V
// rows once (2 * (pos+1) * D * itemsize) plus q and out; the arithmetic is
// ~4 * g * D flops per key row, far below the card's ~295 flops/byte
// balance point. Design response:
//   * one CTA per (slot, kv head) serves all g = Hq / Hkv query heads of
//     that kv head from ONE pass over its pages (native GQA);
//   * the walk stops at the live length ceil((pos+1) / BL) pages — the TPU
//     grid visits all MB pages and skips dead ones with pl.when; here the
//     trash pages past the end are never read at all;
//   * online softmax in f32 over bf16/f32 operands, output written once.
// Later work (split-K over long contexts, TMA page loads, wgmma for large
// g) is left out on purpose: this is the simple, correct first kernel.
#include "decode_common.cuh"

namespace {

struct PagedRows {
  const int* table_row;  // block_table[s, :]
  int block_len, num_blocks, h_kv, d, h;
  __device__ long long operator()(int t) const {
    int blk = table_row[t / block_len];
    blk = min(max(blk, 0), num_blocks - 1);  // a bad id reads a real block, never out of bounds
    return ((static_cast<long long>(blk) * block_len + t % block_len) * h_kv + h) * d;
  }
};

template <typename T>
__global__ void __launch_bounds__(rkt::kThreads)
paged_decode_kernel(const T* q, const T* k_pages, const T* v_pages, const int* block_table,
                    const int* positions, T* out, int hq, int h_kv, int d, int num_blocks,
                    int block_len, int max_blocks, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, g = hq / h_kv;
  const int n = max(1, min(positions[s] + 1, max_blocks * block_len));
  const PagedRows rows{block_table + static_cast<long long>(s) * max_blocks, block_len,
                       num_blocks, h_kv, d, h};
  const long long q_off = (static_cast<long long>(s) * hq + h * g) * d;
  rkt::attend_rows<T>(q + q_off, k_pages, v_pages, rows, n, g, d, scale, out + q_off, smem);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages, const int* block_table,
        const int* positions, void* out, int num_slots, int hq, int h_kv, int d,
        int num_blocks, int block_len, int max_blocks, float scale, void* stream) {
  const size_t smem = rkt::attend_smem_bytes(hq / h_kv, d);
  return rkt::launch(paged_decode_kernel<T>, dim3(num_slots, h_kv), smem, stream,
                     static_cast<const T*>(q), static_cast<const T*>(k_pages),
                     static_cast<const T*>(v_pages), block_table, positions,
                     static_cast<T*>(out), hq, h_kv, d, num_blocks, block_len, max_blocks,
                     scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rkt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                const int* block_table, const int* positions, void* out,
                                int num_slots, int hq, int h_kv, int d, int num_blocks,
                                int block_len, int max_blocks, float scale, int dtype,
                                void* stream) {
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_pages, v_pages, block_table, positions, out, num_slots, hq,
                              h_kv, d, num_blocks, block_len, max_blocks, scale, stream);
  return run<float>(q, k_pages, v_pages, block_table, positions, out, num_slots, hq, h_kv, d,
                    num_blocks, block_len, max_blocks, scale, stream);
}
