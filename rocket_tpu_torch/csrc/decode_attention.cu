// Fused single-token decode attention for generate()'s cached loop, split
// over the context.
//
// Replaces: rocket_tpu/ops/decode_attention.py, _kernel (:64), launched by
// decode_attention (:112, pallas_call at :198).
//
// Per (batch row b, kv head h): writes row `pos` of the (B, Hkv, T, D)
// K/V caches IN PLACE with k_new / v_new, then answers the g = Hq / Hkv
// query heads of that kv head with attention over cache rows [0, pos)
// plus the current token's own row (the self term), f32 softmax, the
// output rounded once.
//
// Bound on the H100: bytes. The cache rows [0, pos) of K and V are read
// once per (b, h), and q, k_new, v_new, out and the written row are moved
// once; the flops are ~4 * g * D per key row. Like row 1 before its split
// design, the first kernel (one CTA per (b, h) walking the whole cache
// through dependent 2-byte V loads) was bound by latency, not bytes. The
// design is row 1's (decode_common.cuh):
//
//   * Split the context into kChunk = 64-row chunks: grid (B, Hkv,
//     n_split = ceil(T / 64)) from the static T, not from pos, so the grid
//     does not change from token to token. A CTA whose chunk starts past
//     pos exits at once.
//   * Stage the chunk's live rows with 16-byte cp.async copies into padded
//     shared memory; the (b, h) plane is contiguous (row t at base + t * D),
//     with no page table.
//   * The self term, with no race between CTAs: only the split whose chunk
//     holds row pos touches that row. It stages it from k_new / v_new, not
//     from the cache, and it alone writes it into both caches (bitwise: the
//     new rows arrive in the cache dtype). No other CTA reads row pos, so
//     the order of the write and the reads does not matter.
//   * Compute from shared memory and fold the f32 partials in split order
//     in a second launch (split_partial, combine_splits): no atomics, so
//     two calls give the same bits. The combine is launched with
//     programmatic stream serialization: it starts while the splits run
//     and waits for them in griddepcontrol.wait, so its launch gap, a
//     good part of a call this short, is hidden.
//
// Any T; D % 8 == 0 and D <= 256 (16-byte pieces, two threads a key row).
// The workspace holds one record of g * (D + 2) floats per (b, h, split):
// about g / 64 of the cache's own bytes in f32, never more than the cache.
#include "decode_common.cuh"
#include "launch_info.cuh"
#include "mma_common.cuh"

namespace {

using namespace rkt_decode;

// Splits per (b, kv head): from the static cache length alone.
inline int num_splits(int t_max) { return (t_max + kChunk - 1) / kChunk; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* q, const T* k_new, const T* v_new, T* k_cache, T* v_cache,
                    float* part, int hq, int h_kv, int t_max, int d, int pos, float scale2) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  // The combine launch may start now; it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int row0 = c * kChunk;
  if (row0 > pos) return;  // the chunk starts past the token's row
  const int g = hq / h_kv, ld = row_ld<T>(d), tid = threadIdx.x;
  const int rows = min(kChunk, pos + 1 - row0);
  const int self = pos - row0;  // < rows exactly when this chunk holds row pos
  const SplitSmem<T> sm(smem, g, d);
  const long long bh = static_cast<long long>(b) * h_kv + h;
  T* kc = k_cache + bh * t_max * d;
  T* vc = v_cache + bh * t_max * d;
  const T* kn = k_new + bh * d;
  const T* vn = v_new + bh * d;

  // Every live K and V row of the chunk in flight at once; row pos from
  // the new rows.
  const int vecs = d / kVec;
  for (int i = tid; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, e = (i - r * vecs) * kVec;
    const long long off = static_cast<long long>(row0 + r) * d + e;
    rkt_mma::cp_async16(sm.k + r * ld + e, r == self ? kn + e : kc + off, true);
    rkt_mma::cp_async16(sm.v + r * ld + e, r == self ? vn + e : vc + off, true);
  }
  rkt_mma::cp_async_commit();
  if (self < rows) {  // this CTA alone owns row pos of both caches
    for (int e = tid * kVec; e < d; e += kThreads * kVec) {
      *reinterpret_cast<uint4*>(kc + static_cast<long long>(pos) * d + e) =
          *reinterpret_cast<const uint4*>(kn + e);
      *reinterpret_cast<uint4*>(vc + static_cast<long long>(pos) * d + e) =
          *reinterpret_cast<const uint4*>(vn + e);
    }
  }
  stage_q(sm.q, q + (static_cast<long long>(b) * hq + static_cast<long long>(h) * g) * d, g, d,
          scale2);
  rkt_mma::cp_async_wait<0>();
  __syncthreads();
  split_partial(sm, rows, g, d, part + (bh * gridDim.z + c) * record_floats(g, d));
}

// Fold the pos / 64 + 1 live splits of each (b, kv head) in split order and
// write its g output rows once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* part, T* out, int hq, int h_kv, int d, int pos,
                      int n_split) {
  const int b = blockIdx.x, h = blockIdx.y, g = hq / h_kv;
  // Launched early (programmatic stream serialization): wait until the
  // split grid has finished and its records are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  combine_splits(part + (static_cast<long long>(b) * h_kv + h) * n_split * record_floats(g, d),
                 pos / kChunk + 1, g, d,
                 out + (static_cast<long long>(b) * hq + static_cast<long long>(h) * g) * d);
}

// Launch 1: one CTA per (b, kv head, split); launch 2: one per (b, kv head).
inline dim3 split_grid(int batch, int h_kv, int t_max) {
  return dim3(batch, h_kv, num_splits(t_max));
}
inline dim3 combine_grid(int batch, int h_kv) { return dim3(batch, h_kv); }

template <typename T>
int run(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
        void* out, float* workspace, int batch, int hq, int h_kv, int t_max, int d, int pos,
        float scale2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = split_smem(hq / h_kv, d, sizeof(T));
  cudaError_t err = prepare(decode_split_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T><<<split_grid(batch, h_kv, t_max), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), workspace, hq, h_kv, t_max, d, pos,
      scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // The combine launches while the split grid runs (its CTAs wait at
  // griddepcontrol.wait), so its launch gap hides behind the splits.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = combine_grid(batch, h_kv);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, decode_combine_kernel<T>,
                                             static_cast<const float*>(workspace),
                                             static_cast<T*>(out), hq, h_kv, d, pos,
                                             num_splits(t_max)));
}

template <typename T>
int query(int which, int batch, int hq, int h_kv, int t_max, int d, long long* info) {
  if (which == 0)
    return rkt_info::write(decode_split_kernel<T>, split_grid(batch, h_kv, t_max), kThreads,
                           split_smem(hq / h_kv, d, sizeof(T)), info);
  return rkt_info::write(decode_combine_kernel<T>, combine_grid(batch, h_kv), kThreads, 0, info);
}

template <typename T>
int kernel_attribute(int which, int what, int g, int d) {
  return which == 0 ? attribute(decode_split_kernel<T>, what, split_smem(g, d, sizeof(T)))
                    : attribute(decode_combine_kernel<T>, what, 0);
}

}  // namespace

// out (B, Hq, D) in the operand dtype; workspace: B * Hkv * n_split * g *
// (D + 2) floats (rkt_decode_attention_workspace), written and read here
// only. scale2 = log2(e) / sqrt(D). dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launches.
extern "C" int rkt_decode_attention(const void* q, const void* k_new, const void* v_new,
                                    void* k_cache, void* v_cache, void* out, float* workspace,
                                    int batch, int hq, int h_kv, int t_max, int d, int pos,
                                    float scale2, int dtype, void* stream) {
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, out, workspace, batch, hq, h_kv,
                              t_max, d, pos, scale2, stream);
  return run<float>(q, k_new, v_new, k_cache, v_cache, out, workspace, batch, hq, h_kv, t_max,
                    d, pos, scale2, stream);
}

// Floats of the workspace rkt_decode_attention needs at these shapes.
extern "C" long long rkt_decode_attention_workspace(int batch, int hq, int h_kv, int t_max,
                                                    int d) {
  return static_cast<long long>(batch) * h_kv * num_splits(t_max) * record_floats(hq / h_kv, d);
}

// The launch geometry of rkt_decode_attention's split (which 0) or combine
// (which 1) launch at these shapes (launch_info.cuh).
extern "C" int rkt_decode_attention_launch_info(int which, int batch, int hq, int h_kv,
                                                int t_max, int d, int dtype, long long* info) {
  if (dtype == 1) return query<__nv_bfloat16>(which, batch, hq, h_kv, t_max, d, info);
  return query<float>(which, batch, hq, h_kv, t_max, d, info);
}

// Resident CTAs per SM (what 0) or registers per thread (what 1) of the
// split (which 0) or combine (which 1) kernel for g query heads per kv
// head at head dim d; -1 when the card refuses it.
extern "C" int rkt_decode_attention_attribute(int which, int what, int g, int d, int dtype) {
  if (dtype == 1) return kernel_attribute<__nv_bfloat16>(which, what, g, d);
  return kernel_attribute<float>(which, what, g, d);
}
