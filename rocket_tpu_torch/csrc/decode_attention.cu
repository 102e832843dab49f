// Fused single-token decode attention for generate()'s cached loop.
//
// Replaces: rocket_tpu/ops/decode_attention.py, _kernel (:64), launched by
// decode_attention (:112, pallas_call at :198).
//
// Per (batch row b, kv head h): writes row `pos` of the (B, Hkv, T, D)
// K/V caches IN PLACE with k_new / v_new, then answers the g = Hq / Hkv
// query heads of that kv head with attention over cache rows [0, pos)
// plus the current token's own row (the self term), f32 softmax.
//
// The TPU kernel keeps the self term apart because its aliased output
// tile is written back only after the kernel; here the row is stored
// first and, after a block barrier, read back as key row `pos` — the same
// values (k_new / v_new arrive in the cache dtype), one code path.
//
// Bound on the H100: bytes. The cache rows [0, pos) of K and V are read
// once per (b, h), and q, k_new, v_new, out and the written row are
// moved once; the flops are ~4 * g * D per key row. Design response: one
// CTA per (b, h) serving all g query heads from one pass over the rows
// (native GQA), online softmax in f32, the walk bounded by pos (not T).
// The TPU gate (T % 128, VMEM budget) does not apply: any T, D % 8 == 0,
// D <= 256.
#include "decode_common.cuh"
#include "launch_info.cuh"

namespace {

struct ContigRows {
  long long base;  // offset of row 0 of this (b, h) cache plane
  int d;
  __device__ long long operator()(int t) const { return base + static_cast<long long>(t) * d; }
};

template <typename T>
__global__ void __launch_bounds__(rkt::kThreads)
decode_attention_kernel(const T* q, const T* k_new, const T* v_new, T* k_cache, T* v_cache,
                        T* out, int hq, int h_kv, int t_max, int d, int pos, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, g = hq / h_kv;
  const long long plane = (static_cast<long long>(b) * h_kv + h) * t_max * d;
  const long long new_off = (static_cast<long long>(b) * h_kv + h) * d;
  for (int i = threadIdx.x; i < d; i += rkt::kThreads) {
    k_cache[plane + static_cast<long long>(pos) * d + i] = k_new[new_off + i];
    v_cache[plane + static_cast<long long>(pos) * d + i] = v_new[new_off + i];
  }
  __syncthreads();  // the row is visible to the whole block before it is read
  const long long q_off = (static_cast<long long>(b) * hq + h * g) * d;
  rkt::attend_rows<T>(q + q_off, k_cache, v_cache, ContigRows{plane, d}, pos + 1, g, d, scale,
                      out + q_off, smem);
}

// One CTA per (batch row, kv head).
inline dim3 launch_grid(int batch, int h_kv) { return dim3(batch, h_kv); }

template <typename T>
int run(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
        void* out, int batch, int hq, int h_kv, int t_max, int d, int pos, float scale,
        void* stream) {
  const size_t smem = rkt::attend_smem_bytes(hq / h_kv, d);
  return rkt::launch(decode_attention_kernel<T>, launch_grid(batch, h_kv), smem, stream,
                     static_cast<const T*>(q), static_cast<const T*>(k_new),
                     static_cast<const T*>(v_new), static_cast<T*>(k_cache),
                     static_cast<T*>(v_cache), static_cast<T*>(out), hq, h_kv, t_max, d, pos,
                     scale);
}

template <typename T>
int query(int batch, int hq, int h_kv, int d, long long* info) {
  return rkt_info::write(decode_attention_kernel<T>, launch_grid(batch, h_kv), rkt::kThreads,
                         rkt::attend_smem_bytes(hq / h_kv, d), info);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rkt_decode_attention(const void* q, const void* k_new, const void* v_new,
                                    void* k_cache, void* v_cache, void* out, int batch, int hq,
                                    int h_kv, int t_max, int d, int pos, float scale, int dtype,
                                    void* stream) {
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, out, batch, hq, h_kv, t_max, d,
                              pos, scale, stream);
  return run<float>(q, k_new, v_new, k_cache, v_cache, out, batch, hq, h_kv, t_max, d, pos,
                    scale, stream);
}

// The launch geometry of rkt_decode_attention at these shapes (launch_info.cuh).
extern "C" int rkt_decode_attention_launch_info(int batch, int hq, int h_kv, int d, int dtype,
                                                long long* info) {
  if (dtype == 1) return query<__nv_bfloat16>(batch, hq, h_kv, d, info);
  return query<float>(batch, hq, h_kv, d, info);
}
