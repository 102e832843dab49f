// Grouped matrix products of the dropless MoE FFN (counterpart of the
// megablox kernels the JAX package calls from nn/moe._grouped_matmul):
//   rkt_gmm:  out[r] = lhs[r] @ rhs[g(r)]       (rhs (E, K, N)), or with
//             transpose_rhs, lhs[r] @ rhs[g(r)]^T (rhs (E, N, K)): the
//             forward, and the lhs cotangent dy @ rhs^T of the backward;
//   rkt_tgmm: out[g] = lhs_g^T @ dy_g           ((E, K, N)): the rhs
//             cotangent, zeros for an empty group.
// g(r) is the group of row r under the device-resident group sizes (see
// grouped_gemm.cuh for the work-tile schedule, which needs no host sync).
//
// Replaces: jax.experimental.pallas.ops.tpu.megablox gmm (reached at
// rocket_tpu/nn/moe.py:85-88) and the tgmm of its custom_vjp. Megablox
// walks a sequential grid of tiles over the sorted rows with the group of
// each tile from scalar-prefetched metadata and accumulates K in VMEM
// scratch; here each block owns one (group, up to 128 rows) x 128-column
// output tile, finds its group itself, and loops over K (gmm) or over its
// group's rows (tgmm, in order, one block per output tile: no atomics).
//
// Bound on the H100: operations. At the MoE LM's in-projection, (16384 x
// 768) x (4, 768, 3072) bf16, 2*M*K*N = 77 GFLOP is 0.078 ms at 989
// TFLOP/s against ~145 MB, 0.043 ms at 3.35 TB/s; the out-projection and
// the two backward products are the same size. bf16 operands multiply on
// the tensor cores with mma.sync (grouped_gemm.cuh: 128 x 128 tiles, 8
// warps of 64 x 32, cp.async two stages deep, f32 accumulators); f32
// operands on the CUDA cores in register-blocked 128 x 128 tiles, near the
// f32 FMA rate (67 TFLOP/s at best). wgmma with TMA and a deeper pipeline,
// the way to the bf16 peak, is later work.
#include <type_traits>

#include "grouped_gemm.cuh"

namespace {

using namespace rkt_gg;

// The kernel of one (dtype, mode): bf16 on the tensor cores, f32 on the
// CUDA cores.
template <typename T, bool TRANS_B>
auto gmm_for() {
  if constexpr (std::is_same<T, bf16>::value) return gmm_tc_kernel<TRANS_B, false>;
  else return gmm_kernel<TRANS_B, false>;
}

template <typename T>
auto tgmm_for() {
  if constexpr (std::is_same<T, bf16>::value) return tgmm_tc_kernel;
  else return tgmm_kernel;
}

template <typename T>
int run_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out, int m, int k,
            int n, int num_groups, int transpose_rhs, void* stream) {
  const dim3 grid = gmm_grid(m, n, num_groups);
  const T* a = static_cast<const T*>(lhs);
  const T* b = static_cast<const T*>(rhs);
  const int* gs = static_cast<const int*>(group_sizes);
  T* o = static_cast<T*>(out);
  if (transpose_rhs)
    return launch(gmm_for<T, true>(), grid, stream, a, static_cast<const int*>(nullptr), m, b,
                  gs, o, m, k, n, num_groups);
  return launch(gmm_for<T, false>(), grid, stream, a, static_cast<const int*>(nullptr), m, b, gs,
                o, m, k, n, num_groups);
}

template <typename T>
int run_tgmm(const void* lhs, const void* dy, const void* group_sizes, void* out, int m, int k,
             int n, int num_groups, void* stream) {
  return launch(tgmm_for<T>(), tgmm_grid(k, n, num_groups), stream, static_cast<const T*>(lhs),
                static_cast<const T*>(dy), static_cast<const int*>(group_sizes),
                static_cast<T*>(out), m, k, n, num_groups);
}

// The grouped kernels take no dynamic shared memory: their tiles are static.
template <typename T>
int query_gmm(int m, int n, int num_groups, int transpose_rhs, long long* info) {
  const dim3 grid = gmm_grid(m, n, num_groups);
  if (transpose_rhs) return rkt_info::write(gmm_for<T, true>(), grid, kThreads, 0, info);
  return rkt_info::write(gmm_for<T, false>(), grid, kThreads, 0, info);
}

template <typename T>
int query_tgmm(int k, int n, int num_groups, long long* info) {
  return rkt_info::write(tgmm_for<T>(), tgmm_grid(k, n, num_groups), kThreads, 0, info);
}

}  // namespace

// lhs (m, k), rhs (E, k, n) [or (E, n, k) with transpose_rhs], group_sizes
// (E,) int32, out (m, n); dtype 0 = float32, 1 = bfloat16. k and n are
// multiples of 8. Returns the launch's cudaError_t.
extern "C" int rkt_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                       int m, int k, int n, int num_groups, int transpose_rhs, int dtype,
                       void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || num_groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return run_gmm<__nv_bfloat16>(lhs, rhs, group_sizes, out, m, k, n, num_groups, transpose_rhs,
                                  stream);
  if (dtype == 0)
    return run_gmm<float>(lhs, rhs, group_sizes, out, m, k, n, num_groups, transpose_rhs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// lhs (m, k), dy (m, n), group_sizes (E,) int32 -> out (E, k, n).
extern "C" int rkt_tgmm(const void* lhs, const void* dy, const void* group_sizes, void* out,
                        int m, int k, int n, int num_groups, int dtype, void* stream) {
  if (m < 0 || k <= 0 || n <= 0 || num_groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return run_tgmm<__nv_bfloat16>(lhs, dy, group_sizes, out, m, k, n, num_groups, stream);
  if (dtype == 0) return run_tgmm<float>(lhs, dy, group_sizes, out, m, k, n, num_groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch geometry of rkt_gmm and rkt_tgmm at these shapes
// (launch_info.cuh).
extern "C" int rkt_gmm_launch_info(int m, int n, int num_groups, int transpose_rhs, int dtype,
                                   long long* info) {
  if (m <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return query_gmm<__nv_bfloat16>(m, n, num_groups, transpose_rhs, info);
  return query_gmm<float>(m, n, num_groups, transpose_rhs, info);
}

extern "C" int rkt_tgmm_launch_info(int k, int n, int num_groups, int dtype, long long* info) {
  if (k <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return query_tgmm<__nv_bfloat16>(k, n, num_groups, info);
  return query_tgmm<float>(k, n, num_groups, info);
}
