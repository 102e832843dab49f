// Gather-GMM: out[r] = x[row_ids[r]] @ rhs[g(r)], the grouped matrix
// product whose lhs rows are read by index from the unsorted token rows,
// so the sorted (M, K) copy never exists.
//
// Replaces: rocket_tpu/ops/gather_gmm.py _gather_gmm_kernel (:117),
// launched by _run_gather_gmm (pallas_call at :179). The TPU kernel walks
// m-tiles in order, DMAs each tile's tile_m rows from HBM into VMEM scratch
// one row at a time by index (two copies in flight), picks the expert's
// rhs block from a scalar-prefetched expert-per-tile table and reuses the
// gathered block across the n-tiles. Here (grouped_gemm.cuh) each block
// owns one (group, up to 128 rows) x 128-column output tile, finds its
// group from the device-resident group sizes, reads the 128 source row
// ids once into shared memory and copies each reduction slice of its A
// tile row by row through them, 16 bytes per copy, the next slice in
// flight while the current one is multiplied (bf16: cp.async into the
// tensor-core tiles; f32: registers into the CUDA-core tiles). The group
// of a row is the group that contains it, so the padded layout's tile_m
// may be smaller than the kernel's 128 rows (tile_m = 8 or 16 in tests and
// at decode): a tile never straddles a group, whatever tile_m is.
//
// Bound on the H100: operations. At the MoE LM's in-projection under the
// padded layout, (18432 x 768) x (4, 768, 3072) bf16, 2*M*K*N = 87 GFLOP
// is 0.088 ms at 989 TFLOP/s against ~150 MB, 0.045 ms at 3.35 TB/s. The
// products run as in grouped_gemm.cu (bf16 on the tensor cores, f32 on the
// CUDA cores); the gathered rows cost nothing beyond the row-id read
// because every A copy is a per-row 16-byte copy either way.
#include <type_traits>

#include "grouped_gemm.cuh"

namespace {

using namespace rkt_gg;

template <typename T>
auto kernel_for() {
  if constexpr (std::is_same<T, bf16>::value) return gmm_tc_kernel<false, true>;
  else return gmm_kernel<false, true>;
}

template <typename T>
int run(const void* x, int src_rows, const void* row_ids, const void* rhs,
        const void* group_sizes, void* out, int m, int k, int n, int num_groups, void* stream) {
  return launch(kernel_for<T>(), gmm_grid(m, n, num_groups), stream, static_cast<const T*>(x),
                static_cast<const int*>(row_ids), src_rows, static_cast<const T*>(rhs),
                static_cast<const int*>(group_sizes), static_cast<T*>(out), m, k, n,
                num_groups);
}

template <typename T>
int query(int m, int n, int num_groups, long long* info) {
  return rkt_info::write(kernel_for<T>(), gmm_grid(m, n, num_groups), kThreads, 0, info);
}

}  // namespace

// x (src_rows, k), row_ids (m,) int32, rhs (E, k, n), group_sizes (E,)
// int32 -> out (m, n); dtype 0 = float32, 1 = bfloat16; k and n multiples
// of 8. A row id outside [0, src_rows) reads as a zero row. Returns the
// launch's cudaError_t.
extern "C" int rkt_gather_gmm(const void* x, int src_rows, const void* row_ids, const void* rhs,
                              const void* group_sizes, void* out, int m, int k, int n,
                              int num_groups, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || num_groups <= 0 || src_rows <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, src_rows, row_ids, rhs, group_sizes, out, m, k, n, num_groups,
                              stream);
  if (dtype == 0)
    return run<float>(x, src_rows, row_ids, rhs, group_sizes, out, m, k, n, num_groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch geometry of rkt_gather_gmm at these shapes (launch_info.cuh).
extern "C" int rkt_gather_gmm_launch_info(int m, int n, int num_groups, int dtype,
                                          long long* info) {
  if (m <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return query<__nv_bfloat16>(m, n, num_groups, info);
  return query<float>(m, n, num_groups, info);
}
