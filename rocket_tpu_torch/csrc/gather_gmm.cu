// Gather-GMM: out[r] = x[row_ids[r]] @ rhs[g(r)], the grouped matrix
// product whose lhs rows are read by index from the unsorted token rows,
// so the sorted (M, K) copy never exists.
//
// Replaces: rocket_tpu/ops/gather_gmm.py _gather_gmm_kernel (:117),
// launched by _run_gather_gmm (pallas_call at :179). The TPU kernel walks
// m-tiles in order, DMAs each tile's tile_m rows from HBM into VMEM scratch
// one row at a time by index (two copies in flight), picks the expert's
// rhs block from a scalar-prefetched expert-per-tile table and reuses the
// gathered block across the n-tiles.
//
// Bound on the H100: operations. At the MoE LM's in-projection under the
// padded layout, (18432 x 768) x (4, 768, 3072) bf16, 2*M*K*N = 87 GFLOP
// is 0.088 ms at 989 TFLOP/s against ~150 MB, 0.045 ms at 3.35 TB/s. Only
// wgmma reaches the tensor cores' full rate, so the bf16 kernel is the
// persistent wgmma + TMA grouped product of wgmma_gemm.cuh (shared with
// grouped_gemm.cu's gmm and tgmm), instantiated with its gathering A loader: TMA
// cannot gather rows, so the producer's 128 threads copy the rows their
// row ids name by cp.async into the swizzled layout wgmma reads, while TMA
// brings rhs as N-major boxes through a 3-D map. Output tiles are 128 x
// 256 (each CTA re-gathers its A rows and re-reads its B block through L2,
// ~1.4 GB at the in-projection with 128 x 128 tiles against ~1.0 GB with
// 128 x 256). Two other designs were correct but timed slower on the card:
// clusters of two CTAs sharing each rhs slice by TMA multicast, and the
// output staged in shared memory for TMA stores (the consumers then take
// turns with the one buffer that fits beside the ring).
//
// The f32 operands stay on the CUDA-core tiles of grouped_gemm.cuh
// (gmm_kernel<false, true>): no main path runs them.
#include "grouped_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace rkt_gg;

using Wgmma = rkt_wg::GatherA;  // the bf16 kernel: gathered A, rhs read N-major

int run_bf16(const void* x, int src_rows, const void* row_ids, const void* rhs,
             const void* group_sizes, void* out, int m, int k, int n, int num_groups,
             void* stream) {
  const Wgmma a{static_cast<const bf16*>(x), static_cast<const int*>(row_ids), src_rows};
  int sms = 0;
  const int err = rkt_wg::device_sms(&sms);
  if (err != 0) return err;
  return rkt_wg::launch_wgmma<Wgmma, false>(a, rhs, group_sizes, out, m, k, n, num_groups, sms,
                                            stream);
}

int run_f32(const void* x, int src_rows, const void* row_ids, const void* rhs,
            const void* group_sizes, void* out, int m, int k, int n, int num_groups,
            void* stream) {
  return launch(gmm_kernel<false, true>, gmm_grid(m, n, num_groups), stream,
                static_cast<const float*>(x), static_cast<const int*>(row_ids), src_rows,
                static_cast<const float*>(rhs), static_cast<const int*>(group_sizes),
                static_cast<float*>(out), m, k, n, num_groups);
}

}  // namespace

// x (src_rows, k), row_ids (m,) int32, rhs (E, k, n), group_sizes (E,)
// int32 -> out (m, n); dtype 0 = float32, 1 = bfloat16; k and n multiples
// of 8; bf16 x and rhs 16-byte aligned. A row id outside [0, src_rows)
// reads as a zero row. Returns the launch's cudaError_t.
extern "C" int rkt_gather_gmm(const void* x, int src_rows, const void* row_ids, const void* rhs,
                              const void* group_sizes, void* out, int m, int k, int n,
                              int num_groups, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || num_groups <= 0 || src_rows <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return run_bf16(x, src_rows, row_ids, rhs, group_sizes, out, m, k, n, num_groups, stream);
  if (dtype == 0)
    return run_f32(x, src_rows, row_ids, rhs, group_sizes, out, m, k, n, num_groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch geometry of rkt_gather_gmm at these shapes on the current
// device (launch_info.cuh).
extern "C" int rkt_gather_gmm_launch_info(int m, int n, int num_groups, int dtype,
                                          long long* info) {
  if (m <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 1)
    return rkt_info::write(gmm_kernel<false, true>, gmm_grid(m, n, num_groups), kThreads, 0,
                           info);
  int sms = 0;
  const int err = rkt_wg::device_sms(&sms);
  if (err != 0) return err;
  return rkt_wg::wgmma_launch_info<Wgmma, false>(m, 0, n, num_groups, sms, info);
}

// Registers per thread (what 1) or resident CTAs per SM (what 0) of the
// bf16 kernel; -1 when the card refuses it.
extern "C" int rkt_gather_gmm_attribute(int what) {
  return rkt_wg::wgmma_attribute<Wgmma, false>(what);
}
