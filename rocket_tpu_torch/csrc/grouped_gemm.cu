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
// scratch; here an output tile is (group, up to 128 rows) x 128 or 256
// columns, whose block finds its group itself (a persistent block per SM
// walks them in bf16 gmm) and loops over K (gmm) or over its group's rows
// (tgmm, in order, one block per output tile): no atomics.
//
// Bound on the H100: operations. At the MoE LM's out-projection under the
// padded layout, (18432 x 3072) x (4, 3072, 768) bf16, 2*M*K*N = 87 GFLOP
// is 0.088 ms at 989 TFLOP/s against ~145 MB, 0.043 ms at 3.35 TB/s; the
// in-projection and the two backward products are the same size.
//
// bf16 gmm runs the persistent wgmma + TMA kernel of wgmma_gemm.cuh (row
// 11's, shared), instantiated with its TMA A loader: the lhs rows are
// contiguous, so one producer thread loads each 64-deep slice of a work
// tile's 128 rows as one box of a 2-D map over (K, M) from the tile's first
// row, and rhs through a 3-D map per expert, N-major for the forward and
// K-major for transpose_rhs. The tile width, 256 or 192 columns, is the
// one whose waves over the card's SMs cost least (gmm_block_n), so
// N = 768's last wave is not left a quarter full.
// bf16 tgmm stays on mma.sync (grouped_gemm.cuh: 128 x 128 tiles, 8 warps
// of 64 x 32, cp.async two stages deep, f32 accumulators). f32 operands run
// on the CUDA cores in register-blocked 128 x 128 tiles, near the f32 FMA
// rate (67 TFLOP/s at best): TF32 would miss the 1e-4 bound, and no main
// path runs them.
#include <type_traits>

#include "grouped_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace rkt_gg;

using rkt_wg::TmaA;

// The lhs map of the bf16 kernel: (K, M) with boxes of one slice by one
// work tile. False when the encode fails.
bool encode_lhs(TmaA* a, const void* lhs, int m, int k) {
  const uint64_t dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t strides[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t box[2] = {rkt_wg::kWgBK, kBM};
  return rkt_wg::encode_bf16<2>(&a->map, lhs, dims, strides, box);
}

// The output tile width of the bf16 kernel on a card of `sms` SMs: the one
// of 256 and 192 whose waves cost least, ceil(tiles / sms) * width (a CTA's
// time per tile grows with its width), 256 on a tie. The group sizes stay
// on the device, so tiles counts ceil(m / kBM) work tiles, the count when
// every group fills whole tiles (the padded layout), times the N tiles. At
// the MoE LM's N = 768 and 18432 rows, 256-wide tiles leave the last of
// four waves a quarter full, and 192-wide ones fill five waves better.
int gmm_block_n(int m, int n, int sms) {
  const auto cost = [&](long long bn) {
    const long long tiles = (m + kBM - 1) / kBM * ((n + bn - 1) / bn);
    return (tiles + sms - 1) / sms * bn;
  };
  return cost(192) < cost(256) ? 192 : 256;
}

// f(kmajor, bn) for the bf16 instantiation of one mode and tile width,
// each a std::integral_constant; an uncompiled width is refused.
template <typename F>
int with_wgmma(int transpose_rhs, int block_n, F f) {
  using std::integral_constant;
  using KMajor = integral_constant<bool, true>;
  using NMajor = integral_constant<bool, false>;
  if (block_n == 256)
    return transpose_rhs ? f(KMajor{}, integral_constant<int, 256>{})
                         : f(NMajor{}, integral_constant<int, 256>{});
  if (block_n == 192)
    return transpose_rhs ? f(KMajor{}, integral_constant<int, 192>{})
                         : f(NMajor{}, integral_constant<int, 192>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out, int m, int k,
            int n, int num_groups, int transpose_rhs, void* stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    int sms = 0;
    const int err = rkt_wg::device_sms(&sms);
    if (err != 0) return err;
    TmaA a;
    if (!encode_lhs(&a, lhs, m, k)) return static_cast<int>(cudaErrorInvalidValue);
    return with_wgmma(transpose_rhs, gmm_block_n(m, n, sms), [&](auto kmajor, auto bn) {
      return rkt_wg::launch_wgmma<TmaA, decltype(kmajor)::value, decltype(bn)::value>(
          a, rhs, group_sizes, out, m, k, n, num_groups, sms, stream);
    });
  } else {
    const dim3 grid = gmm_grid(m, n, num_groups);
    const float* a = static_cast<const float*>(lhs);
    const float* b = static_cast<const float*>(rhs);
    const int* gs = static_cast<const int*>(group_sizes);
    float* o = static_cast<float*>(out);
    if (transpose_rhs)
      return launch(gmm_kernel<true, false>, grid, stream, a, static_cast<const int*>(nullptr),
                    m, b, gs, o, m, k, n, num_groups);
    return launch(gmm_kernel<false, false>, grid, stream, a, static_cast<const int*>(nullptr), m,
                  b, gs, o, m, k, n, num_groups);
  }
}

// The kernel of one dtype: bf16 on the tensor cores, f32 on the CUDA cores.
template <typename T>
auto tgmm_for() {
  if constexpr (std::is_same<T, bf16>::value) return tgmm_tc_kernel;
  else return tgmm_kernel;
}

template <typename T>
int run_tgmm(const void* lhs, const void* dy, const void* group_sizes, void* out, int m, int k,
             int n, int num_groups, void* stream) {
  return launch(tgmm_for<T>(), tgmm_grid(k, n, num_groups), stream, static_cast<const T*>(lhs),
                static_cast<const T*>(dy), static_cast<const int*>(group_sizes),
                static_cast<T*>(out), m, k, n, num_groups);
}

// The f32 kernels and bf16 tgmm take no dynamic shared memory: their tiles
// are static.
int query_gmm(int m, int n, int num_groups, int transpose_rhs, int dtype, long long* info) {
  if (dtype == 1) {
    int sms = 0;
    const int err = rkt_wg::device_sms(&sms);
    if (err != 0) return err;
    return with_wgmma(transpose_rhs, gmm_block_n(m, n, sms), [&](auto kmajor, auto bn) {
      return rkt_wg::wgmma_launch_info<TmaA, decltype(kmajor)::value, decltype(bn)::value>(
          m, n, num_groups, sms, info);
    });
  }
  const dim3 grid = gmm_grid(m, n, num_groups);
  if (transpose_rhs) return rkt_info::write(gmm_kernel<true, false>, grid, kThreads, 0, info);
  return rkt_info::write(gmm_kernel<false, false>, grid, kThreads, 0, info);
}

template <typename T>
int query_tgmm(int k, int n, int num_groups, long long* info) {
  return rkt_info::write(tgmm_for<T>(), tgmm_grid(k, n, num_groups), kThreads, 0, info);
}

}  // namespace

// lhs (m, k), rhs (E, k, n) [or (E, n, k) with transpose_rhs], group_sizes
// (E,) int32, out (m, n); dtype 0 = float32, 1 = bfloat16. k and n are
// multiples of 8; bf16 lhs and rhs 16-byte aligned (TMA reads both).
// Returns the launch's cudaError_t.
extern "C" int rkt_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                       int m, int k, int n, int num_groups, int transpose_rhs, int dtype,
                       void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || num_groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return run_gmm<__nv_bfloat16>(lhs, rhs, group_sizes, out, m, k, n, num_groups, transpose_rhs,
                                  stream);
  if (dtype == 0)
    return run_gmm<float>(lhs, rhs, group_sizes, out, m, k, n, num_groups, transpose_rhs,
                          stream);
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

// The launch geometry of rkt_gmm and rkt_tgmm at these shapes on the
// current device (launch_info.cuh; bf16 gmm's tile width shows in its
// dynamic shared memory).
extern "C" int rkt_gmm_launch_info(int m, int n, int num_groups, int transpose_rhs, int dtype,
                                   long long* info) {
  if (m <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return query_gmm(m, n, num_groups, transpose_rhs, dtype, info);
}

extern "C" int rkt_tgmm_launch_info(int k, int n, int num_groups, int dtype, long long* info) {
  if (k <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return query_tgmm<__nv_bfloat16>(k, n, num_groups, info);
  return query_tgmm<float>(k, n, num_groups, info);
}

// Registers per thread at launch (what 1) or resident CTAs per SM (what 0)
// of the bf16 gmm kernel of one mode and tile width; -1 when the card
// refuses it or the width is not compiled.
extern "C" int rkt_gmm_attribute(int what, int transpose_rhs, int block_n) {
  if (block_n != 256 && block_n != 192) return -1;
  return with_wgmma(transpose_rhs, block_n, [&](auto kmajor, auto bn) {
    return rkt_wg::wgmma_attribute<TmaA, decltype(kmajor)::value, decltype(bn)::value>(what);
  });
}
