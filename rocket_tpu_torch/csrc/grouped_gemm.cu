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
// scratch; here an output tile is (group, up to 128 rows) x 128, 192 or
// 256 columns, whose block finds its group itself (a persistent block per
// SM walks them in bf16) and loops over K (gmm) or over its group's rows
// (tgmm, in order): no atomics.
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
// bf16 tgmm runs the same template with its TmaLhsT loader: slots of (128
// rows of K, a tile of N, group), the group's rows walked in 64-row slices
// from its first row, lhs^T as the M-major A and dy as the N-major B, both
// by TMA through 2-D maps, the rows of a group's last slice past its end
// zeroed by the consumers; its width follows the same rule over its K
// tiles times the groups (192 columns at both MoE shapes: 384 slots, three
// waves of 132 at 97%). f32 operands run on the CUDA cores in
// register-blocked 128 x 128 tiles, near the f32 FMA rate (67 TFLOP/s at
// best): TF32 would miss the 1e-4 bound, and no main path runs them.
#include <string.h>

#include <type_traits>

#include "grouped_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace rkt_gg;

using rkt_wg::TmaA;
using rkt_wg::TmaLhsT;

// The output tile width of the bf16 kernels on a card of `sms` SMs, over
// `row_tiles` tiles of 128 output rows: the one of 256 and 192 whose waves
// cost least, ceil(row_tiles * N tiles / sms) * width (a CTA's time per
// tile grows with its width), 256 on a tie. gmm's group sizes stay on the
// device, so it counts ceil(m / kBM) work tiles, the count when every
// group fills whole tiles (the padded layout); tgmm counts ceil(k / kBM) K
// tiles per group. At the MoE LM's N = 768 and 18432 rows, 256-wide tiles
// leave gmm's last of four waves a quarter full, and 192-wide ones fill
// five waves better; tgmm's 384 slots of 192 columns fill three waves at
// 97%, where 256 columns leave the third of 288 slots 18% full.
int gmm_block_n(long long row_tiles, int n, int sms) {
  const auto cost = [&](long long bn) {
    const long long tiles = row_tiles * ((n + bn - 1) / bn);
    return (tiles + sms - 1) / sms * bn;
  };
  return cost(192) < cost(256) ? 192 : 256;
}

long long gmm_row_tiles(int m) { return (m + kBM - 1) / kBM; }
long long tgmm_row_tiles(int k, int num_groups) {
  return static_cast<long long>((k + kBM - 1) / kBM) * num_groups;
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
    if (!rkt_wg::encode_rows(&a.map, lhs, m, k, rkt_wg::kWgBK, kBM))
      return static_cast<int>(cudaErrorInvalidValue);
    return with_wgmma(transpose_rhs, gmm_block_n(gmm_row_tiles(m), n, sms),
                      [&](auto kmajor, auto bn) {
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

template <typename T>
int run_tgmm(const void* lhs, const void* dy, const void* group_sizes, void* out, int m, int k,
             int n, int num_groups, void* stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    int sms = 0;
    const int err = rkt_wg::device_sms(&sms);
    if (err != 0) return err;
    TmaLhsT a;
    // No rows (every group empty): no slice is loaded, and a map of no
    // rows does not encode.
    if (m == 0) memset(&a.map, 0, sizeof(a.map));
    else if (!rkt_wg::encode_rows(&a.map, lhs, m, k, 64, rkt_wg::kWgBK))
      return static_cast<int>(cudaErrorInvalidValue);
    return with_wgmma(0, gmm_block_n(tgmm_row_tiles(k, num_groups), n, sms),
                      [&](auto, auto bn) {
      return rkt_wg::launch_wgmma<TmaLhsT, false, decltype(bn)::value>(
          a, dy, group_sizes, out, m, k, n, num_groups, sms, stream);
    });
  } else {
    return launch(tgmm_kernel, tgmm_grid(k, n, num_groups), stream,
                  static_cast<const float*>(lhs), static_cast<const float*>(dy),
                  static_cast<const int*>(group_sizes), static_cast<float*>(out), m, k, n,
                  num_groups);
  }
}

// The f32 kernels take no dynamic shared memory: their tiles are static.
int query_gmm(int m, int n, int num_groups, int transpose_rhs, int dtype, long long* info) {
  if (dtype == 1) {
    int sms = 0;
    const int err = rkt_wg::device_sms(&sms);
    if (err != 0) return err;
    return with_wgmma(transpose_rhs, gmm_block_n(gmm_row_tiles(m), n, sms),
                      [&](auto kmajor, auto bn) {
      return rkt_wg::wgmma_launch_info<TmaA, decltype(kmajor)::value, decltype(bn)::value>(
          m, 0, n, num_groups, sms, info);
    });
  }
  const dim3 grid = gmm_grid(m, n, num_groups);
  if (transpose_rhs) return rkt_info::write(gmm_kernel<true, false>, grid, kThreads, 0, info);
  return rkt_info::write(gmm_kernel<false, false>, grid, kThreads, 0, info);
}

int query_tgmm(int k, int n, int num_groups, int dtype, long long* info) {
  if (dtype == 1) {
    int sms = 0;
    const int err = rkt_wg::device_sms(&sms);
    if (err != 0) return err;
    return with_wgmma(0, gmm_block_n(tgmm_row_tiles(k, num_groups), n, sms),
                      [&](auto, auto bn) {
      return rkt_wg::wgmma_launch_info<TmaLhsT, false, decltype(bn)::value>(0, k, n, num_groups,
                                                                           sms, info);
    });
  }
  return rkt_info::write(tgmm_kernel, tgmm_grid(k, n, num_groups), kThreads, 0, info);
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

// lhs (m, k), dy (m, n), group_sizes (E,) int32 -> out (E, k, n); bf16 lhs
// and dy 16-byte aligned (TMA reads both).
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
// current device (launch_info.cuh; the bf16 tile width shows in the
// dynamic shared memory).
extern "C" int rkt_gmm_launch_info(int m, int n, int num_groups, int transpose_rhs, int dtype,
                                   long long* info) {
  if (m <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return query_gmm(m, n, num_groups, transpose_rhs, dtype, info);
}

extern "C" int rkt_tgmm_launch_info(int k, int n, int num_groups, int dtype, long long* info) {
  if (k <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return query_tgmm(k, n, num_groups, dtype, info);
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

// The same of the bf16 tgmm kernel at a compiled tile width.
extern "C" int rkt_tgmm_attribute(int what, int block_n) {
  if (block_n != 256 && block_n != 192) return -1;
  return with_wgmma(0, block_n, [&](auto, auto bn) {
    return rkt_wg::wgmma_attribute<TmaLhsT, false, decltype(bn)::value>(what);
  });
}
