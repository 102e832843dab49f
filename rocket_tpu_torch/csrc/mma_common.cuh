// Tensor-core building blocks of the port's bf16 kernels: cp.async copies
// into shared memory, ldmatrix fragment loads and the mma.sync m16n8k16
// product with f32 accumulators (grouped_gemm.cuh, flash_fwd.cu,
// flash_bwd.cu, flash_dq.cu, fused_block.cu, flash_attention.cu,
// paged_decode.cu), and the pieces the attention kernels share.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (bf16 in, f32 out), with
// g = lane / 4 and q = lane % 4:
//   A (16 x 16):  a0 (g, 2q..2q+1)  a1 (g + 8, 2q..)  a2 (g, 8 + 2q..)  a3 (g + 8, 8 + 2q..)
//   B (16 x 8):   b0 (k 2q..2q+1, n g)  b1 (k 8 + 2q.., n g)
//   C (16 x 8):   c0 c1 (g, 2q..2q+1)  c2 c3 (g + 8, 2q..2q+1)
// so the C fragments of two neighbouring n8 tiles are, packed to bf16
// pairs, the A fragment of one k16 slice: an attention kernel feeds its
// probabilities from the score accumulators straight into P.V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rkt_mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; !valid copies nothing and fills zeros (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, zero-filled when !valid (src still mapped).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- attention pieces (flash_fwd.cu, fused_block.cu) ----------------------
//
// A warp owns 16 query rows and meets the keys 64 at a time. Tiles in
// shared memory are bf16 rows of D elements at a padded row stride LD
// (D + 8: the eight 16-byte rows of an ldmatrix then start in distinct
// bank groups). A thread holds, per n8 tile of scores or outputs, rows
// g and g + 8 at columns 2q and 2q + 1.

constexpr int kKeys = 64;  // keys per tile
constexpr int kPad = 8;    // row padding of every bf16 tile, in elements

// Two f32 values rounded to one bf16 pair (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Reductions over the four lanes of a quad, which share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragments of 16 rows x D (rows from `rows`, stride LD), one per
// k16 slice: the warp's query rows, held in registers for a key loop.
template <int D, int LD>
__device__ __forceinline__ void load_a_rows(unsigned (&a)[D / 16][4], const __nv_bfloat16* rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// s (16 x 64, eight n8 tiles) = Q . K^T for the warp's query fragments
// against a 64-row key tile (stride LD), in f32.
template <int D, int LD>
__device__ __forceinline__ void qk_tile(float (&s)[kKeys / 8][4], const unsigned (&qa)[D / 16][4],
                                        const __nv_bfloat16* k_tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nj = 0; nj < kKeys / 16; ++nj) {
      unsigned r[4];
      ldsm_x4(r, k_tile + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nj], qa[kk], r[0], r[1]);
      mma_bf16(s[2 * nj + 1], qa[kk], r[2], r[3]);
    }
  }
}

// qk_tile with the A rows (16 x D, stride LD) read from shared memory one
// k16 slice at a time instead of held in registers: the D = 128 kernels
// whose accumulators leave no room for the D / 16 A fragments.
template <int D, int LD>
__device__ __forceinline__ void qk_tile_rows(float (&s)[kKeys / 8][4], const __nv_bfloat16* rows,
                                             const __nv_bfloat16* k_tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < kKeys / 16; ++nj) {
      unsigned r[4];
      ldsm_x4(r, k_tile + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nj], a, r[0], r[1]);
      mma_bf16(s[2 * nj + 1], a, r[2], r[3]);
    }
  }
}

// o (16 x D, D / 8 n8 tiles) += A . rows [16 j, 16 j + 16) of a row tile
// (stride LD) read transposed by ldmatrix, for the A fragment of one k16
// slice j.
template <int D, int LD>
__device__ __forceinline__ void av_slice(float (&o)[D / 8][4], const unsigned (&a)[4],
                                         const __nv_bfloat16* tile, int j) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    unsigned r[4];
    ldsm_x4_t(r, tile + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + nd * 16 +
                     ((lane >> 4) << 3));
    mma_bf16(o[2 * nd], a, r[0], r[1]);
    mma_bf16(o[2 * nd + 1], a, r[2], r[3]);
  }
}

// o (16 x D, D / 8 n8 tiles) += P . V for probabilities p (the score
// layout, already rounded where the caller rounds) and a 64-row value tile
// (stride LD), read transposed by ldmatrix.
template <int D, int LD>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[kKeys / 8][4],
                                        const __nv_bfloat16* v_tile) {
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
    const unsigned pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    av_slice<D, LD>(o, pa, v_tile, j);
  }
}

// The A fragments, one per k16 slice, of the 16 x kKeys block whose
// transpose is stored: column c0 .. c0 + 15 of a kKeys-row tile (stride LD)
// becomes row 0 .. 15 of A. ldmatrix.trans reads each 8 x 8 piece
// transposed, so a score block a warp held as keys x queries is read back
// as queries x keys without a pass through registers.
template <int LD>
__device__ __forceinline__ void load_a_rows_t(unsigned (&a)[kKeys / 16][4],
                                              const __nv_bfloat16* tile, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j)
    ldsm_x4_t(a[j], tile + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
                        ((lane >> 3) & 1) * 8);
}

// cp.async a 64-row x D bf16 tile: rows [row0, row0 + 64) of the D-wide
// slice at feature col0 of a (T, f) plane into dst (stride LD); rows at or
// past t are zero-filled. Every source row start must be 16-byte aligned
// (f and col0 multiples of 8, the plane 16-byte aligned).
template <int D, int LD, int THREADS>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, const __nv_bfloat16* plane,
                                              int row0, int t, int f, int col0) {
  constexpr int kVecs = D / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < kKeys * kVecs; idx += THREADS) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    const int row = row0 + r;
    const bool valid = row < t;
    const __nv_bfloat16* src =
        valid ? plane + static_cast<long long>(row) * f + col0 + c : plane;
    cp_async16(dst + r * LD + c, src, valid);
  }
}

// cp.async kKeys f32 statistics (lse or delta) starting at row0 of one
// (T,) row into dst; rows at or past t are zero-filled, so they read as a
// finite 0.
template <int THREADS>
__device__ __forceinline__ void cp_async_stats(float* dst, const float* row_stats, int row0,
                                               int t) {
  for (int r = threadIdx.x; r < kKeys; r += THREADS) {
    const bool valid = row0 + r < t;
    cp_async4(dst + r, valid ? row_stats + row0 + r : row_stats, valid);
  }
}

}  // namespace rkt_mma
