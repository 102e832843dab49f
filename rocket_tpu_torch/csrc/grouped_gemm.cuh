// Shared tile code of the grouped matrix products (grouped_gemm.cu's gmm
// and tgmm, gather_gmm.cu's gather_gmm; in bf16 all three run the wgmma
// kernel of wgmma_gemm.cuh, gmm and gather_gmm over the work tiles below).
//
// Groups: `group_sizes` (E,) int32 lives on the device and is read by every
// block, so the host never learns the counts (no synchronisation). Group g
// covers rows [start_g, end_g) of the M rows, start_0 = 0, end_g = start_g +
// max(size_g, 0), clamped to M. Rows past the last group belong to no
// group and are written as zeros (jax.lax.ragged_dot's semantics).
//
// Work tiles: a (group, row range) pair of at most kBM rows. Group g is cut
// into ceil(n_g / kBM) tiles starting at start_g, so a tile never straddles
// a group boundary and an empty group has no tile; the rows past the groups
// form one more group of zero tiles. Their number is at most
// floor(M / kBM) + E + 1, the static grid size (work_tiles()); block w
// finds its tile by walking the E cumulative sizes (find_work()), and a
// block past the list exits. This is megablox's group metadata, computed
// by each block instead of by a scalar prefetch.
//
// The f32 product engine (bf16 takes wgmma_gemm.cuh): a 256-thread
// block computes a kBM x kBN f32 tile from two shared-memory operand tiles
// As[kBK][kBM] and Bs[kBK][kBN] (the reduction index first), each thread
// an 8 x 8 register block: rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and
// 64 + tx*4 + {0..3}, read as float4 (a warp's B reads are 256 contiguous
// bytes; its A reads broadcast). Operands arrive as 16-byte vectors from
// row-major global matrices, and the next kBK slice is loaded into
// registers while the current one is multiplied with f32 FMA. No float
// atomics anywhere, in any engine, so two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_info.cuh"
#include "mma_common.cuh"

namespace rkt_gg {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 16;

// Four consecutive outputs (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a, b);
  q[1] = __floats2bfloat162_rn(c, d);
}

// Rows [start, end) of group g (g == num_groups: the rows past the groups).
__device__ __forceinline__ void group_rows(const int* __restrict__ group_sizes, int num_groups,
                                           int m, int g, int* start, int* end) {
  int s = 0, e = 0;
  for (int i = 0; i <= g; ++i) {
    s = e;
    if (i == num_groups) {
      e = m;
    } else {
      const int size = max(__ldg(group_sizes + i), 0);
      e = size > m - s ? m : s + size;
    }
  }
  *start = s;
  *end = e;
}

struct Work {
  int group;  // num_groups for a tile of the rows past the groups
  int row0, row1;
};

// Work tile w of the schedule above; false when w is past the list.
__device__ __forceinline__ bool find_work(const int* __restrict__ group_sizes, int num_groups,
                                          int m, int w, Work* work) {
  int start = 0, acc = 0;
  for (int g = 0; g <= num_groups; ++g) {
    int end = m;
    if (g < num_groups) {
      const int size = max(__ldg(group_sizes + g), 0);
      end = size > m - start ? m : start + size;
    }
    const int tiles = (end - start + kBM - 1) / kBM;
    if (w < acc + tiles) {
      work->group = g;
      work->row0 = start + (w - acc) * kBM;
      work->row1 = min(work->row0 + kBM, end);
      return true;
    }
    acc += tiles;
    start = end;
  }
  return false;
}

// Static number of work tiles for m rows in num_groups groups.
inline int work_tiles(int m, int num_groups) { return m / kBM + num_groups + 1; }

// Grid of a gmm or gather-GMM launch: (work tiles, N tiles).
inline dim3 gmm_grid(int m, int n, int num_groups) {
  return dim3(work_tiles(m, num_groups), (n + kBN - 1) / kBN);
}

// Grid of a tgmm launch: one CTA per (K tile, N tile, group).
inline dim3 tgmm_grid(int k, int n, int num_groups) {
  return dim3((k + kBM - 1) / kBM, (n + kBN - 1) / kBN, num_groups);
}

// A ROWS x COLS f32 tile of a row-major matrix whose rows are
// COLS-contiguous, held in registers as float4 vectors. row_ptr[r] (in
// shared memory) is the address of the tile's row r at column 0, or null
// for a row that reads as zeros; columns at or past ncols read as zeros
// (ncols is a multiple of 4, so a vector is all in or all out).
template <int ROWS, int COLS>
struct TileRegs {
  static constexpr int kVPR = COLS / 4;
  static constexpr int kVecs = ROWS * kVPR / kThreads;
  static_assert(COLS % 4 == 0 && (ROWS * kVPR) % kThreads == 0, "tile does not split");
  float4 v[kVecs];

  __device__ __forceinline__ void load(const float* const* row_ptr, int col0, int ncols) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVPR, c = col0 + (idx % kVPR) * 4;
      const float* p = row_ptr[r];
      v[i] = (p != nullptr && c < ncols) ? __ldg(reinterpret_cast<const float4*>(p + c))
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // s[r][c] (ROWS x COLS): the tile's rows are the reduction index.
  __device__ __forceinline__ void store_rows(float* s) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVPR, c = (idx % kVPR) * 4;
      *reinterpret_cast<float4*>(s + r * COLS + c) = v[i];
    }
  }

  // s[c][r] (COLS x ROWS): the tile's columns are the reduction index.
  __device__ __forceinline__ void store_cols(float* s) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVPR, c = (idx % kVPR) * 4;
      s[c * ROWS + r] = v[i].x;
      s[(c + 1) * ROWS + r] = v[i].y;
      s[(c + 2) * ROWS + r] = v[i].z;
      s[(c + 3) * ROWS + r] = v[i].w;
    }
  }
};

// acc += As^T Bs over one kBK slice (As[kBK][kBM], Bs[kBK][kBN]).
__device__ __forceinline__ void mma_slice(const float* As, const float* Bs, float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kBM + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kBM + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kBN + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kBN + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Write the thread's 8 x 8 block of a tile at (row0, col0) of a row-major
// (rows x ncols) output with leading dimension ld; rows at or past row_end
// and columns at or past ncols (a multiple of 4) are skipped.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, long long ld, int row0, int row_end, int col0,
                                           int ncols, const float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= row_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c < ncols)
        store4(out + r * ld + c, acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
               acc[i][4 * h + 3]);
    }
  }
}

// out[r] = lhs[src(r)] @ rhs[group(r)] for the rows of one work tile, with
// src(r) = row_ids[r] when GATHER (rows of an unsorted source matrix of
// src_rows rows; an id out of range reads as a zero row), else r. rhs is
// (E, K, N), or (E, N, K) read transposed when TRANS_B. Grid: (work tiles,
// ceil(N / kBN)). f32 operands; the bf16 form is wgmma_gemm.cuh's.
template <bool TRANS_B, bool GATHER>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const float* __restrict__ lhs, const int* __restrict__ row_ids, int src_rows,
           const float* __restrict__ rhs, const int* __restrict__ group_sizes,
           float* __restrict__ out, int m, int k, int n, int num_groups) {
  Work work;
  if (!find_work(group_sizes, num_groups, m, blockIdx.x, &work)) return;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (work.group == num_groups) {  // rows past the groups
    store_tile(out, n, work.row0, work.row1, n0, n, acc);
    return;
  }
  __shared__ __align__(16) float As[kBK * kBM];
  __shared__ __align__(16) float Bs[kBK * kBN];
  __shared__ const float* a_rows[kBM];
  __shared__ const float* b_rows[TRANS_B ? kBN : kBK];
  const float* b_mat = rhs + static_cast<long long>(work.group) * k * n;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int row = work.row0 + r;
    const float* p = nullptr;
    if (row < work.row1) {
      const int src = GATHER ? __ldg(row_ids + row) : row;
      if (src >= 0 && src < src_rows) p = lhs + static_cast<long long>(src) * k;
    }
    a_rows[r] = p;
  }
  if (TRANS_B) {
    for (int r = threadIdx.x; r < kBN; r += kThreads)
      b_rows[r] = n0 + r < n ? b_mat + static_cast<long long>(n0 + r) * k : nullptr;
  }
  TileRegs<kBM, kBK> a_regs;
  TileRegs<TRANS_B ? kBN : kBK, TRANS_B ? kBK : kBN> b_regs;
  auto set_b_rows = [&](int k0) {
    if (!TRANS_B) {
      for (int r = threadIdx.x; r < kBK; r += kThreads)
        b_rows[r] = k0 + r < k ? b_mat + static_cast<long long>(k0 + r) * n : nullptr;
    }
  };
  set_b_rows(0);
  __syncthreads();
  a_regs.load(a_rows, 0, k);
  b_regs.load(b_rows, TRANS_B ? 0 : n0, TRANS_B ? k : n);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    a_regs.store_cols(As);
    if (TRANS_B) b_regs.store_cols(Bs); else b_regs.store_rows(Bs);
    __syncthreads();  // tiles in place; every b_rows read of this slice done
    if (k0 + kBK < k) {
      set_b_rows(k0 + kBK);
      if (!TRANS_B) __syncthreads();
      a_regs.load(a_rows, k0 + kBK, k);
      b_regs.load(b_rows, TRANS_B ? k0 + kBK : n0, TRANS_B ? k : n);
    }
    mma_slice(As, Bs, acc);
    __syncthreads();
  }
  store_tile(out, n, work.row0, work.row1, n0, n, acc);
}

// Rows of tgmm summed into one partial before it is folded into the
// running total: a group's reduction runs over thousands of rows, and one
// f32 chain that long loses digits where the sum cancels; partials keep
// each chain at kFoldRows rows.
constexpr int kFoldRows = 256;

// out[g] = lhs[rows of g]^T @ dy[rows of g] for one (K, N) tile of group
// g: lhs (M, K), dy (M, N), out (E, K, N). The block walks its group's rows
// in kBK slices, in order, adding each kFoldRows rows into a partial that
// is then folded into the total; an empty group writes zeros. Grid:
// (ceil(K / kBM), ceil(N / kBN), E). f32 operands; the bf16 form is
// wgmma_gemm.cuh's.
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const float* __restrict__ lhs, const float* __restrict__ dy,
            const int* __restrict__ group_sizes, float* __restrict__ out, int m, int k, int n,
            int num_groups) {
  const int g = blockIdx.z, k0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  int start, end;
  group_rows(group_sizes, num_groups, m, g, &start, &end);
  __shared__ __align__(16) float As[kBK * kBM];
  __shared__ __align__(16) float Bs[kBK * kBN];
  __shared__ const float* a_rows[2][kBK];
  __shared__ const float* b_rows[2][kBK];
  float acc[8][8], total[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = total[i][j] = 0.f;
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        total[i][j] += acc[i][j];
        acc[i][j] = 0.f;
      }
  };
  auto set_rows = [&](int buf, int r0) {
    for (int r = threadIdx.x; r < kBK; r += kThreads) {
      const bool live = r0 + r < end;
      a_rows[buf][r] = live ? lhs + static_cast<long long>(r0 + r) * k : nullptr;
      b_rows[buf][r] = live ? dy + static_cast<long long>(r0 + r) * n : nullptr;
    }
  };
  TileRegs<kBK, kBM> a_regs;
  TileRegs<kBK, kBN> b_regs;
  if (start < end) {
    set_rows(0, start);
    __syncthreads();
    a_regs.load(a_rows[0], k0, k);
    b_regs.load(b_rows[0], n0, n);
    int buf = 0;
    for (int r0 = start; r0 < end; r0 += kBK) {
      a_regs.store_rows(As);
      b_regs.store_rows(Bs);
      if (r0 + kBK < end) set_rows(buf ^ 1, r0 + kBK);
      __syncthreads();
      if (r0 + kBK < end) {
        buf ^= 1;
        a_regs.load(a_rows[buf], k0, k);
        b_regs.load(b_rows[buf], n0, n);
      }
      mma_slice(As, Bs, acc);
      if ((r0 - start + kBK) % kFoldRows == 0) fold();
      __syncthreads();
    }
    fold();
  }
  store_tile(out + static_cast<long long>(g) * k * n, n, k0, k, n0, n, total);
}

// Launch on the caller's stream and return the launch status (a refused
// launch never runs, and a later synchronise would not report it).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, void* stream, Args... args) {
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rkt_gg
