// Row 12: the seeded-bad kernel of the schedule audit's rule RKT504,
// y = 2 * x block by block, with the block shape the caller names.
//
// Replaces: rocket_tpu/analysis/sched_audit.py, _badpallas_parts (:1357):
// its kernel (:1369) under the two pallas_calls at :1376 ((7, 100) blocks
// over grid (4,), misaligned with the (8, 128) f32 tile) and :1385 (one
// (4096, 4096) f32 block, 64 MiB, past VMEM). The fixture exists to be
// flagged; this kernel keeps both launches as they are, so the audit's
// Hopper form has the same two faults to find: a (7, 100) f32 block is
// 400-byte rows, 7 of them, and the whole-array block asks for 64 MiB of
// shared memory, which cudaFuncSetAttribute refuses (the opt-in is 227 KB).
//
// CTA (i, j) of a 2-D grid stages block (i, j) of x, block_rows x
// block_cols, in dynamic shared memory and writes 2 * x to the same block
// of y; the fixture's index map (i, 0) is the grid (g, 1). Elements past
// the array's edge are skipped, and blocks the grid does not reach are
// never written (unspecified, as in the fixture).
//
// Bound on the H100: bytes. Over the whole (4096, 4096) f32 array, x is
// read once and y written once, 134,217,728 bytes: 0.040 ms at 3.35 TB/s.
// Design: none beyond the fixture's own; the block shape is the caller's.
// A (7, 100) block reads its rows as 400-byte runs that start off the
// 32-byte sector boundaries, and stages only 2,800 bytes per CTA.
#include <cuda_runtime.h>

#include "launch_info.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bad_scale_kernel(const float* __restrict__ x, float* __restrict__ y, int rows, int cols,
                 int block_rows, int block_cols) {
  extern __shared__ __align__(16) float blk[];
  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long col0 = static_cast<long long>(blockIdx.y) * block_cols;
  const long long n = static_cast<long long>(block_rows) * block_cols;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const long long r = row0 + i / block_cols, c = col0 + i % block_cols;
    if (r < rows && c < cols) blk[i] = x[r * cols + c];
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const long long r = row0 + i / block_cols, c = col0 + i % block_cols;
    if (r < rows && c < cols) y[r * cols + c] = 2.f * blk[i];
  }
}

// Dynamic shared memory of one CTA: its whole block of x, f32.
inline size_t block_smem(int block_rows, int block_cols) {
  return sizeof(float) * static_cast<size_t>(block_rows) * block_cols;
}

}  // namespace

// x, y (rows, cols) f32; grid_rows x grid_cols CTAs of (block_rows,
// block_cols) blocks. Returns the cudaError_t of the launch: a block past
// the shared-memory opt-in is refused by cudaFuncSetAttribute and never
// launched.
extern "C" int rkt_bad_scale(const void* x, void* y, int rows, int cols, int block_rows,
                             int block_cols, int grid_rows, int grid_cols, void* stream) {
  if (rows < 1 || cols < 1 || block_rows < 1 || block_cols < 1 || grid_rows < 1 ||
      grid_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = block_smem(block_rows, block_cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bad_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the next launch's own check does not read it
      return static_cast<int>(err);
    }
  }
  bad_scale_kernel<<<dim3(grid_rows, grid_cols), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                          static_cast<float*>(y), rows, cols,
                                                          block_rows, block_cols);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry of rkt_bad_scale at these shapes (launch_info.cuh).
extern "C" int rkt_bad_scale_launch_info(int block_rows, int block_cols, int grid_rows,
                                         int grid_cols, long long* info) {
  return rkt_info::write(bad_scale_kernel, dim3(grid_rows, grid_cols), kThreads,
                         block_smem(block_rows, block_cols), info);
}

// CUDA's description of an error code, for the wrapper's message.
extern "C" const char* rkt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
