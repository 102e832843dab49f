// The launch-geometry query every kernel library exports beside its launch
// entry point, as rkt_<name>_launch_info(..., long long info[6]).
//
// A query computes the grid and the dynamic shared memory from the same
// helpers its launch calls, and reads the static shared memory of the
// kernel it would launch from cudaFuncGetAttributes, so it needs the card
// but launches nothing. The Python wrappers declare the same numbers from
// shapes alone (ops/_launch.LaunchFact); chip_smoke.py holds each
// declaration against its query, and the schedule audit (analysis/
// sched_audit.py, rule RKT504) checks the declarations on the CPU.
#pragma once

#include <cuda_runtime.h>

namespace rkt_info {

// info = {grid.x, grid.y, grid.z, threads per CTA, dynamic shared memory
// bytes, static shared memory bytes}. Returns the cudaError_t of the
// attribute read.
template <typename Kernel>
int write(Kernel kernel, dim3 grid, int threads, size_t dynamic_smem, long long* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = grid.x;
  info[1] = grid.y;
  info[2] = grid.z;
  info[3] = threads;
  info[4] = static_cast<long long>(dynamic_smem);
  info[5] = static_cast<long long>(attr.sharedSizeBytes);
  return 0;
}

}  // namespace rkt_info
