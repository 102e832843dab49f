// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_dq.cu).
//
// Operands are feature-major (B, T, F) arrays, the layouts of the JAX
// package: a head is the D-wide feature slice at `offset + head * D` of
// every row, so the fused (B, T, 3*H*D) QKV projection is read in place
// at offsets 0 / H*D / 2*H*D and a GQA operand (B, T, Hkv*D) at offset 0.
//
// Tiles are kTile x kTile (block_q == block_k, so causal masking is needed
// only on the diagonal tile). The bf16 instantiations of all three kernels
// run on the tensor cores (mma.sync over bf16 tiles filled by cp.async;
// their pieces are in mma_common.cuh). The f32 instantiations keep the
// first design, which the rest of this note describes: a tile of rows is
// staged in shared memory as f32 with a padded row stride D + 1, so the
// column walks of the products below hit 32 different banks. The 128
// threads of a CTA form a 16 x 8 grid (ty, tx): in a 64 x 64 score tile
// thread (ty, tx) owns rows ty + 16 i (i < 4) and columns tx + 8 j
// (j < 8); in a 64 x D output tile it owns the same rows and columns
// tx + 8 c (c < D / 8). The eight threads of a row group are eight
// neighbouring lanes of one warp, so a row's max and sum reduce with three
// xor-shuffles. All products are f32 FMA; probabilities / ds are rounded
// to the operand dtype where the JAX kernels cast them (round_to).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace rkt_flash {

constexpr int kThreads = 128;
constexpr int kTile = 64;               // query and key rows per tile
constexpr int kTy = 16, kTx = 8;        // thread grid of a CTA
constexpr int kRows = kTile / kTy;      // 4 tile rows per thread
constexpr int kCols = kTile / kTx;      // 8 score columns per thread
constexpr int kLdS = kTile + 1;         // padded row stride of a score tile
constexpr float kNegInf = -1e30f;       // the reference's _NEG_INF

// The bf16 instantiations run on the tensor cores, the f32 ones on the
// CUDA cores.
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The value a JAX kernel sees after `x.astype(operand dtype)`, back in f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Reductions over the 8 lanes of one row group (lanes 8k .. 8k+7).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0 + kTile) of the D-wide slice at feature `col0`
// of one batch row's (T, f) plane into shared memory (f32, row stride
// D + 1). Rows at or past t load as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* plane, int row0, int t, int f,
                                          int col0) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < t ? to_f32(plane[static_cast<long long>(row) * f + col0 + c]) : 0.f;
  }
}

// Stage kTile per-row statistics (lse or delta) of one (b, h) row of a
// (B, H, T) f32 array; rows at or past t read as 0.
__device__ __forceinline__ void load_stats(float* dst, const float* row_stats, int row0, int t) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < t ? row_stats[row0 + r] : 0.f;
}

// Dynamic shared memory of a kernel with `tiles` D-wide row tiles, `scores`
// kTile x kTile score tiles and `stats` kTile-long statistic rows.
inline size_t smem_bytes(int d, int tiles, int scores, int stats) {
  return sizeof(float) * (static_cast<size_t>(tiles) * kTile * (d + 1)
                          + static_cast<size_t>(scores) * kTile * kLdS
                          + static_cast<size_t>(stats) * kTile);
}

// Let `kernel` take `smem` bytes of dynamic shared memory (past the default
// 48 KB only by opting in) and, with `max_shared`, the SM's whole carveout
// as shared memory: several 40-65 KB tensor-core CTAs per SM need it.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool max_shared) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (!max_shared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Prepare the kernel, launch it on the caller's stream and return the
// launch status (a refused launch never runs, and a later synchronise
// would not report it).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, bool max_shared, void* stream, Args... args) {
  const cudaError_t err = prepare(kernel, smem, max_shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM (what 0) or registers per thread (what 1) of a
// prepared kernel, as the card reports them; -1 when it refuses.
template <typename Kernel>
int attribute(Kernel kernel, size_t smem, bool max_shared, int what) {
  if (prepare(kernel, smem, max_shared) != cudaSuccess) return -1;
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
  }
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// Problem geometry shared by the three C entry points.
struct Geometry {
  int batch, t, hq, h_kv, d;
  int fq, fk;                 // feature widths of the q and k/v arrays
  int q_off, k_off, v_off;    // feature offsets of the head-0 slices
};

}  // namespace rkt_flash

// Instantiate RUN<T, D> for the compiled head dims (D = 64, that of the
// GPT-2 and ViT presets; D = 32, that of the MoE char-LM example's
// 128-wide, 4-head model; D = 128, that of the Llama-2/3 and Mistral
// attention widths) and dtypes (dtype 0 = float32, 1 = bfloat16); any other
// D is refused as cudaErrorInvalidValue (the Python wrappers zero-pad every
// other D <= 128 to the next compiled one). The 16 x 8 thread map of the
// f32 kernels holds for all three: a 64 x D output tile gives each thread
// D / 8 columns (4, 8 or 16).
#define RKT_FLASH_DISPATCH(RUN, dtype, d, ...)                                      \
  do {                                                                              \
    if ((d) == 64) {                                                                \
      if ((dtype) == 1) return RUN<__nv_bfloat16, 64>(__VA_ARGS__);                 \
      return RUN<float, 64>(__VA_ARGS__);                                           \
    }                                                                               \
    if ((d) == 32) {                                                                \
      if ((dtype) == 1) return RUN<__nv_bfloat16, 32>(__VA_ARGS__);                 \
      return RUN<float, 32>(__VA_ARGS__);                                           \
    }                                                                               \
    if ((d) == 128) {                                                               \
      if ((dtype) == 1) return RUN<__nv_bfloat16, 128>(__VA_ARGS__);                \
      return RUN<float, 128>(__VA_ARGS__);                                          \
    }                                                                               \
    return static_cast<int>(cudaErrorInvalidValue);                                 \
  } while (0)

// Whether d is a compiled head dim (the occupancy and register queries
// answer -1 otherwise).
#define RKT_FLASH_COMPILED(d) ((d) == 32 || (d) == 64 || (d) == 128)
