// The attention half of a pre-LN transformer block in one launch:
// LayerNorm -> fused QKV projection -> per-head softmax attention
// [-> output projection].
//
// Replaces: rocket_tpu/ops/fused_block.py, _block_kernel (:125), launched
// by _run_block (pallas_call at :184).
//
// Numerics follow the TPU kernel: LayerNorm statistics in f32 with
// var = mean((x - mean)^2); xn rounded to the operand dtype; qkv = xn.Wqkv
// accumulated in f32, rounded, then + bqkv in the dtype (a second
// rounding, not folded into the accumulator); scores in f32 times
// 1/sqrt(64), masked to -1e30, softmax in f32; the weights rounded to the
// dtype before the f32-accumulated PV product; the heads rounded; in the
// fused epilogue heads.Wproj accumulated in f32, rounded, + bproj in the
// dtype.
//
// The TPU program keeps whole (T, D) rows and both weight matrices in VMEM
// (Wqkv alone is 384 KB at char-LM shapes, past the 227 KB of shared memory
// a Hopper block can have), and its grid walks the batch in order. Here
// one CTA owns one (head, batch row):
//   1. it streams x[b] in 64-row tiles: LayerNorm statistics per row (one
//      warp per row, two passes), then the head's 64 k and 64 v columns of
//      the projection, with x normalised on the fly in 32-wide chunks and
//      Wqkv's columns streamed beside them; K and V of all T rows stay in
//      shared memory (f32, row stride 65), which bounds T (kMaxT);
//   2. per 64-row query tile it projects q the same way, then runs the
//      exact softmax in two sweeps over the key tiles (up to the diagonal
//      when causal): the first keeps the running max and sum, the second
//      forms the normalised weights, rounds them and accumulates PV;
//   3. it writes its head's 64 columns of the (B, T, H*64) head output —
//      the result itself for the separate epilogue.
// The fused epilogue launches the H CTAs of a batch row as one thread-block
// cluster: the head outputs go to a scratch (B, T, H*64) array, the cluster
// barrier orders them, and CTA h then projects row tiles h, h + H, ... of
// all heads onto Wproj. No atomics: every output element is written once by
// one CTA, so the result does not depend on the launch order.
//
// Bound on the H100 at char-LM shapes (bf16, B = 128, T = 256, D = 256,
// H = 4): x in and out 16.8 MB each, 0.5 MB of weights — 0.010 ms at the
// HBM rate; 17.2 GFLOP (fused: 21.5 with the projection) — 0.017 ms
// (0.022) at the bf16 tensor-core rate, so operations bound it. Design
// response of this first kernel: register-tiled f32 FMA over shared-memory
// tiles (4 x 8 outputs per thread), as csrc/flash_fwd.cu; each CTA reads
// x[b] from L2 twice per sweep. Tensor cores (mma.sync / wgmma), TMA and
// the occupancy that 166 KB of shared memory per CTA costs are later work
// (PERF.md has its time).
#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "launch_info.cuh"

namespace {

using namespace rkt_flash;
namespace cg = cooperative_groups;

constexpr int kHd = 64;             // head dim: the only one compiled
constexpr int kLd = kHd + 1;        // padded f32 row stride of K, V, q and p tiles
constexpr int kChunk = 32;          // reduction depth of one projection step
constexpr int kLdA = kChunk + 1;    // padded row stride of a staged A chunk
constexpr int kDc = kHd / kTx;      // output columns per thread of a PV tile
constexpr int kMaxT = 320;          // largest T whose K and V fit (block_smem_bytes)
constexpr int kMaxClusterHeads = 8; // portable cluster size: heads of the fused epilogue

// Dynamic shared memory for a sequence of t rows: K and V of every row,
// the q tile, the work tile (scores / probabilities, or the staged A chunk
// and weight chunk of a projection step) and two per-row statistics.
inline size_t block_smem_bytes(int t) {
  const size_t rows = static_cast<size_t>((t + kTile - 1) / kTile) * kTile;
  return sizeof(float) * (2 * rows * kLd + 2 * kTile * kLd + 2 * kTile);
}

struct Args {
  const void* x;       // (B, T, D) operand dtype
  const float* ln;     // (2, D) f32: scale, bias
  const void* wqkv;    // (D, 3*H*64) operand dtype, [q | k | v] columns
  const void* bqkv;    // (3*H*64,)
  const void* wproj;   // (H*64, D)
  const void* bproj;   // (D,)
  void* heads;         // (B, T, H*64): the output (separate) or scratch (fused)
  void* out;           // (B, T, D): the fused epilogue's output
  int batch, t, d, nh;
  float eps, scale;
  int causal;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// LayerNorm statistics of rows [row0, row0 + kTile) of x[b] (rows past t
// read as mean 0, rstd 0, so their normalised value is the LN bias).
template <typename T>
__device__ void row_stats(const T* x, int row0, int t, int d, float eps, float* mean_s,
                          float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // earlier readers of mean_s / rstd_s are done
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = row0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < t) {
      const T* xr = x + static_cast<long long>(row) * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
      mean = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float e = to_f32(xr[c]) - mean;
        v += e * e;
      }
      rstd = 1.f / sqrtf(warp_sum(v) / d + eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();
}

// acc (kTile x kHd, 4 x 8 per thread) = A (kTile x depth) . W[:, col0 : col0 + kHd],
// A staged kChunk columns at a time by load_a(r, c) (already rounded to
// the operand dtype), W of row stride ldw read from device memory.
template <typename T, typename LoadA>
__device__ void tile_product(LoadA load_a, int depth, const T* w, int ldw, int col0,
                             float* a_s, float* w_s, float (&acc)[kRows][kCols]) {
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += kChunk) {
    __syncthreads();  // the previous chunk (or the work tile's last use) is consumed
    for (int i = tid; i < kTile * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i - r * kChunk;
      a_s[r * kLdA + c] = load_a(r, k0 + c);
    }
    for (int i = tid; i < kChunk * kHd; i += kThreads) {
      const int r = i / kHd, c = i - r * kHd;
      w_s[i] = to_f32(w[static_cast<long long>(k0 + r) * ldw + col0 + c]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float ar[kRows], wc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ar[i] = a_s[(ty + kTy * i) * kLdA + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) wc[j] = w_s[kk * kHd + tx + kTx * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(ar[i], wc[j], acc[i][j]);
    }
  }
}

// 64 columns (from col0) of qkv for rows [row0, row0 + kTile) of x[b] into
// dst (kTile x kLd): LayerNorm, the f32-accumulated product rounded to the
// dtype, then + bias in the dtype.
template <typename T>
__device__ void project(const T* x, int row0, const Args& a, int col0, const float* mean_s,
                        const float* rstd_s, float* work, float* dst) {
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int t = a.t, d = a.d;
  const float* ln = a.ln;
  auto load_a = [&](int r, int c) {
    const int row = row0 + r;
    const float xv = row < t ? to_f32(x[static_cast<long long>(row) * d + c]) : 0.f;
    return round_to<T>((xv - mean_s[r]) * rstd_s[r] * ln[c] + ln[d + c]);
  };
  float acc[kRows][kCols];
  tile_product<T>(load_a, d, static_cast<const T*>(a.wqkv), 3 * a.nh * kHd, col0, work,
                  work + kTile * kLdA, acc);
  const T* bias = static_cast<const T*>(a.bqkv);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + kTx * j;
      dst[(ty + kTy * i) * kLd + c] = round_to<T>(round_to<T>(acc[i][j]) + to_f32(bias[col0 + c]));
    }
  __syncthreads();  // dst is complete before anyone reads it
}

// Scaled, masked scores of the q tile (rows q0 + ...) against key tile k0.
__device__ __forceinline__ void scores(const float* q_s, const float* k_tile, int q0, int k0,
                                       const Args& a, float (&s)[kRows][kCols]) {
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < kHd; ++dd) {
    float qr[kRows], kc[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qr[i] = q_s[(ty + kTy * i) * kLd + dd];
#pragma unroll
    for (int j = 0; j < kCols; ++j) kc[j] = k_tile[(tx + kTx * j) * kLd + dd];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTy * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kj = k0 + tx + kTx * j;
      const float v = s[i][j] * a.scale;
      s[i][j] = (kj >= a.t || (a.causal && kj > qi)) ? kNegInf : v;
    }
  }
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int t = a.t, d = a.d, hw = a.nh * kHd;
  const int nt = (t + kTile - 1) / kTile;
  float* k_s = smem;                      // nt*kTile x kLd
  float* v_s = k_s + nt * kTile * kLd;    // nt*kTile x kLd
  float* q_s = v_s + nt * kTile * kLd;    // kTile x kLd
  float* work = q_s + kTile * kLd;        // kTile x kLd
  float* mean_s = work + kTile * kLd;     // kTile
  float* rstd_s = mean_s + kTile;         // kTile

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(b) * t * d;
  T* heads = static_cast<T*>(a.heads) + static_cast<long long>(b) * t * hw;

  // 1. K and V of every row of head h.
  for (int it = 0; it < nt; ++it) {
    row_stats(x, it * kTile, t, d, a.eps, mean_s, rstd_s);
    project(x, it * kTile, a, hw + h * kHd, mean_s, rstd_s, work, k_s + it * kTile * kLd);
    project(x, it * kTile, a, 2 * hw + h * kHd, mean_s, rstd_s, work, v_s + it * kTile * kLd);
  }

  // 2. Per query tile: q, then the exact softmax in two sweeps, then PV.
  float* p_s = work;
  for (int iq = 0; iq < nt; ++iq) {
    const int q0 = iq * kTile;
    row_stats(x, q0, t, d, a.eps, mean_s, rstd_s);
    project(x, q0, a, h * kHd, mean_s, rstd_s, work, q_s);
    const int nk = a.causal ? iq + 1 : nt;

    float m[kRows], l[kRows], s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
    for (int ik = 0; ik < nk; ++ik) {
      scores(q_s, k_s + ik * kTile * kLd, q0, ik * kTile, a, s);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kCols; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], group_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) sum += expf(s[i][j] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + group_sum(sum);
        m[i] = m_new;
      }
    }

    float acc[kRows][kDc];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
    for (int ik = 0; ik < nk; ++ik) {
      scores(q_s, k_s + ik * kTile * kLd, q0, ik * kTile, a, s);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          p_s[(ty + kTy * i) * kLd + tx + kTx * j] = round_to<T>(expf(s[i][j] - m[i]) / l[i]);
      __syncthreads();
      const float* v_tile = v_s + ik * kTile * kLd;
#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        float vr[kDc];
#pragma unroll
        for (int c = 0; c < kDc; ++c) vr[c] = v_tile[kk * kLd + tx + kTx * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = p_s[(ty + kTy * i) * kLd + kk];
#pragma unroll
          for (int c = 0; c < kDc; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
        }
      }
      __syncthreads();  // p_s is consumed before it is written again
    }

    // 3. This head's columns of the head output.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kTy * i;
      if (qi >= t) continue;
      T* row = heads + static_cast<long long>(qi) * hw + h * kHd;
#pragma unroll
      for (int c = 0; c < kDc; ++c) row[tx + kTx * c] = from_f32<T>(acc[i][c]);
    }
  }

  if constexpr (kFused) {
    // The cluster is the H CTAs of batch row b: once all have written
    // their heads, CTA h projects row tiles h, h + H, ... onto Wproj.
    __threadfence();
    cg::this_cluster().sync();
    const T* bias = static_cast<const T*>(a.bproj);
    T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * t * d;
    for (int it = h; it < nt; it += a.nh) {
      const int row0 = it * kTile;
      auto load_a = [&](int r, int c) {
        const int row = row0 + r;
        return row < t ? load_cg(heads + static_cast<long long>(row) * hw + c) : 0.f;
      };
      for (int n0 = 0; n0 < d; n0 += kHd) {
        float acc[kRows][kCols];
        tile_product<T>(load_a, hw, static_cast<const T*>(a.wproj), d, n0, work,
                        work + kTile * kLdA, acc);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = row0 + ty + kTy * i;
          if (row >= t) continue;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = n0 + tx + kTx * j;
            out[static_cast<long long>(row) * d + c] =
                from_f32<T>(round_to<T>(acc[i][j]) + to_f32(bias[c]));
          }
        }
      }
    }
  }
}

// One CTA per (head, batch row); the fused epilogue's H CTAs of a row form
// one cluster.
inline dim3 launch_grid(int nh, int batch) { return dim3(nh, batch, 1); }

template <typename T, bool kFused>
int run(const Args& a, void* stream) {
  auto kernel = fused_block_kernel<T, kFused>;
  const size_t smem = block_smem_bytes(a.t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.nh;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = launch_grid(a.nh, a.batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = kFused ? cluster : nullptr;
  cfg.numAttrs = kFused ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFused>
int query(int batch, int t, int nh, long long* info) {
  return rkt_info::write(fused_block_kernel<T, kFused>, launch_grid(nh, batch), kThreads,
                         block_smem_bytes(t), info);
}

}  // namespace

// Largest sequence length the kernel takes (its K and V stay in shared
// memory) and the most heads of the fused epilogue (one cluster per batch
// row); the Python wrapper reads both.
extern "C" int rkt_fused_block_max_t() { return kMaxT; }
extern "C" int rkt_fused_block_max_fused_heads() { return kMaxClusterHeads; }

// heads (B, T, H*64) in the operand dtype: the output of the separate
// epilogue, the fused epilogue's scratch; out (B, T, D): the fused
// epilogue's output (ignored when separate). d must be num_heads * 64.
// Returns the cudaError_t of the launch.
extern "C" int rkt_fused_block(const void* x, const void* ln, const void* wqkv,
                               const void* bqkv, const void* wproj, const void* bproj,
                               void* heads, void* out, int batch, int t, int d, int num_heads,
                               float eps, float scale, int causal, int fused, int dtype,
                               void* stream) {
  if (num_heads < 1 || d != num_heads * kHd || t < 1 || t > kMaxT || batch < 1 ||
      (fused && num_heads > kMaxClusterHeads))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(ln), wqkv, bqkv, wproj, bproj, heads, out,
               batch, t, d, num_heads, eps, scale, causal};
  if (dtype == 1) {
    return fused ? run<__nv_bfloat16, true>(a, stream) : run<__nv_bfloat16, false>(a, stream);
  }
  return fused ? run<float, true>(a, stream) : run<float, false>(a, stream);
}

// The launch geometry of rkt_fused_block at these shapes (launch_info.cuh).
extern "C" int rkt_fused_block_launch_info(int batch, int t, int num_heads, int fused, int dtype,
                                           long long* info) {
  if (dtype == 1) {
    return fused ? query<__nv_bfloat16, true>(batch, t, num_heads, info)
                 : query<__nv_bfloat16, false>(batch, t, num_heads, info);
  }
  return fused ? query<float, true>(batch, t, num_heads, info)
               : query<float, false>(batch, t, num_heads, info);
}
