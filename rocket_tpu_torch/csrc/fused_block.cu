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
// 1/sqrt(64), masked to -1e30, the exact softmax in f32 (w = exp(s - max)
// / sum; the bf16 kernel takes exp as exp2 of scores pre-scaled by
// log2(e) and divides by multiplying with the sum's reciprocal, f32
// arithmetic one rounding away from the quotient); the weights rounded to
// the dtype after normalising, before the f32-accumulated PV product; the
// heads rounded; in the fused epilogue heads.Wproj accumulated in f32,
// rounded, + bproj in the dtype.
//
// The TPU program keeps whole (T, D) rows and both weight matrices in VMEM
// (Wqkv alone is 384 KB at char-LM shapes, past the 227 KB of shared memory
// a Hopper block can have), and its grid walks the batch in order. Here
// one CTA owns one (head, batch row) and keeps K and V of all T rows in
// shared memory, which bounds T (kMaxT). The fused epilogue launches the H
// CTAs of a batch row as one thread-block cluster: the head outputs go to a
// scratch (B, T, H*64) array, the cluster barrier orders them, and CTA h
// then projects row tiles h, h + H, ... of all heads onto Wproj. No
// atomics: every output element is written once by one CTA, so two
// launches give the same bits.
//
// Bound on the H100 at char-LM shapes (bf16, B = 128, T = 256, D = 256,
// H = 4): x in and out 16.8 MB each, 0.5 MB of weights -- 0.010 ms at the
// HBM rate; 17.2 GFLOP (fused: 21.5 with the projection) -- 0.017 ms
// (0.022) at the bf16 tensor-core rate, so operations bound it.
//
// bf16 (the main path's dtype), redesigned for the tensor cores (4 warps):
//   * per 64-row tile of x[b], the LayerNorm statistics once (a warp per
//     row, eight rows' loads in flight together, f32, two passes, while
//     the first stage of the product is in flight); then the head's
//     q | k | v columns in one
//     (64 x D) . (D x 192) product on mma.sync m16n8k16 (warps 2 x 2, each
//     32 rows x 96 columns), xn rounded to bf16 as it is normalised into a
//     two-stage ring of 64 x 32 chunks (its next chunk's loads in flight in
//     registers), the matching 32 x 192 chunk of Wqkv in a two-stage
//     cp.async ring beside it;
//   * k and v stay resident as bf16 (64 KB at T = 256, with the row
//     padding 72 KB), q in a 64-row tile that reuses the weight ring;
//   * causal: the row tiles in order, one pass over x serving projection
//     and attention (q tile i needs K/V tiles <= i); non-causal: K/V of
//     every tile first, then q per tile;
//   * attention: each warp 16 query rows, the exact softmax in two sweeps
//     over the key tiles, both on mma.sync: the first gives the row max
//     and sum, the second recomputes S, forms the normalised weights in
//     registers, rounds them and feeds them as A fragments into P.V with V
//     read by ldmatrix.trans;
//   * the fused epilogue's heads . Wproj on mma.sync as well, 64 x 128
//     output blocks, the heads scratch and Wproj chunks by cp.async.
// Shared memory is 110,080 B at T = 256 and ptxas gives 254 registers a
// thread (no spills), so two CTAs (8 warps) fit an SM. The projection's
// mainloop, 32 deep with one stage of lookahead at 8 warps per SM, takes
// most of the time. Left for later: wgmma with TMA, more warps per SM,
// 128-row tiles (each CTA re-reads its head's Wqkv columns per tile), and
// sharing one batch row's LayerNorm across its H CTAs.
//
// f32 operands keep the first kernel, not redesigned: register-tiled f32
// FMA over f32 shared-memory tiles (K and V of all rows as f32 at row
// stride 65, 166,912 B at T = 256). TF32 mma would miss the f32 parity
// bound, and no main path trains in f32.
#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "launch_info.cuh"
#include "mma_common.cuh"

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

// ---- bf16: the tensor-core kernel (see the note at the head) -------------

namespace tc {

using namespace rkt_mma;
using bf16 = __nv_bfloat16;

constexpr int kLdH = kHd + kPad;        // row stride of K, V and the q tile
constexpr int kDepth = 32;              // reduction depth of one ring stage
constexpr int kLdA = kDepth + kPad;     // row stride of an A stage (64 x 32)
constexpr int kMaxCols = 3 * kHd;       // widest product: q | k | v
constexpr int kLdW = kMaxCols + kPad;   // row stride of a weight stage (32 x cols)
constexpr int kOutCols = 128;           // output columns of one epilogue product

// K and V of every row (rounded up to whole tiles), two A stages, two
// weight stages (the q tile reuses them between products) and two per-row
// statistics.
inline size_t smem_bytes(int t) {
  const size_t rows = static_cast<size_t>((t + kTile - 1) / kTile) * kTile;
  return sizeof(bf16) * (2 * rows * kLdH + 2 * kTile * kLdA + 2 * kDepth * kLdW) +
         sizeof(float) * 2 * kTile;
}

struct Smem {
  bf16 *k, *v, *a, *w, *q;
  float *mean, *rstd;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void zero(float (&c)[4]) { c[0] = c[1] = c[2] = c[3] = 0.f; }

// acc (the warp's 32 rows x 8 * NT columns from col0) += A stage (64 x 32)
// . W stage (32 x cols). Warps tile 2 x 2: rows 32 * (warp & 1), columns
// col0 chosen by the caller from warp >> 1.
template <int NT>
__device__ __forceinline__ void mma_stage(float (&acc)[2][NT][4], const bf16* a, const bf16* w,
                                          int col0) {
  const int lane = threadIdx.x % 32, wr = (threadIdx.x / 32) & 1;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    unsigned af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(af[mi], a + (32 * wr + mi * 16 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      unsigned r[4];
      ldsm_x4_t(r, w + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdW + col0 + nj * 16 +
                       ((lane >> 4) << 3));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * nj], af[mi], r[0], r[1]);
        mma_bf16(acc[mi][2 * nj + 1], af[mi], r[2], r[3]);
      }
    }
  }
}

// Sum of the 8 bf16 values of a 16-byte vector, and of their squared
// distances from mean.
__device__ __forceinline__ float sum8(const uint4& v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    s += f.x + f.y;
  }
  return s;
}
__device__ __forceinline__ float sq8(const uint4& v, float mean) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    s += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
  }
  return s;
}

// LayerNorm statistics of rows [row0, row0 + 64) of x[b] in f32, two
// passes (mean, then mean((x - mean)^2)). Warp w takes rows w, w + 4, ...,
// eight at a time, so that their loads are in flight together. Rows past t
// read as mean 0, rstd 0: their normalised value is the LayerNorm bias.
__device__ void tile_stats(const bf16* x, int row0, int t, int d, float eps, const Smem& sm) {
  constexpr int kBatch = 8, kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp; r0 < kTile; r0 += kBatch * kWarps) {
    auto load = [&](int j, int c) {
      const int row = row0 + r0 + j * kWarps;
      return row < t ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * d + c))
                     : make_uint4(0u, 0u, 0u, 0u);
    };
    float mean[kBatch], var[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) mean[j] = var[j] = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) v[j] = load(j, c);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) mean[j] += sum8(v[j]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) mean[j] = warp_sum(mean[j]) / d;
    for (int c = lane * 8; c < d; c += 256) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) v[j] = load(j, c);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) var[j] += sq8(v[j], mean[j]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j * kWarps;
      const float rstd = 1.f / sqrtf(warp_sum(var[j]) / d + eps);
      if (lane == 0) {
        sm.mean[r] = row0 + r < t ? mean[j] : 0.f;
        sm.rstd[r] = row0 + r < t ? rstd : 0.f;
      }
    }
  }
}

// Column groups g0 .. g0 + NG - 1 (0 q, 1 k, 2 v) of head h's qkv for rows
// [row0, row0 + 64) of x[b]: LayerNorm statistics, the product on the
// tensor cores, the f32 sum rounded then + bias in bf16, into the q tile
// (q) or the resident K / V rows (k, v).
template <int NG>
__device__ void project(const Args& a, const bf16* x, int row0, int g0, const Smem& sm) {
  constexpr int kCols = NG * kHd, kNt = kCols / 16, kVecs = kCols / 8;
  const int t = a.t, d = a.d, hw = a.nh * kHd, h = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* w = static_cast<const bf16*>(a.wqkv);
  const float* ln = a.ln;
  __syncthreads();  // the last tile's readers of the rings, q and the statistics are done
  auto load_w = [&](int c, int stage) {
    bf16* dst = sm.w + stage * kDepth * kLdW;
    for (int idx = tid; idx < kDepth * kVecs; idx += kThreads) {
      const int r = idx / kVecs, lc = (idx % kVecs) * 8;
      const int col = (g0 + lc / kHd) * hw + h * kHd + lc % kHd;
      cp_async16(dst + r * kLdW + lc, w + static_cast<long long>(c * kDepth + r) * 3 * hw + col,
                 true);
    }
    cp_async_commit();
  };
  // A stage c: 64 rows x 32 columns of x, two 16-byte vectors per thread,
  // fetched into registers one stage ahead and normalised into the ring.
  uint4 xv[2];
  auto fetch_x = [&](int c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 2, cc = (idx & 3) * 8;
      const int row = row0 + r;
      xv[i] = row < t ? __ldg(reinterpret_cast<const uint4*>(
                            x + static_cast<long long>(row) * d + c * kDepth + cc))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_xn = [&](int c, int stage) {
    bf16* dst = sm.a + stage * kTile * kLdA;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 2, cc = (idx & 3) * 8;
      const int col = c * kDepth + cc;
      const float mean = sm.mean[r], rstd = sm.rstd[r];
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln + col));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln + col + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln + d + col));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln + d + col + 4));
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&xv[i]);
      uint4 packed;
      unsigned* out = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        out[j] = pack_bf16((f.x - mean) * rstd * sc[2 * j] + bi[2 * j],
                           (f.y - mean) * rstd * sc[2 * j + 1] + bi[2 * j + 1]);
      }
      *reinterpret_cast<uint4*>(dst + r * kLdA + cc) = packed;
    }
  };

  float acc[2][kNt][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNt; ++ni) zero(acc[mi][ni]);
  const int nc = d / kDepth, col0 = (warp >> 1) * (kCols / 2);
  load_w(0, 0);
  fetch_x(0);
  tile_stats(x, row0, t, d, a.eps, sm);  // while stage 0 is in flight
  __syncthreads();  // the statistics are visible
  for (int c = 0; c < nc; ++c) {
    store_xn(c, c & 1);
    cp_async_wait<0>();
    __syncthreads();  // stage c of both rings is complete; stage c - 1's readers are done
    if (c + 1 < nc) {
      load_w(c + 1, (c + 1) & 1);
      fetch_x(c + 1);
    }
    mma_stage<kNt>(acc, sm.a + (c & 1) * kTile * kLdA, sm.w + (c & 1) * kDepth * kLdW, col0);
  }
  __syncthreads();  // every warp is done with the weight ring, which the q tile reuses

  const bf16* bias = static_cast<const bf16*>(a.bqkv);
  const int wr = warp & 1;
#pragma unroll
  for (int ni = 0; ni < kNt; ++ni) {
    const int lc = col0 + ni * 8 + 2 * (lane % 4);
    const int g = g0 + lc / kHd, hc = lc % kHd;
    const float bias0 = __bfloat162float(bias[g * hw + h * kHd + hc]);
    const float bias1 = __bfloat162float(bias[g * hw + h * kHd + hc + 1]);
    bf16* dst = (g == 0 ? sm.q : (g == 1 ? sm.k : sm.v) + row0 * kLdH) + hc;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 32 * wr + mi * 16 + lane / 4 + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(dst + r * kLdH) =
            __floats2bfloat162_rn(round_bf16(acc[mi][ni][2 * half]) + bias0,
                                  round_bf16(acc[mi][ni][2 * half + 1]) + bias1);
      }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// Scores of the warp's 16 query rows (from row_a) against key tile ik, in
// base 2 (times scale * log2(e), so exp(s - max) is exp2 of their
// difference); masked to -1e30 only on the diagonal tile and the tile that
// holds t.
__device__ __forceinline__ void scores(float (&s)[kKeys / 8][4], const unsigned (&qa)[kHd / 16][4],
                                       const Smem& sm, int ik, int iq, int row_a, const Args& a) {
  const int lane = threadIdx.x % 32, k0 = ik * kTile;
  const float c = a.scale * kLog2e;
  qk_tile<kHd, kLdH>(s, qa, sm.k + k0 * kLdH);
  if ((a.causal && ik == iq) || k0 + kTile > a.t) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        s[n][e] = (col >= a.t || (a.causal && col > row)) ? kNegInf : s[n][e] * c;
      }
  } else {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= c;
  }
}

// Query tile iq against the resident keys: the exact softmax in two
// sweeps (the first gives each row's max and sum; the second forms
// w = exp(s - max) / sum as exp2 times the sum's reciprocal, rounds it to
// bf16 as it is packed into A fragments, and multiplies by V), then this
// head's 64 columns of the head output.
__device__ void attend(const Args& a, int iq, const Smem& sm, bf16* heads) {
  const int t = a.t, nt = (t + kTile - 1) / kTile, hw = a.nh * kHd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // q, K and V of this tile are written
  unsigned qa[kHd / 16][4];
  load_a_rows<kHd, kLdH>(qa, sm.q + warp * 16 * kLdH);
  const int row_a = iq * kTile + warp * 16 + lane / 4;
  const int nk = a.causal ? iq + 1 : nt;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[kKeys / 8][4];
  for (int ik = 0; ik < nk; ++ik) {
    scores(s, qa, sm, ik, iq, row_a, a);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
        sum += exp2f(s[n][2 * r] - m_new) + exp2f(s[n][2 * r + 1] - m_new);
      l[r] = l[r] * exp2f(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};

  float o[kHd / 8][4];
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) zero(o[n]);
  for (int ik = 0; ik < nk; ++ik) {
    scores(s, qa, sm, ik, iq, row_a, a);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] - m[e >> 1]) * inv[e >> 1];
    pv_tile<kHd, kLdH>(o, s, sm.v + ik * kTile * kLdH);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    bf16* dst = heads + static_cast<long long>(row) * hw + blockIdx.x * kHd + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
  }
}
// Output columns [n0, n0 + kCols) of row tile [row0, row0 + 64) of the
// fused epilogue: heads (64 x hw) . Wproj, rounded, + bproj in bf16.
template <int kCols>
__device__ void out_tile(const Args& a, const bf16* heads, int row0, int n0, const Smem& sm,
                         bf16* out) {
  constexpr int kNt = kCols / 16, kVecs = kCols / 8;
  const int t = a.t, d = a.d, hw = a.nh * kHd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* wp = static_cast<const bf16*>(a.wproj);
  auto load = [&](int c, int stage) {
    bf16* as = sm.a + stage * kTile * kLdA;
    bf16* ws = sm.w + stage * kDepth * kLdW;
    for (int idx = tid; idx < kTile * kDepth / 8; idx += kThreads) {
      const int r = idx >> 2, cc = (idx & 3) * 8, row = row0 + r;
      const bool valid = row < t;
      cp_async16(as + r * kLdA + cc,
                 valid ? heads + static_cast<long long>(row) * hw + c * kDepth + cc : heads,
                 valid);
    }
    for (int idx = tid; idx < kDepth * kVecs; idx += kThreads) {
      const int r = idx / kVecs, lc = (idx % kVecs) * 8;
      cp_async16(ws + r * kLdW + lc, wp + static_cast<long long>(c * kDepth + r) * d + n0 + lc,
                 true);
    }
    cp_async_commit();
  };
  float acc[2][kNt][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNt; ++ni) zero(acc[mi][ni]);
  const int nc = hw / kDepth, col0 = (warp >> 1) * (kCols / 2);
  __syncthreads();  // the rings' last readers are done
  load(0, 0);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // stage c is complete; stage c - 1's readers are done
    if (c + 1 < nc) load(c + 1, (c + 1) & 1);
    mma_stage<kNt>(acc, sm.a + (c & 1) * kTile * kLdA, sm.w + (c & 1) * kDepth * kLdW, col0);
  }
  const bf16* bias = static_cast<const bf16*>(a.bproj);
  const int wr = warp & 1;
#pragma unroll
  for (int ni = 0; ni < kNt; ++ni) {
    const int col = n0 + col0 + ni * 8 + 2 * (lane % 4);
    const float bias0 = __bfloat162float(bias[col]), bias1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 32 * wr + mi * 16 + lane / 4 + 8 * half;
        if (row >= t) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * d + col) =
            __floats2bfloat162_rn(round_bf16(acc[mi][ni][2 * half]) + bias0,
                                  round_bf16(acc[mi][ni][2 * half + 1]) + bias1);
      }
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads) fused_block_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = a.t, d = a.d, hw = a.nh * kHd;
  const int nt = (t + kTile - 1) / kTile;
  Smem sm;
  sm.k = reinterpret_cast<bf16*>(smem_raw);
  sm.v = sm.k + nt * kTile * kLdH;
  sm.a = sm.v + nt * kTile * kLdH;
  sm.w = sm.a + 2 * kTile * kLdA;
  sm.q = sm.w;
  sm.mean = reinterpret_cast<float*>(sm.w + 2 * kDepth * kLdW);
  sm.rstd = sm.mean + kTile;

  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* x = static_cast<const bf16*>(a.x) + static_cast<long long>(b) * t * d;
  bf16* heads = static_cast<bf16*>(a.heads) + static_cast<long long>(b) * t * hw;
  if (a.causal) {
    for (int it = 0; it < nt; ++it) {
      project<3>(a, x, it * kTile, 0, sm);
      attend(a, it, sm, heads);
    }
  } else {
    for (int it = 0; it < nt; ++it) project<2>(a, x, it * kTile, 1, sm);
    for (int iq = 0; iq < nt; ++iq) {
      project<1>(a, x, iq * kTile, 0, sm);
      attend(a, iq, sm, heads);
    }
  }

  if constexpr (kFused) {
    __threadfence();
    cg::this_cluster().sync();
    bf16* out = static_cast<bf16*>(a.out) + static_cast<long long>(b) * t * d;
    for (int it = h; it < nt; it += a.nh) {
      int n0 = 0;
      for (; n0 + kOutCols <= d; n0 += kOutCols)
        out_tile<kOutCols>(a, heads, it * kTile, n0, sm, out);
      if (n0 < d) out_tile<kOutCols / 2>(a, heads, it * kTile, n0, sm, out);
    }
  }
}

}  // namespace tc

// One CTA per (head, batch row); the fused epilogue's H CTAs of a row form
// one cluster. bf16 runs on the tensor cores, f32 on the CUDA cores.
inline dim3 launch_grid(int nh, int batch) { return dim3(nh, batch, 1); }

template <typename T, bool kFused>
auto kernel_for() {
  if constexpr (kTensorCores<T>) return tc::fused_block_tc_kernel<kFused>;
  else return fused_block_kernel<T, kFused>;
}

template <typename T>
size_t smem_for(int t) {
  if constexpr (kTensorCores<T>) return tc::smem_bytes(t);
  return block_smem_bytes(t);
}

// Raise the kernel's shared-memory cap to `smem` and, for the tensor-core
// kernel, ask for the whole carveout as shared memory (two 110 KB CTAs per
// SM need it).
template <typename T, typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && kTensorCores<T>)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, bool kFused>
int run(const Args& a, void* stream) {
  auto kernel = kernel_for<T, kFused>();
  const size_t smem = smem_for<T>(a.t);
  cudaError_t err = set_smem<T>(kernel, smem);
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
  return rkt_info::write(kernel_for<T, kFused>(), launch_grid(nh, batch), kThreads,
                         smem_for<T>(t), info);
}

// Resident CTAs per SM of the (dtype, epilogue) kernel at sequence length
// t, as the card reports it; -1 when it refuses.
template <typename T, bool kFused>
int occupancy(int t) {
  auto kernel = kernel_for<T, kFused>();
  const size_t smem = smem_for<T>(t);
  if (set_smem<T>(kernel, smem) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
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

// Resident CTAs per SM of rkt_fused_block's kernel at sequence length t;
// -1 when the card refuses it.
extern "C" int rkt_fused_block_occupancy(int t, int fused, int dtype) {
  if (dtype == 1)
    return fused ? occupancy<__nv_bfloat16, true>(t) : occupancy<__nv_bfloat16, false>(t);
  return fused ? occupancy<float, true>(t) : occupancy<float, false>(t);
}
