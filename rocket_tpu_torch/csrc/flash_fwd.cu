// Flash-attention forward on feature-major operands.
//
// Replaces: rocket_tpu/ops/flash_native.py, _fwd_kernel (:134), launched by
// _fwd (pallas_call at :236).
//
// One CTA per (q-tile, query head, batch row). It stages its kTile query
// rows once, then walks the key tiles in order — up to the diagonal tile
// when causal, masking only that tile — keeping an online base-2 softmax:
// scores s = q.k * log2(e)/sqrt(D) in f32, a running max m and sum l per
// row in registers, and the f32 output accumulator in registers. The
// probabilities enter the PV product rounded to the operand dtype, as the
// reference casts them. At the end it writes out (B, T, Hq*D) once and
// lse = m + log2(l) (base 2, l = 0 read as 1) into (B, Hq, T) f32.
//
// The TPU grid's last axis runs in order and carries m, l and the
// accumulator in VMEM scratch; Hopper blocks run in no order, so that axis
// is the loop inside the CTA. GQA: query head h reads kv head h / g.
//
// Bound on the H100: at GPT-2 shapes (bf16, B = 8, T = 1024, H = 12,
// D = 64) the bytes (q, k, v read once, out and lse written once: ~51 MB)
// and the causal flops (4 * D per visible pair: ~12.9 GFLOP) give nearly
// equal least times, ~0.015 ms and ~0.013 ms; in f32 the flops bound.
// Design response of this first kernel: register-tiled f32 FMA over
// shared-memory tiles (4 x 8 scores and 4 x D/8 outputs per thread),
// skipping the tiles above the diagonal; tensor cores (mma.sync / wgmma),
// TMA and warp specialisation are later work (PERF.md has its time).
#include "flash_common.cuh"
#include "launch_info.cuh"

namespace {

using namespace rkt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* q, const T* k, const T* v, T* out, float* lse, Geometry geo,
                 float scale2, int causal) {
  constexpr int LD = D + 1;
  constexpr int DC = D / kTx;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;  // kTile x kLdS

  const int t = geo.t;
  const int nq = (t + kTile - 1) / kTile;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (geo.hq / geo.h_kv);
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = iq * kTile;
  const T* q_plane = q + static_cast<long long>(b) * t * geo.fq;
  const T* k_plane = k + static_cast<long long>(b) * t * geo.fk;
  const T* v_plane = v + static_cast<long long>(b) * t * geo.fk;

  load_tile<T, D>(q_s, q_plane, q0, t, geo.fq, geo.q_off + h * D);

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? iq + 1 : nq;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // the previous tile's k_s / v_s / p_s reads are done
    load_tile<T, D>(k_s, k_plane, k0, t, geo.fk, geo.k_off + hk * D);
    load_tile<T, D>(v_s, v_plane, k0, t, geo.fk, geo.v_off + hk * D);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qr[kRows], kc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = q_s[(ty + kTy * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = k_s[(tx + kTx * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    const bool diag = causal && ik == iq;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kTy * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTx * j;
        float x = s[i][j] * scale2;
        if (kj >= t || (diag && kj > qi)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        p_s[(ty + kTy * i) * kLdS + tx + kTx * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vr[c] = v_s[kk * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty + kTy * i) * kLdS + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
      }
    }
  }

  const int f_out = geo.hq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTy * i;
    if (qi >= t) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / safe_l;
    T* row = out + (static_cast<long long>(b) * t + qi) * f_out + h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + kTx * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0) lse[(static_cast<long long>(b) * geo.hq + h) * t + qi] = m[i] + log2f(safe_l);
  }
}

// One CTA per (q tile, query head, batch row), and its dynamic shared memory.
inline dim3 launch_grid(const Geometry& geo) {
  return dim3((geo.t + kTile - 1) / kTile, geo.hq, geo.batch);
}
inline size_t launch_smem(int d) { return smem_bytes(d, 3, 1, 0); }

template <typename T, int D>
int run(const void* q, const void* k, const void* v, void* out, void* lse, Geometry geo,
        float scale2, int causal, void* stream) {
  return launch(flash_fwd_kernel<T, D>, launch_grid(geo), launch_smem(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(out), static_cast<float*>(lse), geo, scale2, causal);
}

template <typename T, int D>
int query(Geometry geo, long long* info) {
  return rkt_info::write(flash_fwd_kernel<T, D>, launch_grid(geo), kThreads, launch_smem(D),
                         info);
}

}  // namespace

// out (B, T, hq*d) in the operand dtype, lse (B, hq, T) f32. Returns the
// cudaError_t of the launch.
extern "C" int rkt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int batch, int t, int hq, int h_kv, int d, int fq, int fk, int q_off,
                             int k_off, int v_off, float scale2, int causal, int dtype,
                             void* stream) {
  const rkt_flash::Geometry geo{batch, t, hq, h_kv, d, fq, fk, q_off, k_off, v_off};
  RKT_FLASH_DISPATCH(run, dtype, d, q, k, v, out, lse, geo, scale2, causal, stream);
}

// The launch geometry of rkt_flash_fwd at these shapes (launch_info.cuh).
extern "C" int rkt_flash_fwd_launch_info(int batch, int t, int hq, int h_kv, int d, int dtype,
                                         long long* info) {
  const rkt_flash::Geometry geo{batch, t, hq, h_kv, d, 0, 0, 0, 0, 0};
  RKT_FLASH_DISPATCH(query, dtype, d, geo, info);
}
