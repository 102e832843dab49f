// Flash-attention accumulating dq: the backward's dq past the partial
// buffer's byte bound.
//
// Replaces: rocket_tpu/ops/flash_native.py, _dq_kernel (:348), launched by
// _bwd_arrays (pallas_call at :508) when dq_split.
//
// One CTA per (q-tile, query head, batch row). It stages its kTile query
// and dout rows and their lse / delta once, then walks the key tiles up to
// the diagonal (all when not causal), recomputing
//   p = exp2(s - lse), dp = dout . v, ds = p * (dp - delta) / sqrt(D)
// and accumulating dq += round(ds) k in f32 registers; dq is written once,
// in the operand dtype. HBM stays linear in T where the partial strategy
// of flash_bwd writes nk f32 copies of dq, at the price of the two score
// products flash_bwd already computed.
//
// The TPU grid's last axis (the k sweep) runs in order with dq in VMEM
// scratch; here it is the loop inside the CTA.
//
// Bound on the H100: operations (3 products per visible pair, ~19 GFLOP
// causal at GPT-2 shapes). Design response: the register-tiled f32 FMA of
// flash_fwd; tensor cores and TMA are later work.
#include "flash_common.cuh"
#include "launch_info.cuh"

namespace {

using namespace rkt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                const float* delta, T* dq, Geometry geo, float scale, float scale2, int causal) {
  constexpr int LD = D + 1;
  constexpr int DC = D / kTx;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;   // kTile (q) x kLdS (k)
  float* lse_s = ds_s + kTile * kLdS;
  float* dl_s = lse_s + kTile;

  const int t = geo.t, hq = geo.hq;
  const int nq = (t + kTile - 1) / kTile;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / geo.h_kv);
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = iq * kTile;
  const int f_do = hq * D;
  const T* k_plane = k + static_cast<long long>(b) * t * geo.fk;
  const T* v_plane = v + static_cast<long long>(b) * t * geo.fk;

  load_tile<T, D>(q_s, q + static_cast<long long>(b) * t * geo.fq, q0, t, geo.fq,
                  geo.q_off + h * D);
  load_tile<T, D>(do_s, dout + static_cast<long long>(b) * t * f_do, q0, t, f_do, h * D);
  load_stats(lse_s, lse + (static_cast<long long>(b) * hq + h) * t, q0, t);
  load_stats(dl_s, delta + (static_cast<long long>(b) * hq + h) * t, q0, t);

  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int nk = causal ? iq + 1 : nq;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // the previous tile's k_s / v_s / ds_s reads are done
    load_tile<T, D>(k_s, k_plane, k0, t, geo.fk, geo.k_off + hk * D);
    load_tile<T, D>(v_s, v_plane, k0, t, geo.fk, geo.v_off + hk * D);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; ++dd) {
      float qr[kRows], dr[kRows], kc[kCols], vc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qr[i] = q_s[(ty + kTy * i) * LD + dd];
        dr[i] = do_s[(ty + kTy * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kc[j] = k_s[(tx + kTx * j) * LD + dd];
        vc[j] = v_s[(tx + kTx * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
        }
    }

    const bool diag = causal && ik == iq;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kTy * i, qi = q0 + row;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTx * j;
        const bool live = kj < t && qi < t && !(diag && kj > qi);
        const float p = live ? exp2f(s[i][j] * scale2 - lse_s[row]) : 0.f;
        ds_s[row * kLdS + tx + kTx * j] = round_to<T>(p * (dp[i][j] - dl_s[row]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kTile; ++kk) {
      float kr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kr[c] = k_s[kk * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ds = ds_s[(ty + kTy * i) * kLdS + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kr[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTy * i;
    if (qi >= t) continue;
    T* row = dq + (static_cast<long long>(b) * t + qi) * f_do + h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + kTx * c] = from_f32<T>(acc[i][c]);
  }
}

// One CTA per (q tile, query head, batch row), and its dynamic shared memory.
inline dim3 launch_grid(const Geometry& geo) {
  return dim3((geo.t + kTile - 1) / kTile, geo.hq, geo.batch);
}
inline size_t launch_smem(int d) { return smem_bytes(d, 4, 1, 2); }

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq, Geometry geo, float scale, float scale2, int causal,
        void* stream) {
  return launch(flash_dq_kernel<T, D>, launch_grid(geo), launch_smem(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), geo, scale, scale2,
                causal);
}

template <typename T, int D>
int query(Geometry geo, long long* info) {
  return rkt_info::write(flash_dq_kernel<T, D>, launch_grid(geo), kThreads, launch_smem(D),
                         info);
}

}  // namespace

// dq (B, T, hq*d) in the operand dtype; dout (B, T, hq*d); lse and delta
// (B, hq, T) f32. Returns the cudaError_t of the launch.
extern "C" int rkt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int batch, int t,
                            int hq, int h_kv, int d, int fq, int fk, int q_off, int k_off,
                            int v_off, float scale, float scale2, int causal, int dtype,
                            void* stream) {
  const rkt_flash::Geometry geo{batch, t, hq, h_kv, d, fq, fk, q_off, k_off, v_off};
  RKT_FLASH_DISPATCH(run, dtype, d, q, k, v, dout, lse, delta, dq, geo, scale, scale2, causal,
                     stream);
}

// The launch geometry of rkt_flash_dq at these shapes (launch_info.cuh).
extern "C" int rkt_flash_dq_launch_info(int batch, int t, int hq, int h_kv, int d, int dtype,
                                        long long* info) {
  const rkt_flash::Geometry geo{batch, t, hq, h_kv, d, 0, 0, 0, 0, 0};
  RKT_FLASH_DISPATCH(query, dtype, d, geo, info);
}
