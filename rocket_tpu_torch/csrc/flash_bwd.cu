// Flash-attention fused backward: dk, dv and the f32 dq partials.
//
// Replaces: rocket_tpu/ops/flash_native.py, _bwd_kernel (:270), launched by
// _bwd_arrays (pallas_call at :484).
//
// One CTA per (k-tile, kv head, batch row). It stages its kTile key and
// value rows once and keeps dk and dv for them in f32 registers. For each
// query head of the kv head's group (GQA: g = Hq / Hkv heads share it) it
// walks the q-tiles from the diagonal on (all of them when not causal):
//   p  = exp2(s - lse)            recomputed from s = k.q * log2(e)/sqrt(D)
//   dp = v . dout
//   ds = p * (dp - delta) / sqrt(D)
//   dv += round(p)^T dout,  dk += round(ds)^T q      (round: to the dtype)
// and, with with_dq, writes this k-tile's dq contribution round(ds) k for
// the visited q-tile as an f32 partial into dq_partials[ik] (nk, B, T,
// Hq*D); causal tiles it skips (q-tile < k-tile) are written as zeros, as
// the reference does, so the buffer needs no clearing. The partials are
// summed by one torch add outside: deterministic, no atomics, the sum the
// reference takes. Without with_dq only dk and dv are written (the
// accumulating flash_dq kernel makes dq).
//
// The TPU grid's last axis (the q sweep) runs in order with dk/dv in VMEM
// scratch; here it is the loop inside the CTA, which owns its k-tile for
// the whole sweep, so dk/dv need no cross-block reduction.
//
// Bound on the H100: operations at GPT-2 shapes (5 products per visible
// pair against 2 in the forward, ~32 GFLOP causal, ~0.033 ms; the bytes of
// q, k, v, dout, lse, delta, dq, dk and dv, ~89 MB, take ~0.027 ms). The
// f32 partials are this design's own cost on top: ~400 MB of writes at
// T = 1024, B = 8 with 64-row k-tiles, ~0.12 ms at the HBM rate. Design
// response: the same register-tiled f32 FMA over shared-memory tiles as
// flash_fwd; tensor cores and TMA are later work.
#include "flash_common.cuh"
#include "launch_info.cuh"

namespace {

using namespace rkt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                 const float* delta, float* dq_partials, T* dk, T* dv, Geometry geo,
                 float scale, float scale2, int causal, int with_dq) {
  constexpr int LD = D + 1;
  constexpr int DC = D / kTx;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;   // kTile (k) x kLdS (q)
  float* ds_s = p_s + kTile * kLdS;
  float* lse_s = ds_s + kTile * kLdS;
  float* dl_s = lse_s + kTile;

  const int t = geo.t, hq = geo.hq, g = geo.hq / geo.h_kv;
  const int nq = (t + kTile - 1) / kTile;
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int k0 = ik * kTile;
  const int f_do = hq * D;
  const T* q_plane = q + static_cast<long long>(b) * t * geo.fq;
  const T* do_plane = dout + static_cast<long long>(b) * t * f_do;

  load_tile<T, D>(k_s, k + static_cast<long long>(b) * t * geo.fk, k0, t, geo.fk,
                  geo.k_off + hk * D);
  load_tile<T, D>(v_s, v + static_cast<long long>(b) * t * geo.fk, k0, t, geo.fk,
                  geo.v_off + hk * D);

  float dk_acc[kRows][DC], dv_acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int jq = 0; jq < g; ++jq) {
    const int h = hk * g + jq;
    const float* lse_row = lse + (static_cast<long long>(b) * hq + h) * t;
    const float* dl_row = delta + (static_cast<long long>(b) * hq + h) * t;
    if (with_dq && causal) {
      // Partials of the q-tiles this k-tile cannot see are zero.
      for (long long i = tid; i < static_cast<long long>(min(k0, t)) * D; i += kThreads) {
        const int r = static_cast<int>(i / D), c = static_cast<int>(i - static_cast<long long>(r) * D);
        dq_partials[((static_cast<long long>(ik) * geo.batch + b) * t + r) * f_do + h * D + c] = 0.f;
      }
    }
    for (int iq = causal ? ik : 0; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();  // the previous q-tile's shared reads are done
      load_tile<T, D>(q_s, q_plane, q0, t, geo.fq, geo.q_off + h * D);
      load_tile<T, D>(do_s, do_plane, q0, t, f_do, h * D);
      load_stats(lse_s, lse_row, q0, t);
      load_stats(dl_s, dl_row, q0, t);
      __syncthreads();

      // Transposed tiles: thread rows are key rows, columns query rows.
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int dd = 0; dd < D; ++dd) {
        float kr[kRows], vr[kRows], qc[kCols], dc[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kr[i] = k_s[(ty + kTy * i) * LD + dd];
          vr[i] = v_s[(ty + kTy * i) * LD + dd];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qc[j] = q_s[(tx + kTx * j) * LD + dd];
          dc[j] = do_s[(tx + kTx * j) * LD + dd];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], dc[j], dp[i][j]);
          }
      }

      const bool diag = causal && iq == ik;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kj = k0 + ty + kTy * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + kTx * j, qi = q0 + col;
          const bool live = kj < t && qi < t && !(diag && kj > qi);
          const float p = live ? exp2f(s[i][j] * scale2 - lse_s[col]) : 0.f;
          const float ds = p * (dp[i][j] - dl_s[col]) * scale;
          p_s[(ty + kTy * i) * kLdS + col] = round_to<T>(p);
          ds_s[(ty + kTy * i) * kLdS + col] = round_to<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float dor[DC], qr[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dor[c] = do_s[qq * LD + tx + kTx * c];
          qr[c] = q_s[qq * LD + tx + kTx * c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = p_s[(ty + kTy * i) * kLdS + qq];
          const float ds = ds_s[(ty + kTy * i) * kLdS + qq];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[i][c] = fmaf(p, dor[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qr[c], dk_acc[i][c]);
          }
        }
      }

      if (with_dq) {
        // This k-tile's dq partial for the q-tile: rows are query rows.
        float dq[kRows][DC];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < kTile; ++kk) {
          float kr[DC];
#pragma unroll
          for (int c = 0; c < DC; ++c) kr[c] = k_s[kk * LD + tx + kTx * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float ds = ds_s[kk * kLdS + ty + kTy * i];
#pragma unroll
            for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(ds, kr[c], dq[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int qi = q0 + ty + kTy * i;
          if (qi >= t) continue;
          float* row = dq_partials + ((static_cast<long long>(ik) * geo.batch + b) * t + qi) * f_do
                       + h * D;
#pragma unroll
          for (int c = 0; c < DC; ++c) row[tx + kTx * c] = dq[i][c];
        }
      }
    }
  }

  const int f_kv = geo.h_kv * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty + kTy * i;
    if (kj >= t) continue;
    const long long off = (static_cast<long long>(b) * t + kj) * f_kv + hk * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + kTx * c] = from_f32<T>(dk_acc[i][c]);
      dv[off + tx + kTx * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// One CTA per (k tile, kv head, batch row), and its dynamic shared memory.
inline dim3 launch_grid(const Geometry& geo) {
  return dim3((geo.t + kTile - 1) / kTile, geo.h_kv, geo.batch);
}
inline size_t launch_smem(int d) { return smem_bytes(d, 4, 2, 2); }

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq_partials, void* dk, void* dv, Geometry geo, float scale,
        float scale2, int causal, int with_dq, void* stream) {
  return launch(flash_bwd_kernel<T, D>, launch_grid(geo), launch_smem(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dq_partials),
                static_cast<T*>(dk), static_cast<T*>(dv), geo, scale, scale2, causal, with_dq);
}

template <typename T, int D>
int query(Geometry geo, long long* info) {
  return rkt_info::write(flash_bwd_kernel<T, D>, launch_grid(geo), kThreads, launch_smem(D),
                         info);
}

}  // namespace

// dq_partials (nk, B, T, hq*d) f32 (may be null without with_dq); dk, dv
// (B, T, h_kv*d) in the operand dtype; dout (B, T, hq*d); lse and delta
// (B, hq, T) f32. Returns the cudaError_t of the launch.
extern "C" int rkt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq_partials, void* dk,
                             void* dv, int batch, int t, int hq, int h_kv, int d, int fq, int fk,
                             int q_off, int k_off, int v_off, float scale, float scale2,
                             int causal, int with_dq, int dtype, void* stream) {
  const rkt_flash::Geometry geo{batch, t, hq, h_kv, d, fq, fk, q_off, k_off, v_off};
  if (with_dq && dq_partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  RKT_FLASH_DISPATCH(run, dtype, d, q, k, v, dout, lse, delta, dq_partials, dk, dv, geo, scale,
                     scale2, causal, with_dq, stream);
}

// The launch geometry of rkt_flash_bwd at these shapes (launch_info.cuh).
extern "C" int rkt_flash_bwd_launch_info(int batch, int t, int hq, int h_kv, int d, int dtype,
                                         long long* info) {
  const rkt_flash::Geometry geo{batch, t, hq, h_kv, d, 0, 0, 0, 0, 0};
  RKT_FLASH_DISPATCH(query, dtype, d, geo, info);
}
