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
// T = 1024, B = 8 with 64-row k-tiles (zeros included), ~0.12 ms at the
// HBM rate.
//
// bf16 (the main path's dtype), on the tensor cores: flash_fwd's
// primitives with the roles of queries and keys swapped. Each warp owns 16
// of the tile's 64 key rows. K and V are copied once by cp.async and read
// as mma A fragments per q-tile (ldmatrix; holding both in registers
// would cost the 32 that keep three CTAs resident); Q, dout and the tile's
// lse and delta stream through a two-stage cp.async ring (bf16 64 x D at
// row stride D + 8, rows past t zero-filled), q-tile i + 1 in flight while
// i is computed. S^T = K.Q^T and dP^T = V.dO^T run on mma.sync m16n8k16
// with f32 accumulators (16 keys x 64 queries a warp); p and ds are formed
// in that layout and re-packed, rounded to bf16, as the A fragments of
// dv += P^T.dO and dk += dS^T.Q, dO and Q read by ldmatrix.trans. For dq
// the warps write round(dS^T) to one bf16 64 x 64 tile (stride 72); after
// a barrier each warp reads its 16 query rows of dS from it by
// ldmatrix.trans (load_a_rows_t) and multiplies them by the K tile, read
// transposed as in the PV product, and writes its f32 partial rows in
// whole 32-byte pieces; the causal-skipped partials are written as zeros
// by 16-byte stores. Shared memory is 6 x 64 x (D + 8) bf16, the dS tile
// and two stages of the statistics (65,536 B at D = 64), three CTAs per
// SM. At D = 128 (114,688 B, two CTAs per SM by shared memory) dk and dv
// take 128 f32 registers a thread, so the warp reads its K and V rows from
// shared memory one k16 slice at a time (qk_tile_rows) instead of holding
// them as fragments, and makes its dq partial in two 64-column passes;
// the launch bounds ask for two CTAs (255 registers). Left for later:
// wgmma with TMA.
//
// f32 operands keep the first kernel, register-tiled f32 FMA over f32
// shared-memory tiles (TF32 would miss the 1e-4 bound; no main path
// trains in f32).
#include "flash_common.cuh"
#include "launch_info.cuh"
#include "mma_common.cuh"

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

// The bf16 kernel on the tensor cores (see the note at the head).
// Three resident CTAs at D <= 64 (168 registers a thread); two at D = 128,
// where dk and dv alone take 128 f32 registers a thread (255 at most).
template <int D>
__global__ void __launch_bounds__(kThreads, D > 64 ? 2 : 3)
flash_bwd_tc_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const __nv_bfloat16* dout, const float* lse, const float* delta,
                    float* dq_partials, __nv_bfloat16* dk, __nv_bfloat16* dv, Geometry geo,
                    float scale, float scale2, int causal, int with_dq) {
  using namespace rkt_mma;
  constexpr int LD = D + kPad;
  constexpr int LDS = kKeys + kPad;  // row stride of the dS^T tile
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTileElems;
  __nv_bfloat16* q_s = v_s + kTileElems;        // two stages
  __nv_bfloat16* do_s = q_s + 2 * kTileElems;   // two stages
  __nv_bfloat16* ds_s = do_s + 2 * kTileElems;  // kTile keys x LDS
  float* lse_s = reinterpret_cast<float*>(ds_s + kTile * LDS);  // two stages
  float* dl_s = lse_s + 2 * kTile;                               // two stages

  const int t = geo.t, hq = geo.hq, g = geo.hq / geo.h_kv;
  const int nq = (t + kTile - 1) / kTile;
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = ik * kTile;
  const int f_do = hq * D;
  const __nv_bfloat16* q_plane = q + static_cast<long long>(b) * t * geo.fq;
  const __nv_bfloat16* do_plane = dout + static_cast<long long>(b) * t * f_do;
  // The steps of the sweep: every visible q-tile of each query head of the
  // group, head by head.
  const int first = causal ? ik : 0, per_head = nq - first, steps = g * per_head;
  auto stage = [&](int i, int st) {
    const int h = hk * g + i / per_head, q0 = (first + i % per_head) * kTile;
    const long long stats = (static_cast<long long>(b) * hq + h) * t;
    cp_async_rows<D, LD, kThreads>(q_s + st * kTileElems, q_plane, q0, t, geo.fq,
                                   geo.q_off + h * D);
    cp_async_rows<D, LD, kThreads>(do_s + st * kTileElems, do_plane, q0, t, f_do, h * D);
    cp_async_stats<kThreads>(lse_s + st * kTile, lse + stats, q0, t);
    cp_async_stats<kThreads>(dl_s + st * kTile, delta + stats, q0, t);
  };

  const __nv_bfloat16* k_plane = k + static_cast<long long>(b) * t * geo.fk;
  const __nv_bfloat16* v_plane = v + static_cast<long long>(b) * t * geo.fk;
  cp_async_rows<D, LD, kThreads>(k_s, k_plane, k0, t, geo.fk, geo.k_off + hk * D);
  cp_async_rows<D, LD, kThreads>(v_s, v_plane, k0, t, geo.fk, geo.v_off + hk * D);
  stage(0, 0);
  cp_async_commit();

  float* dqp = with_dq ? dq_partials + (static_cast<long long>(ik) * geo.batch + b) * t * f_do
                       : nullptr;  // this k-tile's partial
  if (with_dq && causal) {
    // Partials of the q-tiles this k-tile cannot see are zero.
    constexpr int kVecs = D / 4;
    for (int jq = 0; jq < g; ++jq)
      for (int i = threadIdx.x; i < k0 * kVecs; i += kThreads)
        *reinterpret_cast<float4*>(dqp + static_cast<long long>(i / kVecs) * f_do +
                                   (hk * g + jq) * D + (i % kVecs) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Rows g and g + 8 of the warp's 16 keys: dk and dv.
  const int key_a = k0 + warp * 16 + lane / 4;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    const int h = hk * g + i / per_head, iq = first + i % per_head, q0 = iq * kTile;
    cp_async_wait<0>();
    __syncthreads();  // step i has landed; every warp is done with step i - 1
    if (i + 1 < steps) {
      stage(i + 1, st ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* q_tile = q_s + st * kTileElems;
    const __nv_bfloat16* do_tile = do_s + st * kTileElems;
    const float* lse_t = lse_s + st * kTile;
    const float* dl_t = dl_s + st * kTile;

    // Transposed blocks: rows are the warp's keys, columns the tile's queries.
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    if constexpr (D > 64) {
      qk_tile_rows<D, LD>(s, k_s + warp * 16 * LD, q_tile);
      qk_tile_rows<D, LD>(dp, v_s + warp * 16 * LD, do_tile);
    } else {
      unsigned a[D / 16][4];
      load_a_rows<D, LD>(a, k_s + warp * 16 * LD);
      qk_tile<D, LD>(s, a, q_tile);
      load_a_rows<D, LD>(a, v_s + warp * 16 * LD);
      qk_tile<D, LD>(dp, a, do_tile);
    }
    const bool diag = causal && iq == ik;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * (lane % 4) + (e & 1), qi = q0 + col;
        const int kj = key_a + (e >> 1) * 8;
        const bool live = kj < t && qi < t && !(diag && kj > qi);
        const float p = live ? exp2f(s[n][e] * scale2 - lse_t[col]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dl_t[col]) * scale;
      }
    pv_tile<D, LD>(dv_acc, s, do_tile);  // p rounded to bf16 in the packing
    pv_tile<D, LD>(dk_acc, dp, q_tile);  // ds likewise

    if (with_dq) {
      // round(dS^T) to shared memory, then this k-tile's dq partial for the
      // q-tile: each warp's 16 query rows of dS.K.
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<unsigned*>(ds_s + (warp * 16 + lane / 4 + 8 * r) * LDS + n * 8 +
                                       2 * (lane % 4)) = pack_bf16(dp[n][2 * r], dp[n][2 * r + 1]);
      __syncthreads();
      unsigned dsa[kKeys / 16][4];
      load_a_rows_t<LDS>(dsa, ds_s, warp * 16);
      // At most 64 columns of dq a pass, so that dq, dk and dv fit the
      // registers together at D = 128.
      constexpr int DW = D > 64 ? 64 : D;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += DW) {
        float dq[DW / 8][4];
#pragma unroll
        for (int n = 0; n < DW / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys / 16; ++j) av_slice<DW, LD>(dq, dsa[j], k_s + c0, j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
          if (qi >= t) continue;
          float* row = dqp + static_cast<long long>(qi) * f_do + h * D + c0 + 2 * (lane % 4);
#pragma unroll
          for (int n = 0; n < DW / 8; ++n)
            *reinterpret_cast<float2*>(row + n * 8) = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
        }
      }
    }
  }

  const int f_kv = geo.h_kv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key_a + 8 * r;
    if (kj >= t) continue;
    const long long off = (static_cast<long long>(b) * t + kj) * f_kv + hk * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// One CTA per (k tile, kv head, batch row), and its dynamic shared memory:
// the bf16 kernel's K and V tiles, two stages of Q and dout (bf16, row
// stride D + 8), the bf16 dS^T tile and two stages of lse and delta; the
// f32 kernel's four f32 tiles, two score tiles and two statistic rows.
inline dim3 launch_grid(const Geometry& geo) {
  return dim3((geo.t + kTile - 1) / kTile, geo.h_kv, geo.batch);
}
template <typename T>
size_t launch_smem(int d) {
  if constexpr (kTensorCores<T>)
    return sizeof(__nv_bfloat16) * kTile * (6 * static_cast<size_t>(d + rkt_mma::kPad) +
                                            rkt_mma::kKeys + rkt_mma::kPad) +
           sizeof(float) * 4 * kTile;
  return smem_bytes(d, 4, 2, 2);
}

// The kernel of one (dtype, D): bf16 on the tensor cores, f32 on the CUDA
// cores.
template <typename T, int D>
auto kernel_for() {
  if constexpr (kTensorCores<T>) return flash_bwd_tc_kernel<D>;
  else return flash_bwd_kernel<T, D>;
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq_partials, void* dk, void* dv, Geometry geo, float scale,
        float scale2, int causal, int with_dq, void* stream) {
  return launch(kernel_for<T, D>(), launch_grid(geo), launch_smem<T>(D), kTensorCores<T>, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dq_partials),
                static_cast<T*>(dk), static_cast<T*>(dv), geo, scale, scale2, causal, with_dq);
}

template <typename T, int D>
int query(Geometry geo, long long* info) {
  return rkt_info::write(kernel_for<T, D>(), launch_grid(geo), kThreads, launch_smem<T>(D), info);
}

template <typename T, int D>
int attr(int what) {
  return attribute(kernel_for<T, D>(), launch_smem<T>(D), kTensorCores<T>, what);
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

// Resident CTAs per SM of rkt_flash_bwd's (d, dtype) kernel at its shared
// memory, and its registers per thread; -1 when the card refuses it or d
// is not compiled.
extern "C" int rkt_flash_bwd_occupancy(int d, int dtype) {
  if (!RKT_FLASH_COMPILED(d)) return -1;
  RKT_FLASH_DISPATCH(attr, dtype, d, 0);
}
extern "C" int rkt_flash_bwd_registers(int d, int dtype) {
  if (!RKT_FLASH_COMPILED(d)) return -1;
  RKT_FLASH_DISPATCH(attr, dtype, d, 1);
}
