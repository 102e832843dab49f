// Flash-attention accumulating dq: the backward's dq past the partial
// buffer's byte bound.
//
// Replaces: rocket_tpu/ops/flash_native.py, _dq_kernel (:348), launched by
// _bwd_arrays (pallas_call at :508) when dq_split.
//
// One CTA per (q-tile, query head, batch row), 4 warps, longest causal
// rows first. It stages its kTile query and dout rows and their lse /
// delta once, then walks the key tiles up to the diagonal (all when not
// causal), recomputing
//   p = exp2(s - lse), dp = dout . v, ds = p * (dp - delta) / sqrt(D)
// and accumulating dq += round(ds) k in f32 registers; dq is written once,
// in the operand dtype. HBM stays linear in T where the partial strategy
// of flash_bwd writes nk f32 copies of dq, at the price of the two score
// products flash_bwd already computed.
//
// The TPU grid's last axis (the k sweep) runs in order with dq in VMEM
// scratch; here it is the loop inside the CTA.
//
// Bound on the H100: operations (3 products per visible pair, 2 * D flops
// each: ~77 GFLOP causal at B = 8, T = 2048, H = 12, D = 64, 0.078 ms at
// 989 TFLOP/s; the bytes of q, k, v, dout, lse, delta and dq, ~0.13 GB,
// take ~0.038 ms).
//
// bf16 (the main path's dtype), on the tensor cores: flash_fwd's design
// with a second score product and the PV product on K. Each warp owns 16
// query rows of the 64-row tile. Q and dout are copied once by cp.async
// and read as mma A fragments per key tile (ldmatrix; holding both in
// registers would cost the 32 that keep four CTAs resident), lse and delta
// of the thread's two rows sit in registers. K and V stream through a
// two-stage cp.async ring of bf16 64 x D tiles (row stride D + 8, rows
// past t zero-filled), tile ik + 1 in flight while ik is computed.
// S = Q.K^T and dP = dO.V^T run on mma.sync m16n8k16 with f32
// accumulators, ds is formed in the accumulator layout and re-packed,
// rounded to bf16, as the A fragments of dq += dS.K, K read by
// ldmatrix.trans: dS never touches shared memory. Shared memory is
// 6 x 64 x (D + 8) bf16 (55,296 B at D = 64), four CTAs per SM; at
// D = 128 (104,448 B, two CTAs) Q and dout are read one k16 slice at a
// time (qk_tile_rows) and the launch bounds ask for two CTAs. Left for
// later: wgmma with TMA.
//
// f32 operands keep the first kernel, register-tiled f32 FMA over f32
// shared-memory tiles (TF32 would miss the 1e-4 bound; no main path trains
// in f32).
#include "flash_common.cuh"
#include "launch_info.cuh"
#include "mma_common.cuh"

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

// The bf16 kernel on the tensor cores (see the note at the head).
// Four resident CTAs at D <= 64 (128 registers a thread); two at D = 128,
// where the dq accumulator alone takes 64.
template <int D>
__global__ void __launch_bounds__(kThreads, D > 64 ? 2 : 4)
flash_dq_tc_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* delta,
                   __nv_bfloat16* dq, Geometry geo, float scale, float scale2, int causal) {
  using namespace rkt_mma;
  constexpr int LD = D + kPad;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTileElems;
  __nv_bfloat16* k_s = do_s + kTileElems;     // two stages
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // two stages

  const int t = geo.t, hq = geo.hq;
  const int nq = (t + kTile - 1) / kTile;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / geo.h_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kTile;
  const int f_do = hq * D;
  const __nv_bfloat16* k_plane = k + static_cast<long long>(b) * t * geo.fk;
  const __nv_bfloat16* v_plane = v + static_cast<long long>(b) * t * geo.fk;
  const int k_col = geo.k_off + hk * D, v_col = geo.v_off + hk * D;

  cp_async_rows<D, LD, kThreads>(q_s, q + static_cast<long long>(b) * t * geo.fq, q0, t, geo.fq,
                                 geo.q_off + h * D);
  cp_async_rows<D, LD, kThreads>(do_s, dout + static_cast<long long>(b) * t * f_do, q0, t, f_do,
                                 h * D);
  cp_async_rows<D, LD, kThreads>(k_s, k_plane, 0, t, geo.fk, k_col);
  cp_async_rows<D, LD, kThreads>(v_s, v_plane, 0, t, geo.fk, v_col);
  cp_async_commit();

  // Rows g and g + 8 of the warp's 16: their lse and delta (0 past t) and dq.
  const int row_a = q0 + warp * 16 + lane / 4;
  const long long stats = (static_cast<long long>(b) * hq + h) * t;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse_r[r] = row < t ? lse[stats + row] : 0.f;
    dl_r[r] = row < t ? delta[stats + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nk = causal ? iq + 1 : nq;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile ik has landed; every warp is done with tile ik - 1
    if (ik + 1 < nk) {
      const int st = (ik + 1) & 1;
      cp_async_rows<D, LD, kThreads>(k_s + st * kTileElems, k_plane, k0 + kTile, t, geo.fk,
                                     k_col);
      cp_async_rows<D, LD, kThreads>(v_s + st * kTileElems, v_plane, k0 + kTile, t, geo.fk,
                                     v_col);
      cp_async_commit();
    }
    const __nv_bfloat16* k_tile = k_s + (ik & 1) * kTileElems;
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    if constexpr (D > 64) {
      qk_tile_rows<D, LD>(s, q_s + warp * 16 * LD, k_tile);
      qk_tile_rows<D, LD>(dp, do_s + warp * 16 * LD, v_s + (ik & 1) * kTileElems);
    } else {
      unsigned a[D / 16][4];
      load_a_rows<D, LD>(a, q_s + warp * 16 * LD);
      qk_tile<D, LD>(s, a, k_tile);
      load_a_rows<D, LD>(a, do_s + warp * 16 * LD);
      qk_tile<D, LD>(dp, a, v_s + (ik & 1) * kTileElems);
    }
    const bool diag = causal && ik == iq;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        const bool live = col < t && row < t && !(diag && col > row);
        const float p = live ? exp2f(s[n][e] * scale2 - lse_r[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl_r[e >> 1]) * scale;
      }
    pv_tile<D, LD>(acc, s, k_tile);  // ds rounded to bf16 in the packing
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    __nv_bfloat16* dst = dq + (static_cast<long long>(b) * t + row) * f_do + h * D +
                         2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// One CTA per (q tile, query head, batch row), and its dynamic shared
// memory: the bf16 kernel's Q and dout tiles and two stages of K and V
// (bf16, row stride D + 8); the f32 kernel's four f32 tiles, a score tile
// and two statistic rows.
inline dim3 launch_grid(const Geometry& geo) {
  return dim3((geo.t + kTile - 1) / kTile, geo.hq, geo.batch);
}
template <typename T>
size_t launch_smem(int d) {
  if constexpr (kTensorCores<T>)
    return sizeof(__nv_bfloat16) * 6 * kTile * static_cast<size_t>(d + rkt_mma::kPad);
  return smem_bytes(d, 4, 1, 2);
}

// The kernel of one (dtype, D): bf16 on the tensor cores, f32 on the CUDA
// cores.
template <typename T, int D>
auto kernel_for() {
  if constexpr (kTensorCores<T>) return flash_dq_tc_kernel<D>;
  else return flash_dq_kernel<T, D>;
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq, Geometry geo, float scale, float scale2, int causal,
        void* stream) {
  return launch(kernel_for<T, D>(), launch_grid(geo), launch_smem<T>(D), kTensorCores<T>, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), geo, scale, scale2,
                causal);
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

// Resident CTAs per SM of rkt_flash_dq's (d, dtype) kernel at its shared
// memory, and its registers per thread; -1 when the card refuses it or d
// is not compiled.
extern "C" int rkt_flash_dq_occupancy(int d, int dtype) {
  if (!RKT_FLASH_COMPILED(d)) return -1;
  RKT_FLASH_DISPATCH(attr, dtype, d, 0);
}
extern "C" int rkt_flash_dq_registers(int d, int dtype) {
  if (!RKT_FLASH_COMPILED(d)) return -1;
  RKT_FLASH_DISPATCH(attr, dtype, d, 1);
}
