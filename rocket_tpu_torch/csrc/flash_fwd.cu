// Flash-attention forward on feature-major operands.
//
// Replaces: rocket_tpu/ops/flash_native.py, _fwd_kernel (:134), launched by
// _fwd (pallas_call at :236).
//
// One CTA per (q-tile, query head, batch row), 4 warps. It walks the key
// tiles in order -- up to the diagonal tile when causal, masking only that
// tile and keys past t -- keeping an online base-2 softmax: scores
// s = q.k * log2(e)/sqrt(D) in f32, a running max m and sum l per row, and
// the f32 output accumulator in registers. The probabilities enter the PV
// product rounded to the operand dtype, as the reference casts them. At
// the end it writes out (B, T, Hq*D) once and lse = m + log2(l) (base 2,
// l = 0 read as 1) into (B, Hq, T) f32.
//
// The TPU grid's last axis runs in order and carries m, l and the
// accumulator in VMEM scratch; Hopper blocks run in no order, so that axis
// is the loop inside the CTA. GQA: query head h reads kv head h / g.
//
// Bound on the H100: at GPT-2 shapes (bf16, B = 8, T = 1024, H = 12,
// D = 64) the bytes (q, k, v read once, out and lse written once: ~51 MB)
// and the causal flops (4 * D per visible pair: ~12.9 GFLOP) give nearly
// equal least times, ~0.015 ms and ~0.013 ms; in f32 the flops bound.
//
// bf16 (the main path's dtype), redesigned for the tensor cores: each warp
// owns 16 query rows of a 64-row tile. The Q tile is copied once by
// cp.async and held in registers as mma A fragments; K and V stream
// through a two-stage cp.async ring of bf16 64 x D tiles (row stride D + 8,
// so ldmatrix is free of bank conflicts; rows past t zero-filled by the
// copy's src-size), tile ik + 1 in flight while ik is computed. S = Q.K^T
// and O += P.V run on mma.sync m16n8k16 with f32 accumulators; the row
// max and sum reduce over the quad that shares a row; P is rounded to bf16
// and re-packed from the score accumulators into A fragments (it never
// touches shared memory), V is read by ldmatrix.trans. Shared memory is
// 5 x 64 x (D + 8) bf16 (46,080 B at D = 64), so four CTAs fit an SM by
// shared memory; 87,040 B at D = 128, two. Left for later: wgmma with TMA, 128-row q tiles, and
// splitting K and V into separate copy groups.
//
// f32 operands keep the first kernel, not redesigned: register-tiled f32
// FMA over f32 shared-memory tiles (4 x 8 scores and 4 x D/8 outputs per
// thread). TF32 mma would miss the f32 parity bound of 1e-4, and no main
// path trains in f32.
#include "flash_common.cuh"
#include "launch_info.cuh"
#include "mma_common.cuh"

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

// The bf16 kernel on the tensor cores (see the note at the head).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    __nv_bfloat16* out, float* lse, Geometry geo, float scale2, int causal) {
  using namespace rkt_mma;
  constexpr int LD = D + kPad;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kTileElems;      // two stages
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // two stages

  const int t = geo.t;
  const int nq = (t + kTile - 1) / kTile;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (geo.hq / geo.h_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kTile;
  const __nv_bfloat16* q_plane = q + static_cast<long long>(b) * t * geo.fq;
  const __nv_bfloat16* k_plane = k + static_cast<long long>(b) * t * geo.fk;
  const __nv_bfloat16* v_plane = v + static_cast<long long>(b) * t * geo.fk;
  const int k_col = geo.k_off + hk * D, v_col = geo.v_off + hk * D;

  cp_async_rows<D, LD, kThreads>(q_s, q_plane, q0, t, geo.fq, geo.q_off + h * D);
  cp_async_rows<D, LD, kThreads>(k_s, k_plane, 0, t, geo.fk, k_col);
  cp_async_rows<D, LD, kThreads>(v_s, v_plane, 0, t, geo.fk, v_col);
  cp_async_commit();

  // Rows g and g + 8 of the warp's 16: running max, this thread's share
  // of the running sum (quad-reduced at the end) and the output.
  const int row_a = q0 + warp * 16 + lane / 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  unsigned qa[D / 16][4];

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
    if (ik == 0) load_a_rows<D, LD>(qa, q_s + warp * 16 * LD);

    float s[kKeys / 8][4];
    qk_tile<D, LD>(s, qa, k_s + (ik & 1) * kTileElems);
    const bool diag = causal && ik == iq;
    const bool edge = k0 + kTile > t;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        const float x = s[n][e] * scale2;
        s[n][e] = ((edge && col >= t) || (diag && col > row)) ? kNegInf : x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - m_new);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_new);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
    pv_tile<D, LD>(o, s, v_s + (ik & 1) * kTileElems);  // p rounded to bf16 in the packing
  }

  const int f_out = geo.hq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    const float safe_l = l_row == 0.f ? 1.f : l_row;
    const float inv = 1.f / safe_l;
    __nv_bfloat16* dst = out + (static_cast<long long>(b) * t + row) * f_out + h * D +
                         2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (lane % 4 == 0) lse[(static_cast<long long>(b) * geo.hq + h) * t + row] = m[r] + log2f(safe_l);
  }
}

// One CTA per (q tile, query head, batch row), and its dynamic shared
// memory: the bf16 kernel's Q tile and two stages of K and V (bf16, row
// stride D + 8); the f32 kernel's three f32 tiles and a score tile.
inline dim3 launch_grid(const Geometry& geo) {
  return dim3((geo.t + kTile - 1) / kTile, geo.hq, geo.batch);
}
template <typename T>
size_t launch_smem(int d) {
  if constexpr (kTensorCores<T>)
    return sizeof(__nv_bfloat16) * 5 * kTile * static_cast<size_t>(d + rkt_mma::kPad);
  return smem_bytes(d, 3, 1, 0);
}

// The kernel of one (dtype, D): bf16 on the tensor cores, f32 on the CUDA
// cores.
template <typename T, int D>
auto kernel_for() {
  if constexpr (kTensorCores<T>) return flash_fwd_tc_kernel<D>;
  else return flash_fwd_kernel<T, D>;
}

// Four 46 KB bf16 CTAs per SM need the whole carveout as shared memory.
template <typename T, int D>
int run(const void* q, const void* k, const void* v, void* out, void* lse, Geometry geo,
        float scale2, int causal, void* stream) {
  return launch(kernel_for<T, D>(), launch_grid(geo), launch_smem<T>(D), kTensorCores<T>, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(out), static_cast<float*>(lse), geo, scale2, causal);
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

// Resident CTAs per SM of rkt_flash_fwd's (d, dtype) kernel at its shared
// memory; -1 when the card refuses it or d is not compiled.
extern "C" int rkt_flash_fwd_occupancy(int d, int dtype) {
  if (!RKT_FLASH_COMPILED(d)) return -1;
  RKT_FLASH_DISPATCH(attr, dtype, d, 0);
}
