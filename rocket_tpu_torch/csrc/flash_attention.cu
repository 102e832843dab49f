// Flash attention on one stacked (3, B, H, T, D) q/k/v operand: forward
// (rkt_flash_qkv_fwd) and fused one-pass backward (rkt_flash_qkv_bwd).
//
// Replaces: rocket_tpu/ops/flash_attention.py, _fwd_kernel (:102) launched
// by _fwd (pallas_call at :202), and _bwd_kernel (:232) launched by _bwd
// (pallas_call at :326).
//
// Forward. One CTA per (q-tile, head, batch row). It stages its BQ query
// rows once and walks the BK-row key tiles in order (up to the diagonal
// tile when causal: tiles above it are skipped, the diagonal tile is masked
// to -1e30), keeping an online base-2 softmax: s2 = q.k * log2(e)/sqrt(D)
// in f32, a running max m and sum l per row, exp2, and the f32 output
// accumulator, all in registers; p enters the PV product rounded to v's
// dtype. It writes O (B, H, T, D) in the operand dtype and lse = m +
// log2(l) (base 2; a row with l == 0 reads l as 1) into (B, H, 1, T) f32.
//
// Backward. One CTA per (k-tile, head, batch row). It stages its key and
// value rows once, keeps dk and dv for them in f32 registers and walks the
// query tiles (from the diagonal on when causal):
//   p  = exp2(s2 - lse)            recomputed, transposed (k rows, q cols)
//   dp = v . dO
//   ds = p * (dp - delta) / sqrt(D)
//   dv += round(p)^T dO,  dk += round(ds)^T q      (round: to the dtype)
// and writes this k-tile's dq contribution round(ds) k for the q-tile,
// summed in f32 and rounded to the operand dtype, into dq_partials[ik]
// (nk, B, H, T, D); q-tiles a causal k-tile cannot see are written as
// zeros. delta = rowsum(O * dO) (B, H, 1, T) f32 comes from outside, and
// the partials are summed in f32 outside, as the reference does (:310,
// :357). No atomics: two launches give the same bits.
//
// The TPU grid's last axis (the kv sweep forward, the q sweep backward)
// runs in order and carries its state in VMEM scratch; Hopper blocks run
// in no order, so that axis is the loop inside the CTA.
//
// Tiles: BQ x BK in {64, 128}^2, a template parameter each (causal needs
// BQ == BK; the entry points refuse anything else), head dim D in {32, 64},
// f32 or bf16 operands, and 64 x 64 at D = 128: 18 instantiations of each
// direction. At D = 128 the bf16 forward takes two CTAs' registers (255
// a thread) and the bf16 backward reads its K and V rows one k16 slice at
// a time (qk_tile_rows) and makes dq in 64-column passes, so that dk, dv
// and dq fit the registers together.
//
// The bf16 forward (the tuner's flash_fwd path) runs on the tensor cores:
// each warp owns 16 query rows, so BQ = 64 is 4 warps and BQ = 128 is 8.
// The Q tile is copied once by cp.async and held as mma A fragments; K and
// V stream through a two-stage cp.async ring of bf16 BK x D tiles at row
// stride D + 8 (ldmatrix free of bank conflicts), tile ik + 1 in flight
// while ik is computed. Each stage is BK / 64 steps of 64 keys: S = Q.K^T
// and O += P.V on mma.sync m16n8k16 with f32 accumulators (mma_common.cuh's
// qk_tile / pv_tile), the online softmax stepping once per 64 keys (the
// same sum as one step per BK tile, regrouped), P rounded to bf16 and
// re-packed from the score accumulators into A fragments, never touching
// shared memory. On a causal diagonal tile a warp skips the 64-key steps
// that lie wholly above its rows (their p is 0: skipping them changes no
// bit). Shared memory is (BQ + 4 BK) (D + 8) bf16: 46,080 B at 64 x 64 and
// 92,160 B at 128 x 128 (D = 64), so four and two CTAs fit an SM by
// shared memory.
//
// The bf16 backward runs on the tensor cores too, row 4's core
// (flash_bwd.cu) with the roles of its operands moved onto the planes:
// each warp owns 16 of the CTA's BK key rows (BK = 64: 4 warps, 128: 8).
// K and V are copied once and read as mma A fragments; Q, dO, lse and
// delta stream through a two-stage cp.async ring in 64-query steps
// whatever BQ is (BQ only sets where the causal zero partials end), so the
// ring is row 4's size. Per step S^T = K.Q^T and dP^T = V.dO^T run on
// mma.sync (16 keys x 64 queries a warp), p and ds are formed in that
// layout, and dv += P^T.dO and dk += dS^T.Q take them re-packed as A
// fragments. A warp whose 16 keys all follow the step's 64 queries on the
// causal diagonal (at BK = 128) skips the products (p is 0 there: no bit
// changes). For
// dq the warps write round(dS^T) to one bf16 BK x 64 tile (stride 72);
// after a barrier the 64 x D partial, a sum over all BK keys, is split so
// that no two warps sum into one element (4 groups of 16 query rows, times
// BK / 64 column slices of D), read back by ldmatrix.trans and multiplied
// by the K tile, summed in f32 and written once in bf16. Shared memory is
// (2 BK + 256) (D + 8) + 72 BK bf16 and 1 KB of statistics: 65,536 B at
// BK = 64 and 93,184 B at BK = 128 (D = 64). Registers, not shared
// memory, set the residency: two CTAs of 4 warps per SM at BK = 64, one
// of 8 at BK = 128.
//
// The f32 forward and backward keep the first kernel:
// 256 threads form a 16 x 16 grid (ty, tx); in a score tile thread (ty,
// tx) owns rows ty + 16 i and columns tx + 16 j; in an output tile the
// same rows and columns tx + 16 c (c < D / 16). The 16 threads of a row are
// 16 neighbouring lanes, so a row's max and sum reduce with four
// xor-shuffles. Tiles are staged in shared memory as f32 with a padded row
// stride D + 1, register-tiled f32 FMA over them. At BQ = BK = 128, D = 64,
// f32 the backward takes 200 KB of dynamic shared memory (q, k, v and dO
// tiles of 33 KB each, one 66 KB score tile shared by round(p) and then
// round(ds)); each instantiation raises its own cap. TF32 mma would miss
// the f32 parity bound of 1e-4; no main path runs f32.
//
// Bound on the H100 at GPT-2 shapes (bf16, B = 8, H = 12, T = 1024,
// D = 64, causal): forward bytes (qkv read once, O and lse written once,
// ~51 MB, ~0.015 ms) against 2 products per visible pair (~12.9 GFLOP,
// ~0.013 ms): bytes. Backward: 5 products per visible pair (~32 GFLOP,
// ~0.033 ms) against its bytes, which with the bf16 dq partials (nk copies
// of dq) are ~190 MB at block_k = 128 (~0.057 ms). Left for later: wgmma
// with TMA loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "launch_info.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTy = 16, kTx = 16;
constexpr float kNegInf = -1e30f;

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

// Reductions over the 16 lanes of one row (lanes 16k .. 16k+15).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0 + R) of a contiguous (T, D) plane as f32 with row
// stride D + 1 (T is a multiple of every tile, so no row is ragged).
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* plane, int row0) {
  const T* src = plane + static_cast<long long>(row0) * D;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] = to_f32(src[i]);
  }
}

template <int BQ, int BK, int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

template <int BQ, int BK, int D>
constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * (BQ + BK) * (D + 1) + BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
qkv_fwd_kernel(const T* qkv, T* out, float* lse, int batch, int heads, int t, float scale2,
               int causal) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RI = BQ / kTy, CJ = BK / kTx, DC = D / kTx;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* p_s = v_s + BK * LD;

  const int nq = t / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = iq * BQ;
  const long long plane = static_cast<long long>(t) * D;
  const long long bh = static_cast<long long>(b) * heads + h;
  const long long stack = static_cast<long long>(batch) * heads * plane;
  const T* qp = qkv + bh * plane;
  const T* kp = qp + stack;
  const T* vp = kp + stack;

  load_rows<T, BQ, D>(q_s, qp, q0);

  float m[RI], l[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? iq + 1 : t / BK;  // causal: BQ == BK
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's k_s / v_s / p_s reads are done
    load_rows<T, BK, D>(k_s, kp, k0);
    load_rows<T, BK, D>(v_s, vp, k0);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qr[RI], kc[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qr[i] = q_s[(ty + kTy * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kc[j] = k_s[(tx + kTx * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    const bool diag = causal && ik == iq;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + kTy * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float x = s[i][j] * scale2;
        if (diag && k0 + tx + kTx * j > qi) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        p_s[(ty + kTy * i) * LP + tx + kTx * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vr[c] = v_s[kk * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty + kTy * i) * LP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + kTy * i;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / safe_l;
    T* row = out + bh * plane + static_cast<long long>(qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + kTx * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0) lse[bh * t + qi] = m[i] + log2f(safe_l);
  }
}

// The bf16 forward on the tensor cores (see the note at the head): 2 * BQ
// threads, one warp per 16 query rows.
template <int D, int BQ, int BK>
constexpr size_t fwd_tc_smem() {
  return sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (D + rkt_mma::kPad);
}

// cp.async rows [row0, row0 + R) of a contiguous (T, D) bf16 plane into
// dst at row stride D + 8, 64 rows a call.
template <int R, int D, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* plane,
                                           int row0, int t) {
  constexpr int LD = D + rkt_mma::kPad;
#pragma unroll
  for (int r = 0; r < R; r += rkt_mma::kKeys)
    rkt_mma::cp_async_rows<D, LD, THREADS>(dst + r * LD, plane, row0 + r, t, D, 0);
}

// Four CTAs of 4 warps or two of 8 per SM: at most 128 registers a thread.
// At D = 128 (64 x 64 only) the output accumulator alone takes 64: two CTAs.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ, (D > 64 ? 128 : 256) / BQ)
qkv_fwd_tc_kernel(const __nv_bfloat16* qkv, __nv_bfloat16* out, float* lse, int batch, int heads,
                  int t, float scale2, int causal) {
  using namespace rkt_mma;
  constexpr int kThr = 2 * BQ;
  constexpr int LD = D + kPad;
  constexpr int kStage = BK * LD;  // elements of one K (or V) stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * LD;     // two stages
  __nv_bfloat16* v_s = k_s + 2 * kStage;  // two stages

  const int nq = t / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * BQ;
  const long long plane = static_cast<long long>(t) * D;
  const long long bh = static_cast<long long>(b) * heads + h;
  const long long stack = static_cast<long long>(batch) * heads * plane;
  const __nv_bfloat16* qp = qkv + bh * plane;
  const __nv_bfloat16* kp = qp + stack;
  const __nv_bfloat16* vp = kp + stack;

  stage_rows<BQ, D, kThr>(q_s, qp, q0, t);
  stage_rows<BK, D, kThr>(k_s, kp, 0, t);
  stage_rows<BK, D, kThr>(v_s, vp, 0, t);
  cp_async_commit();

  // Rows g and g + 8 of the warp's 16: running max, this thread's share
  // of the running sum (quad-reduced at the end) and the output.
  const int warp_row0 = q0 + warp * 16;
  const int row_a = warp_row0 + lane / 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  unsigned qa[D / 16][4];

  const int nk = causal ? iq + 1 : t / BK;  // causal: BQ == BK
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile ik has landed; every warp is done with tile ik - 1
    if (ik + 1 < nk) {
      const int st = (ik + 1) & 1;
      stage_rows<BK, D, kThr>(k_s + st * kStage, kp, k0 + BK, t);
      stage_rows<BK, D, kThr>(v_s + st * kStage, vp, k0 + BK, t);
      cp_async_commit();
    }
    if (ik == 0) load_a_rows<D, LD>(qa, q_s + warp * 16 * LD);
    const __nv_bfloat16* k_tile = k_s + (ik & 1) * kStage;
    const __nv_bfloat16* v_tile = v_s + (ik & 1) * kStage;
    const bool diag = causal && ik == iq;
#pragma unroll
    for (int sub = 0; sub < BK / kKeys; ++sub) {
      const int c0 = k0 + sub * kKeys;
      if (diag && c0 > warp_row0 + 15) continue;  // wholly above this warp's rows
      float s[kKeys / 8][4];
      qk_tile<D, LD>(s, qa, k_tile + sub * kKeys * LD);
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * (lane % 4) + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          const float x = s[n][e] * scale2;
          s[n][e] = (diag && col > row) ? kNegInf : x;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
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
      pv_tile<D, LD>(o, s, v_tile + sub * kKeys * LD);  // p rounded to bf16 in the packing
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int row = row_a + 8 * r;
    const float safe_l = l_row == 0.f ? 1.f : l_row;
    const float inv = 1.f / safe_l;
    __nv_bfloat16* dst = out + bh * plane + static_cast<long long>(row) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (lane % 4 == 0) lse[bh * t + row] = m[r] + log2f(safe_l);
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_kernel(const T* qkv, const T* dout, const float* lse, const float* delta,
               T* dq_partials, T* dk, T* dv, int batch, int heads, int t, float scale,
               float scale2, int causal) {
  constexpr int LD = D + 1, LS = BQ + 1;
  constexpr int RI = BK / kTy, CJ = BQ / kTx, DC = D / kTx, QI = BQ / kTy;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * LD;
  float* q_s = v_s + BK * LD;
  float* do_s = q_s + BQ * LD;
  float* sc_s = do_s + BQ * LD;  // BK (k) x LS (q): round(p), then round(ds)
  float* lse_s = sc_s + BK * LS;
  float* dl_s = lse_s + BQ;

  const int nq = t / BQ;
  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int k0 = ik * BK;
  const long long plane = static_cast<long long>(t) * D;
  const long long bh = static_cast<long long>(b) * heads + h;
  const long long stack = static_cast<long long>(batch) * heads * plane;
  const T* qp = qkv + bh * plane;
  const T* kp = qp + stack;
  const T* vp = kp + stack;
  const T* dop = dout + bh * plane;
  const float* lse_row = lse + bh * t;
  const float* dl_row = delta + bh * t;
  T* dqp = dq_partials + static_cast<long long>(ik) * stack + bh * plane;

  load_rows<T, BK, D>(k_s, kp, k0);
  load_rows<T, BK, D>(v_s, vp, k0);

  float dk_acc[RI][DC], dv_acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int iq0 = causal ? ik : 0;  // causal: BQ == BK
  // The partials of the q-tiles this k-tile cannot see are zero.
  for (long long i = tid; i < static_cast<long long>(iq0) * BQ * D; i += kThreads)
    dqp[i] = from_f32<T>(0.f);

  for (int iq = iq0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // the previous q-tile's shared reads are done
    load_rows<T, BQ, D>(q_s, qp, q0);
    load_rows<T, BQ, D>(do_s, dop, q0);
    for (int r = tid; r < BQ; r += kThreads) {
      lse_s[r] = lse_row[q0 + r];
      dl_s[r] = dl_row[q0 + r];
    }
    __syncthreads();

    // Transposed tiles: thread rows are key rows, columns query rows.
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; ++dd) {
      float kr[RI], vr[RI], qc[CJ], dc[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kr[i] = k_s[(ty + kTy * i) * LD + dd];
        vr[i] = v_s[(ty + kTy * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        qc[j] = q_s[(tx + kTx * j) * LD + dd];
        dc[j] = do_s[(tx + kTx * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
          dp[i][j] = fmaf(vr[i], dc[j], dp[i][j]);
        }
    }

    const bool diag = causal && iq == ik;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kj = k0 + ty + kTy * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + kTx * j;
        const float p = (diag && kj > q0 + col) ? 0.f : exp2f(s[i][j] * scale2 - lse_s[col]);
        dp[i][j] = p * (dp[i][j] - dl_s[col]) * scale;  // ds, unrounded
        sc_s[(ty + kTy * i) * LS + col] = round_to<T>(p);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float dor[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) dor[c] = do_s[qq * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = sc_s[(ty + kTy * i) * LS + qq];
#pragma unroll
        for (int c = 0; c < DC; ++c) dv_acc[i][c] = fmaf(p, dor[c], dv_acc[i][c]);
      }
    }
    __syncthreads();  // round(p) is read; the tile takes round(ds)
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc_s[(ty + kTy * i) * LS + tx + kTx * j] = round_to<T>(dp[i][j]);
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float qr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) qr[c] = q_s[qq * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = sc_s[(ty + kTy * i) * LS + qq];
#pragma unroll
        for (int c = 0; c < DC; ++c) dk_acc[i][c] = fmaf(ds, qr[c], dk_acc[i][c]);
      }
    }

    // This k-tile's dq partial for the q-tile: rows are query rows.
    float dq[QI][DC];
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float kr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kr[c] = k_s[kk * LD + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const float ds = sc_s[kk * LS + ty + kTy * i];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(ds, kr[c], dq[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      T* row = dqp + static_cast<long long>(q0 + ty + kTy * i) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) row[tx + kTx * c] = from_f32<T>(dq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long off = bh * plane + static_cast<long long>(k0 + ty + kTy * i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + kTx * c] = from_f32<T>(dk_acc[i][c]);
      dv[off + tx + kTx * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// The bf16 backward on the tensor cores (see the note at the head): 2 * BK
// threads, one warp per 16 key rows. Shared memory: K and V (BK rows each),
// two stages of 64 rows of Q and dO, all bf16 at row stride D + 8; the
// bf16 BK x 64 dS^T tile at stride 72; two stages of 64 lse and delta.
template <int D, int BK>
constexpr size_t bwd_tc_smem() {
  return sizeof(__nv_bfloat16) * ((2 * BK + 4 * rkt_mma::kKeys) * (D + rkt_mma::kPad) +
                                  BK * (rkt_mma::kKeys + rkt_mma::kPad)) +
         sizeof(float) * 4 * rkt_mma::kKeys;
}

// No floor on resident CTAs: at row 4's three per SM (168 registers a
// thread) the BK = 64 kernel spills. Unbounded it takes 190 registers at
// BK = 64 (two CTAs of 4 warps per SM) and 240 at BK = 128 (one of 8), at
// D = 64, and spills nowhere.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BK)
qkv_bwd_tc_kernel(const __nv_bfloat16* qkv, const __nv_bfloat16* dout, const float* lse,
                  const float* delta, __nv_bfloat16* dq_partials, __nv_bfloat16* dk,
                  __nv_bfloat16* dv, int batch, int heads, int t, float scale, float scale2,
                  int causal) {
  using namespace rkt_mma;
  constexpr int kThr = 2 * BK;
  constexpr int LD = D + kPad;
  constexpr int LDS = kKeys + kPad;  // row stride of the dS^T tile
  constexpr int kStep = kKeys * LD;  // elements of one Q (or dO) stage
  // dq of a step: 4 groups of 16 query rows, each split over BK / 64
  // warps by columns, so no two warps sum into one element.
  constexpr int kSplit = BK / kKeys, DW = D / kSplit, DQW = DW > 64 ? 64 : DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + BK * LD;
  __nv_bfloat16* q_s = v_s + BK * LD;      // two stages
  __nv_bfloat16* do_s = q_s + 2 * kStep;   // two stages
  __nv_bfloat16* ds_s = do_s + 2 * kStep;  // BK keys x LDS
  float* lse_s = reinterpret_cast<float*>(ds_s + BK * LDS);  // two stages
  float* dl_s = lse_s + 2 * kKeys;                           // two stages

  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = ik * BK;
  const long long plane = static_cast<long long>(t) * D;
  const long long bh = static_cast<long long>(b) * heads + h;
  const long long stack = static_cast<long long>(batch) * heads * plane;
  const __nv_bfloat16* qp = qkv + bh * plane;
  const __nv_bfloat16* dop = dout + bh * plane;
  const float* lse_row = lse + bh * t;
  const float* dl_row = delta + bh * t;
  __nv_bfloat16* dqp = dq_partials + static_cast<long long>(ik) * stack + bh * plane;

  // The sweep: 64-query steps from the diagonal on when causal (BQ == BK),
  // from row 0 otherwise.
  const int first = causal ? k0 / kKeys : 0, steps = t / kKeys - first;
  auto stage = [&](int i, int st) {
    const int q0 = (first + i) * kKeys;
    cp_async_rows<D, LD, kThr>(q_s + st * kStep, qp, q0, t, D, 0);
    cp_async_rows<D, LD, kThr>(do_s + st * kStep, dop, q0, t, D, 0);
    cp_async_stats<kThr>(lse_s + st * kKeys, lse_row, q0, t);
    cp_async_stats<kThr>(dl_s + st * kKeys, dl_row, q0, t);
  };
  stage_rows<BK, D, kThr>(k_s, qp + stack, k0, t);
  stage_rows<BK, D, kThr>(v_s, qp + 2 * stack, k0, t);
  stage(0, 0);
  cp_async_commit();

  if (causal) {
    // The partial rows of the queries this k-tile cannot see are zero.
    for (int i = threadIdx.x; i < k0 * (D / 8); i += kThr)
      reinterpret_cast<uint4*>(dqp)[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // Rows g and g + 8 of the warp's 16 keys: dk and dv.
  const int key_a = k0 + warp * 16 + lane / 4;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  // This warp's share of each step's dq: its query group and column slice.
  const int qg = kSplit == 1 ? warp : warp % 4, dh = kSplit == 1 ? 0 : warp / 4;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1, q0 = (first + i) * kKeys;
    cp_async_wait<0>();
    __syncthreads();  // step i has landed; every warp is done with step i - 1
    if (i + 1 < steps) {
      stage(i + 1, st ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* q_tile = q_s + st * kStep;
    const __nv_bfloat16* do_tile = do_s + st * kStep;
    const float* lse_t = lse_s + st * kKeys;
    const float* dl_t = dl_s + st * kKeys;
    __nv_bfloat16* ds_rows = ds_s + warp * 16 * LDS;
    const bool diag = causal && q0 < k0 + BK;
    if (BK > kKeys && diag && k0 + warp * 16 > q0 + kKeys - 1) {
      // Every key of the warp follows every query of the step (only at
      // BK = 128): p and ds are 0, so the products are skipped and dS^T is
      // zero.
      for (int idx = lane; idx < 16 * (kKeys / 8); idx += 32)
        *reinterpret_cast<uint4*>(ds_rows + (idx / (kKeys / 8)) * LDS + (idx % (kKeys / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    } else {
      // Transposed blocks: rows are the warp's keys, columns the step's queries.
      float s[kKeys / 8][4], dp[kKeys / 8][4];
      if constexpr (D > 64) {  // dk and dv leave no room for the A fragments
        qk_tile_rows<D, LD>(s, k_s + warp * 16 * LD, q_tile);
        qk_tile_rows<D, LD>(dp, v_s + warp * 16 * LD, do_tile);
      } else {
        unsigned a[D / 16][4];
        load_a_rows<D, LD>(a, k_s + warp * 16 * LD);
        qk_tile<D, LD>(s, a, q_tile);
        load_a_rows<D, LD>(a, v_s + warp * 16 * LD);
        qk_tile<D, LD>(dp, a, do_tile);
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * (lane % 4) + (e & 1);
          const int kj = key_a + (e >> 1) * 8;
          const float p = (diag && kj > q0 + col) ? 0.f : exp2f(s[n][e] * scale2 - lse_t[col]);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl_t[col]) * scale;
        }
      pv_tile<D, LD>(dv_acc, s, do_tile);  // p rounded to bf16 in the packing
      pv_tile<D, LD>(dk_acc, dp, q_tile);  // ds likewise
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<unsigned*>(ds_rows + (lane / 4 + 8 * r) * LDS + n * 8 +
                                       2 * (lane % 4)) = pack_bf16(dp[n][2 * r], dp[n][2 * r + 1]);
    }
    __syncthreads();  // dS^T of every key of the tile is in place

    // This k-tile's dq partial for the step: query rows 16 qg .. 16 qg + 15
    // of round(dS).K over all BK keys, columns DW dh .. DW dh + DW - 1,
    // summed in f32 and rounded once.
    // At most 64 columns a pass, so that dq, dk and dv fit the registers
    // together at D = 128.
#pragma unroll
    for (int c0 = dh * DW; c0 < (dh + 1) * DW; c0 += DQW) {
      float dq[DQW / 8][4];
#pragma unroll
      for (int n = 0; n < DQW / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
      for (int kh = 0; kh < BK / kKeys; ++kh) {
        unsigned dsa[kKeys / 16][4];
        load_a_rows_t<LDS>(dsa, ds_s + kh * kKeys * LDS, qg * 16);
#pragma unroll
        for (int j = 0; j < kKeys / 16; ++j)
          av_slice<DQW, LD>(dq, dsa[j], k_s + kh * kKeys * LD + c0, j);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat16* row = dqp + static_cast<long long>(q0 + qg * 16 + lane / 4 + 8 * r) * D +
                             c0 + 2 * (lane % 4);
#pragma unroll
        for (int n = 0; n < DQW / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
              __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off = bh * plane + static_cast<long long>(key_a + 8 * r) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// Raise the dynamic shared-memory cap past the default 48 KB (once per
// instantiation is enough, but the call is cheap) and, for the
// tensor-core kernels, ask for the whole carveout as shared memory, so
// their CTAs fit an SM side by side. Returns the cudaError_t.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool carveout) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

struct FwdArgs {
  const void* qkv;
  void *out, *lse;
  int batch, heads, t;
  float scale2;
  int causal;
  void* stream;
};

struct BwdArgs {
  const void *qkv, *dout, *lse, *delta;
  void *dq_partials, *dk, *dv;
  int batch, heads, t;
  float scale, scale2;
  int causal;
  void* stream;
};

// One CTA per (tile of `block` rows: q tiles forward, k tiles backward, head,
// batch row).
inline dim3 tile_grid(int t, int block, int heads, int batch) {
  return dim3(t / block, heads, batch);
}

// The kernel, threads and dynamic shared memory of one instantiation
// (which 0: forward, 1: backward): bf16 on the tensor cores, f32 on the
// CUDA cores.
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int D, int BQ, int BK>
struct Fwd {
  static constexpr bool tc = kTensorCores<T>;
  static constexpr int threads = tc ? 2 * BQ : kThreads;
  static constexpr size_t smem = tc ? fwd_tc_smem<D, BQ, BK>() : fwd_smem<BQ, BK, D>();
  static auto kernel() {
    if constexpr (tc) return qkv_fwd_tc_kernel<D, BQ, BK>;
    else return qkv_fwd_kernel<T, D, BQ, BK>;
  }
  static dim3 grid(int batch, int heads, int t) { return tile_grid(t, BQ, heads, batch); }
};

template <typename T, int D, int BQ, int BK>
struct Bwd {
  static constexpr bool tc = kTensorCores<T>;
  static constexpr int threads = tc ? 2 * BK : kThreads;
  static constexpr size_t smem = tc ? bwd_tc_smem<D, BK>() : bwd_smem<BQ, BK, D>();
  static auto kernel() {
    if constexpr (tc) return qkv_bwd_tc_kernel<D, BQ, BK>;
    else return qkv_bwd_kernel<T, D, BQ, BK>;
  }
  static dim3 grid(int batch, int heads, int t) { return tile_grid(t, BK, heads, batch); }
};

// Launch on the caller's stream and return the launch status: a refused
// launch never runs.
template <typename K, typename... Args>
int launch(dim3 grid, void* stream, Args... args) {
  auto kernel = K::kernel();
  const cudaError_t err = prepare(kernel, K::smem, K::tc);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, K::threads, K::smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int BQ, int BK>
int run_fwd(const FwdArgs& a) {
  using K = Fwd<T, D, BQ, BK>;
  return launch<K>(K::grid(a.batch, a.heads, a.t), a.stream, static_cast<const T*>(a.qkv),
                   static_cast<T*>(a.out), static_cast<float*>(a.lse), a.batch, a.heads, a.t,
                   a.scale2, a.causal);
}

template <typename T, int D, int BQ, int BK>
int run_bwd(const BwdArgs& a) {
  using K = Bwd<T, D, BQ, BK>;
  return launch<K>(K::grid(a.batch, a.heads, a.t), a.stream, static_cast<const T*>(a.qkv),
                   static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
                   static_cast<const float*>(a.delta), static_cast<T*>(a.dq_partials),
                   static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.batch, a.heads, a.t,
                   a.scale, a.scale2, a.causal);
}

// Resident CTAs per SM (what 0) or registers per thread (what 1) of one
// kernel at its threads, shared memory and carveout; -1 when the card
// refuses it.
template <typename K>
int attribute(int what) {
  auto kernel = K::kernel();
  if (prepare(kernel, K::smem, K::tc) != cudaSuccess) return -1;
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
  }
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, K::threads, K::smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

struct AttrArgs {
  int which, what;  // which 0: forward, 1: backward; what 0: CTAs per SM, 1: registers
};

template <typename T, int D, int BQ, int BK>
int run_attribute(const AttrArgs& a) {
  return a.which == 0 ? attribute<Fwd<T, D, BQ, BK>>(a.what)
                      : attribute<Bwd<T, D, BQ, BK>>(a.what);
}

struct QueryArgs {
  int which, batch, heads, t;  // which 0: forward, 1: backward
  long long* info;
};

template <typename K>
int query(const QueryArgs& a) {
  return rkt_info::write(K::kernel(), K::grid(a.batch, a.heads, a.t), K::threads, K::smem,
                         a.info);
}

template <typename T, int D, int BQ, int BK>
int run_query(const QueryArgs& a) {
  return a.which == 0 ? query<Fwd<T, D, BQ, BK>>(a) : query<Bwd<T, D, BQ, BK>>(a);
}

// Instantiate RUN<T, D, BQ, BK> for the compiled dtypes (0 = float32,
// 1 = bfloat16), head dims (32, 64: tiles (64, 128)^2; 128: 64 x 64 only)
// and tiles; anything else is refused as cudaErrorInvalidValue. At
// D = 128 a 128-row tile does not fit: the f32 forward's 128 x 128 tiles
// take 264,192 B of shared memory, and the bf16 backward's 128 keys would
// hold 128 f32 accumulator registers a thread in each of 8 warps.
#define RKT_QKV_TILES(RUN, T, D, bq, bk, arg)                                    \
  do {                                                                           \
    if ((bq) == 64 && (bk) == 64) return RUN<T, D, 64, 64>(arg);                 \
    if ((bq) == 64 && (bk) == 128) return RUN<T, D, 64, 128>(arg);               \
    if ((bq) == 128 && (bk) == 64) return RUN<T, D, 128, 64>(arg);               \
    if ((bq) == 128 && (bk) == 128) return RUN<T, D, 128, 128>(arg);             \
    return static_cast<int>(cudaErrorInvalidValue);                              \
  } while (0)

#define RKT_QKV_DISPATCH(RUN, dtype, d, bq, bk, arg)                             \
  do {                                                                           \
    if ((d) == 64) {                                                             \
      if ((dtype) == 1) RKT_QKV_TILES(RUN, __nv_bfloat16, 64, bq, bk, arg);      \
      RKT_QKV_TILES(RUN, float, 64, bq, bk, arg);                                \
    }                                                                            \
    if ((d) == 32) {                                                             \
      if ((dtype) == 1) RKT_QKV_TILES(RUN, __nv_bfloat16, 32, bq, bk, arg);      \
      RKT_QKV_TILES(RUN, float, 32, bq, bk, arg);                                \
    }                                                                            \
    if ((d) == 128 && (bq) == 64 && (bk) == 64) {                                \
      if ((dtype) == 1) return RUN<__nv_bfloat16, 128, 64, 64>(arg);             \
      return RUN<float, 128, 64, 64>(arg);                                       \
    }                                                                            \
    return static_cast<int>(cudaErrorInvalidValue);                              \
  } while (0)

bool legal(int t, int block_q, int block_k, int causal) {
  return t > 0 && t % block_q == 0 && t % block_k == 0 && (!causal || block_q == block_k);
}

}  // namespace

// out (B, H, T, D) in the operand dtype, lse (B, H, 1, T) f32. Returns the
// cudaError_t of the launch.
extern "C" int rkt_flash_qkv_fwd(const void* qkv, void* out, void* lse, int batch, int heads,
                                 int t, int d, int block_q, int block_k, float scale2, int causal,
                                 int dtype, void* stream) {
  if (!legal(t, block_q, block_k, causal)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{qkv, out, lse, batch, heads, t, scale2, causal, stream};
  RKT_QKV_DISPATCH(run_fwd, dtype, d, block_q, block_k, a);
}

// dq_partials (T / block_k, B, H, T, D), dk and dv (B, H, T, D), all in
// the operand dtype; dout (B, H, T, D); lse and delta (B, H, 1, T) f32.
// Returns the cudaError_t of the launch.
extern "C" int rkt_flash_qkv_bwd(const void* qkv, const void* dout, const void* lse,
                                 const void* delta, void* dq_partials, void* dk, void* dv,
                                 int batch, int heads, int t, int d, int block_q, int block_k,
                                 float scale, float scale2, int causal, int dtype, void* stream) {
  if (!legal(t, block_q, block_k, causal)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{qkv, dout, lse, delta, dq_partials, dk, dv, batch, heads, t, scale, scale2,
                  causal, stream};
  RKT_QKV_DISPATCH(run_bwd, dtype, d, block_q, block_k, a);
}

// Resident CTAs per SM of one instantiation (which 0: forward, 1:
// backward) at its dynamic shared memory, or -1 when the card refuses it.
extern "C" int rkt_flash_qkv_occupancy(int which, int d, int block_q, int block_k, int dtype) {
  const AttrArgs a{which, 0};
  RKT_QKV_DISPATCH(run_attribute, dtype, d, block_q, block_k, a);
}

// Registers per thread of one instantiation, or -1.
extern "C" int rkt_flash_qkv_registers(int which, int d, int block_q, int block_k, int dtype) {
  const AttrArgs a{which, 1};
  RKT_QKV_DISPATCH(run_attribute, dtype, d, block_q, block_k, a);
}

// The launch geometry of rkt_flash_qkv_fwd (which 0) or rkt_flash_qkv_bwd
// (which 1) at these shapes (launch_info.cuh).
extern "C" int rkt_flash_qkv_launch_info(int which, int batch, int heads, int t, int d,
                                         int block_q, int block_k, int dtype, long long* info) {
  if (!legal(t, block_q, block_k, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const QueryArgs a{which, batch, heads, t, info};
  RKT_QKV_DISPATCH(run_query, dtype, d, block_q, block_k, a);
}
