// The persistent warp-specialised grouped product on wgmma + TMA that the
// bf16 grouped kernels instantiate: gather_gmm.cu (row 11, lhs rows
// gathered by index), grouped_gemm.cu's gmm (lhs rows contiguous, rhs read
// as stored or transposed) and grouped_gemm.cu's tgmm (the rhs cotangent):
//
//   gmm:   out[r] = A[r] @ B[g(r)]            over the work tiles of
//          grouped_gemm.cuh (find_work: at most kBM rows of one group, so a
//          tile never straddles a group; rows past the groups written as
//          zeros; an empty group has no tile), K the reduction;
//   tgmm:  out[g] = lhs_g^T @ dy_g            over (K tile, N tile, group)
//          slots, the group's rows the reduction (an empty group: zeros);
//
// bf16 in, f32 accumulation, bf16 out.
//
//   * Output tiles of 128 rows x BN columns, a template parameter: 256
//     (row 11), or 256 or 192 for gmm and tgmm, whichever fills the card's
//     waves best (grouped_gemm.cu's gmm_block_n); the reduction walked in
//     64-deep slices (128 bytes of bf16, the swizzle width).
//   * Three warpgroups: two consumers, each a 64 x BN half of the tile on
//     wgmma m64nBNk16 with BN / 2 f32 accumulators a thread (setmaxnreg
//     gives them 224 registers and the producer 56), and one producer
//     feeding a ring of kStages slices in shared memory, full and empty
//     mbarriers per slot. A consumer keeps one slice of products in flight
//     behind the next one's issue, and one whose 64 rows all lie past its
//     tile's end (a 16-row decode tile, K's last 64 rows) waits and
//     releases each slot without multiplying.
//   * Persistent grid: min(SMs, slots) CTAs, one per SM, each walking the
//     slot list with a stride of the grid; the ring runs on across tiles,
//     so the producer fills the next tile's slices while the consumers
//     store the last one's.
//   * The A loader is a template parameter. GatherA (row 11): TMA cannot
//     gather rows, so the producer's 128 threads copy 16-byte pieces of the
//     rows their row ids name by cp.async straight into the swizzled
//     K-major layout (8 threads a row; a row past the tile, an id outside
//     [0, src_rows) or a piece past K zero-filled), each thread's arrival
//     on the slot's full barrier a cp.async.mbarrier.arrive, and a consumer
//     fences the async proxy after its wait. TmaA (gmm): the rows are
//     contiguous, so one thread loads each slice of A by TMA through a 2-D
//     map over (K, M), one 64 K x 128 row box from the tile's first row
//     (any row: TMA takes element coordinates); rows past M and a slice
//     past K arrive as zeros, and rows past the tile's end (the next
//     group's) are multiplied but never stored. TmaLhsT (tgmm): A is
//     lhs_g^T, M-major: per slice two boxes of 64 K x 64 rows, one per
//     consumer half, through a 2-D map over lhs (K, M) from the slice's
//     first row, read by wgmma with its A transpose bit.
//   * The B map is the other parameter. N-major (B_KMAJOR false): rhs
//     (E, K, N) through a 3-D map (N, K, E), BN / 64 boxes of 64 K x 64 N
//     a slice, read by wgmma with its transpose bit. K-major (true): rhs
//     (E, N, K) read transposed, through a 3-D map (K, N, E), one 64 K x
//     BN box a slice, read without it. Either way a slice past K reads
//     zeros, not the next group's rows. tgmm's B is dy (M, N), N-major,
//     through a 2-D map (N, M): BN / 64 boxes of 64 rows x 64 N a slice.
//   * tgmm's last slice of a group runs past the group's end into rows
//     that hold data (the next group's, or rows past the groups), which
//     the maps do not zero. The consumers zero those rows of the slice in
//     both operands (each its own A box and half the B boxes), fence the
//     async proxy and meet at a named barrier before multiplying; a group
//     of whole 64-row slices (the padded layout) never takes this path.
//   * The consumers store straight from registers, 16 bytes a lane after a
//     transpose within each quad, rounded once; no atomics and no split of
//     the reduction across CTAs: two launches give the same bits.
//
// sm_90a only; the f32 operands stay on grouped_gemm.cuh's CUDA-core tiles.
#pragma once

#include <string.h>

#include "grouped_gemm.cuh"
#include "wgmma_common.cuh"

namespace rkt_wg {

using bf16 = __nv_bfloat16;
using rkt_gg::kBM;
using rkt_gg::Work;

constexpr int kWgBN = 256;                         // output columns per tile (row 11's)
constexpr int kWgBK = 64;                          // K per slice: 128 bytes of bf16
constexpr int kStages = 4;                         // slices in the ring
constexpr int kConsumers = 2;                      // warpgroups multiplying, 64 rows each
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr int kATile = kBM * kWgBK * 2;            // 16 KB of A rows
constexpr int kBBox = kWgBK * 64 * 2;              // 8 KB: one N-major box, 64 K rows x 64 N
template <int BN>
constexpr int kStageBytes = kATile + BN * kWgBK * 2;  // A rows, then B (32 KB at BN = 256)
// The ring (1024-byte aligned by hand: 1 KB of slack), then the full and
// empty barriers.
template <int BN>
constexpr int kWgSmem = 1024 + kStages * kStageBytes<BN> + 2 * kStages * 8;
// Registers a thread after setmaxnreg: the producer's warpgroup, each
// consumer's (128 * 56 + 2 * 128 * 224 <= 65,536; at 40 the producer
// spilled).
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kBM == kConsumers * 64, "two 64-row halves of a work tile");

// The A loaders (kTgmm: the tgmm schedule, with dy as B).
struct GatherA {  // A[r] = x[row_ids[r]], a zero row for an id outside [0, src_rows)
  static constexpr bool kTma = false, kTgmm = false;
  const bf16* x;
  const int* row_ids;
  int src_rows;
};
struct TmaA {  // A = the (M, K) lhs, through a 2-D map (K, M) of kWgBK x kBM boxes
  static constexpr bool kTma = true, kTgmm = false;
  CUtensorMap map;
};
struct TmaLhsT {  // A = lhs_g^T, through a 2-D map (K, M) of 64 x kWgBK boxes
  static constexpr bool kTma = true, kTgmm = true;
  CUtensorMap map;
};

// One slot's output tile, rows [row0, row1) by columns [n0, n0 + BN) of
// group `group`'s output, and its reduction: `slices` 64-deep slices from
// red0 up to red1 (gmm: K; tgmm: the group's rows). No slices: a tile of
// zeros (gmm's rows past the groups, tgmm's empty group).
struct Slot {
  int group, row0, row1, n0, red0, red1, slices;
};

// Slot `slot` of the schedule; false when it is past gmm's work-tile list.
template <typename ALoad, int BN>
__device__ __forceinline__ bool find_slot(const int* __restrict__ group_sizes, int num_groups,
                                          int m, int k, int n, int slot, Slot* s) {
  const int n_tiles = (n + BN - 1) / BN;
  s->n0 = (slot % n_tiles) * BN;
  if constexpr (ALoad::kTgmm) {  // (K tile, N tile, group), N fastest, then K
    const int k_tiles = (k + kBM - 1) / kBM, tile = slot / n_tiles;
    s->group = tile / k_tiles;
    s->row0 = (tile % k_tiles) * kBM;
    s->row1 = min(s->row0 + kBM, k);
    rkt_gg::group_rows(group_sizes, num_groups, m, s->group, &s->red0, &s->red1);
    s->slices = (s->red1 - s->red0 + kWgBK - 1) / kWgBK;
    return true;
  } else {
    Work work;
    if (!rkt_gg::find_work(group_sizes, num_groups, m, slot / n_tiles, &work)) return false;
    s->group = work.group;
    s->row0 = work.row0;
    s->row1 = work.row1;
    s->red0 = 0;
    s->red1 = k;
    // Rows past the groups: no operands.
    s->slices = work.group == num_groups ? 0 : (k + kWgBK - 1) / kWgBK;
    return true;
  }
}

// slots from the host (wgmma_slots).
template <typename ALoad, bool B_KMAJOR, int BN = kWgBN>
__global__ void __launch_bounds__(kWgThreads, 1)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap rhs_map,
                     const __grid_constant__ ALoad a_load, const int* __restrict__ group_sizes,
                     bf16* __restrict__ out, int m, int k, int n, int num_groups, int slots) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kStage = kStageBytes<BN>, kBTile = BN * kWgBK * 2;
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The TMA's expect_tx, and each producer thread's cp.async arrival.
      mbar_init(&full[s], 1 + (ALoad::kTma ? 0 : 128));
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: B by TMA (thread 0); A by TMA (thread 0) or by cp.async
    // through the row ids (all 128 threads).
    regs_release<kProducerRegs>();
    if (ALoad::kTma && t != 0) return;
    const int piece = t % 8, row_base = t / 8;  // gather: rows row_base + 16 i, i < 8
    int it = 0;
    for (int slot = blockIdx.x; slot < slots; slot += gridDim.x) {
      Slot tile;
      if (!find_slot<ALoad, BN>(group_sizes, num_groups, m, k, n, slot, &tile)) break;
      if (tile.slices == 0) continue;  // a tile of zeros: no operands
      int src[8];  // gather: the source row of each of this thread's rows, -1 for a zero row
      if constexpr (!ALoad::kTma) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = tile.row0 + row_base + 16 * i;
          const int id = row < tile.row1 ? __ldg(a_load.row_ids + row) : -1;
          src[i] = id >= 0 && id < a_load.src_rows ? id : -1;
        }
      }
      for (int s = 0; s < tile.slices; ++s, ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        unsigned char* a_s = ring + stage * kStage;
        unsigned char* b_s = a_s + kATile;
        const int k0 = tile.red0 + s * kWgBK;
        if (t == 0) {
          mbar_arrive_expect_tx(&full[stage], kBTile + (ALoad::kTma ? kATile : 0));
          if constexpr (ALoad::kTgmm) {  // dy rows k0.., lhs rows k0.. of each K half
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(b_s + j * kBBox, &rhs_map, &full[stage], tile.n0 + 64 * j, k0);
#pragma unroll
            for (int h = 0; h < kConsumers; ++h)
              tma_load_2d(a_s + h * kBBox, &a_load.map, &full[stage], tile.row0 + 64 * h, k0);
          } else {
            if constexpr (B_KMAJOR) {
              tma_load_3d(b_s, &rhs_map, &full[stage], k0, tile.n0, tile.group);
            } else {
#pragma unroll
              for (int j = 0; j < BN / 64; ++j)
                tma_load_3d(b_s + j * kBBox, &rhs_map, &full[stage], tile.n0 + 64 * j, k0,
                            tile.group);
            }
            if constexpr (ALoad::kTma)
              tma_load_2d(a_s, &a_load.map, &full[stage], k0, tile.row0);
          }
        }
        if constexpr (!ALoad::kTma) {
          const int col = k0 + piece * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool valid = src[i] >= 0 && col < k;
            rkt_mma::cp_async16(a_s + swizzle_offset(row_base + 16 * i, piece),
                                valid ? a_load.x + static_cast<long long>(src[i]) * k + col
                                      : a_load.x,
                                valid);
          }
          mbar_arrive_cp_async(&full[stage]);  // when this thread's copies have landed
        }
      }
    }
    if constexpr (!ALoad::kTma) rkt_mma::cp_async_wait<0>();
  } else {
    // Consumer wg: rows 64 wg .. 64 wg + 63 of each tile. One slice of
    // products stays in flight: slice s - 1's slot is released once slice
    // s is issued and s - 1 has completed.
    regs_claim<kConsumerRegs>();
    const int warp = t / 32, lane = t % 32;
    const int frag_row = 16 * warp + lane / 4, q = lane % 4;
    int it = 0;
    for (int slot = blockIdx.x; slot < slots; slot += gridDim.x) {
      Slot tile;
      if (!find_slot<ALoad, BN>(group_sizes, num_groups, m, k, n, slot, &tile)) break;
      const int row0 = tile.row0 + 64 * wg;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if (tile.slices > 0) {
        const bool live = row0 < tile.row1;
        for (int s = 0; s < tile.slices; ++s, ++it) {
          const int stage = it % kStages;
          mbar_wait(&full[stage], (it / kStages) & 1);
          if constexpr (!ALoad::kTma) fence_proxy_async();  // the cp.async rows, seen by wgmma
          if constexpr (ALoad::kTgmm) {
            // Rows of the slice past the group's end: zeros in A (this
            // half's box) and B (every other box from this half), seen by
            // both halves' wgmma.
            const int tail = (tile.red0 + (s + 1) * kWgBK - tile.red1) * 128;
            if (tail > 0) {
              unsigned char* slab = ring + stage * kStage;
              const uint4 zero = make_uint4(0, 0, 0, 0);
              for (int off = kBBox - tail + 16 * t; off < kBBox; off += 16 * 128) {
                *reinterpret_cast<uint4*>(slab + wg * kBBox + off) = zero;
                for (int j = wg; j < BN / 64; j += kConsumers)
                  *reinterpret_cast<uint4*>(slab + kATile + j * kBBox + off) = zero;
              }
              fence_proxy_async();
              named_barrier_sync(1, kConsumers * 128);
            }
          }
          if (live) {
            const unsigned char* a_s = ring + stage * kStage + wg * 64 * 128;
            const unsigned char* b_s = ring + stage * kStage + kATile;
            fence_operands(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kWgBK / 16; ++kk) {
              if constexpr (ALoad::kTgmm)
                wgmma_bf16<BN, 1, 1>(acc, smem_desc(a_s + 2048 * kk, kBBox, 1024),
                                     smem_desc(b_s + 2048 * kk, kBBox, 1024));
              else if constexpr (B_KMAJOR)
                wgmma_bf16<BN, 0, 0>(acc, smem_desc(a_s + 32 * kk, 16, 1024),
                                     smem_desc(b_s + 32 * kk, 16, 1024));
              else
                wgmma_bf16<BN, 0, 1>(acc, smem_desc(a_s + 32 * kk, 16, 1024),
                                     smem_desc(b_s + 2048 * kk, kBBox, 1024));
            }
            wgmma_commit();
            wgmma_wait<1>();
            fence_operands(acc);
          }
          if (s > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
        wgmma_wait<0>();
        fence_operands(acc);
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      // Store the half tile (zeros for a tile without slices), rounded
      // once, 16 bytes a lane: a quad holds 32 columns of a row as four
      // 8-column pieces, two columns of each per lane; transposed within
      // the quad, lane q holds piece q whole.
      bf16* const base =
          ALoad::kTgmm ? out + static_cast<long long>(tile.group) * k * n : out;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + frag_row + 8 * half;
#pragma unroll
        for (int jj = 0; jj < BN / 32; ++jj) {
          unsigned v[4], mine[4] = {0, 0, 0, 0};
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(acc[4 * (4 * jj + b) + 2 * half],
                                                           acc[4 * (4 * jj + b) + 2 * half + 1]);
            v[b] = *reinterpret_cast<const unsigned*>(&h);
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int si = (q + rr) & 3, di = (q - rr) & 3;
            const unsigned got =
                __shfl_sync(0xffffffffu, si == 0 ? v[0] : si == 1 ? v[1] : si == 2 ? v[2] : v[3],
                            (lane & ~3) | di);
            mine[0] = di == 0 ? got : mine[0];
            mine[1] = di == 1 ? got : mine[1];
            mine[2] = di == 2 ? got : mine[2];
            mine[3] = di == 3 ? got : mine[3];
          }
          const int c = tile.n0 + 8 * (4 * jj + q);
          if (r < tile.row1 && c < n)
            *reinterpret_cast<uint4*>(base + static_cast<long long>(r) * n + c) =
                make_uint4(mine[0], mine[1], mine[2], mine[3]);
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

// The schedule's slots (gmm: work tiles x N tiles; tgmm: K tiles x groups
// x N tiles), and the grid: one CTA per SM, at most one per slot.
template <typename ALoad>
inline int wgmma_slots(int m, int k, int n, int num_groups, int bn) {
  const int n_tiles = (n + bn - 1) / bn;
  if constexpr (ALoad::kTgmm) return (k + kBM - 1) / kBM * num_groups * n_tiles;
  else return rkt_gg::work_tiles(m, num_groups) * n_tiles;
}
template <typename ALoad>
inline dim3 wgmma_grid(int m, int k, int n, int num_groups, int bn, int sms) {
  const int slots = wgmma_slots<ALoad>(m, k, n, num_groups, bn);
  return dim3(sms < slots ? sms : slots);
}

// The SMs of the current device.
inline int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// Raise the instantiation's dynamic shared-memory cap, once per device, and
// check that the build gave the CTA the registers its warpgroups trade: a
// consumer's setmaxnreg.inc would otherwise wait for registers that never
// come.
template <typename ALoad, bool B_KMAJOR, int BN>
int prepare_wgmma() {
  static unsigned long long ready = 0;  // a bit per device ordinal
  auto kernel = grouped_wgmma_kernel<ALoad, B_KMAJOR, BN>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready & bit) return 0;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kWgThreads < 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem<BN>);
  if (err == cudaSuccess) ready |= bit;
  return static_cast<int>(err);
}

// A 2-D bf16 map over a row-major (rows, cols) matrix in boxes of
// box_cols x box_rows (tgmm's lhs and dy; gmm's lhs). False when the encode
// fails.
inline bool encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                        int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows)};
  return encode_bf16<2>(map, base, dims, strides, box);
}

// The map of the group's B block: rhs (E, K, N) read N-major, or (E, N, K)
// read K-major (B_KMAJOR). False when the encode fails.
template <bool B_KMAJOR, int BN>
bool encode_rhs(CUtensorMap* map, const void* rhs, int k, int n, int num_groups) {
  const uint64_t inner = B_KMAJOR ? k : n, outer = B_KMAJOR ? n : k;
  const uint64_t dims[3] = {inner, outer, static_cast<uint64_t>(num_groups)};
  const uint64_t strides[2] = {inner * 2, static_cast<uint64_t>(k) * n * 2};
  const uint32_t box[3] = {64, B_KMAJOR ? static_cast<uint32_t>(BN) : kWgBK, 1};
  return encode_bf16<3>(map, rhs, dims, strides, box);
}

// Launch on the caller's stream over a card of `sms` SMs (device_sms);
// `rhs` is gmm's rhs, or tgmm's dy (M, N). Returns the cudaError_t.
template <typename ALoad, bool B_KMAJOR, int BN = kWgBN>
int launch_wgmma(const ALoad& a_load, const void* rhs, const void* group_sizes, void* out, int m,
                 int k, int n, int num_groups, int sms, void* stream) {
  const int err = prepare_wgmma<ALoad, B_KMAJOR, BN>();
  if (err != 0) return err;
  CUtensorMap map;
  if constexpr (ALoad::kTgmm) {
    // No rows (every group empty): no slice is loaded, and a map of no
    // rows does not encode.
    if (m == 0)
      memset(&map, 0, sizeof(map));
    else if (!encode_rows(&map, rhs, m, n, 64, kWgBK))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (!encode_rhs<B_KMAJOR, BN>(&map, rhs, k, n, num_groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grouped_wgmma_kernel<ALoad, B_KMAJOR, BN>
      <<<wgmma_grid<ALoad>(m, k, n, num_groups, BN, sms), kWgThreads, kWgSmem<BN>,
         static_cast<cudaStream_t>(stream)>>>(map, a_load, static_cast<const int*>(group_sizes),
                                              static_cast<bf16*>(out), m, k, n, num_groups,
                                              wgmma_slots<ALoad>(m, k, n, num_groups, BN));
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at these shapes on a card of `sms` SMs
// (launch_info.cuh).
template <typename ALoad, bool B_KMAJOR, int BN = kWgBN>
int wgmma_launch_info(int m, int k, int n, int num_groups, int sms, long long* info) {
  return rkt_info::write(grouped_wgmma_kernel<ALoad, B_KMAJOR, BN>,
                         wgmma_grid<ALoad>(m, k, n, num_groups, BN, sms), kWgThreads,
                         kWgSmem<BN>, info);
}

// Registers per thread at launch (what 1) or resident CTAs per SM (what
// 0); -1 when the card refuses the instantiation.
template <typename ALoad, bool B_KMAJOR, int BN = kWgBN>
int wgmma_attribute(int what) {
  auto kernel = grouped_wgmma_kernel<ALoad, B_KMAJOR, BN>;
  if (prepare_wgmma<ALoad, B_KMAJOR, BN>() != 0) return -1;
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
  }
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWgThreads, kWgSmem<BN>) !=
      cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace rkt_wg
