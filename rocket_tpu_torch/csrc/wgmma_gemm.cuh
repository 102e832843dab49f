// The persistent warp-specialised grouped product on wgmma + TMA that the
// bf16 grouped kernels instantiate: gather_gmm.cu (row 11, lhs rows
// gathered by index) and grouped_gemm.cu's gmm (lhs rows contiguous, rhs
// read as stored or transposed):
//
//   out[r] = A[r] @ B[g(r)],  bf16 in, f32 accumulation, bf16 out,
//
// over the work tiles of grouped_gemm.cuh (find_work: at most kBM rows of
// one group, so a tile never straddles a group; rows past the groups
// written as zeros; an empty group has no tile).
//
//   * Output tiles of 128 rows x BN columns, a template parameter: 256
//     (row 11), or 256 or 192 for gmm, whichever fills the card's waves
//     best (grouped_gemm.cu's gmm_block_n); K walked in 64-deep slices (128
//     bytes of bf16, the swizzle width).
//   * Three warpgroups: two consumers, each a 64 x BN half of the tile on
//     wgmma m64nBNk16 with BN / 2 f32 accumulators a thread (setmaxnreg
//     gives them 224 registers and the producer 56), and one producer
//     feeding a ring of kStages slices in shared memory, full and empty
//     mbarriers per slot. A consumer keeps one slice of products in flight
//     behind the next one's issue, and one whose 64 rows all lie past its
//     tile's end (a 16-row decode tile) waits and releases each slot
//     without multiplying.
//   * Persistent grid: min(SMs, work tiles x N tiles) CTAs, one per SM,
//     each walking the (work tile, N tile) list with a stride of the grid;
//     the ring runs on across tiles, so the producer fills the next tile's
//     slices while the consumers store the last one's.
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
//     group's) are multiplied but never stored.
//   * The B map is the other parameter. N-major (B_KMAJOR false): rhs
//     (E, K, N) through a 3-D map (N, K, E), BN / 64 boxes of 64 K x 64 N
//     a slice, read by wgmma with its transpose bit. K-major (true): rhs
//     (E, N, K) read transposed, through a 3-D map (K, N, E), one 64 K x
//     BN box a slice, read without it. Either way a slice past K reads
//     zeros, not the next group's rows.
//   * The consumers store straight from registers, 16 bytes a lane after a
//     transpose within each quad, rounded once; no atomics and no split-K
//     across CTAs: two launches give the same bits.
//
// sm_90a only; the f32 operands stay on grouped_gemm.cuh's CUDA-core tiles.
#pragma once

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

// The A loaders.
struct GatherA {  // A[r] = x[row_ids[r]], a zero row for an id outside [0, src_rows)
  static constexpr bool kTma = false;
  const bf16* x;
  const int* row_ids;
  int src_rows;
};
struct TmaA {  // A = the (M, K) lhs, through a 2-D map (K, M) of kWgBK x kBM boxes
  static constexpr bool kTma = true;
  CUtensorMap map;
};

// slots = work tiles x N tiles, from the host.
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
  const int n_tiles = (n + BN - 1) / BN;
  const int slices = (k + kWgBK - 1) / kWgBK;

  if (wg == kConsumers) {
    // Producer: B by TMA (thread 0); A by TMA (thread 0) or by cp.async
    // through the row ids (all 128 threads).
    regs_release<kProducerRegs>();
    if (ALoad::kTma && t != 0) return;
    const int piece = t % 8, row_base = t / 8;  // gather: rows row_base + 16 i, i < 8
    int it = 0;
    for (int slot = blockIdx.x; slot < slots; slot += gridDim.x) {
      Work work;
      if (!rkt_gg::find_work(group_sizes, num_groups, m, slot / n_tiles, &work)) break;
      if (work.group == num_groups) continue;  // rows past the groups: no operands
      const int n0 = (slot % n_tiles) * BN;
      int src[8];  // gather: the source row of each of this thread's rows, -1 for a zero row
      if constexpr (!ALoad::kTma) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = work.row0 + row_base + 16 * i;
          const int id = row < work.row1 ? __ldg(a_load.row_ids + row) : -1;
          src[i] = id >= 0 && id < a_load.src_rows ? id : -1;
        }
      }
      for (int s = 0; s < slices; ++s, ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        unsigned char* a_s = ring + stage * kStage;
        unsigned char* b_s = a_s + kATile;
        const int k0 = s * kWgBK;
        if (t == 0) {
          mbar_arrive_expect_tx(&full[stage], kBTile + (ALoad::kTma ? kATile : 0));
          if constexpr (B_KMAJOR) {
            tma_load_3d(b_s, &rhs_map, &full[stage], k0, n0, work.group);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(b_s + j * kBBox, &rhs_map, &full[stage], n0 + 64 * j, k0, work.group);
          }
          if constexpr (ALoad::kTma) tma_load_2d(a_s, &a_load.map, &full[stage], k0, work.row0);
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
      Work work;
      if (!rkt_gg::find_work(group_sizes, num_groups, m, slot / n_tiles, &work)) break;
      const int n0 = (slot % n_tiles) * BN;
      const int row0 = work.row0 + 64 * wg;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if (work.group != num_groups) {
        const bool live = row0 < work.row1;
        for (int s = 0; s < slices; ++s, ++it) {
          const int stage = it % kStages;
          mbar_wait(&full[stage], (it / kStages) & 1);
          if constexpr (!ALoad::kTma) fence_proxy_async();  // the cp.async rows, seen by wgmma
          if (live) {
            const unsigned char* a_s = ring + stage * kStage + wg * 64 * 128;
            const unsigned char* b_s = ring + stage * kStage + kATile;
            fence_operands(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kWgBK / 16; ++kk) {
              if constexpr (B_KMAJOR)
                wgmma_bf16<BN, 0>(acc, smem_desc(a_s + 32 * kk, 16, 1024),
                                  smem_desc(b_s + 32 * kk, 16, 1024));
              else
                wgmma_bf16<BN, 1>(acc, smem_desc(a_s + 32 * kk, 16, 1024),
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
      // Store the half tile (zeros for rows past the groups), rounded once,
      // 16 bytes a lane: a quad holds 32 columns of a row as four 8-column
      // pieces, two columns of each per lane; transposed within the quad,
      // lane q holds piece q whole.
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
          const int c = n0 + 8 * (4 * jj + q);
          if (r < work.row1 && c < n)
            *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * n + c) =
                make_uint4(mine[0], mine[1], mine[2], mine[3]);
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

// Work tiles x N tiles, and the grid: one CTA per SM, at most one per slot.
inline int wgmma_slots(int m, int n, int num_groups, int bn) {
  return rkt_gg::work_tiles(m, num_groups) * ((n + bn - 1) / bn);
}
inline dim3 wgmma_grid(int m, int n, int num_groups, int bn, int sms) {
  const int slots = wgmma_slots(m, n, num_groups, bn);
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
// returns the cudaError_t.
template <typename ALoad, bool B_KMAJOR, int BN = kWgBN>
int launch_wgmma(const ALoad& a_load, const void* rhs, const void* group_sizes, void* out, int m,
                 int k, int n, int num_groups, int sms, void* stream) {
  const int err = prepare_wgmma<ALoad, B_KMAJOR, BN>();
  if (err != 0) return err;
  CUtensorMap map;
  if (!encode_rhs<B_KMAJOR, BN>(&map, rhs, k, n, num_groups))
    return static_cast<int>(cudaErrorInvalidValue);
  grouped_wgmma_kernel<ALoad, B_KMAJOR, BN>
      <<<wgmma_grid(m, n, num_groups, BN, sms), kWgThreads, kWgSmem<BN>,
         static_cast<cudaStream_t>(stream)>>>(map, a_load, static_cast<const int*>(group_sizes),
                                              static_cast<bf16*>(out), m, k, n, num_groups,
                                              wgmma_slots(m, n, num_groups, BN));
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at these shapes on a card of `sms` SMs
// (launch_info.cuh).
template <typename ALoad, bool B_KMAJOR, int BN = kWgBN>
int wgmma_launch_info(int m, int n, int num_groups, int sms, long long* info) {
  return rkt_info::write(grouped_wgmma_kernel<ALoad, B_KMAJOR, BN>,
                         wgmma_grid(m, n, num_groups, BN, sms), kWgThreads, kWgSmem<BN>, info);
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
