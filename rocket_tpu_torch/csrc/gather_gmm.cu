// Gather-GMM: out[r] = x[row_ids[r]] @ rhs[g(r)], the grouped matrix
// product whose lhs rows are read by index from the unsorted token rows,
// so the sorted (M, K) copy never exists.
//
// Replaces: rocket_tpu/ops/gather_gmm.py _gather_gmm_kernel (:117),
// launched by _run_gather_gmm (pallas_call at :179). The TPU kernel walks
// m-tiles in order, DMAs each tile's tile_m rows from HBM into VMEM scratch
// one row at a time by index (two copies in flight), picks the expert's
// rhs block from a scalar-prefetched expert-per-tile table and reuses the
// gathered block across the n-tiles.
//
// Bound on the H100: operations. At the MoE LM's in-projection under the
// padded layout, (18432 x 768) x (4, 768, 3072) bf16, 2*M*K*N = 87 GFLOP
// is 0.088 ms at 989 TFLOP/s against ~150 MB, 0.045 ms at 3.35 TB/s. Only
// wgmma reaches the tensor cores' full rate, so the bf16 kernel
// (gather_gmm_wgmma_kernel, primitives in wgmma_common.cuh) is built on it:
//
//   * Work tiles as grouped_gemm.cuh cuts them (find_work): at most 128
//     rows of one group, so a tile never straddles a group, whatever the
//     layout's tile_m (16 at decode); rows past the groups are written as
//     zeros; an empty group has no tile. Each output tile is 128 rows x
//     256 columns (256, not 128: each CTA re-gathers its A rows and
//     re-reads its B block through L2, ~1.4 GB at the in-projection with
//     128 x 128 tiles against ~1.0 GB with 128 x 256); K is walked in
//     64-deep slices (128 bytes of bf16, the swizzle width).
//   * Warp-specialised CTA of three warpgroups: two consumers, each a
//     64 x 256 half of the tile on wgmma m64n256k16 with 128 f32
//     accumulators a thread (setmaxnreg gives them 224 registers and the
//     producer 56), and one producer feeding a ring of kStages slices in
//     shared memory, full and empty mbarriers per slot. A consumer keeps
//     one slice of products in flight behind the next one's issue.
//   * B, rhs[g] (K, N) with N contiguous: TMA loads four 64 x 64 boxes per
//     slice through a 3-D tensor map (N, K, E), so a slice past K reads
//     zeros rather than the next group's rows, into 128-byte swizzled
//     shared memory, read by wgmma as N-major (its transpose bit).
//   * A, the gathered rows: TMA cannot gather by index, and one 1-row TMA
//     box per row would take 128 issues a slice from one thread. So the
//     producer's 128 threads each read the row ids of their rows once per
//     tile and copy 16-byte pieces with cp.async straight into the
//     swizzled K-major layout wgmma expects (8 threads a row, a warp
//     instruction covering four whole 128-byte rows); a row past the tile,
//     an id outside [0, src_rows) or a piece past K is zero-filled. Each
//     producer thread's arrival on the slot's full barrier is a
//     cp.async.mbarrier.arrive, made by the hardware once its copies have
//     landed, so the producer never waits on its own copies; a consumer
//     runs fence.proxy.async after the barrier wait, making those
//     generic-proxy writes visible to wgmma's async proxy. (Waiting on the
//     copies in the producer and fencing there, two slices behind, timed
//     slower on the card.)
//   * Persistent grid: min(SMs, work tiles x N tiles) CTAs, one per SM,
//     each walking the (work tile, N tile) list with a stride of the grid;
//     the ring runs on across tiles, so the producer fills the next tile's
//     slices while the consumers store the last one's.
//   * A consumer whose 64 rows are all past its tile's end (a decode tile
//     of 16 rows) waits and releases each slot without multiplying.
//   * Accumulation is f32 in the tensor cores, rounded to bf16 once at the
//     store; no atomics and no split-K across CTAs: two launches give the
//     same bits. The consumers store straight from registers, 16 bytes a
//     lane. Two other designs were correct but timed slower on the card:
//     clusters of two CTAs sharing each rhs slice by TMA multicast, and
//     the output staged in shared memory for TMA stores (the consumers
//     then take turns with the one buffer that fits beside the ring).
//
// The f32 operands stay on the CUDA-core tiles of grouped_gemm.cuh
// (gmm_kernel<false, true>): no main path runs them.
#include "grouped_gemm.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace rkt_gg;
using namespace rkt_wg;

constexpr int kWgBN = 256;                         // output columns per tile
constexpr int kWgBK = 64;                          // K per slice: 128 bytes of bf16
constexpr int kStages = 4;                         // slices in the ring
constexpr int kConsumers = 2;                      // warpgroups multiplying, 64 rows each
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr int kBoxes = kWgBN / 64;                 // TMA boxes of rhs per slice
constexpr int kATile = kBM * kWgBK * 2;            // 16 KB of gathered rows
constexpr int kBBox = kWgBK * 64 * 2;              // 8 KB: one TMA box, 64 K rows x 64 N
constexpr int kBTile = kBoxes * kBBox;
constexpr int kStageBytes = kATile + kBTile;
// The ring (1024-byte aligned by hand: 1 KB of slack), then the full and
// empty barriers.
constexpr int kWgSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
// Registers a thread after setmaxnreg: the producer's warpgroup, each
// consumer's (128 * 56 + 2 * 128 * 224 <= 65,536; at 40 the producer
// spilled).
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kBM == kConsumers * 64, "two 64-row halves of a work tile");

// Grid of the bf16 launch: one CTA per SM, at most one per (work tile, N
// tile).
inline int wgmma_slots(int m, int n, int num_groups) {
  return work_tiles(m, num_groups) * ((n + kWgBN - 1) / kWgBN);
}
inline dim3 wgmma_grid(int m, int n, int num_groups, int sms) {
  const int slots = wgmma_slots(m, n, num_groups);
  return dim3(sms < slots ? sms : slots);
}

// slots = wgmma_slots(m, n, num_groups), from the host.
__global__ void __launch_bounds__(kWgThreads, 1)
gather_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap rhs_map, const bf16* __restrict__ x,
                        const int* __restrict__ row_ids, int src_rows,
                        const int* __restrict__ group_sizes, bf16* __restrict__ out, int m,
                        int k, int n, int num_groups, int slots) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128 + 1);          // each producer thread, and the TMA's expect_tx
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = (n + kWgBN - 1) / kWgBN;
  const int slices = (k + kWgBK - 1) / kWgBK;

  if (wg == kConsumers) {
    // Producer: B by TMA (thread 0), A by cp.async through the row ids.
    regs_release<kProducerRegs>();
    const int piece = t % 8, row_base = t / 8;  // rows row_base + 16 i, i < 8
    int it = 0;
    for (int slot = blockIdx.x; slot < slots; slot += gridDim.x) {
      Work work;
      if (!find_work(group_sizes, num_groups, m, slot / n_tiles, &work)) break;
      if (work.group == num_groups) continue;  // rows past the groups: no operands
      const int n0 = (slot % n_tiles) * kWgBN;
      int src[8];  // the source row of each of this thread's rows, -1 for a zero row
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = work.row0 + row_base + 16 * i;
        const int id = row < work.row1 ? __ldg(row_ids + row) : -1;
        src[i] = id >= 0 && id < src_rows ? id : -1;
      }
      for (int s = 0; s < slices; ++s, ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        unsigned char* a_s = ring + stage * kStageBytes;
        unsigned char* b_s = a_s + kATile;
        const int k0 = s * kWgBK;
        if (t == 0) {
          mbar_arrive_expect_tx(&full[stage], kBTile);
#pragma unroll
          for (int j = 0; j < kBoxes; ++j)
            tma_load_3d(b_s + j * kBBox, &rhs_map, &full[stage], n0 + 64 * j, k0, work.group);
        }
        const int col = k0 + piece * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool valid = src[i] >= 0 && col < k;
          rkt_mma::cp_async16(a_s + swizzle_offset(row_base + 16 * i, piece),
                              valid ? x + static_cast<long long>(src[i]) * k + col : x, valid);
        }
        mbar_arrive_cp_async(&full[stage]);  // when this thread's copies have landed
      }
    }
    rkt_mma::cp_async_wait<0>();
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
      if (!find_work(group_sizes, num_groups, m, slot / n_tiles, &work)) break;
      const int n0 = (slot % n_tiles) * kWgBN;
      const int row0 = work.row0 + 64 * wg;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      if (work.group != num_groups) {
        const bool live = row0 < work.row1;
        for (int s = 0; s < slices; ++s, ++it) {
          const int stage = it % kStages;
          mbar_wait(&full[stage], (it / kStages) & 1);
          fence_proxy_async();  // the producer's cp.async rows, seen by wgmma
          if (live) {
            const unsigned char* a_s = ring + stage * kStageBytes + wg * 64 * 128;
            const unsigned char* b_s = ring + stage * kStageBytes + kATile;
            fence_operands(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kWgBK / 16; ++kk)
              wgmma_m64n256k16_bf16(acc, smem_desc(a_s + 32 * kk, 16, 1024),
                                    smem_desc(b_s + 2048 * kk, kBBox, 1024));
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
        for (int jj = 0; jj < kWgBN / 32; ++jj) {
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

// The SMs of the current device.
int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// Raise the bf16 kernel's dynamic shared-memory cap, once per device, and
// check that the build gave the CTA the registers its warpgroups trade: a
// consumer's setmaxnreg.inc would otherwise wait for registers that never
// come.
int prepare_wgmma() {
  static unsigned long long ready = 0;  // a bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready & bit) return 0;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gather_gmm_wgmma_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kWgThreads < 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(gather_gmm_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err == cudaSuccess) ready |= bit;
  return static_cast<int>(err);
}

int run_bf16(const void* x, int src_rows, const void* row_ids, const void* rhs,
             const void* group_sizes, void* out, int m, int k, int n, int num_groups,
             void* stream) {
  int sms = 0;
  int err = device_sms(&sms);
  if (err == 0) err = prepare_wgmma();
  if (err != 0) return err;
  CUtensorMap map;
  const uint64_t dims[3] = {static_cast<uint64_t>(n), static_cast<uint64_t>(k),
                            static_cast<uint64_t>(num_groups)};
  const uint64_t strides[2] = {static_cast<uint64_t>(n) * 2, static_cast<uint64_t>(k) * n * 2};
  const uint32_t box[3] = {64, kWgBK, 1};
  if (!encode_bf16_3d(&map, rhs, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  gather_gmm_wgmma_kernel<<<wgmma_grid(m, n, num_groups, sms), kWgThreads, kWgSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const bf16*>(x), static_cast<const int*>(row_ids), src_rows,
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), m, k, n, num_groups,
      wgmma_slots(m, n, num_groups));
  return static_cast<int>(cudaGetLastError());
}

int run_f32(const void* x, int src_rows, const void* row_ids, const void* rhs,
            const void* group_sizes, void* out, int m, int k, int n, int num_groups,
            void* stream) {
  return launch(gmm_kernel<false, true>, gmm_grid(m, n, num_groups), stream,
                static_cast<const float*>(x), static_cast<const int*>(row_ids), src_rows,
                static_cast<const float*>(rhs), static_cast<const int*>(group_sizes),
                static_cast<float*>(out), m, k, n, num_groups);
}

}  // namespace

// x (src_rows, k), row_ids (m,) int32, rhs (E, k, n), group_sizes (E,)
// int32 -> out (m, n); dtype 0 = float32, 1 = bfloat16; k and n multiples
// of 8; bf16 x and rhs 16-byte aligned. A row id outside [0, src_rows)
// reads as a zero row. Returns the launch's cudaError_t.
extern "C" int rkt_gather_gmm(const void* x, int src_rows, const void* row_ids, const void* rhs,
                              const void* group_sizes, void* out, int m, int k, int n,
                              int num_groups, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || num_groups <= 0 || src_rows <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return run_bf16(x, src_rows, row_ids, rhs, group_sizes, out, m, k, n, num_groups, stream);
  if (dtype == 0)
    return run_f32(x, src_rows, row_ids, rhs, group_sizes, out, m, k, n, num_groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch geometry of rkt_gather_gmm at these shapes on the current
// device (launch_info.cuh).
extern "C" int rkt_gather_gmm_launch_info(int m, int n, int num_groups, int dtype,
                                          long long* info) {
  if (m <= 0 || n <= 0 || num_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 1)
    return rkt_info::write(gmm_kernel<false, true>, gmm_grid(m, n, num_groups), kThreads, 0,
                           info);
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return err;
  return rkt_info::write(gather_gmm_wgmma_kernel, wgmma_grid(m, n, num_groups, sms), kWgThreads,
                         kWgSmem, info);
}

// Registers per thread (what 1) or resident CTAs per SM (what 0) of the
// bf16 kernel; -1 when the card refuses it.
extern "C" int rkt_gather_gmm_attribute(int what) {
  if (prepare_wgmma() != 0) return -1;
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, gather_gmm_wgmma_kernel) == cudaSuccess ? attr.numRegs
                                                                                : -1;
  }
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_gmm_wgmma_kernel,
                                                    kWgThreads, kWgSmem) != cudaSuccess)
    return -1;
  return blocks;
}
