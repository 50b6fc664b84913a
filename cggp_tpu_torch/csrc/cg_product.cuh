// B2's product pA = p @ A on the tiled path (pallas_cg.cu): one 128 x 128
// output tile at a time in 3xTF32, fed through a warp-specialised pipeline.
// B1 (pallas_matvec.cu) keeps tiled_matvec.cuh's loop: it takes p at any
// 4-byte offset from its caller, which no TMA descriptor can describe.
//
// Layout.  B2 owns its p: its rows sit round4(M) words apart in the solve's
// work buffer, so a stage's 128 x 32 p tile is one 2-D TMA copy (box 32 x
// 128, SWIZZLE_128B) straight into the swizzled layout of tile_offset;
// depths past M and rows past R are the copy's zero fill.  A stage's B
// tile of the split A (tiled_matvec.cuh's split_b_kernel) is 32 KB of
// contiguous words: one bulk copy.  Both complete on the slot's mbarrier.
//
// Roles.  Two consumer warpgroups (64 rows of the tile each) and a
// producer warpgroup, whose first thread issues the copies; setmaxnreg
// moves the producer's registers to the consumers (it acts on whole
// warpgroups: a lone producer warp hangs in it).  The ring has kSlots
// slots of [B hi | B lo | p tile] (48 KB each); a slot's "full" mbarrier
// completes when its copies land, its "empty" mbarrier when the eight
// consumer warps are done with it.  The consumers never meet at a
// block-wide barrier inside the stage loop.
//
// Ping-pong.  A stage's products are two groups of wgmma per consumer
// warpgroup (ten, then two: mma_3xtf32.cuh's two-part sums), each waited
// for and added to the accumulator in IEEE fp32 before the next is issued.
// The two warpgroups issue their groups in strict turns (two named
// barriers: a warpgroup waits for its turn before it issues a group and
// hands the turn over after), so while one drains and adds, the tensor
// cores work on the other's group.  Measured no faster on an H100 (PERF.md
// §6): two register sets for the parts, one drain a stage (~285 registers
// a consumer thread with the accumulator and the fragments: it spills);
// splitting the next stage's fragments while the first group runs; a
// fourth slot in place of the outer sums at M <= 1024; the copies issued by
// a consumer thread instead of a producer warpgroup.
//
// Arithmetic.  The same TF32 split of p in registers, the same twelve wgmma
// per stage in the same two parts and the same IEEE adds in the same order
// as tiled_matvec.cuh's loop, the outer sums every kFlushStages stages: the
// output is bitwise that loop's.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled_matvec.cuh"

namespace cggp {
namespace cg_product {

using tf32x3::kStageDepth;
using tf32x3::kTileWords;

constexpr int kConsumerThreads = 256;                // two warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 128;     // and the producer warpgroup
constexpr int kSlots = 3;
constexpr int kSlotWords = 3 * kTileWords;           // [B hi][B lo][p]
constexpr uint32_t kBBytes = 2 * kTileWords * sizeof(float);
constexpr uint32_t kStageBytes = kSlotWords * sizeof(float);
constexpr size_t kRingBytes = sizeof(float) * kSlots * size_t(kSlotWords);  // 144 KB
constexpr size_t kOuterBytes = sizeof(float) * 64 * kConsumerThreads;      // 64 KB
// The ring, the consumers' outer sums, then kSlots full and kSlots empty
// mbarriers.
constexpr size_t kSmemBytes = kRingBytes + kOuterBytes + 2 * kSlots * sizeof(uint64_t);
// setmaxnreg: the producer warpgroup gives up registers to the consumers
// (the accumulator, the stage's partial sum and its A fragments).  At 384
// threads a block starts at 168 registers a thread.
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
static_assert(kConsumerThreads * kConsumerRegs + 128 * kProducerRegs <= 65536, "register file");
static_assert(kSlotWords * sizeof(float) % 1024 == 0, "slots keep the 1024-byte alignment");

__host__ __device__ constexpr int row_stride(int m) { return (m + 3) / 4 * 4; }

struct Ring {
  float* base;
  uint64_t* full;
  uint64_t* empty;

  __device__ uint32_t* b_hi(int slot) const {
    return reinterpret_cast<uint32_t*>(base) + slot * kSlotWords;
  }
  __device__ float* p_tile(int slot) const { return base + slot * kSlotWords + 2 * kTileWords; }
};

__device__ __forceinline__ Ring ring_of(float* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (kRingBytes + kOuterBytes) / sizeof(float));
  return {smem, bars, bars + kSlots};
}

__device__ __forceinline__ float* outer_of(float* smem) {
  return smem + kRingBytes / sizeof(float);
}

__device__ __forceinline__ void mbarrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tf32x3::smem_addr(bar))
               : "memory");
}

// One bulk copy of `bytes` contiguous bytes (16-byte aligned, a multiple of
// 16) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(tf32x3::smem_addr(dst)), "l"(src), "r"(bytes), "r"(tf32x3::smem_addr(bar))
      : "memory");
}

// Orders this thread's view of global memory (p, written by every block's
// row pass before the last grid.sync()) before its asynchronous copies.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The consumers' turns: warpgroup wg waits on named barrier 1 + wg before it
// issues a group of wgmma and arrives on the other's after (256 threads).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kConsumerThreads) : "memory");
}

// Producer (one thread): the copies of the tile (row0, cb)'s nk stages, the
// block's stages q, q + 1, ... in slot q % kSlots; a slot is refilled once
// both consumer warpgroups have released its previous stage.
__device__ __forceinline__ void produce_tile(const Ring& ring, const CUtensorMap* p_map,
                                             const uint32_t* b_split, int col_blocks, int cb,
                                             int row0, int nk, uint32_t& q) {
  for (int s = 0; s < nk; ++s, ++q) {
    const int slot = q % kSlots;
    if (q >= kSlots) tf32x3::mbarrier_wait(&ring.empty[slot], (q / kSlots - 1) & 1);
    tf32x3::mbarrier_expect_tx(&ring.full[slot], kStageBytes);
    bulk_load(ring.b_hi(slot),
              b_split + (static_cast<size_t>(s) * col_blocks + cb) * 2 * kTileWords, kBBytes,
              &ring.full[slot]);
    tf32x3::tma_load_2d(ring.p_tile(slot), p_map, s * kStageDepth, row0, &ring.full[slot]);
  }
}

// The A fragments of a warpgroup's 64 rows of a stage, split into TF32
// halves (as tf32x3::issue_stage splits them).
__device__ __forceinline__ void split_fragments(const float* p_tile, int wg_row0,
                                                tf32x3::StageRegs& st) {
  using tf32x3::split;
  using tf32x3::tile_offset;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r = wg_row0 + 16 * ((threadIdx.x % 128) / 32) + g;
#pragma unroll
  for (int s = 0; s < kStageDepth / 8; ++s) {
    split(p_tile[tile_offset(r, 8 * s + t)], st.a_hi[s][0], st.a_lo[s][0]);
    split(p_tile[tile_offset(r + 8, 8 * s + t)], st.a_hi[s][1], st.a_lo[s][1]);
    split(p_tile[tile_offset(r, 8 * s + t + 4)], st.a_hi[s][2], st.a_lo[s][2]);
    split(p_tile[tile_offset(r + 8, 8 * s + t + 4)], st.a_hi[s][3], st.a_lo[s][3]);
  }
}

// The first part of a stage: the eight small products and the first two
// 8-deep steps' large ones (tf32x3::issue_stage's wgmma).
__device__ __forceinline__ void issue_first_part(const uint32_t* b_hi, const uint32_t* b_lo,
                                                 tf32x3::StageRegs& st) {
  using namespace tf32x3;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kStageDepth / 8; ++s) {
    const uint64_t bh = wgmma_desc(b_hi, 8 * s), bl = wgmma_desc(b_lo, 8 * s);
    wgmma_tf32(st.part, st.a_lo[s], bh, s > 0);
    wgmma_tf32(st.part, st.a_hi[s], bl, 1);
  }
  wgmma_tf32(st.part, st.a_hi[0], wgmma_desc(b_hi, 0), 1);
  wgmma_tf32(st.part, st.a_hi[1], wgmma_desc(b_hi, 8), 1);
  wgmma_commit();
}

// The second part: the last two 8-deep steps' large products
// (tf32x3::finish_stage's wgmma).
__device__ __forceinline__ void issue_second_part(const uint32_t* b_hi, tf32x3::StageRegs& st) {
  using namespace tf32x3;
  wgmma_fence();  // part was read: order that before the tensor cores write it
  wgmma_tf32(st.part, st.a_hi[2], wgmma_desc(b_hi, 16), 0);
  wgmma_tf32(st.part, st.a_hi[3], wgmma_desc(b_hi, 24), 1);
  wgmma_commit();
}

// Consumers (all 256 threads): acc = this thread's part of the tile whose
// nk stages are the block's next ones in the ring, q..; `outer` is the
// block's kOuterBytes of outer sums.  On return every wgmma of the tile has
// completed and every slot it read is released.
__device__ __forceinline__ void consume_tile(const Ring& ring, int nk, uint32_t& q, float* outer,
                                             float (&acc)[64]) {
  const int tid = threadIdx.x;
  const int wg = tid / 128;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    outer[i * kConsumerThreads + tid] = 0.f;
  }
  tf32x3::StageRegs st;
  for (int s = 0; s < nk; ++s, ++q) {
    const int slot = q % kSlots;
    tf32x3::mbarrier_wait(&ring.full[slot], (q / kSlots) & 1);
    const uint32_t* b_hi = ring.b_hi(slot);
    split_fragments(ring.p_tile(slot), 64 * wg, st);
    turn_wait(wg);
    issue_first_part(b_hi, b_hi + kTileWords, st);
    turn_pass(wg);
    tf32x3::add_part(st, acc);
    turn_wait(wg);
    issue_second_part(b_hi, st);
    turn_pass(wg);
    tf32x3::add_part(st, acc);
    __syncwarp();
    if (tid % 32 == 0) mbarrier_arrive(&ring.empty[slot]);
    if ((s + 1) % tiles::kFlushStages == 0) {  // this thread's own words: no barrier
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        outer[i * kConsumerThreads + tid] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = outer[i * kConsumerThreads + tid] + acc[i];
}

}  // namespace cg_product
}  // namespace cggp
