// The 3xTF32 tiled product p @ A of kernel B1 (pallas_matvec.cu, one output
// tile per block).  B2 (pallas_cg.cu) shares its split of A, its tile layout
// and store_tile, and runs its own main loop on the same sums
// (cg_product.cuh): B2 owns its p and lays it out for TMA, B1 cannot.
//
// Layout.  A is symmetric (both TPU kernels assume it), so the K-major B
// tile of column block cb and stage s, B(k, c) = A[k][c] = A[c][k], is read
// along rows of A.  split_b_kernel splits A once into its TF32 halves and
// stores each tile as a block holds it in shared memory -- [hi, lo]
// [kTileWords] in the swizzled layout, zero past M -- at b_split + ((s *
// col_blocks + cb) * 2) kTileWords: a stage's B tile is 32 KB of contiguous,
// aligned words (8 MB in all at M = 989).
//
// Main loop (tiled_product).  A 128 x 128 output tile, two warpgroups of
// 64 x 128 issuing wgmma (mma_3xtf32.cuh), over 32-deep stages in a 3-slot
// cp.async ring (150 KB of dynamic shared memory); A fragments are split in
// registers from the p rows, each stage summed on the tensor cores from
// zero and added to the accumulator in IEEE fp32.  The depth is summed at
// two levels: every kFlushStages stages each thread adds its accumulators
// to its own outer sums in shared memory (kOuterBytes more) and restarts
// them from zero, as B3 does.  One running sum of all 2 M / 32 stage parts
// (2048 at M = 32768) rounds at the ulp of the growing sum on every add:
// 3.0x torch.matmul's error from fp64 at R = 16, M = 32768, 0.50x with the
// outer sums (chip_smoke.py's solver_family, H100 80GB HBM3 at 700 W; no
// time added: 8.0 ms a call).  Up to kFlushStages stages (M <= 1024) the
// outer sum only adds the running sum to zero: the same bits as one level.
// Every copy is cp.async.cg, which reads through L2 and never L1 (L1 is not
// coherent across SMs).
//
// Alignment.  M = 989 is odd, so rows of p are only 4-byte aligned: 16-byte
// copies, float4 loads and TMA descriptors (global strides must be
// multiples of 16 bytes) cannot describe them.  Each p row of a stage is
// copied as the nine aligned 16-byte chunks that cover it and read at its
// skew (load_p_tile); p is never padded (a padding copy would move 32 MB
// per call).  The skew comes from the row's address, so p may start at any
// 4-byte boundary (a view at an offset).  Rows, columns and depths past the
// edge read as zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_3xtf32.cuh"

namespace cggp {
namespace tiles {

using tf32x3::kStageDepth;
using tf32x3::kTileWords;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBlock = tf32x3::kTileRows;
constexpr int kSlots = 3;
constexpr int kRawChunks = kStageDepth / 4 + 1;  // 16-byte chunks covering a misaligned row
constexpr int kRawStride = 4 * kRawChunks;       // words per raw row (16-byte aligned rows)
constexpr int kRawWords = kBlock * kRawStride;
// [3 slots] x (the B stage tile [hi, lo][kTileWords] TF32 and the p stage
// tile [128 rows][kRawStride] fp32).
constexpr size_t kSmemBytes =
    sizeof(float) * kSlots * (2 * size_t(kTileWords) + kRawWords);  // 150 KB
static_assert(2 * 128 == kThreads, "two warpgroups");
// Two-level depth sums: stages between outer adds, and the outer sums of a
// block's output tile (thread t's word i at [i][t]).
constexpr int kFlushStages = 32;
constexpr size_t kOuterBytes = sizeof(float) * 64 * kThreads;  // 64 KB

__host__ __device__ constexpr int col_blocks(int m) { return (m + kBlock - 1) / kBlock; }
__host__ __device__ constexpr int stages(int m) { return (m + kStageDepth - 1) / kStageDepth; }
// Words of b_split for an [M, M] A.
__host__ __device__ inline long long split_words(int m) {
  return static_cast<long long>(col_blocks(m)) * stages(m) * 2 * kTileWords;
}

// Grid (col_blocks, stages, gang): block (cb, s, g) splits one B tile of
// member g's A (a + g M^2) into member g's split_words(M) words.  In an
// unnamed namespace: each source that includes this header has its own.
namespace {
__global__ void __launch_bounds__(kThreads)
    split_b_kernel(const float* a, int m, uint32_t* b_split) {
  const int cb = blockIdx.x, stage = blockIdx.y;
  a += static_cast<size_t>(blockIdx.z) * m * m;
  b_split += static_cast<size_t>(blockIdx.z) * split_words(m);
  uint32_t* hi = b_split + (static_cast<size_t>(stage) * gridDim.x + cb) * 2 * kTileWords;
  uint32_t* lo = hi + kTileWords;
#pragma unroll 4
  for (int o = threadIdx.x; o < kTileWords; o += kThreads) {
    const int gc = cb * kBlock + tf32x3::tile_row(o);
    const int gk = stage * kStageDepth + tf32x3::tile_depth(o);
    const float v = gc < m && gk < m ? __ldg(a + static_cast<size_t>(gc) * m + gk) : 0.f;
    tf32x3::split(v, hi[o], lo[o]);
  }
}
}  // namespace

// The skew of p's row `row`: its word address mod 4 (stage starts are
// multiples of 32 words apart).
__device__ __forceinline__ int row_skew(const float* p, int row, int m) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / 4 + static_cast<size_t>(row) * m) & 3);
}

// The p tile of one stage: for each of its 128 rows, the nine 16-byte
// aligned chunks that cover the row's 32 depths, the row's data starting
// row_skew words into its raw row.  The first chunk of a row may begin up
// to 12 bytes before it, inside the same aligned 16 bytes (never before the
// allocation, which is 16-byte aligned); chunks past the array's end are
// cut short (src-size) and zero-filled, and depths past M are masked when
// read.
__device__ __forceinline__ void load_p_tile(const float* p, size_t p_words, int row0, int rows,
                                            int m, int k0, float* raw) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(p) / 4;  // word address of p
  const uintptr_t end = base + p_words;
  const float* aligned_p = reinterpret_cast<const float*>((base & ~uintptr_t{3}) * 4);
  for (int c = threadIdx.x; c < kBlock * kRawChunks; c += kThreads) {
    const int n = c / kRawChunks, j = c % kRawChunks;
    const uintptr_t start = base + static_cast<size_t>(row0 + n) * m + k0;
    const uintptr_t chunk = (start & ~uintptr_t{3}) + 4 * j;
    const uintptr_t left = chunk < end ? end - chunk : 0;
    const int bytes = row0 + n >= rows ? 0 : (left >= 4 ? 16 : static_cast<int>(4 * left));
    tf32x3::cp_async_16(raw + n * kRawStride + 4 * j,
                        bytes ? reinterpret_cast<const float*>(chunk * 4) : aligned_p, bytes);
  }
}

// acc = p[row0 : row0 + 128, :] @ A[:, 128 cb : 128 cb + 128] in 3xTF32, for
// p [rows, m] and A split in b_split (col_blocks column blocks); `smem` is
// the block's kSmemBytes of dynamic shared memory, followed by kOuterBytes
// for the outer sums.  All 256 threads call it.  On return every wgmma and
// every copy of the tile has completed.
__device__ __forceinline__ void tiled_product(const float* p, int rows, int m,
                                              const uint32_t* b_split, int col_blocks, int cb,
                                              int row0, float* smem, float (&acc)[64]) {
  using namespace tf32x3;
  // [slot][B hi, B lo][kTileWords] then [slot][kRawWords].
  const auto b_tile = [&](int stage) {
    return reinterpret_cast<uint32_t*>(smem) + (stage % kSlots) * 2 * kTileWords;
  };
  const auto raw_p = [&](int stage) {
    return smem + kSlots * 2 * kTileWords + (stage % kSlots) * kRawWords;
  };
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nk = stages(m);
  const size_t p_words = static_cast<size_t>(rows) * m;
  const auto load = [&](int stage) {
    if (stage < nk) {
      load_p_tile(p, p_words, row0, rows, m, stage * kStageDepth, raw_p(stage));
      const uint32_t* src =
          b_split + (static_cast<size_t>(stage) * col_blocks + cb) * 2 * kTileWords;
      uint32_t* dst = b_tile(stage);
      for (int c = tid; c < 2 * kTileWords / 4; c += kThreads) {
        cp_async_16(dst + 4 * c, src + 4 * c, 16);
      }
    }
    cp_async_commit();
  };
  // A fragments come from the raw p rows, skewed and masked.
  const auto a_value = [&](int stage, int r, int k) {
    const int k0 = stage * kStageDepth;
    return k0 + k < m ? raw_p(stage)[r * kRawStride + row_skew(p, row0 + r, m) + k] : 0.f;
  };

  float* outer = smem + kSmemBytes / sizeof(float);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    outer[i * kThreads + tid] = 0.f;
  }
  StageRegs st;

  // A caller that loops over tiles (B2) reaches here while the other
  // warpgroup may still read its previous tile's last stage from the ring.
  __syncthreads();
  // Stage s lives in slot s % 3.  Iteration s issues stage s's products on
  // the tensor cores (A from registers, B from shared memory), waits for
  // stage s + 1's copies and prefetches stage s + 2.
  load(0);
  load(1);
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  for (int s = 0; s < nk; ++s) {
    issue_stage([&](int r, int k) { return a_value(s, r, k); }, b_tile(s),
                b_tile(s) + kTileWords, 64 * wg, st);
    cp_async_wait<0>();   // this thread's copies of stage s + 1 have landed
    fence_proxy_async();  // ... and are visible to the tensor cores
    __syncthreads();      // everyone's have, and everyone is done with stage s - 1
    load(s + 2);          // into slot (s + 2) % 3, which held stage s - 1
    finish_stage(st, b_tile(s), acc);  // the rest of stage s, slot s % 3 untouched
    if ((s + 1) % kFlushStages == 0) {  // this thread's own words: no barrier
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        outer[i * kThreads + tid] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = outer[i * kThreads + tid] + acc[i];
}

// Accumulator layout of m64n128: warp w of warpgroup wg owns rows
// row0 + 64 wg + 16 w + g and + 8 (h = 0, 1); acc[4 j + 2 h + e] is column
// col0 + 8 j + 2 t + e of row h.
__device__ __forceinline__ int acc_row(int row0, int h) {
  const int tid = threadIdx.x;
  return row0 + 64 * (tid / 128) + 16 * ((tid % 128) / 32) + (tid % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col(int col0, int j, int e) {
  return col0 + 8 * j + 2 * (threadIdx.x % 4) + e;
}

// Writes the thread's part of a tile into out [rows, m].
__device__ __forceinline__ void store_tile(float* out, int rows, int m, int row0, int col0,
                                           const float (&acc)[64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = acc_row(row0, h);
    if (r >= rows) continue;
    float* o = out + static_cast<size_t>(r) * m;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = acc_col(col0, j, e);
        if (c < m) o[c] = acc[4 * j + 2 * h + e];
      }
  }
}

}  // namespace tiles
}  // namespace cggp
