// B1: the row-batched CG matvec out = p @ A, fp32-accurate.
//
// Replaces cggp_tpu/ops/pallas_matvec.py::pallas_matvec (body _matvec_kernel).
// On the TPU that kernel streams contiguous row panels of A through VMEM and
// forms (A @ p^T)^T, because column panels of row-major A are strided there.
// On the GPU a row-major A is read along its rows by p @ A directly, so the
// panel trick is not carried over.  Two launch shapes:
//
//   * rows > 8 (a serving batch, R = 8192, M = 989): 3xTF32 on the tensor
//     cores (mma_3xtf32.cuh).  split_b_kernel first splits A once into its
//     TF32 halves, stored tile by tile as the product reads them (8 MB of
//     scratch at M = 989); then 128 x 128 output tiles, two warpgroups of
//     64 x 128 issuing wgmma, over 32-deep stages in a 3-slot cp.async ring
//     (150 KB of shared memory), A fragments split in registers from the p
//     rows.
//     What bounds it: 2 R M^2 = 1.6e10 flops on 69 MB of operands and
//     result.  fp32-accurate on the tensor cores that is three TF32 passes,
//     3 x 1.6e10 / 495 TFLOP/s = 0.097 ms, against 0.239 ms of fp32 FMA
//     outside them (the SIMT bound) and 0.021 ms of bytes: the tensor cores
//     bound it.  CG cannot afford one TF32 pass (~3 digits); the hi/lo split
//     and the IEEE accumulation outside the tensor cores keep fp32-level
//     error.
//   * rows <= 8 (the pseudo-u solve, R = 1): a GEMV bound by reading A once
//     (3.9 MB, resident in L2 across CG steps).  Blocks own 32 columns (a
//     lane each) and a cluster of 8 blocks splits the depth; each block sums
//     its 8 warps in shared memory and stores its partial into the cluster's
//     rank 0 through distributed shared memory, which adds the 8 partials in
//     a fixed order after one cluster barrier (no atomics: the result is
//     deterministic).  248 blocks at M = 989 cover
//     the 132 SMs.  Plain fp32 FMA: the tensor cores buy nothing here.
//
// Alignment.  M = 989 is odd, so rows of p are only 4-byte aligned: 16-byte
// copies, float4 loads and TMA descriptors (global strides must be
// multiples of 16 bytes) cannot describe them.  Each p row of a stage is
// copied as the nine aligned 16-byte chunks that cover it and read at its
// skew (load_p_tile); p is never padded (a padding copy would move 32 MB
// per call).  The skew comes from the row's address, so p may start at any
// 4-byte boundary (a view at an offset).  Rows, columns and depths past the
// edge read as zero.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mma_3xtf32.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cggp::tf32x3;

constexpr int kThreads = 256;

// Tiled launch: 128 x 128 output tiles, two warpgroups of 64 x 128.
// Shared memory: [3 slots] x (the p stage tile [128 rows][kRawStride] fp32
// and the B stage tile [hi, lo][kTileWords] TF32), all by cp.async.
constexpr int kBlock = kTileRows;
constexpr int kSlots = 3;
constexpr int kRawChunks = kStageDepth / 4 + 1;  // 16-byte chunks covering a misaligned row
constexpr int kRawStride = 4 * kRawChunks;       // words per raw row (16-byte aligned rows)
constexpr int kRawWords = kBlock * kRawStride;
constexpr size_t kTiledSmemBytes =
    sizeof(float) * kSlots * (2 * size_t(kTileWords) + kRawWords);  // 150 KB
static_assert(2 * 128 == kThreads, "two warpgroups");

// GEMV launch.
constexpr int kGemvRows = 8;
constexpr int kGemvCols = 32;
constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvSplit = 8;  // depth slices, one per block of a cluster
static_assert(kGemvRows * kGemvCols == kThreads, "one thread per output of a block");

// The B operand, split once per call.  B(k, c) = A[k][c] = A[c][k]: A is
// symmetric (as the TPU kernel also assumes), so the K-major B tile of
// column block cb and stage s is read along rows of A.  Each tile is stored
// as the block will hold it in shared memory -- [hi, lo][kTileWords] in the
// swizzled layout, zero past M -- at b_split + ((s * col_blocks + cb) * 2)
// kTileWords, so a stage's B tile is 32 KB of contiguous, aligned words.
// Splitting the 3.9 MB A once here, instead of once per row block in the
// product, moves ~12 MB and saves every block a pass over each B tile; at
// R = 8192, M = 989 it takes 5.1 us of the call's 266 us of device time
// (torch.profiler in chip_smoke.py's B1 phase, H100 80GB HBM3 at 700 W).
__global__ void __launch_bounds__(kThreads)
    split_b_kernel(const float* a, int m, uint32_t* b_split) {
  const int cb = blockIdx.x, stage = blockIdx.y;
  uint32_t* hi = b_split + (static_cast<size_t>(stage) * gridDim.x + cb) * 2 * kTileWords;
  uint32_t* lo = hi + kTileWords;
#pragma unroll 4
  for (int o = threadIdx.x; o < kTileWords; o += kThreads) {
    const int gc = cb * kBlock + tile_row(o);
    const int gk = stage * kStageDepth + tile_depth(o);
    const float v = gc < m && gk < m ? __ldg(a + static_cast<size_t>(gc) * m + gk) : 0.f;
    split(v, hi[o], lo[o]);
  }
}

// The p tile of one stage: for each of its 128 rows, the nine 16-byte
// aligned chunks that cover the row's 32 depths.  Rows of p are only 4-byte
// aligned at odd M or when p is a view at an offset (16-byte copies, float4
// loads and TMA descriptors cannot describe them), so a row's data starts
// row_skew words into its raw row: its word address mod 4 (stage starts are
// multiples of 32 words apart).  The first chunk of a row may begin up to
// 12 bytes before it, inside the same aligned 16 bytes (never before the
// allocation, which is 16-byte aligned); chunks past the array's end are
// cut short (src-size) and zero-filled, and depths past M are masked when
// read.
__device__ __forceinline__ int row_skew(const float* p, int row, int m) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / 4 + static_cast<size_t>(row) * m) & 3);
}

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
    cp_async_16(raw + n * kRawStride + 4 * j,
                bytes ? reinterpret_cast<const float*>(chunk * 4) : aligned_p, bytes);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    matvec_tiled_kernel(const float* p, const uint32_t* b_split, float* out, int rows, int m) {
  extern __shared__ __align__(1024) float smem[];
  // [slot][B hi, B lo][kTileWords] then [slot][kRawWords].
  const auto b_tile = [&](int stage) {
    return reinterpret_cast<uint32_t*>(smem) + (stage % kSlots) * 2 * kTileWords;
  };
  const auto raw_p = [&](int stage) {
    return smem + kSlots * 2 * kTileWords + (stage % kSlots) * kRawWords;
  };
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row0 = blockIdx.y * kBlock;
  const int col0 = blockIdx.x * kBlock;
  const int nk = (m + kStageDepth - 1) / kStageDepth;
  const size_t p_words = static_cast<size_t>(rows) * m;
  const auto load = [&](int stage) {
    if (stage < nk) {
      load_p_tile(p, p_words, row0, rows, m, stage * kStageDepth, raw_p(stage));
      const uint32_t* src =
          b_split + (static_cast<size_t>(stage) * gridDim.x + blockIdx.x) * 2 * kTileWords;
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

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  StageRegs st;

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
    finish_stage(st, acc);
  }

  // Accumulator layout of m64n128: warp w of the warpgroup owns rows
  // 16 w + g and 16 w + g + 8; acc[4 j + e] is column 8 j + 2 t + (e & 1).
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_base = row0 + 64 * wg + 16 * ((tid % 128) / 32) + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_base + 8 * h;
      if (r >= rows) continue;
      float* o = out + static_cast<size_t>(r) * m;
      if (c < m) o[c] = acc[4 * j + 2 * h];
      if (c + 1 < m) o[c + 1] = acc[4 * j + 2 * h + 1];
    }
  }
}

__global__ void __cluster_dims__(1, kGemvSplit, 1) __launch_bounds__(kThreads)
    matvec_gemv_kernel(const float* p, const float* a, float* out, int rows, int m) {
  __shared__ float red[kGemvWarps][kGemvRows][kGemvCols];
  __shared__ float gather[kGemvSplit][kGemvRows][kGemvCols];  // read on rank 0 only
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * kGemvCols + lane;
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = (m + kGemvSplit - 1) / kGemvSplit;
  const int k_begin = rank * slice;
  const int k_end = min(m, k_begin + slice);

  float acc[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) acc[r] = 0.f;
  if (c < m) {
#pragma unroll 4
    for (int k = k_begin + warp; k < k_end; k += kGemvWarps) {
      const float av = __ldg(a + static_cast<size_t>(k) * m + c);
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r)
        if (r < rows) acc[r] = fmaf(__ldg(p + static_cast<size_t>(r) * m + k), av, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = threadIdx.x / kGemvCols;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kGemvWarps; ++w) s += red[w][r][lane];
  // Each block's partial goes into rank 0's shared memory; one cluster
  // barrier makes them visible there, and rank 0 adds them in rank order.
  cluster.map_shared_rank(&gather[0][0][0], 0)[rank * kThreads + threadIdx.x] = s;
  cluster.sync();
  if (rank == 0) {
    float total = 0.f;
#pragma unroll
    for (int b = 0; b < kGemvSplit; ++b) total += gather[b][r][lane];
    if (r < rows && c < m) out[static_cast<size_t>(r) * m + c] = total;
  }
}

}  // namespace

// Words of scratch the tiled launch needs for the split B tiles (0 when
// rows <= 8: the GEMV reads A as it is).
extern "C" long long cggp_pallas_matvec_scratch_words(int rows, int m) {
  if (rows <= kGemvRows || m <= 0) return 0;
  const long long col_blocks = (m + kBlock - 1) / kBlock;
  const long long stages = (m + kStageDepth - 1) / kStageDepth;
  return col_blocks * stages * 2 * kTileWords;
}

// Returns a cudaError_t: the argument check's, else cudaGetLastError() right
// after each launch (a refused launch never runs and no later synchronize
// reports it).  b_split: cggp_pallas_matvec_scratch_words(rows, m) words.
extern "C" int cggp_pallas_matvec(const float* p, const float* a, float* out, int rows, int m,
                                  void* b_split, void* stream) {
  if (rows < 0 || m < 0) return cudaErrorInvalidValue;
  if (rows == 0 || m == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= kGemvRows) {
    const dim3 grid((m + kGemvCols - 1) / kGemvCols, kGemvSplit);
    matvec_gemv_kernel<<<grid, kThreads, 0, s>>>(p, a, out, rows, m);
    return cudaGetLastError();
  }
  const dim3 grid((m + kBlock - 1) / kBlock, (rows + kBlock - 1) / kBlock);
  if (grid.y > 65535 || b_split == nullptr) return cudaErrorInvalidValue;
  const dim3 split_grid(grid.x, (m + kStageDepth - 1) / kStageDepth);
  split_b_kernel<<<split_grid, kThreads, 0, s>>>(a, m, static_cast<uint32_t*>(b_split));
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return split_err;
  const cudaError_t attr = cudaFuncSetAttribute(
      matvec_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kTiledSmemBytes));
  if (attr != cudaSuccess) return attr;
  matvec_tiled_kernel<<<grid, kThreads, kTiledSmemBytes, s>>>(
      p, static_cast<const uint32_t*>(b_split), out, rows, m);
  return cudaGetLastError();
}

extern "C" const char* cggp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
