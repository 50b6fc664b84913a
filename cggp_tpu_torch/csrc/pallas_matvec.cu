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
//     rows, the depth summed at two levels (outer sums every 32 stages in
//     64 KB more of shared memory; tiled_matvec.cuh).
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
// The tiled launch's main loop, the split of A and the alignment rules live
// in tiled_matvec.cuh, shared with B2 (pallas_cg.cu).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_matvec.cuh"

namespace {

namespace cg = cooperative_groups;

using cggp::tiles::kBlock;
using cggp::tiles::kThreads;

// GEMV launch.
constexpr int kGemvRows = 8;
constexpr int kGemvCols = 32;
constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvSplit = 8;  // depth slices, one per block of a cluster
static_assert(kGemvRows * kGemvCols == kThreads, "one thread per output of a block");

// Tiled launch: grid (col_blocks, row_tiles), one 128 x 128 output tile per
// block.  A is split once per call by tiles::split_b_kernel (5.1 us of the
// call's 266 us of device time at R = 8192, M = 989; torch.profiler in
// chip_smoke.py's B1 phase, H100 80GB HBM3 at 700 W).
__global__ void __launch_bounds__(kThreads, 1)
    matvec_tiled_kernel(const float* p, const uint32_t* b_split, float* out, int rows, int m) {
  extern __shared__ __align__(1024) float smem[];
  const int row0 = blockIdx.y * kBlock;
  float acc[64];
  cggp::tiles::tiled_product(p, rows, m, b_split, gridDim.x, blockIdx.x, row0, smem, acc);
  cggp::tiles::store_tile(out, rows, m, row0, blockIdx.x * kBlock, acc);
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
  return cggp::tiles::split_words(m);
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
  const dim3 split_grid(grid.x, cggp::tiles::stages(m));
  cggp::tiles::split_b_kernel<<<split_grid, kThreads, 0, s>>>(a, m,
                                                              static_cast<uint32_t*>(b_split));
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return split_err;
  constexpr size_t smem_bytes = cggp::tiles::kSmemBytes + cggp::tiles::kOuterBytes;  // 214 KB
  const cudaError_t attr = cudaFuncSetAttribute(
      matvec_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes));
  if (attr != cudaSuccess) return attr;
  matvec_tiled_kernel<<<grid, kThreads, smem_bytes, s>>>(
      p, static_cast<const uint32_t*>(b_split), out, rows, m);
  return cudaGetLastError();
}

extern "C" const char* cggp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
