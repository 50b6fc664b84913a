// B1: the row-batched CG matvec out = p @ A, in IEEE fp32.
//
// Replaces cggp_tpu/ops/pallas_matvec.py::pallas_matvec (body _matvec_kernel).
// On the TPU that kernel streams contiguous row panels of A through VMEM and
// forms (A @ p^T)^T, because column panels of row-major A are strided there.
// On the GPU a row-major A is read along its rows by p @ A directly, so this
// kernel is a plain tiled GEMM: 64 x 64 output tiles, 4 x 4 register blocks,
// depth 16 staged in shared memory (tile_gemm.cuh); ragged edges are masked.
//
// What bounds it on an H100: at the serving shape (p [8192, 989], A [989, 989])
// it does 2*R*M^2 = 16 GFLOP on 36 MB of operands, ~450 FLOP per byte, so the
// card's fp32 FMA rate (67 TFLOP/s outside the tensor cores) bounds it, not
// HBM.  TF32 tensor cores would be faster but keep ~3 decimal digits, which CG
// cannot afford; this first version is simple and right, and reaches a share
// of the FMA peak that PERF.md records.  At R = 1 (the nu solve) it is bound by
// reading A once (3.9 MB) and runs 16 blocks, a known weak point.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

__global__ void __launch_bounds__(cggp::kThreads)
    pallas_matvec_kernel(const float* p, const float* a, float* out, int rows, int m) {
  __shared__ cggp::TileSmem s;
  float acc[4][4];
  const int row0 = blockIdx.y * cggp::kTileRows;
  const int col0 = blockIdx.x * cggp::kTileCols;
  cggp::tile_gemm(p, a, rows, m, row0, col0, s, acc);
  cggp::store_tile(out, rows, m, row0, col0, acc);
}

}  // namespace

extern "C" int cggp_pallas_matvec(const float* p, const float* a, float* out, int rows, int m,
                                  void* stream) {
  if (rows <= 0 || m <= 0) return cudaSuccess;
  const dim3 grid((m + cggp::kTileCols - 1) / cggp::kTileCols,
                  (rows + cggp::kTileRows - 1) / cggp::kTileRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  pallas_matvec_kernel<<<grid, cggp::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, a, out, rows, m);
  return cudaGetLastError();
}

extern "C" const char* cggp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
