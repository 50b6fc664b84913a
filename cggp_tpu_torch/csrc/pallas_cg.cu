// B2: a whole unpreconditioned CG solve v A = b (row convention) in one launch.
//
// Replaces cggp_tpu/ops/pallas_cg.py::pallas_cg_solve (body _cg_kernel): the
// same stop rule (iterate while any row has 0.5 |r|^2 > thr and i < max),
// the same curvature guards (gamma = 0 when p.pA <= 1e-16; no beta momentum
// when the old r.r <= 1e-16), the same association (p * new_rz) / rz, and
// all rows step together until every row meets the threshold, as there.
//
// What bounds it on an H100: every iteration is a [R, M] x [M, M] fp32
// product (2*R*M^2 FLOP; 16 GFLOP at R = 8192, M = 989), so the fp32 FMA rate
// bounds it; A (3.9 MB at M = 989) is far above one SM's 227 KB of shared
// memory but stays resident in the 50 MB L2 across iterations, which is what
// the TPU kernel got from keeping A in VMEM.  What the design does:
//  * One cooperative launch of persistent blocks, as many as the occupancy
//    API says can be resident, so the matvec has enough warps in flight to
//    hide L2 latency (one block per 64-row tile, the first version of this
//    kernel, left one block of 8 warps per SM and ran at a quarter of the
//    rate of the same tile product launched as a grid).
//  * Each iteration has two phases.  (A) The product pA = p @ A is cut into
//    64 x 64 output tiles (row tile, column chunk) that the blocks take in
//    turn, through the tile product of tile_gemm.cuh.  grid.sync().  (B) One
//    warp per row, each row always owned by the same warp, does p.pA, the
//    v/r updates, r.r and the p update, and notes whether its row is over
//    the threshold.  State (v, r, p, pA, rz) lives in global memory (L2);
//    data written by another block is read through L2 (__ldcg).
//  * The stop rule: each block writes "one of my rows is over" into its own
//    slot of a two-slot array indexed by the iteration's parity, then
//    grid.sync(); every block reads all slots and takes the same decision.
//    A slot is rewritten two iterations later, after two more grid.sync()s,
//    when every read of it is done, so no slot needs resetting.
//  * cudaLaunchCooperativeKernel refuses a grid that cannot be resident with
//    an error instead of deadlocking.  There is no hand-written barrier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kWarps = cggp::kThreads / 32;
constexpr float kMinFloat = 1e-16f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// Publishes this block's "a row is over the threshold" into the slot of the
// given parity, waits for the grid, and returns whether any block had one.
__device__ __forceinline__ int any_over(cgrp::grid_group& grid, int* flags, int parity,
                                        int over) {
  int* slot = flags + parity * gridDim.x;
  const int block_over = __syncthreads_or(over);
  if (threadIdx.x == 0) slot[blockIdx.x] = block_over;
  grid.sync();
  int any = 0;
  for (int g = threadIdx.x; g < static_cast<int>(gridDim.x); g += blockDim.x)
    any |= __ldcg(slot + g);
  return __syncthreads_or(any);
}

__global__ void __launch_bounds__(cggp::kThreads)
    pallas_cg_kernel(const float* a, const float* b, float* v, float* r, float* p, float* pa,
                     float* rz, int* flags, int* steps, int rows, int m, float thr,
                     int max_iterations) {
  cgrp::grid_group grid = cgrp::this_grid();
  __shared__ cggp::TileSmem s;
  const int lane = threadIdx.x % 32;
  const int first_row = blockIdx.x * kWarps + threadIdx.x / 32;  // this warp's rows
  const int row_stride = gridDim.x * kWarps;
  const int col_chunks = (m + cggp::kTileCols - 1) / cggp::kTileCols;
  const int units = (rows + cggp::kTileRows - 1) / cggp::kTileRows * col_chunks;

  // v0 = 0, r0 = p0 = b, rz0 = b.b
  int over = 0;
  for (int row = first_row; row < rows; row += row_stride) {
    const size_t base = static_cast<size_t>(row) * m;
    float bb = 0.f;
    for (int c = lane; c < m; c += 32) {
      const float x = b[base + c];
      v[base + c] = 0.f;
      r[base + c] = x;
      p[base + c] = x;
      bb = fmaf(x, x, bb);
    }
    bb = warp_sum(bb);
    if (lane == 0) {
      rz[row] = bb;
      over |= (0.5f * bb > thr);
    }
  }

  // Stop rule before each step, as in the TPU kernel's while_loop cond.
  int it = 0;
  int any = any_over(grid, flags, 0, over);
  while (any && it < max_iterations) {
    // (A) pA = p @ A, one 64 x 64 output tile per unit.
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      const int row0 = unit / col_chunks * cggp::kTileRows;
      const int col0 = unit % col_chunks * cggp::kTileCols;
      float acc[4][4];
      cggp::tile_gemm(p, a, rows, m, row0, col0, s, acc);
      cggp::store_tile(pa, rows, m, row0, col0, acc);
    }
    grid.sync();

    // (B) per-row dots and updates, one warp per row.
    over = 0;
    for (int row = first_row; row < rows; row += row_stride) {
      const size_t base = static_cast<size_t>(row) * m;
      float denom = 0.f;
      for (int c = lane; c < m; c += 32) denom = fmaf(p[base + c], __ldcg(pa + base + c), denom);
      denom = warp_sum(denom);
      const float rz_old = rz[row];
      const float gamma = denom <= kMinFloat ? 0.f : rz_old / denom;
      float rz_new = 0.f;
      for (int c = lane; c < m; c += 32) {
        v[base + c] = v[base + c] + gamma * p[base + c];
        const float rc = r[base + c] - gamma * __ldcg(pa + base + c);
        r[base + c] = rc;
        rz_new = fmaf(rc, rc, rz_new);
      }
      rz_new = warp_sum(rz_new);
      const bool momentum = !(rz_old <= kMinFloat);
      for (int c = lane; c < m; c += 32) {
        const float pc = p[base + c];
        p[base + c] = r[base + c] + (momentum ? (pc * rz_new) / rz_old : 0.f);
      }
      if (lane == 0) {
        rz[row] = rz_new;
        over |= (0.5f * rz_new > thr);
      }
    }
    ++it;
    any = any_over(grid, flags, it & 1, over);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) steps[0] = it;
}

}  // namespace

// The cooperative grid for `rows` right-hand sides of length m on `device`:
// enough blocks for every tile-product unit (or every row's warp), capped at
// what the occupancy API says can be resident at once.
extern "C" int cggp_cg_grid(int rows, int m, int device, int* grid_out) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pallas_cg_kernel, cggp::kThreads, 0);
  if (err != cudaSuccess) return err;
  const int units = (rows + cggp::kTileRows - 1) / cggp::kTileRows *
                    ((m + cggp::kTileCols - 1) / cggp::kTileCols);
  const int row_blocks = (rows + kWarps - 1) / kWarps;
  const int wanted = units > row_blocks ? units : row_blocks;
  const int resident = per_sm * sms;
  *grid_out = wanted < resident ? wanted : resident;
  if (*grid_out < 1) *grid_out = 1;  // a refused launch reports the error
  return cudaSuccess;
}

// flags holds 2 * grid ints; steps one int.  v, r, p, pa are [rows, m], rz [rows].
extern "C" int cggp_pallas_cg_solve(const float* a, const float* b, float* v, float* r, float* p,
                                    float* pa, float* rz, int* flags, int* steps, int rows, int m,
                                    float thr, int max_iterations, int grid, void* stream) {
  if (rows <= 0 || m <= 0 || grid <= 0) return cudaErrorInvalidValue;
  void* args[] = {&a, &b, &v, &r, &p, &pa, &rz, &flags, &steps, &rows, &m, &thr, &max_iterations};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pallas_cg_kernel), dim3(grid),
                                  dim3(cggp::kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
