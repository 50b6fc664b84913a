// B2: a whole unpreconditioned CG solve v A = b (row convention) in one
// cooperative launch.
//
// Replaces cggp_tpu/ops/pallas_cg.py::pallas_cg_solve (body _cg_kernel): the
// same stop rule (iterate while any row has 0.5 |r|^2 > thr and i < max,
// tested before each step), the same curvature guards (gamma = 0 when
// p.pA <= 1e-16; no momentum when the old r.r <= 1e-16), the same
// association (p * new_rz) / rz, v0 = 0 and r0 = p0 = b, and all rows step
// together until every row meets the threshold, as there.  The TPU kernel
// keeps A and the state in VMEM; here A stays in the 50 MB L2 (or in shared
// memory, below) and the grid meets at grid.sync() (never a hand-written
// barrier: cudaLaunchCooperativeKernel refuses a grid that cannot be
// resident instead of deadlocking).  No atomics: a solve run twice gives
// bitwise the same output.  Two paths, chosen by cggp_cg_plan:
//
// Tiled path (R > 8, the serving batch R = 8192 at M = 989).
//   What bounds it on an H100: per step the [R, M] x [M, M] product, three
//   TF32 passes on the tensor cores for fp32 accuracy: 3 x 2 R M^2 / 495
//   TFLOP/s = 0.099 ms, 19.5 ms over a 198-step solve (fp32 FMA outside the
//   tensor cores: 0.24 ms a step).  Bytes a step of this design: the
//   product reads p and writes pA, the row pass reads p, r, pA, v and
//   writes v, r, p: 9 R M x 4 B = 292 MB, 0.087 ms at 3.35 TB/s (17.2 ms a
//   solve); the split A (8 MB) stays in L2.  So the tensor cores bound it,
//   the bytes close behind.
//   What the design does:
//   * A is split once per solve into its TF32 halves (tiles::split_b_kernel,
//     launched just before the solve), 8 MB that stay in L2 for all ~200
//     steps.
//   * Phase A, pA = p @ A: 128 x 128 output tiles (row tile, column block),
//     64 x 8 = 512 at R = 8192, taken in turn by the persistent blocks (one
//     per SM: 150 KB of dynamic shared memory each for the ring, 64 KB more
//     for the outer depth sums) through the main loop B1 uses
//     (tiles::tiled_product, 3xTF32 wgmma, the depth summed at two levels,
//     every wgmma group waited for before the tile is stored).
//     grid.sync().
//   * Phase B, one warp per row: ONE set of cp.async copies stages the row's
//     p, r, pA and v in the block's shared memory (idle between products);
//     from there the warp takes p.pA, writes v and r and takes r.r, then
//     writes p = r + (p rz') / rz from the staged r and p.  Nothing is read
//     from global memory twice.  p.pA comes from the staged row, not from
//     partial sums in the product's epilogue: there, with the accumulators
//     live, the loads of p serialise (PERF.md, B2 findings).  Rows longer than
//     1024 are staged 1024 words at a time: p and pA once for p.pA, all four
//     again for the update, and the momentum update reads r and p from L2.
//   * The stop rule: each block writes "one of my rows is over" into its
//     own slot of a two-slot array indexed by the step's parity, then
//     grid.sync(); every block reads all slots and takes the same decision.
//     A slot is rewritten two steps later, after two more grid.sync()s, when
//     every read of it is done.  Two grid.sync()s a step.
//
// Small-R path (R <= 8, the pseudo-u solve R = 1).  Each step is bound by
//   the grid-wide synchronisation, not by flops (2 R M^2 = 2 MFLOP) or bytes
//   (r, 4 KB).  What the design does:
//   * Block g owns columns [g C, g C + C) of A, C = ceil(M / grid), for the
//     whole solve: A[:, cols] = A[cols, :] (symmetric) is copied once into
//     its shared memory (C = 8 at M = 989 on 132 SMs: 32 KB a block), the
//     counterpart of the TPU kernel keeping A in VMEM.  Where the slices
//     and p no longer fit a block's shared memory (cggp_cg_plan, from the
//     device's opt-in shared memory: above M = 2640 at R = 1 and M = 2244 at
//     R = 8 on an H100), the same kernel streams its columns of A from L2
//     instead (kResidentA = false); where p itself no longer fits (M above
//     ~7200 at R = 8), the solve takes the tiled path.
//   * Every block keeps all of p in shared memory and updates it itself,
//     p = r + (p rz') / rz, from r (read from L2) and scalars that every
//     block computes alike, so every copy of p is bitwise the same and p is
//     never exchanged.  v and r of a block's own columns stay in its shared
//     memory; only r goes to global memory, for the other blocks.
//   * Per step: p; pA of the own columns in fp32 FMA (warp per column, depth
//     over the lanes); each block's partial p.pA -> grid.sync() -> gamma from
//     all partials, added in block order by every block; v, r of the own
//     columns and each block's partial r.r -> grid.sync() -> r.r, again
//     added in block order, which also decides the stop rule.  Two
//     grid.sync()s a step, no flags.  On an H100 a grid.sync() of 124
//     blocks takes ~1.2 us: 0.57 ms of the 245-step pseudo-u solve's 2.6 ms
//     (chip_smoke.py's sync_floor_ms, a kernel doing only the same
//     grid.sync()s); the product's bound is 7 us a solve.
//
// Every read of state that another block wrote goes through L2 (ld.cg,
// cp.async.cg): L1 is not coherent across SMs.  The product is 3xTF32 on the
// tiled path; dots, updates and the small-R path are IEEE fp32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_matvec.cuh"

namespace cgrp = cooperative_groups;

namespace {

using cggp::tiles::kBlock;
using cggp::tiles::kThreads;

constexpr int kWarps = kThreads / 32;
constexpr float kMinFloat = 1e-16f;
constexpr int kSmallRows = 8;   // the small-R path takes R <= 8

enum Path { kTiled = 0, kSmallResident = 1, kSmallStreamed = 2 };

// Loads state that another block may have written since the last
// grid.sync(): through L2 (.cg), and volatile so that it is never hoisted
// across a grid.sync() or merged with an earlier load.
__device__ __forceinline__ float load_l2(const float* ptr) {
  float x;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(x) : "l"(ptr));
  return x;
}
__device__ __forceinline__ int load_l2(const int* ptr) {
  int x;
  asm volatile("ld.global.cg.s32 %0, [%1];\n" : "=r"(x) : "l"(ptr));
  return x;
}

// The warp's sum by butterfly: every lane ends with the same value (each
// step adds the same two operands in both lanes of a pair).
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
    any |= load_l2(slot + g);
  return __syncthreads_or(any);
}

// ---- Tiled path -----------------------------------------------------------------

// Phase B stages a row of p, r, pA and v in shared memory (the product's
// ring is idle then), kSeg words of each at a time: 16.5 KB a warp, 132 KB
// for the block's eight warps.
constexpr int kSeg = 1024;
constexpr int kSegWords = kSeg + 8;  // the 16-byte chunks covering kSeg words at any skew
static_assert(kWarps * 4 * kSegWords * sizeof(float) <= cggp::tiles::kSmemBytes,
              "phase B's row buffers fit the product's shared memory");

// Copies the aligned 16-byte chunks that cover x[start, start + len) of an
// array of `words` words into dst with cp.async.cg (through L2), one warp;
// returns the skew at which x[start] sits in dst.  Chunks past the array's
// end are cut short and zero-filled (src-size), as in tiles::load_p_tile.
__device__ __forceinline__ int stage_row(const float* x, size_t words, size_t start, int len,
                                         float* dst) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x) / 4;  // word address of x
  const uintptr_t end = base + words;
  const uintptr_t first = (base + start) & ~uintptr_t{3};
  const int skew = static_cast<int>((base + start) & 3);
  const float* aligned_x = reinterpret_cast<const float*>((base & ~uintptr_t{3}) * 4);
  const int chunks = (skew + len + 3) / 4;
  for (int ch = threadIdx.x % 32; ch < chunks; ch += 32) {
    const uintptr_t chunk = first + 4 * ch;
    const uintptr_t left = chunk < end ? end - chunk : 0;
    const int bytes = left >= 4 ? 16 : static_cast<int>(4 * left);
    cggp::tf32x3::cp_async_16(dst + 4 * ch,
                              bytes ? reinterpret_cast<const float*>(chunk * 4) : aligned_x, bytes);
  }
  return skew;
}

// Waits for this lane's copies, then makes every lane's visible to the warp.
__device__ __forceinline__ void staged() {
  cggp::tf32x3::cp_async_commit();
  cggp::tf32x3::cp_async_wait<0>();
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
    cg_tiled_kernel(const float* b, const uint32_t* b_split, float* v, float* r, float* p,
                    float* pa, float* rz, int* flags, int* steps, int rows, int m, float thr,
                    int max_iterations) {
  cgrp::grid_group grid = cgrp::this_grid();
  extern __shared__ __align__(1024) float smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int first_row = blockIdx.x * kWarps + warp;  // this warp's rows
  const int row_stride = gridDim.x * kWarps;
  const int col_blocks = cggp::tiles::col_blocks(m);
  const int units = (rows + kBlock - 1) / kBlock * col_blocks;
  const size_t words = static_cast<size_t>(rows) * m;
  float* s_p = smem + warp * 4 * kSegWords;  // this warp's row buffers
  float* s_r = s_p + kSegWords;
  float* s_pa = s_r + kSegWords;
  float* s_v = s_pa + kSegWords;
  const bool one_seg = m <= kSeg;

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
    if (lane == 0) rz[row] = bb;
    over |= 0.5f * bb > thr;
  }

  int it = 0;
  int any = any_over(grid, flags, 0, over);
  while (any && it < max_iterations) {
    // (A) pA = p @ A, one 128 x 128 tile per unit.
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      const int row0 = unit / col_blocks * kBlock;
      const int cb = unit % col_blocks;
      float acc[64];
      cggp::tiles::tiled_product(p, rows, m, b_split, col_blocks, cb, row0, smem, acc);
      cggp::tiles::store_tile(pa, rows, m, row0, cb * kBlock, acc);
    }
    grid.sync();

    // (B) per row, one warp: p, r, pA and v staged in shared memory by one
    // set of copies (M <= kSeg); p.pA, then v and r written and r.r, then p
    // written from the staged r and p.  Larger M stages kSeg words at a
    // time: p and pA once for p.pA, all four again for the update, and the
    // momentum update reads r and p once more from L2.
    over = 0;
    for (int row = first_row; row < rows; row += row_stride) {
      const size_t base = static_cast<size_t>(row) * m;
      int kp = 0, kr = 0, kpa = 0, kv = 0;  // skews of the staged rows
      float denom = 0.f;
      for (int seg0 = 0; seg0 < m; seg0 += kSeg) {
        const int len = min(kSeg, m - seg0);
        kp = stage_row(p, words, base + seg0, len, s_p);
        kpa = stage_row(pa, words, base + seg0, len, s_pa);
        if (one_seg) {
          kr = stage_row(r, words, base, m, s_r);
          kv = stage_row(v, words, base, m, s_v);
        }
        staged();
        for (int c = lane; c < len; c += 32) denom = fmaf(s_p[kp + c], s_pa[kpa + c], denom);
        __syncwarp();
      }
      denom = warp_sum(denom);
      const float rz_old = load_l2(rz + row);
      const float gamma = denom <= kMinFloat ? 0.f : rz_old / denom;
      float rz_new = 0.f;
      for (int seg0 = 0; seg0 < m; seg0 += kSeg) {
        const int len = min(kSeg, m - seg0);
        if (!one_seg) {
          kp = stage_row(p, words, base + seg0, len, s_p);
          kr = stage_row(r, words, base + seg0, len, s_r);
          kpa = stage_row(pa, words, base + seg0, len, s_pa);
          kv = stage_row(v, words, base + seg0, len, s_v);
          staged();
        }
        for (int c = lane; c < len; c += 32) {
          const float pc = s_p[kp + c];
          const float rc = s_r[kr + c] - gamma * s_pa[kpa + c];
          v[base + seg0 + c] = s_v[kv + c] + gamma * pc;
          r[base + seg0 + c] = rc;
          s_r[kr + c] = rc;  // read back below by this same lane
          rz_new = fmaf(rc, rc, rz_new);
        }
        __syncwarp();
      }
      rz_new = warp_sum(rz_new);
      const bool momentum = !(rz_old <= kMinFloat);
      for (int c = lane; c < m; c += 32) {
        const float pc = one_seg ? s_p[kp + c] : load_l2(p + base + c);
        const float rc = one_seg ? s_r[kr + c] : load_l2(r + base + c);
        p[base + c] = rc + (momentum ? (pc * rz_new) / rz_old : 0.f);
      }
      __syncwarp();  // the next row's copies overwrite the buffers
      if (lane == 0) rz[row] = rz_new;
      over |= 0.5f * rz_new > thr;
    }
    ++it;
    any = any_over(grid, flags, it & 1, over);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) steps[0] = it;
}

// ---- Small-R path ---------------------------------------------------------------

// Warp `row` (< rows) of every block adds part[0..count) [rows] in block
// order, lane-strided then by butterfly: every block gets the same value.
__device__ __forceinline__ float sum_partials(const float* part, int count, int rows, int row) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int g = lane; g < count; g += 32) s += load_l2(part + static_cast<size_t>(g) * rows + row);
  return warp_sum(s);
}

// Shared memory of a block: [cols][m] of A (kResidentA only), p [rows][m],
// then r, v and pA of the own columns, [rows][cols] each.
__host__ __device__ inline long long small_smem_words(int rows, int m, int cols, bool resident) {
  return (resident ? static_cast<long long>(cols) * m : 0) + static_cast<long long>(rows) * m +
         3LL * rows * cols;
}

template <bool kResidentA>
__global__ void __launch_bounds__(kThreads, 1)
    cg_small_kernel(const float* a, const float* b, float* v_out, float* r_all, float* part_pap,
                    float* part_rz, int* steps, int rows, int m, int cols, float thr,
                    int max_iterations) {
  cgrp::grid_group grid = cgrp::this_grid();
  extern __shared__ __align__(1024) float smem[];
  __shared__ float rz_s[kSmallRows], rz_old_s[kSmallRows], gamma_s[kSmallRows];
  float* a_s = smem;
  float* p_s = smem + (kResidentA ? static_cast<size_t>(cols) * m : 0);
  float* r_own = p_s + static_cast<size_t>(rows) * m;
  float* v_own = r_own + rows * cols;
  float* pa_own = v_own + rows * cols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * cols;
  const int own = max(0, min(cols, m - c0));  // columns this block owns
  const int blocks = gridDim.x;

  if (kResidentA) {
    const float* src = a + static_cast<size_t>(c0) * m;  // rows c0.. of A = its columns c0..
    for (int i = tid; i < own * m; i += kThreads) a_s[i] = __ldg(src + i);
  }
  for (int i = tid; i < rows * cols; i += kThreads) {
    const int rr = i / cols, c = i % cols;
    r_own[i] = c < own ? b[static_cast<size_t>(rr) * m + c0 + c] : 0.f;
    v_own[i] = 0.f;
  }
  __syncthreads();
  // This block's partial of rz0 = b.b over its own columns, in column order.
  const auto publish = [&](float* part, const float* x, const float* y) {
    if (warp < rows && lane == 0) {
      float s = 0.f;
      for (int c = 0; c < own; ++c) s = fmaf(x[warp * cols + c], y[warp * cols + c], s);
      part[static_cast<size_t>(blockIdx.x) * rows + warp] = s;
    }
  };
  publish(part_rz, r_own, r_own);
  if (tid < kSmallRows) rz_s[tid] = 0.f;
  grid.sync();

  int it = 0;
  while (true) {
    // r.r of the current r from every block's partial; the stop rule reads it.
    if (warp < rows) {
      const float rz = sum_partials(part_rz, blocks, rows, warp);
      if (lane == 0) {
        rz_old_s[warp] = rz_s[warp];
        rz_s[warp] = rz;
      }
    }
    __syncthreads();
    int over = 0;
    for (int rr = 0; rr < rows; ++rr) over |= 0.5f * rz_s[rr] > thr;
    if (!over || it >= max_iterations) break;  // the same decision in every block

    // p = r + (p rz) / rz_old, all of it, in every block alike (p0 = b).
    for (int i = tid; i < rows * m; i += kThreads) {
      const int rr = i / m;
      if (it == 0) {
        p_s[i] = b[i];
      } else {
        const float rv = load_l2(r_all + i);
        p_s[i] = rv + (rz_old_s[rr] <= kMinFloat ? 0.f : (p_s[i] * rz_s[rr]) / rz_old_s[rr]);
      }
    }
    __syncthreads();

    // pA of the own columns: a warp per column, the depth over its lanes.
    for (int c = warp; c < own; c += kWarps) {
      const float* col = kResidentA ? a_s + static_cast<size_t>(c) * m
                                    : a + static_cast<size_t>(c0 + c) * m;
      float acc[kSmallRows];
#pragma unroll
      for (int rr = 0; rr < kSmallRows; ++rr) acc[rr] = 0.f;
      for (int k = lane; k < m; k += 32) {
        const float av = kResidentA ? col[k] : __ldg(col + k);
#pragma unroll
        for (int rr = 0; rr < kSmallRows; ++rr)
          if (rr < rows) acc[rr] = fmaf(p_s[rr * m + k], av, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kSmallRows; ++rr) {
        const float s = warp_sum(acc[rr]);
        if (rr < rows && lane == 0) pa_own[rr * cols + c] = s;
      }
    }
    __syncthreads();
    if (warp < rows && lane == 0) {
      float s = 0.f;
      for (int c = 0; c < own; ++c) s = fmaf(p_s[warp * m + c0 + c], pa_own[warp * cols + c], s);
      part_pap[static_cast<size_t>(blockIdx.x) * rows + warp] = s;
    }
    grid.sync();

    if (warp < rows) {
      const float denom = sum_partials(part_pap, blocks, rows, warp);
      if (lane == 0) gamma_s[warp] = denom <= kMinFloat ? 0.f : rz_s[warp] / denom;
    }
    __syncthreads();
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int rr = i / cols, c = i % cols;
      if (c < own) {
        const float g = gamma_s[rr];
        v_own[i] = v_own[i] + g * p_s[rr * m + c0 + c];
        r_own[i] = r_own[i] - g * pa_own[i];
        r_all[static_cast<size_t>(rr) * m + c0 + c] = r_own[i];
      }
    }
    __syncthreads();
    publish(part_rz, r_own, r_own);
    ++it;
    grid.sync();
  }
  for (int i = tid; i < rows * own; i += kThreads) {
    const int rr = i / own, c = i % own;
    v_out[static_cast<size_t>(rr) * m + c0 + c] = v_own[rr * cols + c];
  }
  if (blockIdx.x == 0 && tid == 0) steps[0] = it;
}

// The same grid, doing nothing but `count` grid.sync()s: the floor the
// grid-wide synchronisation sets under a small-R step.
__global__ void __launch_bounds__(kThreads, 1) cg_sync_floor_kernel(int count) {
  cgrp::grid_group grid = cgrp::this_grid();
  for (int i = 0; i < count; ++i) grid.sync();
}

const void* kernel_of(int path) {
  switch (path) {
    case kTiled: return reinterpret_cast<const void*>(cg_tiled_kernel);
    case kSmallResident: return reinterpret_cast<const void*>(cg_small_kernel<true>);
    case kSmallStreamed: return reinterpret_cast<const void*>(cg_small_kernel<false>);
    default: return nullptr;
  }
}

int round4(long long words) { return static_cast<int>((words + 3) / 4 * 4); }

}  // namespace

// The launch of a solve of `rows` right-hand sides of length m on `device`:
// path (0 tiled, 1 small-R with A in shared memory, 2 small-R streaming A),
// cooperative grid, columns per block (small-R) and dynamic shared memory.
// The small-R path takes R <= 8 while p and the block's bookkeeping fit a
// block's shared memory; A's column slices go into it too while they fit
// (with 132 SMs, up to M = 2640 at R = 1 and 2244 at R = 8), else they are
// streamed from L2.  The attribute for the dynamic shared memory is set
// before the occupancy query, which is asked with the real size; a grid
// that cannot be resident is an error.
extern "C" int cggp_cg_plan(int rows, int m, int device, int* path, int* grid, int* cols,
                            long long* smem_bytes) {
  if (rows <= 0 || m <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // What a block of each small-R kernel may take besides its static shared
  // memory (which the dynamic part's 1024-byte alignment pads to 1 KB).
  const auto budget = [&](int path_id, long long* out) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_of(path_id));
    *out = optin - static_cast<long long>(attr.sharedSizeBytes);
    return e;
  };
  long long resident_budget = 0, streamed_budget = 0;
  if ((err = budget(kSmallResident, &resident_budget)) != cudaSuccess) return err;
  if ((err = budget(kSmallStreamed, &streamed_budget)) != cudaSuccess) return err;
  *path = kTiled;
  *cols = 0;
  *smem_bytes = static_cast<long long>(cggp::tiles::kSmemBytes + cggp::tiles::kOuterBytes);
  if (rows <= kSmallRows) {
    const int blocks = sms < m ? sms : m;
    const int c = (m + blocks - 1) / blocks;
    if (4 * small_smem_words(rows, m, c, true) <= resident_budget) {
      *path = kSmallResident;
    } else if (4 * small_smem_words(rows, m, c, false) <= streamed_budget) {
      *path = kSmallStreamed;
    }
    if (*path != kTiled) {
      *cols = c;
      *smem_bytes = 4 * small_smem_words(rows, m, c, *path == kSmallResident);
    }
  }
  const void* kernel = kernel_of(*path);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem_bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(*smem_bytes));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (*path == kTiled) {
    // Enough blocks for every tile unit or every row's warp, at most what
    // is resident (1 per SM at 214 KB: 132 on an H100).
    const int units = (rows + kBlock - 1) / kBlock * cggp::tiles::col_blocks(m);
    const int row_blocks = (rows + kWarps - 1) / kWarps;
    const int wanted = units > row_blocks ? units : row_blocks;
    *grid = wanted < per_sm * sms ? wanted : per_sm * sms;
  } else {
    *grid = (m + *cols - 1) / *cols;  // <= sms: every block owns columns
  }
  return cudaSuccess;
}

// Words of the solve's work buffer (16-byte aligned parts), and of the split
// A (tiled path only).
extern "C" long long cggp_cg_work_words(int rows, int m, int path, int grid) {
  const long long rm = round4(static_cast<long long>(rows) * m);
  if (path == kTiled) {
    return 3 * rm + round4(rows) + round4(2LL * grid);
  }
  return rm + 2LL * round4(static_cast<long long>(grid) * rows);
}

extern "C" long long cggp_cg_split_words(int m, int path) {
  return path == kTiled ? cggp::tiles::split_words(m) : 0;
}

// Solves v A = b.  work: cggp_cg_work_words words, b_split:
// cggp_cg_split_words words (tiled path), steps: one int.  The plan's
// arguments come from cggp_cg_plan for the same rows, m and device.
// Returns a cudaError_t: the argument check's, else the launch's, else
// cudaGetLastError() right after it.
extern "C" int cggp_pallas_cg_solve(const float* a, const float* b, float* v, float* work,
                                    void* b_split, int* steps, int rows, int m, float thr,
                                    int max_iterations, int path, int grid, int cols,
                                    long long smem_bytes, void* stream) {
  if (rows <= 0 || m <= 0 || grid <= 0 || max_iterations < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* kernel = kernel_of(path);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const long long rm = round4(static_cast<long long>(rows) * m);
  if (path == kTiled) {
    if (b_split == nullptr) return cudaErrorInvalidValue;
    uint32_t* split = static_cast<uint32_t*>(b_split);
    const dim3 split_grid(cggp::tiles::col_blocks(m), cggp::tiles::stages(m));
    cggp::tiles::split_b_kernel<<<split_grid, kThreads, 0, s>>>(a, m, split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const uint32_t* b_tiles = split;
    float* r = work;
    float* p = r + rm;
    float* pa = p + rm;
    float* rz = pa + rm;
    int* flags = reinterpret_cast<int*>(rz + round4(rows));
    void* args[] = {&b, &b_tiles, &v, &r, &p, &pa, &rz, &flags, &steps,
                    &rows, &m, &thr, &max_iterations};
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                      static_cast<size_t>(smem_bytes), s);
  } else {
    float* r_all = work;
    float* part_pap = r_all + rm;
    float* part_rz = part_pap + round4(static_cast<long long>(grid) * rows);
    void* args[] = {&a, &b, &v, &r_all, &part_pap, &part_rz, &steps,
                    &rows, &m, &cols, &thr, &max_iterations};
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                      static_cast<size_t>(smem_bytes), s);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `count` grid.sync()s on the grid and shared memory of a solve's plan.
extern "C" int cggp_cg_sync_floor(int grid, long long smem_bytes, int count, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(cg_sync_floor_kernel);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  void* args[] = {&count};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    static_cast<size_t>(smem_bytes),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
