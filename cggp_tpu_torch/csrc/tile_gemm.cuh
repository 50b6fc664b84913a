// Shared 64 x 64 fp32 tile product used by both kernels of this package.
//
// acc = p[row0:row0+64, :] @ a[:, col0:col0+64] for row-major p [rows, m] and
// a [m, m], in IEEE fp32 FMA (no TF32, no tensor cores): 256 threads, each
// owning a 4 x 4 register block, over depth steps of 16 staged in shared
// memory.  Rows, columns and depth past the edge read as zero, so the result
// equals the product of the unpadded operands.
#pragma once

#include <cuda_runtime.h>

namespace cggp {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kTileDepth = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct __align__(16) TileSmem {
  // The p tile is stored depth-major so a thread reads its four rows as one
  // float4; the +4 pad keeps those rows 16-byte aligned and halves the bank
  // conflicts of the transposing store.
  float p[kTileDepth][kTileRows + 4];
  float a[kTileDepth][kTileCols];
};

// `p` is read with __ldcg (L2, not L1): in the CG kernel other blocks rewrite
// p between tile products, and L1 is not coherent across SMs.  `a` is
// read-only for every caller and goes through the read-only path.
__device__ __forceinline__ void tile_gemm(const float* p, const float* a, int rows, int m,
                                          int row0, int col0, TileSmem& s, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kTileDepth) {
    for (int e = tid; e < kTileRows * kTileDepth; e += kThreads) {
      const int i = e / kTileDepth;
      const int kk = e % kTileDepth;
      const int gr = row0 + i;
      const int gk = k0 + kk;
      s.p[kk][i] = (gr < rows && gk < m) ? __ldcg(p + static_cast<size_t>(gr) * m + gk) : 0.f;
    }
    for (int e = tid; e < kTileDepth * kTileCols; e += kThreads) {
      const int kk = e / kTileCols;
      const int j = e % kTileCols;
      const int gk = k0 + kk;
      const int gc = col0 + j;
      s.a[kk][j] = (gk < m && gc < m) ? __ldg(a + static_cast<size_t>(gk) * m + gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileDepth; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&s.p[kk][ty * 4]);
      const float4 av = *reinterpret_cast<const float4*>(&s.a[kk][tx * 4]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pr[i], ar[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Writes the thread's 4 x 4 block of a tile product into out [rows, m].
__device__ __forceinline__ void store_tile(float* out, int rows, int m, int row0, int col0,
                                           float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < m) out[static_cast<size_t>(gr) * m + gc] = acc[i][j];
    }
  }
}

}  // namespace cggp
