// Shared 3xTF32 tensor-core core of kernels B1 (pallas_matvec.cu) and B3
// (pallas_gram.cu): fp32-accurate products on Hopper's warpgroup MMA.
//
// Split.  Each fp32 operand x is split into two TF32 values,
//   hi = tf32(x),  lo = tf32(x - hi)      (round to nearest, ties away),
// so x = hi + lo to ~22 significant bits, and each product is taken as
//   lo_a hi_b + hi_a lo_b + hi_a hi_b
// (lo lo, ~2^-22 of the product, is dropped), the small products first.  One TF32 pass
// keeps ~3 decimal digits; three passes give fp32-level error at three times
// the work, and the H100 runs dense TF32 at 495 TFLOP/s against 67 TFLOP/s
// of fp32 FMA outside the tensor cores.  No other TF32 is used.
//
// Accumulation.  The tensor cores' internal fp32 sum is not guaranteed to
// round to nearest (Ootomo and Yokota, 2022, found it truncates on A100), and
// a sum kept on them over M = 1e3-1e4 terms would drift.  So each 32-deep
// stage (twelve wgmmas: three passes x four 8-deep steps) is summed on the
// tensor cores from zero in two parts (issue_stage, finish_stage), each
// added to the running sum with IEEE fp32 adds outside them: the truncation
// touches two 8-deep steps' large products at a time.  For data of one sign
// it is a bias, and the ELBO's predictive variances, Kmn^T (Kmm + Lambda)^-1
// Kmn subtracted from the prior's, magnify it.  The first training step's
// loss from fp64, over fp32's (chip_smoke.py on an H100): a whole stage in
// one part 4.4x, in two parts 1.8x at no cost to B1 and B2 (+4 % on B3),
// in four parts (one large product each) 1.5x for 7-8 % more time.
// Nothing is atomic; the results are deterministic.
//
// Instruction: wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32, A from
// registers (the mma.m16n8k8 A layout per warp of the warpgroup), B from
// shared memory through a 128-byte-swizzle K-major descriptor.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cggp {
namespace tf32x3 {

constexpr int kStageDepth = 32;  // depth of one stage tile (four 8-deep wgmma steps)

// tf32(x), as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero),
// in two integer ops on the bit pattern: add half of the 13 dropped bits'
// range, clear them.  The cvt instruction runs at the conversion rate (16
// per clock per SM); the integer ops at 64.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo (+ ~2^-22 |x|), both TF32 bit patterns.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// 4-byte asynchronous copy global -> shared; when `valid` is false nothing
// is read (src-size 0) and the shared word is zero-filled.
__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_size)
               : "memory");
}

// 16-byte asynchronous copy of `bytes` (0..16) valid bytes from a 16-byte
// aligned global address; the rest of the 16 shared bytes is zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- Stage tiles ---------------------------------------------------------------
//
// A stage tile is [128 rows][32 depths] of 4-byte words: one 128-byte row
// per row, in the 128-byte-swizzle K-major layout of wgmma and of TMA's
// SWIZZLE_128B (16-byte chunk c of row n stored at chunk c ^ (n % 8); 8-row
// groups kSbo = 1024 bytes apart; tiles 1024-byte aligned).  Walking a
// tile's words in order, a warp covers one row: copies into it read 128
// contiguous bytes of global memory, and passes over it are free of bank
// conflicts.
constexpr int kTileRows = 128;
constexpr int kTileWords = kTileRows * kStageDepth;  // 4096
constexpr uint32_t kSbo = 8 * 128;                    // bytes: next 8 rows

__device__ __forceinline__ int tile_offset(int n, int k) {
  return (n << 5) + ((((k >> 2) ^ n) & 7) << 2) + (k & 3);
}

// Row and depth of word o of a stage tile (the inverse of tile_offset).
__device__ __forceinline__ int tile_row(int o) { return o >> 5; }
__device__ __forceinline__ int tile_depth(int o) {
  return ((((o >> 2) ^ (o >> 5)) & 7) << 2) + (o & 3);
}

// Shared-memory descriptor of the 8-deep slice at depth k of a swizzled
// K-major tile: start address (advanced by 4 k bytes inside the 128-byte
// rows; the hardware applies the swizzle to the absolute address), the
// leading offset (unused by this layout: 1), the 8-row stride and the
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const uint32_t* tile, int k) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile)) + 4 * k;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32) | (uint64_t{1} << 62);
}

// d = A B (+ d when accumulate != 0) for a 64 x 128 x 8 step of a
// warpgroup: A (TF32) in registers in the mma.m16n8k8 A layout per warp
// (rows 16 w + g, + 8; depths t, t + 4), B (TF32) in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// mbarriers and TMA copies (sm_90).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once on the barrier and expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbarrier_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA copy of the box at (x, y) (x the inner coordinate) of the tensor
// behind `map` into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// Moves this warpgroup's register allocation to kRegs per thread (setmaxnreg:
// warpgroups that give up registers must do so before others can take them).
template <int kRegs, bool kIncrease>
__device__ __forceinline__ void set_max_registers() {
  if constexpr (kIncrease) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  }
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One warpgroup's 3xTF32 product of a 32-deep stage, A rows wg_row0.. read
// through a_value(row, depth) (fp32, from shared memory), B split in b_hi /
// b_lo, added to acc in two parts, each summed on the tensor cores from
// zero and added with IEEE fp32 adds:
//   the eight small products A_lo B_hi + A_hi B_lo of the stage's four
//   8-deep steps and the first two steps' A_hi B_hi (issue_stage), then
//   A_hi B_hi of the last two steps (finish_stage).
// The tensor cores' sum truncates, and for data of one sign (kernel values)
// truncation is a bias, not noise: ~0.5 ulp of the running sum lost, in the
// same direction, on every add.  Keeping each part's sum to two 8-deep
// steps puts those losses at the ulp of a 16-deep partial, not of a
// growing 32-deep one (the small products go first, while the sum is
// small).  issue_stage's products run asynchronously: the A registers and
// `part` stay untouched until finish_stage has waited for them.  A warp
// that issues a wgmma waits until the tensor cores take it, so the issuing
// warps are busy for most of the stage's tensor-core time: other work goes
// to other warps.
struct StageRegs {
  float part[64];
  uint32_t a_hi[kStageDepth / 8][4];
  uint32_t a_lo[kStageDepth / 8][4];
};

template <class AValue>
__device__ __forceinline__ void issue_stage(AValue a_value, const uint32_t* b_hi,
                                            const uint32_t* b_lo, int wg_row0, StageRegs& st) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r = wg_row0 + 16 * ((threadIdx.x % 128) / 32) + g;
#pragma unroll
  for (int s = 0; s < kStageDepth / 8; ++s) {
    split(a_value(r, 8 * s + t), st.a_hi[s][0], st.a_lo[s][0]);
    split(a_value(r + 8, 8 * s + t), st.a_hi[s][1], st.a_lo[s][1]);
    split(a_value(r, 8 * s + t + 4), st.a_hi[s][2], st.a_lo[s][2]);
    split(a_value(r + 8, 8 * s + t + 4), st.a_hi[s][3], st.a_lo[s][3]);
  }
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

// Waits for the products in flight and adds part to acc with IEEE fp32
// adds.  The empty asm statements pin part and the A registers across the
// asynchronous wgmma: the compiler may neither read part early nor reuse
// the A registers.
__device__ __forceinline__ void add_part(StageRegs& st, float (&acc)[64]) {
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(st.part[i])::"memory");
#pragma unroll
  for (int s = 0; s < kStageDepth / 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm volatile("" : "+r"(st.a_hi[s][i]), "+r"(st.a_lo[s][i])::"memory");
    }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], st.part[i]);
}

// Adds issue_stage's part to acc, then the large products of the stage's
// last two 8-deep steps (b_hi must still hold the stage).
__device__ __forceinline__ void finish_stage(StageRegs& st, const uint32_t* b_hi,
                                             float (&acc)[64]) {
  add_part(st, acc);
  wgmma_fence();  // part was read: order that before the tensor cores write it
  wgmma_tf32(st.part, st.a_hi[2], wgmma_desc(b_hi, 16), 0);
  wgmma_tf32(st.part, st.a_hi[3], wgmma_desc(b_hi, 24), 1);
  wgmma_commit();
  add_part(st, acc);
}

}  // namespace tf32x3
}  // namespace cggp
