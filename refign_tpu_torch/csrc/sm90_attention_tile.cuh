// Building blocks shared by K1's bf16 forward (sra_attention.cu) and backward
// (sra_attention_backward.cu) bodies on Hopper: one warpgroup (128 threads)
// per block, 64 x 64 bf16 tiles (64 rows of one 128-byte head-dim row each)
// staged by 16-byte cp.async in the 128-byte swizzle, and wgmma m64n64k16
// with fp32 accumulators, A from shared memory or from registers.
//
// Accumulator layout of a wgmma m64n64 (per warp w of the warpgroup, lane
// 4g + t4): d[nt][e] is row 16w + g + 8 * (e >> 1), column nt * 8 + 2 * t4 +
// (e & 1).  The A-operand register layout of a k16 step kk is the same
// pairs of the accumulator tiles 2kk and 2kk + 1, so a product's result
// feeds the next product from registers (split_frags).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int NT = 128;       // one warpgroup: 4 warps x 16 rows
constexpr int HD = 64;        // head dim, and rows and columns of a tile
constexpr int TILE = 64 * 64; // bf16 of one 64 x 128-byte tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the staged tiles, written by cp.async, become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the MUFU unit (relative error ~2^-22); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// An accumulator x[8][4] as the bf16 hi and lo A operands of four k16 steps
// (the accumulator's columns are the next product's k dimension).
__device__ __forceinline__ void split_frags(const float (&x)[8][4], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split2(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split2(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// Stage rows [r0, r0+64) of a (rows, 64) bf16 slab with row stride `ld` as
// a 64 x 128-byte tile in the 128-byte swizzle that wgmma reads: the
// 16-byte group gi of row r sits at group gi ^ (r % 8), so the 8 rows of a
// core matrix fall in distinct banks.  Rows at or beyond `nrows` are
// zero-filled.  A warp takes 4 whole rows.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ base, long long ld,
                                      int r0, int nrows, __nv_bfloat16* dst) {
#pragma unroll
  for (int it = 0; it < (64 * HD / 8) / NT; ++it) {
    const int vi = threadIdx.x + it * NT;
    const int row = vi >> 3, gi = vi & 7;
    const bool ok = r0 + row < nrows;
    cp_async16(dst + row * 64 + ((gi ^ (row & 7)) << 3),
               base + (ok ? (long long)(r0 + row) * ld : 0) + gi * 8, ok);
  }
}

// The first 1024-byte aligned address of dynamic shared memory: the swizzle
// pattern repeats every 1024 bytes.
__device__ __forceinline__ __nv_bfloat16* align1024(void* smem) {
  const uint32_t s = smem_u32(smem);
  return reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) +
                                          (((s + 1023) & ~1023u) - s));
}

// wgmma shared-memory matrix descriptor of a tile above: start address,
// 8-row groups 1024 bytes apart (the leading and the stride byte offset; a
// 64-element-wide tile uses only one of them), 128-byte swizzle.  A k16
// step adds 32 bytes (2 units) along a K-major row, 16 rows (2048 bytes,
// 128 units) down an MN-major tile.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_D32(d)                                                                        \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),             \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),             \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),             \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),             \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

#define WG_REGS32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A from registers (per warp, the mma.m16n8k16 A-fragment
// layout), B from shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d = A B^T over the 64-wide head dim: four k16 steps, A and B both K-major
// tiles (the first step overwrites d)
__device__ __forceinline__ void wgmma_ss_hd(float (&d)[8][4], uint64_t da, uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) wgmma_ss(d, da + 2 * ks, db + 2 * ks, ks > 0);
}

}  // namespace sm90
