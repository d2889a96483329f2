// Spatial-reduction attention forward for MiT blocks, softmax(q k^T * scale) v.
//
// Replaces the TPU kernel refign_tpu/ops/attention.py:fused_small_kv_attention
// (Pallas body _make_kernel).  Same numerics as that kernel: fp32 logits with
// the true row max, fp32 softmax, products of the storage type summed in fp32.
//
// What bounds it on an H100: bytes.  Per (batch, head) the work is 4*N*M*D
// flops over (2*N + 2*M)*D elements; at the MiT-B5 shapes (N = 289..18225,
// M = 256..289, D = 64) that is ~130 flops per byte in bf16, under the card's
// ridge of ~295 at the bf16 tensor-core rate, so the least time is the bytes
// of q, k, v and o over 3.35 TB/s: 0.957 ms per HRDA* forward (52 launches).
//
// Two bodies, chosen by the storage type (a dispatch, not a fallback):
//
// bf16 (the HRDA* path), FlashAttention-2 style on Hopper's wgmma:
//  * one block, one warpgroup (4 warps), per (64-query tile, head, batch);
//    warp w holds query rows 16w..16w+15 of every product; q, k, v and o go
//    through their (B, N, H, D) strides, so k/v may be the two halves of one
//    fused kv projection and nothing is copied;
//  * the Q tile and K/V in 64-key chunks are staged with 16-byte cp.async,
//    K/V double-buffered (a chunk loads while the one before computes), as 64 x
//    128-byte tiles in the 128-byte swizzle the wgmma descriptors name, in
//    41 KB of shared memory.  All of K/V (~74 KB at M = 289) would fit too,
//    but would cut the blocks per SM from 4 to 2 for no less traffic.  Keys
//    and queries past the end are zero-filled (src-size 0), keys masked to
//    -inf in the logits;
//  * S = Q K^T: four wgmma m64n64k16 per chunk, Q and K both read from
//    shared memory.  bf16 x bf16 products are exact in fp32, so the logits
//    are the fp32 logits up to summation order; the scale is applied to the
//    fp32 logits, folded with log2 e into the MUFU exp2;
//  * online softmax in registers: the accumulator holds rows g and g+8 of
//    each warp's 16 in 4 lanes, whose max and sum are reduced with
//    __shfl_xor_sync; no logits in shared memory;
//  * O += P V with P split into bf16 hi + lo, two wgmma into one fp32
//    accumulator for each 16 keys: ~16 bits of P, so the result is the
//    fp32-probability product within fp32 noise (one bf16 P would add
//    ~2^-9 |p| |v| per term, beyond the 2^-8 |o| + 1e-4 limit).  The S
//    accumulator layout is wgmma's register A-operand layout, so P never
//    leaves registers; V is read MN-major (transposed) from its tile, and
//    16-key steps wholly past M are skipped;
//  * the epilogue divides by the row sum and writes bf16 through o's strides.
//  * software pipeline: S of chunk c+1 is issued behind PV of chunk c.
// What holds it back: the softmax and the split of each chunk run on the
// CUDA cores between its S and its PV, so a block's tensor work waits for
// them; 4 blocks per SM (128 registers) interleave.  The split costs a
// third more tensor work than one bf16 P.
//
// fp32 (the precision checks): the CUDA-core body, one block of 256 threads
// per (64-query tile, head, batch), a 4x4 register tile of logits and of the
// output per thread, logits and probabilities through shared memory.  TF32
// tensor cores would not hold the 1e-5 fp32 limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;     // head dim (MiT: 64 at every stage)
constexpr int TQ = 64;    // queries per block
constexpr int TK = 64;    // keys per chunk

struct Strides {
  long long b, n, h;  // element strides; the head-dim stride is 1
};

// ---------------------------------------------------------------- bf16 body

namespace tc {

constexpr int NT = 128;                          // one warpgroup: 4 warps x 16 query rows
constexpr int TILE = 64 * 64;                    // bf16 of one 64 x 128-byte tile
constexpr int SMEM_BYTES = 5 * TILE * 2 + 1024;  // Q, K x2, V x2, 1024-byte alignment

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

// Stage rows [r0, r0+64) of a (rows, 64) bf16 slab with row stride `ld` as
// a 64 x 128-byte tile in the 128-byte swizzle that wgmma reads: the
// 16-byte group gi of row r sits at group gi ^ (r % 8), so the 8 rows of a
// core matrix fall in distinct banks.  Rows at or beyond `nrows` are
// zero-filled.  A warp takes 4 whole rows.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ base, long long ld,
                                      int r0, int nrows, __nv_bfloat16* dst) {
#pragma unroll
  for (int it = 0; it < (64 * D / 8) / NT; ++it) {
    const int vi = threadIdx.x + it * NT;
    const int row = vi >> 3, gi = vi & 7;
    const bool ok = r0 + row < nrows;
    cp_async16(dst + row * 64 + ((gi ^ (row & 7)) << 3),
               base + (ok ? (long long)(r0 + row) * ld : 0) + gi * 8, ok);
  }
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

// 128 registers: 4 blocks (16 warps) per SM
__global__ void __launch_bounds__(NT, 4)
sra_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int N, int M, Strides qs,
                          Strides ks, Strides vs, Strides os, float scale_log2) {
  extern __shared__ uint4 smem_tc[];
  // 1024-byte aligned tiles: the swizzle pattern repeats every 1024 bytes
  const uint32_t base_s = smem_u32(smem_tc);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem_tc) + (((base_s + 1023) & ~1023u) - base_s));
  __nv_bfloat16* Ks = Qs + TILE;      // two buffers
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // two buffers

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int nchunk = (M + TK - 1) / TK;

  stage(qb, qs.n, q0, N, Qs);
  stage(kb, ks.n, 0, M, Ks);
  stage(vb, vs.n, 0, M, Vs);
  cp_async_commit();

  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const uint64_t dq = desc_sw128(Qs);

  // S = Q K^T over four k16 steps of the head dim (32 bytes each; the
  // first overwrites s).  S of chunk c+1 is computed while P V of chunk c
  // runs, and chunk c+2 loads into the buffers chunk c used.
  float s[TK / 8][4];
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  wg_fence();
  const uint64_t dk0 = desc_sw128(Ks);
#pragma unroll
  for (int ks4 = 0; ks4 < D / 16; ++ks4) wgmma_ss(s, dq + 2 * ks4, dk0 + 2 * ks4, ks4 > 0);
  wg_commit();
  if (nchunk > 1) {
    stage(kb, ks.n, TK, M, Ks + TILE);
    stage(vb, vs.n, TK, M, Vs + TILE);
    cp_async_commit();
  }
  wg_wait0();
  for (int c = 0; c < nchunk; ++c) {
    const int buf = (c & 1) * TILE;
    // scale into the log2 domain; mask keys past M on the ragged last chunk
    const int kvalid = M - c * TK;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= scale_log2;
        if (kvalid < TK && nt * 8 + t4 * 2 + (e & 1) >= kvalid) s[nt][e] = -INFINITY;
      }
    // online softmax for rows g (r = 0, elements 0-1) and g+8 (r = 1, 2-3)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);  // finite: every chunk has a key
      alpha[r] = ex2(m_run[r] - m_new);         // 0 on the first chunk
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
        s[nt][2 * r] = ex2(s[nt][2 * r] - m_new);  // masked keys give 0
        s[nt][2 * r + 1] = ex2(s[nt][2 * r + 1] - m_new);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }
    // O += P_hi V + P_lo V; the S tiles 2kk, 2kk+1 are the A fragment of
    // keys 16kk.., rows 16kk.. of V (2048 bytes, 128 descriptor units)
    uint32_t ph[TK / 16][4], pl[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      split2(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    const uint64_t dv = desc_sw128(Vs + buf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      if (kk * 16 >= kvalid) break;  // these 16 keys are all past M
      wgmma_rs(oacc, ph[kk], dv + 128 * kk);
      wgmma_rs(oacc, pl[kk], dv + 128 * kk);
    }
    wg_commit();
    if (c + 1 < nchunk) {
      cp_async_wait_all();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint64_t dk = desc_sw128(Ks + TILE - buf);
#pragma unroll
      for (int ks4 = 0; ks4 < D / 16; ++ks4) wgmma_ss(s, dq + 2 * ks4, dk + 2 * ks4, ks4 > 0);
      wg_commit();
    }
    wg_wait0();
    __syncthreads();  // buffer `buf` is free
    if (c + 2 < nchunk) {
      stage(kb, ks.n, (c + 2) * TK, M, Ks + buf);
      stage(vb, vs.n, (c + 2) * TK, M, Vs + buf);
      cp_async_commit();
    }
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < N) {
      __nv_bfloat16* dst = ob + (long long)row * os.n + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------- fp32 body

namespace f32 {

constexpr int NT = 256;   // threads per block
constexpr int LDS = 68;   // row stride of the logits tile S[q][k]
constexpr int LDP = 72;   // row stride of the probabilities Pt[k][q]
constexpr int SMEM_FLOATS = D * TQ + D * TK + TK * D + TQ * LDS + TK * LDP + 3 * TQ;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

// Load rows [r0, r0+64) of a (rows, D) slab with row stride `ld`; rows at or
// beyond `nrows` read as zero.  Vector v of 512 covers row (v % 64) or
// (v / 8) and 8 consecutive head-dim elements.
template <bool TRANSPOSE>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, long long ld, int r0,
                                          int nrows, float* __restrict__ dst) {
#pragma unroll
  for (int it = 0; it < (64 * D / 8) / NT; ++it) {
    const int vi = threadIdx.x + it * NT;
    // transposed tiles: a warp takes 32 rows of one 8-column group, so the
    // scalar shared stores dst[d][row] hit 32 banks; row-major tiles: a warp
    // takes 4 whole rows, so the global reads coalesce
    const int row = TRANSPOSE ? (vi % 64) : (vi / 8);
    const int d0 = TRANSPOSE ? (vi / 64) * 8 : (vi % 8) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (r0 + row < nrows) {
      const float4* src = reinterpret_cast<const float4*>(base + (long long)(r0 + row) * ld + d0);
      a = src[0];
      c = src[1];
    }
    if (TRANSPOSE) {
      const float r[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(d0 + e) * 64 + row] = r[e];
    } else {
      float4* out = reinterpret_cast<float4*>(dst + row * D + d0);
      out[0] = a;
      out[1] = c;
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
sra_attention_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o, int N, int M,
                          Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][TQ]
  float* Kt = Qt + D * TQ;                        // [D][TK]
  float* Vs = Kt + D * TK;                        // [TK][D]
  float* S = Vs + TK * D;                         // [TQ][LDS]
  float* Pt = S + TQ * LDS;                       // [TK][LDP]
  float* row_m = Pt + TK * LDP;                   // running max per query
  float* row_l = row_m + TQ;                      // running sum per query
  float* row_a = row_l + TQ;                      // rescale of this chunk

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  // register tiles: rows tq*4.., columns (keys, then head dims) tc*4..
  const int tq = tid / 16, tc = tid % 16;
  // softmax: 4 threads per query row, thread ss takes keys ss + 4t
  const int sr = tid / 4, ss = tid % 4;

  if (tid < TQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  load_tile<true>(qb, qs.n, q0, N, Qt);

  float oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;

  for (int c0 = 0; c0 < M; c0 += TK) {
    __syncthreads();  // the previous chunk's P.V is done with Kt, Vs, Pt
    load_tile<true>(kb, ks.n, c0, M, Kt);
    load_tile<false>(vb, vs.n, c0, M, Vs);
    __syncthreads();

    // S = (Q K^T) * scale for this thread's 4x4 tile
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * TQ + tq * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * TK + tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(av[i], cv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&S[(tq * 4 + i) * LDS + tc * 4]) =
          make_float4(sacc[i][0] * scale, sacc[i][1] * scale, sacc[i][2] * scale,
                      sacc[i][3] * scale);
    __syncthreads();

    // online softmax over this chunk's 64 keys of row sr
    {
      const float m_old = row_m[sr];
      float vals[16];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int kk = ss + 4 * t;
        vals[t] = (c0 + kk < M) ? S[sr * LDS + kk] : -INFINITY;
        mx = fmaxf(mx, vals[t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);  // finite: every chunk has a key
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float p = expf(vals[t] - m_new);  // masked keys give 0
        Pt[(ss + 4 * t) * LDP + sr] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (ss == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first chunk
        row_a[sr] = alpha;
        row_l[sr] = row_l[sr] * alpha + sum;
        row_m[sr] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[tq * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) oacc[i][j] *= a;
    }
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * LDP + tq * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Vs[kk * D + tc * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) oacc[i][j] = fmaf(pv[i], cv[j], oacc[i][j]);
    }
  }
  __syncthreads();  // row_l of the last chunk

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tq * 4 + i;
    if (row < N) {
      const float inv = 1.f / row_l[tq * 4 + i];
      *reinterpret_cast<float4*>(ob + (long long)row * os.n + tc * 4) =
          make_float4(oacc[i][0] * inv, oacc[i][1] * inv, oacc[i][2] * inv, oacc[i][3] * inv);
    }
  }
}

}  // namespace f32

}  // namespace

// q (B,N,H,64), k/v (B,M,H,64), o (B,N,H,64), all of one type (fp32, or
// bf16 when is_bf16), head-dim stride 1, other strides in elements and
// multiples of 8, pointers 16-byte aligned.  Returns cudaGetLastError().
extern "C" int sra_attention_forward(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B, int N,
    int M, int H, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, void* stream) {
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TQ - 1) / TQ, H, B);
  // the shared-memory attribute belongs to the current device: set it before
  // every launch so a process that launches on several cards gets it on each
  if (is_bf16) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::sra_attention_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    // exp(x * scale) = exp2(x * scale * log2 e)
    tc::sra_attention_kernel_bf16<<<grid, tc::NT, tc::SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, M, qs, ks,
        vs, os, scale * 1.4426950408889634f);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        f32::sra_attention_kernel_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f32::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    f32::sra_attention_kernel_fp32<<<grid, f32::NT, f32::SMEM_BYTES, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), N, M, qs, ks, vs, os, scale);
  }
  return (int)cudaGetLastError();
}
