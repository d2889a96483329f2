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
//  * the epilogue divides by the row sum and writes bf16 through o's strides;
//    in grad mode only (a second instance of the kernel, chosen by the
//    launch), it also writes the fp32 output and each row's base-2
//    log-sum-exp, which the backward (sra_attention_backward.cu) reads in
//    place of recomputing the softmax.  The inference launch passes no such
//    buffers and runs the instance without them;
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

#include "sm90_attention_tile.cuh"

namespace {

constexpr int D = 64;     // head dim (MiT: 64 at every stage)
constexpr int TQ = 64;    // queries per block
constexpr int TK = 64;    // keys per chunk

struct Strides {
  long long b, n, h;  // element strides; the head-dim stride is 1
};

// ---------------------------------------------------------------- bf16 body

namespace tc {

using namespace sm90;

constexpr int SMEM_BYTES = 5 * TILE * 2 + 1024;  // Q, K x2, V x2, 1024-byte alignment

// 128 registers: 4 blocks (16 warps) per SM.  STATS (grad mode only) also
// writes the fp32 output o32 (o's strides) and the base-2 log-sum-exp of
// each row's scaled logits, lse[(b * H + h) * N + row], for the backward;
// the inference instance (STATS false) is the kernel without them.
template <bool STATS>
__global__ void __launch_bounds__(NT, 4)
sra_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
                          float* __restrict__ lse, int N, int M, Strides qs, Strides ks,
                          Strides vs, Strides os, float scale_log2) {
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* Qs = align1024(smem_tc);
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
  fence_async_smem();
  __syncthreads();
  wg_fence();
  wgmma_ss_hd(s, dq, desc_sw128(Ks));
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
    split_frags(s, ph, pl);
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
      fence_async_smem();
      __syncthreads();
      wgmma_ss_hd(s, dq, desc_sw128(Ks + TILE - buf));
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
      if (STATS) {
        float* dst32 = o32 + b * os.b + h * os.h + (long long)row * os.n + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<float2*>(dst32 + dt * 8) =
              make_float2(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
        if (t4 == 0) lse[((long long)b * gridDim.y + h) * N + row] = m_run[r] + log2f(l);
      }
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
// multiples of 8, pointers 16-byte aligned.  o32 and lse: null, or (bf16
// only, the grad-mode forward) the fp32 output at o's strides and the
// (B, H, N) base-2 log-sum-exp of the rows of scale * log2(e) * q k^T, for
// the backward.  Returns cudaGetLastError().
extern "C" int sra_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* o32, void* lse, int is_bf16,
    int B, int N, int M, int H, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, void* stream) {
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TQ - 1) / TQ, H, B);
  if ((o32 != nullptr || lse != nullptr) && !(is_bf16 && o32 != nullptr && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  // the shared-memory attribute belongs to the current device: set it before
  // every launch so a process that launches on several cards gets it on each
  if (is_bf16) {
    const auto kernel = o32 != nullptr ? tc::sra_attention_kernel_bf16<true>
                                       : tc::sra_attention_kernel_bf16<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    // exp(x * scale) = exp2(x * scale * log2 e)
    kernel<<<grid, tc::NT, tc::SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(o32), static_cast<float*>(lse), N, M, qs, ks, vs, os,
        scale * 1.4426950408889634f);
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
