// Backward of K1: spatial-reduction attention, o = softmax(scale * q k^T) v with fp32
// logits, on (B, N, H, 64) queries and (B, M, H, 64) keys and values.
//
// Replaces the backward of the TPU kernel's custom_vjp, refign_tpu/ops/attention.py:
// _attn_fused_bwd (the VJP of the fp32 einsum formulation _attn_einsum_fp32; the Pallas
// kernel fused_small_kv_attention has no backward of its own).  With
// P = softmax(scale * q k^T) and the output gradient dO:
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - Delta),  Delta = rowsum(P o dP),
//   dQ = scale * dS K,   dK = scale * dS^T Q.
// Delta equals rowsum(dO o O) for the unrounded fp32 O.  dQ, dK and dV are rounded once
// to the storage type.  q, k, v and dO are read through their (B, N or M, H) strides, so
// k and v may be the two halves of one fused kv projection; the outputs are written
// through theirs.  dK and dV sum over all N queries: the query tiles are split into
// groups that fill the card, each writes fp32 partials, and attn_bwd_reduce adds them in
// split order (deterministic, no atomics), scales dK, casts, and writes dK and dV.
//
// What bounds it on an H100: operations.  The function needs five products of
// 2*N*M*64 flops per (batch, head) (S, dP, dQ, dK, dV).
//
// Two bodies, chosen by the storage type (a dispatch, not a fallback):
//
// bf16 (the train step's path), on Hopper's wgmma with the forward's statistics.  K1's
// grad-mode forward (sra_attention.cu) writes the fp32 output O and the base-2
// log-sum-exp of each row, so P = exp2(scale * log2(e) * S - lse) needs no pass over the
// keys for the row max and sum, and Delta = rowsum(dO o O) is one pass over the head dim.
// Delta comes from the fp32 O, not the bf16 output: the rounding of the bf16 O puts
// gradients beyond the bf16 limit (tests/test_torch_attention_bwd_numerics.py, which
// emulates this arithmetic and holds it to the limit on the CPU).  Both kernels use one
// warpgroup (128 threads) per block and the forward's tiles: 64 x 128-byte bf16 tiles in
// the 128-byte swizzle, staged by 16-byte cp.async and double-buffered, products on
// wgmma m64n64k16 with fp32 accumulators.  The accumulator of S (and of dP) is the
// register A-operand layout of the next product, so P and dS never leave registers; they
// enter their products as bf16 hi + lo pairs (two wgmma each), since one bf16 P or dS
// breaks the limit (the same tests).  With one key (M = 1) the softmax is the constant
// 1 and dS is 0 exactly, which both kernels set rather than leave dP - Delta's
// rounding.
//  1. attn_bwd_dq_bf16: one block per (64-query tile, head, batch).  Its prologue forms
//     Delta for its rows from dO and O (fp32, two threads a row) and writes it for kernel
//     2.  Over the 64-key chunks: S = Q K^T, dP = dO V^T (four k16 steps each, both
//     operands from shared memory), P and dS in registers, dQ += dS K (K read MN-major),
//     with S and dP of chunk c+1 issued behind dQ of chunk c.  Writes dQ once.
//  2. attn_bwd_dkdv_bf16: one block per (64-key tile, query split, head, batch).  Over
//     the 64-query tiles of its split, Q, dO and their lse and Delta double-buffered:
//     S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in registers, dV += P^T dO and
//     dK += dS^T Q (dO and Q read MN-major), with the next tile's S^T and dP^T issued
//     behind them.  Writes one fp32 partial of dK and of dV per split.
// So the kernels do 10 products of 2*N*M*64 per (batch, head) at the bf16 rate: S and dP
// in both kernels, and dQ, dK and dV twice each for the hi + lo split.
//
// fp32 (the precision checks), on the CUDA cores: the statistics are recomputed, so the
// forward's fp32 launch is unchanged.  Three kernels, on 64 x 64 fp32 tiles in shared
// memory (row stride 65, so that both the row-wise and the column-wise reads of a tile
// are free of bank conflicts).  A block has 256 threads; thread (ty, tx) of a 16 x 16
// grid holds a 4 x 4 register tile of rows ty + 16 i and columns tx + 16 j of each
// product, and the 16 threads of a row reduce with __shfl_xor_sync.
//  1. attn_bwd_dq: one block per (64-query tile, head, batch).  Pass 1 over the 64-key
//     chunks: the row max and the sum of exp (online).  Pass 2: P and dP, Delta.  Pass 3:
//     dS into shared memory, dQ += dS K.  Writes dQ, and the row max, the reciprocal row
//     sum and Delta (fp32) for kernel 2.
//  2. attn_bwd_dkdv: one block per (64-key tile, query split, head, batch).  Over the
//     64-query tiles of its split: P from the stored row statistics, dP, dS;
//     dV += P^T dO and dK += dS^T Q in registers.  Writes fp32 partials, one per split.
// That is ten products, S twice more and dP once more than the bf16 body, at the fp32
// rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_attention_tile.cuh"

namespace {

constexpr int D = 64;     // head dim (MiT: 64 at every stage)
constexpr int RNT = 256;  // threads per block of the reduce

struct Strides {
  long long b, n, h;  // element strides; the head-dim stride is 1
};

struct Args {
  const void *q, *k, *v, *dout;
  // bf16 body: the grad-mode forward's fp32 output, (B, N, H, 64) contiguous, and the
  // base-2 log-sum-exp of each row, (B*H, N); null for fp32
  const float *o32, *lse;
  void *dq, *dk, *dv;
  // stats: fp32 (3, B*H, N) row max, 1/row sum, Delta; bf16 (B*H, N) Delta.
  // part: 2 x (nsplit, B*H, M, D), dK's partials then dV's
  float *stats, *part;
  int B, N, M, H, nsplit;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------- fp32 body

namespace f32 {

constexpr int T = 64;          // queries and keys per tile
constexpr int LD = T + 1;      // shared-memory row stride in floats
constexpr int NT = 256;        // threads per block
constexpr int TILE = T * LD;   // floats of one tile
constexpr int SMEM_BYTES = (5 * TILE + 3 * T) * 4;

// rows r0.. r0+63 of a (rows, 64) slab at src (row stride rs) into a tile as fp32; rows at
// or past `rows` are zero
template <typename E>
__device__ __forceinline__ void load_tile(float* tile, const E* src, long long rs, int r0,
                                          int rows) {
  for (int e = threadIdx.x; e < T * D; e += NT) {
    const int r = e / D, d = e % D;
    tile[r * LD + d] = r0 + r < rows ? to_f(src[(long long)(r0 + r) * rs + d]) : 0.f;
  }
}

// acc[i][j] += sum_k A(ty + 16 i, k) * B(tx + 16 j, k) over k < 64, with
// A(r, k) = a[r * ARS + k * AKS] and B(c, k) = b[c * BCS + k * BKS]
template <int ARS, int AKS, int BCS, int BKS>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* a, const float* b, int ty,
                                   int tx) {
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ARS + k * AKS];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * BCS + k * BKS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// reductions over the 16 threads (tx) that share a row; they are one half of a warp
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename E>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(Args a) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;
  float* Vs = Ks + TILE;
  float* Ss = Vs + TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, M = a.M;
  const E* q = static_cast<const E*>(a.q) + b * a.qs.b + h * a.qs.h;
  const E* k = static_cast<const E*>(a.k) + b * a.ks.b + h * a.ks.h;
  const E* v = static_cast<const E*>(a.v) + b * a.vs.b + h * a.vs.h;
  const E* dout = static_cast<const E*>(a.dout) + b * a.dos.b + h * a.dos.h;
  load_tile(Qs, q, a.qs.n, n0, N);
  load_tile(dOs, dout, a.dos.n, n0, N);

  float mx[4], inv[4], delta[4];
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = -INFINITY;
    inv[i] = 0.f;  // the running sum of exp until the end of pass 1
    delta[i] = 0.f;
  }
  // pass 1: row max and sum of exp
  for (int m0 = 0; m0 < M; m0 += T) {
    __syncthreads();
    load_tile(Ks, k, a.ks.n, m0, M);
    __syncthreads();
    zero(s);
    mm<LD, 1, LD, 1>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + tx + 16 * j < M) cm = fmaxf(cm, s[i][j] * a.scale);
      const float mnew = fmaxf(mx[i], row_max(cm));
      float cs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + tx + 16 * j < M) cs += expf(s[i][j] * a.scale - mnew);
      inv[i] = inv[i] * expf(mx[i] - mnew) + row_sum(cs);
      mx[i] = mnew;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / inv[i];
  // pass 2: Delta = rowsum(P o dP)
  for (int m0 = 0; m0 < M; m0 += T) {
    __syncthreads();
    load_tile(Ks, k, a.ks.n, m0, M);
    load_tile(Vs, v, a.vs.n, m0, M);
    __syncthreads();
    zero(s);
    zero(dp);
    mm<LD, 1, LD, 1>(s, Qs, Ks, ty, tx);
    mm<LD, 1, LD, 1>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + tx + 16 * j < M)
          delta[i] = fmaf(expf(s[i][j] * a.scale - mx[i]) * inv[i], dp[i][j], delta[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) delta[i] = row_sum(delta[i]);
  // pass 3: dS, dQ += dS K
  float dq[4][4];
  zero(dq);
  for (int m0 = 0; m0 < M; m0 += T) {
    __syncthreads();
    load_tile(Ks, k, a.ks.n, m0, M);
    load_tile(Vs, v, a.vs.n, m0, M);
    __syncthreads();
    zero(s);
    zero(dp);
    mm<LD, 1, LD, 1>(s, Qs, Ks, ty, tx);
    mm<LD, 1, LD, 1>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = m0 + c < M ? expf(s[i][j] * a.scale - mx[i]) * inv[i] : 0.f;
        Ss[(ty + 16 * i) * LD + c] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    // dQ(row, d) += sum_key dS(row, key) K(key, d)
    mm<LD, 1, 1, LD>(dq, Ss, Ks, ty, tx);
  }
  E* dqo = static_cast<E*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
  const long long bh = (long long)b * a.H + h;
  float* st_max = a.stats + bh * N;
  float* st_inv = a.stats + ((long long)a.B * a.H + bh) * N;
  float* st_delta = a.stats + (2ll * a.B * a.H + bh) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dqo[n * a.dqs.n + tx + 16 * j] = from_f<E>(a.scale * dq[i][j]);
    if (tx == 0) {
      st_max[n] = mx[i];
      st_inv[n] = inv[i];
      st_delta[n] = delta[i];
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(Args a) {
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* dOs = Qs + TILE;
  float* Ps = dOs + TILE;
  float* st = Ps + TILE;  // this query tile's row max, 1/row sum, Delta
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int mtiles = (a.M + T - 1) / T;
  const int mt = blockIdx.x % mtiles, split = blockIdx.x / mtiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, M = a.M, k0 = mt * T;
  const E* q = static_cast<const E*>(a.q) + b * a.qs.b + h * a.qs.h;
  const E* k = static_cast<const E*>(a.k) + b * a.ks.b + h * a.ks.h;
  const E* v = static_cast<const E*>(a.v) + b * a.vs.b + h * a.vs.h;
  const E* dout = static_cast<const E*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const long long bh = (long long)b * a.H + h;
  const float* st_max = a.stats + bh * N;
  const float* st_inv = a.stats + ((long long)a.B * a.H + bh) * N;
  const float* st_delta = a.stats + (2ll * a.B * a.H + bh) * N;
  load_tile(Ks, k, a.ks.n, k0, M);
  load_tile(Vs, v, a.vs.n, k0, M);

  // this split's query tiles: [t0, t1) of ceil(N / 64)
  const int ntiles = (N + T - 1) / T;
  const int per = (ntiles + a.nsplit - 1) / a.nsplit;
  const int t0 = split * per, t1 = min(ntiles, t0 + per);
  float dk[4][4], dv[4][4], s[4][4], dp[4][4];
  zero(dk);
  zero(dv);
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * T;
    __syncthreads();
    load_tile(Qs, q, a.qs.n, n0, N);
    load_tile(dOs, dout, a.dos.n, n0, N);
    for (int r = threadIdx.x; r < T; r += NT) {
      const bool in = n0 + r < N;
      st[r] = in ? st_max[n0 + r] : 0.f;
      st[T + r] = in ? st_inv[n0 + r] : 0.f;
      st[2 * T + r] = in ? st_delta[n0 + r] : 0.f;
    }
    __syncthreads();
    zero(s);
    zero(dp);
    // rows: queries; columns: this block's keys
    mm<LD, 1, LD, 1>(s, Qs, Ks, ty, tx);
    mm<LD, 1, LD, 1>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool rin = n0 + r < N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p =
            rin && k0 + c < M ? expf(s[i][j] * a.scale - st[r]) * st[T + r] : 0.f;
        Ps[r * LD + c] = p;
        s[i][j] = p * (dp[i][j] - st[2 * T + r]);  // dS
      }
    }
    __syncthreads();
    // dV(key, d) += sum_query P(query, key) dO(query, d)
    mm<1, LD, 1, LD>(dv, Ps, dOs, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LD + tx + 16 * j] = s[i][j];
    __syncthreads();
    // dK(key, d) += sum_query dS(query, key) Q(query, d)
    mm<1, LD, 1, LD>(dk, Ps, Qs, ty, tx);
  }
  // partials (split, b*H + h, M, D) for dK then dV
  const long long slab = (long long)a.B * a.H * M * D;
  float* pk = a.part + ((long long)split * a.B * a.H + bh) * M * D;
  float* pv = pk + (long long)a.nsplit * slab;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = k0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pk[(long long)m * D + tx + 16 * j] = dk[i][j];
      pv[(long long)m * D + tx + 16 * j] = dv[i][j];
    }
  }
}

int launch(const Args& a, cudaStream_t s) {
  const int ntiles = (a.N + T - 1) / T, mtiles = (a.M + T - 1) / T;
  // the shared-memory attribute belongs to the current device: set it before every launch
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<float><<<dim3(ntiles, a.H, a.B), NT, SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<float><<<dim3(mtiles * a.nsplit, a.H, a.B), NT, SMEM_BYTES, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// adds the splits' partials in split order, scales dK, casts, writes dK and dV
template <typename E>
__global__ void __launch_bounds__(RNT) attn_bwd_reduce_kernel(Args a) {
  const long long e = (long long)blockIdx.x * RNT + threadIdx.x;
  const long long slab = (long long)a.B * a.H * a.M * D;
  if (e >= slab) return;
  const int d = (int)(e % D);
  const long long r = e / D;
  const int m = (int)(r % a.M);
  const long long bh = r / a.M;
  const int h = (int)(bh % a.H), b = (int)(bh / a.H);
  float sk = 0.f, sv = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    sk += a.part[s * slab + e];
    sv += a.part[(a.nsplit + s) * slab + e];
  }
  static_cast<E*>(a.dk)[b * a.dks.b + m * a.dks.n + h * a.dks.h + d] = from_f<E>(a.scale * sk);
  static_cast<E*>(a.dv)[b * a.dvs.b + m * a.dvs.n + h * a.dvs.h + d] = from_f<E>(sv);
}


// ---------------------------------------------------------------- bf16 body

namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
// Q, dO, K x2, V x2, the block's Delta, 1024-byte alignment
constexpr int DQ_SMEM = 6 * TILE * 2 + 64 * 4 + 1024;
// K, V, Q x2, dO x2, (lse, Delta) of a query tile x2, 1024-byte alignment
constexpr int DKV_SMEM = 6 * TILE * 2 + 2 * 2 * 64 * 4 + 1024;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// dQ of a 64-query tile, and Delta of its rows for kernel 2
__global__ void __launch_bounds__(NT, 2) attn_bwd_dq_bf16(Args a) {
  extern __shared__ uint4 smem[];
  bf16* Qs = align1024(smem);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;      // two buffers
  bf16* Vs = Ks + 2 * TILE;   // two buffers
  float* dl_s = reinterpret_cast<float*>(Vs + 2 * TILE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, M = a.M;
  const long long bh = (long long)b * a.H + h;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const int nchunk = (M + 63) / 64;

  stage(qb, a.qs.n, q0, N, Qs);
  stage(dob, a.dos.n, q0, N, dOs);
  stage(kb, a.ks.n, 0, M, Ks);
  stage(vb, a.vs.n, 0, M, Vs);
  cp_async_commit();

  // Delta = rowsum(dO o O) in fp32, threads 2r and 2r+1 taking half of row r each
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float sum = 0.f;
    if (row < N) {
      const uint4* dsrc = reinterpret_cast<const uint4*>(dob + (long long)row * a.dos.n) + 4 * half;
      const float4* osrc =
          reinterpret_cast<const float4*>(a.o32 + (((long long)b * N + row) * a.H + h) * D) +
          8 * half;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 u = dsrc[i];
        const float4 oa = osrc[2 * i], ob = osrc[2 * i + 1];
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 f0 = __bfloat1622float2(p2[0]), f1 = __bfloat1622float2(p2[1]);
        const float2 f2 = __bfloat1622float2(p2[2]), f3 = __bfloat1622float2(p2[3]);
        sum = fmaf(f0.x, oa.x, sum);
        sum = fmaf(f0.y, oa.y, sum);
        sum = fmaf(f1.x, oa.z, sum);
        sum = fmaf(f1.y, oa.w, sum);
        sum = fmaf(f2.x, ob.x, sum);
        sum = fmaf(f2.y, ob.y, sum);
        sum = fmaf(f3.x, ob.z, sum);
        sum = fmaf(f3.y, ob.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      dl_s[r] = sum;
      if (row < N) a.stats[bh * N + row] = sum;
    }
  }
  // this thread's rows: g and g + 8 of its warp's 16
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < N ? a.lse[bh * N + row] : 0.f;
  }

  float dq[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  const uint64_t dQd = desc_sw128(Qs), dOd = desc_sw128(dOs);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  const float dl_r[2] = {dl_s[warp * 16 + g], dl_s[warp * 16 + g + 8]};
  wg_fence();
  wgmma_ss_hd(s, dQd, desc_sw128(Ks));
  wgmma_ss_hd(dp, dOd, desc_sw128(Vs));
  wg_commit();
  if (nchunk > 1) {
    stage(kb, a.ks.n, 64, M, Ks + TILE);
    stage(vb, a.vs.n, 64, M, Vs + TILE);
    cp_async_commit();
  }
  wg_wait0();
  const float sl2 = a.scale * LOG2E;
  const bool one_key = M == 1;
  for (int c = 0; c < nchunk; ++c) {
    const int buf = (c & 1) * TILE;
    const int kvalid = M - c * 64;
    // P = exp2(S * scale * log2 e - lse), 0 for keys past M; dS = P (dP - Delta)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(s[nt][e] * sl2 - lse_r[r]);
        if (kvalid < 64 && nt * 8 + t4 * 2 + (e & 1) >= kvalid) p = 0.f;
        s[nt][e] = one_key ? 0.f : p * (dp[nt][e] - dl_r[r]);
      }
    uint32_t dsh[4][4], dsl[4][4];
    split_frags(s, dsh, dsl);
    const uint64_t dKd = desc_sw128(Ks + buf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 >= kvalid) break;  // these 16 keys are all past M
      wgmma_rs(dq, dsh[kk], dKd + 128 * kk);
      wgmma_rs(dq, dsl[kk], dKd + 128 * kk);
    }
    wg_commit();
    if (c + 1 < nchunk) {
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();
      wgmma_ss_hd(s, dQd, desc_sw128(Ks + TILE - buf));
      wgmma_ss_hd(dp, dOd, desc_sw128(Vs + TILE - buf));
      wg_commit();
    }
    wg_wait0();
    __syncthreads();  // buffer `buf` is free
    if (c + 2 < nchunk) {
      stage(kb, a.ks.n, (c + 2) * 64, M, Ks + buf);
      stage(vb, a.vs.n, (c + 2) * 64, M, Vs + buf);
      cp_async_commit();
    }
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    bf16* dst = dqb + (long long)row * a.dqs.n + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(a.scale * dq[dt][2 * r], a.scale * dq[dt][2 * r + 1]);
  }
}

// Q, dO, lse and Delta of query tile t into buffer `bi`
__device__ __forceinline__ void stage_queries(const Args& a, const bf16* qb, const bf16* dob,
                                              long long bh, int t, int bi, bf16* Qs, bf16* dOs,
                                              float* st) {
  stage(qb, a.qs.n, t * 64, a.N, Qs + bi * TILE);
  stage(dob, a.dos.n, t * 64, a.N, dOs + bi * TILE);
  // threads 0-63 the lse of the tile's rows, 64-127 their Delta; past N, 0
  const int r = threadIdx.x & 63, n = t * 64 + r;
  const float* src = (threadIdx.x < 64 ? a.lse : a.stats) + bh * a.N;
  cp_async4(st + bi * 128 + threadIdx.x, n < a.N ? src + n : src, n < a.N);
}

// fp32 partials of dK (unscaled) and dV of a 64-key tile over one query split
__global__ void __launch_bounds__(NT, 2) attn_bwd_dkdv_bf16(Args a) {
  extern __shared__ uint4 smem[];
  bf16* Ks = align1024(smem);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;       // two buffers
  bf16* dOs = Qs + 2 * TILE;  // two buffers
  float* st = reinterpret_cast<float*>(dOs + 2 * TILE);  // per buffer: lse[64], Delta[64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int N = a.N, M = a.M;
  const int mtiles = (M + 63) / 64;
  const int mt = blockIdx.x % mtiles, split = blockIdx.x / mtiles;
  const int h = blockIdx.y, b = blockIdx.z, k0 = mt * 64;
  const long long bh = (long long)b * a.H + h;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  // this split's query tiles: [t0, t1) of ceil(N / 64); empty for a trailing split
  const int ntiles = (N + 63) / 64;
  const int per = (ntiles + a.nsplit - 1) / a.nsplit;
  const int t0 = split * per, t1 = min(ntiles, t0 + per);

  float dk[8][4], dv[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  if (t0 < t1) {
    stage(kb, a.ks.n, k0, M, Ks);
    stage(vb, a.vs.n, k0, M, Vs);
    stage_queries(a, qb, dob, bh, t0, 0, Qs, dOs, st);
    cp_async_commit();
    const uint64_t dKd = desc_sw128(Ks), dVd = desc_sw128(Vs);
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    wg_fence();
    wgmma_ss_hd(s, dKd, desc_sw128(Qs));    // S^T = K Q^T
    wgmma_ss_hd(dp, dVd, desc_sw128(dOs));  // dP^T = V dO^T
    wg_commit();
    if (t0 + 1 < t1) {
      stage_queries(a, qb, dob, bh, t0 + 1, 1, Qs, dOs, st);
      cp_async_commit();
    }
    wg_wait0();
    const float sl2 = a.scale * LOG2E;
    const bool one_key = M == 1;
    for (int t = t0; t < t1; ++t) {
      const int bi = (t - t0) & 1, buf = bi * TILE;
      const float* lse_s = st + bi * 128;
      const float* dl_s = lse_s + 64;
      const int nvalid = N - t * 64;
      // columns are queries: P^T = exp2(S^T * scale * log2 e - lse), 0 past N
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + t4 * 2 + (e & 1);
          const float p = col < nvalid ? ex2(s[nt][e] * sl2 - lse_s[col]) : 0.f;
          dp[nt][e] = one_key ? 0.f : p * (dp[nt][e] - dl_s[col]);
          s[nt][e] = p;
        }
      uint32_t ph[4][4], pl[4][4], dsh[4][4], dsl[4][4];
      split_frags(s, ph, pl);
      split_frags(dp, dsh, dsl);
      const uint64_t dOd = desc_sw128(dOs + buf), dQd = desc_sw128(Qs + buf);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 >= nvalid) break;  // these 16 queries are all past N
        wgmma_rs(dv, ph[kk], dOd + 128 * kk);
        wgmma_rs(dv, pl[kk], dOd + 128 * kk);
        wgmma_rs(dk, dsh[kk], dQd + 128 * kk);
        wgmma_rs(dk, dsl[kk], dQd + 128 * kk);
      }
      wg_commit();
      if (t + 1 < t1) {
        cp_async_wait_all();
        fence_async_smem();
        __syncthreads();
        wgmma_ss_hd(s, dKd, desc_sw128(Qs + TILE - buf));
        wgmma_ss_hd(dp, dVd, desc_sw128(dOs + TILE - buf));
        wg_commit();
      }
      wg_wait0();
      __syncthreads();  // buffer `bi` is free
      if (t + 2 < t1) {
        stage_queries(a, qb, dob, bh, t + 2, bi, Qs, dOs, st);
        cp_async_commit();
      }
    }
  }
  // partials (split, b*H + h, M, D) for dK then dV
  const long long slab = (long long)a.B * a.H * M * D;
  float* pk = a.part + ((long long)split * a.B * a.H + bh) * M * D;
  float* pv = pk + (long long)a.nsplit * slab;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = k0 + warp * 16 + g + 8 * r;
    if (m >= M) continue;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const long long o = (long long)m * D + dt * 8 + t4 * 2;
      *reinterpret_cast<float2*>(pk + o) = make_float2(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<float2*>(pv + o) = make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

int launch(const Args& a, cudaStream_t s) {
  const int ntiles = (a.N + 63) / 64, mtiles = (a.M + 63) / 64;
  // the shared-memory attribute belongs to the current device: set it before every launch
  cudaError_t err =
      cudaFuncSetAttribute(attn_bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_bf16<<<dim3(ntiles, a.H, a.B), NT, DQ_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_bf16<<<dim3(mtiles * a.nsplit, a.H, a.B), NT, DKV_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, dout, dq: (B, N, H, 64); k, v, dk, dv: (B, M, H, 64); each through its (b, n, h)
// element strides with unit head-dim stride, strides multiples of 8 and pointers 16-byte
// aligned, in the storage type (bf16 or fp32).  o32 and lse: for bf16, the fp32 output
// (B, N, H, 64) contiguous and the (B, H, N) base-2 log-sum-exp that K1's grad-mode
// forward wrote; null for fp32.  Scratch (fp32): stats, B*H*N floats for bf16 and
// 3*B*H*N for fp32; part, 2*nsplit*B*H*M*64 floats.  nsplit >= 1 splits the query tiles
// of the dK/dV kernel.  Returns the CUDA error of the launches (0 on success).
extern "C" int sra_attention_backward(
    const void* q, const void* k, const void* v, const void* dout, const void* o32,
    const void* lse, void* dq, void* dk, void* dv, void* stats, void* part, int is_bf16, int B,
    int N, int M, int H, int nsplit, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh, long long dq_sb,
    long long dq_sn, long long dq_sh, long long dk_sb, long long dk_sn, long long dk_sh,
    long long dv_sb, long long dv_sn, long long dv_sh, float scale, void* stream) {
  const int mtiles = (M + 63) / 64;
  if (H > 65535 || B > 65535 || nsplit < 1 || (long long)mtiles * nsplit > 0x7fffffffll ||
      (is_bf16 != 0) != (o32 != nullptr && lse != nullptr))
    return (int)cudaErrorInvalidConfiguration;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.o32 = static_cast<const float*>(o32);
  a.lse = static_cast<const float*>(lse);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.part = static_cast<float*>(part);
  a.B = B;
  a.N = N;
  a.M = M;
  a.H = H;
  a.nsplit = nsplit;
  a.qs = Strides{q_sb, q_sn, q_sh};
  a.ks = Strides{k_sb, k_sn, k_sh};
  a.vs = Strides{v_sb, v_sn, v_sh};
  a.dos = Strides{do_sb, do_sn, do_sh};
  a.dqs = Strides{dq_sb, dq_sn, dq_sh};
  a.dks = Strides{dk_sb, dk_sn, dk_sh};
  a.dvs = Strides{dv_sb, dv_sn, dv_sh};
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = is_bf16 ? tc::launch(a, s) : f32::launch(a, s);
  if (err != 0) return err;
  const long long slab = (long long)B * H * M * D;
  if (is_bf16)
    attn_bwd_reduce_kernel<__nv_bfloat16><<<(unsigned)((slab + RNT - 1) / RNT), RNT, 0, s>>>(a);
  else
    attn_bwd_reduce_kernel<float><<<(unsigned)((slab + RNT - 1) / RNT), RNT, 0, s>>>(a);
  return (int)cudaGetLastError();
}
