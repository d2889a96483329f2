// Backward of K1: spatial-reduction attention, o = softmax(scale * q k^T) v with fp32
// logits, on (B, N, H, 64) queries and (B, M, H, 64) keys and values.
//
// Replaces the backward of the TPU kernel's custom_vjp, refign_tpu/ops/attention.py:
// _attn_fused_bwd (the VJP of the fp32 einsum formulation _attn_einsum_fp32; the Pallas
// kernel fused_small_kv_attention has no backward of its own).  With
// P = softmax(scale * q k^T) and the output gradient dO:
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - Delta),  Delta = rowsum(P o dP),
//   dQ = scale * dS K,   dK = scale * dS^T Q.
// Delta equals rowsum(dO o O) for the unrounded fp32 O.  The forward kernel stores neither
// that O nor the softmax statistics, so both are recomputed here and the forward (and
// inference) launch is unchanged.  All arithmetic is fp32 on the CUDA cores, P and dS
// included; dQ, dK and dV are rounded once to the storage type.
//
// Three kernels, on 64 x 64 fp32 tiles in shared memory (row stride 65, so that both the
// row-wise and the column-wise reads of a tile are free of bank conflicts).  A block has
// 256 threads; thread (ty, tx) of a 16 x 16 grid holds a 4 x 4 register tile of rows
// ty + 16 i and columns tx + 16 j of each product, and the 16 threads of a row reduce
// with __shfl_xor_sync.
//  1. attn_bwd_dq: one block per (64-query tile, head, batch).  Pass 1 over the 64-key chunks: the
//     row max and the sum of exp (online).  Pass 2: P and dP, Delta.  Pass 3: dS into
//     shared memory, dQ += dS K.  Writes dQ, and the row max, the reciprocal row sum and
//     Delta (fp32) for kernel 2.
//  2. attn_bwd_dkdv: one block per (64-key tile, query split, head, batch).  Over the 64-query tiles
//     of its split: P from the stored row statistics, dP, dS; dV += P^T dO and
//     dK += dS^T Q in registers.  Writes fp32 partials, one per split.  The splits give
//     the card enough blocks where B*H*ceil(M/64) alone would not fill it (N up to 16384
//     queries against M = 256 keys at MiT stage 1).
//  3. attn_bwd_reduce: adds the splits' partials in split order (deterministic, no atomics),
//     scales dK, casts, and writes dK and dV.
// q, k, v and dO are read through their (B, N or M, H) strides, so k and v may be the two
// halves of one fused kv projection; the outputs are written through theirs.
//
// What bounds it on an H100: operations.  The function needs five products of 2*N*M*64
// flops per (batch, head) (S, dP, dQ, dK, dV); this design does ten (S twice more and dP
// once more in kernel 1, S and dP again in kernel 2) on the fp32 CUDA cores, where a
// tensor-core design would do five at the bf16 rate.  It is the simple kernel of the first
// port.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim (MiT: 64 at every stage)
constexpr int T = 64;          // queries and keys per tile
constexpr int LD = T + 1;      // shared-memory row stride in floats
constexpr int NT = 256;        // threads per block
constexpr int TILE = T * LD;   // floats of one tile
constexpr int SMEM_BYTES = (5 * TILE + 3 * T) * 4;

struct Strides {
  long long b, n, h;  // element strides; the head-dim stride is 1
};

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *stats, *part;  // stats: (3, B*H, N) row max, 1/row sum, Delta; part: 2 x (S, B*H, M, D)
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

template <typename E>
__global__ void __launch_bounds__(NT) attn_bwd_reduce_kernel(Args a) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
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

template <typename E>
int launch(const Args& a, cudaStream_t s) {
  const int ntiles = (a.N + T - 1) / T, mtiles = (a.M + T - 1) / T;
  if (a.H > 65535 || a.B > 65535 || (long long)mtiles * a.nsplit > 0x7fffffffll)
    return (int)cudaErrorInvalidConfiguration;
  // the shared-memory attribute belongs to the current device: set it before every launch
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<E><<<dim3(ntiles, a.H, a.B), NT, SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<E><<<dim3(mtiles * a.nsplit, a.H, a.B), NT, SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long slab = (long long)a.B * a.H * a.M * D;
  attn_bwd_reduce_kernel<E><<<(unsigned)((slab + NT - 1) / NT), NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: (B, N, H, 64); k, v, dk, dv: (B, M, H, 64); each through its (b, n, h)
// element strides with unit head-dim stride, in the storage type (bf16 or fp32).  Scratch
// (fp32): stats, 3*B*H*N floats; part, 2*nsplit*B*H*M*64 floats.  nsplit >= 1 splits the
// query tiles of kernel 2.  Returns the CUDA error of the launches (0 on success).
extern "C" int sra_attention_backward(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, void* stats, void* part, int is_bf16, int B, int N, int M, int H, int nsplit,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long do_sb,
    long long do_sn, long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh,
    long long dk_sb, long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn,
    long long dv_sh, float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
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
  if (is_bf16) return launch<__nv_bfloat16>(a, s);
  return launch<float>(a, s);
}
