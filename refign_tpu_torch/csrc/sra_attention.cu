// Spatial-reduction attention forward for MiT blocks, softmax(q k^T * scale) v.
//
// Replaces the TPU kernel refign_tpu/ops/attention.py:fused_small_kv_attention
// (Pallas body _make_kernel).  Same numerics as that kernel: logits, max,
// exp, sum and both products in fp32, whatever the storage type.
//
// What bounds it on an H100: operations.  Per (batch, head) the work is
// 4*N*M*D flops over (2*N + 2*M)*D elements; at the MiT-B5 shapes
// (N = 289..18225, M = 256..289, D = 64) that is ~130 flops per byte in
// bf16, so with fp32 arithmetic on the CUDA cores (67 TFLOP/s) the card is
// compute-bound long before it is memory-bound.  The tensor cores
// (989 TFLOP/s bf16) would lift that bound; mma/wgmma is later work.
//
// Design:
//  * one block of 256 threads per (64-query tile, head, batch); q, k, v and
//    o are read and written through their (B, N, H, D) strides, so the
//    caller makes no (B*H, N, D) transpose copies and k/v may be the two
//    halves of one fused kv projection;
//  * K/V stream through shared memory in chunks of 64 keys with an online
//    (running-max) softmax, so shared memory does not grow with M; the
//    ragged last chunk is zero-filled and masked to -inf in the kernel;
//  * each thread keeps a 4x4 register tile of the logits and of the output,
//    so every shared-memory float4 feeds 16 FMAs;
//  * (N, M) logits never leave the SM; device memory sees q, k, v read once
//    per tile and o written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;     // head dim (MiT: 64 at every stage)
constexpr int TQ = 64;    // queries per block
constexpr int TK = 64;    // keys per chunk
constexpr int NT = 256;   // threads per block
constexpr int LDS = 68;   // row stride of the logits tile S[q][k]
constexpr int LDP = 72;   // row stride of the probabilities Pt[k][q]
constexpr int SMEM_FLOATS = D * TQ + D * TK + TK * D + TQ * LDS + TK * LDP + 3 * TQ;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

struct Strides {
  long long b, n, h;  // element strides; the head-dim stride is 1
};

__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&r)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    r[2 * i] = f.x;
    r[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Load rows [r0, r0+64) of a (rows, D) slab with row stride `ld` as fp32;
// rows at or beyond `nrows` read as zero.  Vector v of 512 covers row
// (v % 64) or (v / 8) and 8 consecutive head-dim elements.
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, long long ld, int r0,
                                          int nrows, float* __restrict__ dst) {
#pragma unroll
  for (int it = 0; it < (64 * D / 8) / NT; ++it) {
    const int vi = threadIdx.x + it * NT;
    // transposed tiles: a warp takes 32 rows of one 8-column group, so the
    // scalar shared stores dst[d][row] hit 32 banks; row-major tiles: a warp
    // takes 4 whole rows, so the global reads coalesce
    const int row = TRANSPOSE ? (vi % 64) : (vi / 8);
    const int d0 = TRANSPOSE ? (vi / 64) * 8 : (vi % 8) * 8;
    float r[8];
    if (r0 + row < nrows) {
      load8(base + (long long)(r0 + row) * ld + d0, r);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = 0.f;
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(d0 + e) * 64 + row] = r[e];
    } else {
      float4* out = reinterpret_cast<float4*>(dst + row * D + d0);
      out[0] = make_float4(r[0], r[1], r[2], r[3]);
      out[1] = make_float4(r[4], r[5], r[6], r[7]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
sra_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int N, int M,
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  // register tiles: rows tq*4.., columns (keys, then head dims) tc*4..
  const int tq = tid / 16, tc = tid % 16;
  // softmax: 4 threads per query row, thread ss takes keys ss + 4t
  const int sr = tid / 4, ss = tid % 4;

  if (tid < TQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  load_tile<T, true>(qb, qs.n, q0, N, Qt);

  float oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;

  for (int c0 = 0; c0 < M; c0 += TK) {
    __syncthreads();  // the previous chunk's P.V is done with Kt, Vs, Pt
    load_tile<T, true>(kb, ks.n, c0, M, Kt);
    load_tile<T, false>(vb, vs.n, c0, M, Vs);
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tq * 4 + i;
    if (row < N) {
      const float inv = 1.f / row_l[tq * 4 + i];
      T* dst = ob + (long long)row * os.n + tc * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) store1(dst + j, oacc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
           int H, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           cudaStream_t stream) {
  // the attribute belongs to the current device: set it before every
  // launch so a process that launches on several cards gets it on each
  const cudaError_t err = cudaFuncSetAttribute(
      sra_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, H, B);
  sra_attention_kernel<T><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, M, qs, ks, vs, os, scale);
  return (int)cudaGetLastError();
}

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
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, N, M, H, qs, ks, vs, os, scale, s);
  return launch<float>(q, k, v, o, B, N, M, H, qs, ks, vs, os, scale, s);
}
