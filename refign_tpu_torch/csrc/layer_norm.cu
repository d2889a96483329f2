// LayerNorm over the last axis of bf16 rows, no gradient: kernel K5.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses its bf16 arm (refign_tpu/nn/layers.py:126-136) into one pass.  In
// PyTorch that arm (nn/layers.py:layer_norm_reference) is 18 launches with
// two (N, C) fp32 temporaries; the MiT-B5 forward of an HRDA* 1080p slide
// frame calls it 161 times over ~1.47 G elements, the largest share of the
// frame's device time and of its host dispatch.  K5 is that arm in one pass.
//
// Arithmetic, the composite's: the row's sums of x and x*x in fp32 (in
// another order than torch's reduction), m = sum(x) * (1/C), m2 =
// sum(x*x) * (1/C), r = rsqrt(max(m2 - m*m, 0) + eps) (a NaN passes, as
// torch.clamp), then per element s = r*w, t = b - (m*r)*w and y = x*s + t,
// each product and sum rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: no contraction into an FMA, as the composite's separate
// launches round), and one rounding to bf16.  w and b are read in their own
// dtype (bf16 or fp32) and widened here.
//
// What bounds it on an H100: bytes.  A row of C bf16 is read once and
// written once, 4 bytes an element against ~10 fp32 operations, so the least
// time is 4 * rows * C / 3.35 TB/s: 1.76 ms for the 161 norms of a frame.
//
// Design.  The widths are short rows (the MiT's C = 32 ... 512, C % 8 ==
// 0), so a row never crosses a warp: 8 lanes hold one row, lane l its
// 16-byte chunks l, l + 8, l + 16, ... (K = ceil(C / 64) of them, C = 320
// five each), loaded together before any is used, so a warp reads 4 rows'
// contiguous bytes with 16-byte loads.  A lane sums each chunk as a tree and
// the chunk sums in turn; the two sums then reduce over the 8 lanes by
// shuffles.  The row stays in registers, so there is no second read.
// w and b are staged once per block as fp32 in shared memory, the first and
// the last 4 values of each chunk in two planes, so the 8 lanes of a row read
// conflict-free 16-byte words.  Blocks are persistent: the grid is the
// SMs times the blocks that fit on one, each block walking 32 rows at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8;                     // lanes that hold one row
constexpr int THREADS = 256;                 // 8 warps, 32 rows a block
constexpr int ROWS_PER_BLOCK = THREADS / LANES;
constexpr int MAX_K = 8;                     // 16-byte chunks a lane: C <= 512
constexpr int MAX_C = MAX_K * LANES * 8;

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    layer_norm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                          const void* __restrict__ b, __nv_bfloat16* __restrict__ y,
                          long long rows, int C, int w_is_bf16, float inv_c, float eps) {
  // w and b as fp32; element j of chunk c at plane (j / 4), c * 4 + j % 4
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* bs = ws + C;
  const int half = C / 2;
  for (int i = threadIdx.x; i < C; i += THREADS) {
    float wi, bi;
    if (w_is_bf16) {
      wi = __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
      bi = __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
    } else {
      wi = static_cast<const float*>(w)[i];
      bi = static_cast<const float*>(b)[i];
    }
    const int j = i % 8, at = ((j / 4) * half) + (i / 8) * 4 + j % 4;
    ws[at] = wi;
    bs[at] = bi;
  }
  __syncthreads();

  const int sub = threadIdx.x % LANES;
  const int chunks = C / 8;
  const long long stride = (long long)gridDim.x * ROWS_PER_BLOCK;
  // the loop's bound is uniform over a warp (its 4 rows start together), so
  // every lane reaches the full-warp shuffles; rows past the end are masked
  for (long long base = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x / 32) * 4;
       base < rows; base += stride) {
    const long long row = base + (threadIdx.x % 32) / LANES;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * C);
    uint4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * LANES + sub;
      v[k] = (live && c < chunks) ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    // each chunk's 8 values and squares summed as a tree, the chunk sums
    // in turn: no serial chain longer than K + 3
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      float p[4], q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = bf16_lo(u[j]), h = bf16_hi(u[j]);
        p[j] = __fadd_rn(a, h);
        q[j] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(h, h));
      }
      s1 = __fadd_rn(s1, __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])));
      s2 = __fadd_rn(s2, __fadd_rn(__fadd_rn(q[0], q[1]), __fadd_rn(q[2], q[3])));
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o /= 2) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float m = __fmul_rn(s1, inv_c);
    const float d = __fsub_rn(__fmul_rn(s2, inv_c), __fmul_rn(m, m));
    const float r = rsqrtf(__fadd_rn(d < 0.f ? 0.f : d, eps));
    const float mr = __fmul_rn(m, r);
    uint4* yr = reinterpret_cast<uint4*>(y + (live ? row : 0) * C);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * LANES + sub;
      if (!live || c >= chunks) continue;
      const float4 wv[2] = {*reinterpret_cast<const float4*>(ws + c * 4),
                            *reinterpret_cast<const float4*>(ws + half + c * 4)};
      const float4 bv[2] = {*reinterpret_cast<const float4*>(bs + c * 4),
                            *reinterpret_cast<const float4*>(bs + half + c * 4)};
      const float wf[8] = {wv[0].x, wv[0].y, wv[0].z, wv[0].w,
                           wv[1].x, wv[1].y, wv[1].z, wv[1].w};
      const float bf[8] = {bv[0].x, bv[0].y, bv[0].z, bv[0].w,
                           bv[1].x, bv[1].y, bv[1].z, bv[1].w};
      const uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float e[2] = {bf16_lo(u[q]), bf16_hi(u[q])};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float wj = wf[2 * q + h];
          const float s = __fmul_rn(r, wj);
          const float t = __fsub_rn(bf[2 * q + h], __fmul_rn(mr, wj));
          e[h] = __fadd_rn(__fmul_rn(e[h], s), t);
        }
        o[q] = pack_bf16(e[0], e[1]);
      }
      yr[c] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int K>
int launch(const void* x, const void* w, const void* b, void* y, int w_is_bf16, long long rows,
           int C, float eps, cudaStream_t stream) {
  // blocks that fit on one SM: the same on every card of the build's target
  static int fit = 0;
  cudaError_t err = cudaSuccess;
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, layer_norm_fwd_kernel<K>, THREADS,
                                                        2 * MAX_C * sizeof(float));
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long most = (long long)sms * (fit > 0 ? fit : 1);
  const int grid = (int)(need < most ? need : most);
  layer_norm_fwd_kernel<K><<<grid, THREADS, 2 * C * sizeof(float), stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, b, static_cast<__nv_bfloat16*>(y), rows, C,
      w_is_bf16, 1.0f / (float)C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, C) bf16, rows stored densely, 16-byte aligned; w, b: (C,)
// contiguous, bf16 when w_is_bf16 else fp32; 8 <= C <= 512, C % 8 == 0.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a width or a
// pointer it does not take.
extern "C" int layer_norm_forward(const void* x, const void* w, const void* b, void* y,
                                  int w_is_bf16, long long rows, int C, float eps, void* stream) {
  if (C < 8 || C > MAX_C || C % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + LANES * 8 - 1) / (LANES * 8)) {
    case 1: return launch<1>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    case 2: return launch<2>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    case 3: return launch<3>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    case 4: return launch<4>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    case 5: return launch<5>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    case 6: return launch<6>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    case 7: return launch<7>(x, w, b, y, w_is_bf16, rows, C, eps, s);
    default: return launch<8>(x, w, b, y, w_is_bf16, rows, C, eps, s);
  }
}
