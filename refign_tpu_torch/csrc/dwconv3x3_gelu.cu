// Depthwise 3x3 conv (stride 1, zero pad 1) + bias + exact-erf GELU on NHWC.
//
// Replaces the TPU kernel refign_tpu/ops/dwconv.py:_dwconv3x3_gelu_pallas
// (Pallas body _kernel): the 9 taps accumulate in fp32, then the bias, then
// GELU with erff, then one cast to the storage type.
//
// What bounds it on an H100: bytes.  It does 9 multiply-adds and one erf
// per element, far below the card's ~20 flops per byte of fp32 CUDA-core
// rate against 3.35 TB/s, so the least time is (input + output bytes) /
// 3.35 TB/s.
//
// Design: one thread per (pixel, 8-channel vector) when C is a multiple of
// 8 (16-byte loads and stores of bf16; two of fp32), else one thread per
// (pixel, channel).  Neighbouring threads take neighbouring channels of one
// pixel, so every load is coalesced; the 3x3 halo re-reads rows that the
// neighbouring pixels' threads just read, which L1/L2 serve.  The weights
// arrive tap-major, (9, C), so one tap of 8 channels is one vector load.
// Out-of-image taps are skipped (zero padding); nothing is padded in memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <int VEC>
__device__ __forceinline__ void loadv(const float* p, float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = p[e];
  }
}

template <int VEC>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      r[2 * i] = f.x;
      r[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = __bfloat162float(p[e]);
  }
}

template <int VEC>
__device__ __forceinline__ void storev(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = r[e];
  }
}

template <int VEC>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = __float2bfloat16(r[e]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
dwconv3x3_gelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, T* __restrict__ y, int B, int H,
                      int W, int C) {
  const int CV = C / VEC;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const long long total = (long long)B * H * W * CV;
  if (idx >= total) return;
  const int c0 = (int)(idx % CV) * VEC;
  const long long pix = idx / CV;
  const int px = (int)(pix % W);
  const int py = (int)((pix / W) % H);
  const long long img = pix / ((long long)W * H);

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int yy = py + i - 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int xx = px + j - 1;
      if (xx < 0 || xx >= W) continue;
      float xv[VEC], wv[VEC];
      loadv<VEC>(x + ((img * H + yy) * W + xx) * C + c0, xv);
      loadv<VEC>(w + (i * 3 + j) * C + c0, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv[e], wv[e], acc[e]);
    }
  }
  float bv[VEC];
  loadv<VEC>(bias + c0, bv);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float z = acc[e] + bv[e];
    acc[e] = 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
  }
  storev<VEC>(y + pix * C + c0, acc);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
           int C, cudaStream_t stream) {
  const bool vec8 = (C % 8 == 0) && ((uintptr_t)x % 16 == 0) &&
                    ((uintptr_t)w % 16 == 0) && ((uintptr_t)b % 16 == 0) &&
                    ((uintptr_t)y % 16 == 0);
  const long long total = (long long)B * H * W * (vec8 ? C / 8 : C);
  const unsigned int blocks = (unsigned int)((total + NT - 1) / NT);
  const T* xs = static_cast<const T*>(x);
  const T* ws = static_cast<const T*>(w);
  const T* bs = static_cast<const T*>(b);
  T* ys = static_cast<T*>(y);
  if (vec8)
    dwconv3x3_gelu_kernel<T, 8><<<blocks, NT, 0, stream>>>(xs, ws, bs, ys, B, H, W, C);
  else
    dwconv3x3_gelu_kernel<T, 1><<<blocks, NT, 0, stream>>>(xs, ws, bs, ys, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B,H,W,C) contiguous; w (9, C) tap-major (the HWIO (3,3,1,C) layout);
// b (C,); all of one type (fp32, or bf16 when is_bf16).  Returns
// cudaGetLastError().
extern "C" int dwconv3x3_gelu_forward(const void* x, const void* w, const void* b,
                                      void* y, int is_bf16, int B, int H, int W, int C,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, b, y, B, H, W, C, s);
  return launch<float>(x, w, b, y, B, H, W, C, s);
}
