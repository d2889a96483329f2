// Backward of K2: depthwise 3x3 conv (stride 1, zero pad 1) + bias + exact-erf GELU on NHWC.
//
// Replaces the backward of the TPU kernel's custom_vjp, refign_tpu/ops/dwconv.py:_fused_bwd
// (the VJP of the fp32 shift-and-add formulation _dwconv3x3_gelu_xla; the Pallas kernel
// _dwconv3x3_gelu_pallas has no backward of its own).  With y = GELU(z),
// z = sum_ij x[h+i-1, w+j-1, c] * w[i, j, c] + b[c] and the output gradient g:
//   g'[h,w,c]  = g * GELU'(z),  GELU'(z) = Phi(z) + z * phi(z)
//   dx[h,w,c]  = sum_ij g'[h-i+1, w-j+1, c] * w[i, j, c]      (the flipped-tap stencil)
//   dw[i,j,c]  = sum_{b,h,w} x[h+i-1, w+j-1, c] * g'[h,w,c]
//   db[c]      = sum_{b,h,w} g'[h,w,c]
// Everything is fp32 arithmetic, as the JAX VJP is; dx, dw and db are rounded once to the
// storage type.
//
// Three kernels:
//  1. dwconv_bwd_gprime: one thread per (pixel, channel).  z is recomputed from the 9 taps in the
//     forward kernel's order (i outer, j inner, an fmaf chain from 0, then the bias), and g'
//     is written to an fp32 scratch map: dx at a pixel needs g' at its 8 neighbours, so
//     the stencil of the second kernel reads g' instead of recomputing 9 erf per tap.
//  2. dwconv_bwd_dx_dwdb: a block is 32 channels x 8 pixel lanes over a run of 256 consecutive
//     pixels.  A thread keeps one channel's 9 weights in registers and walks its lane of
//     the run: it writes dx of each pixel and sums its 9 products x * g' and g' in
//     registers.  The 8 lanes of a channel add through shared memory and the block writes
//     one fp32 partial (9 taps and the bias) per channel per run.
//  3. dwconv_bwd_reduce: one thread per (tap, channel) adds the partials of all runs in run order
//     (deterministic, no atomics), and writes dw through the weight's own strides (so dw
//     comes back in the parameter's layout, OIHW (C,1,3,3) or HWIO (3,3,1,C)) and db.
// Neighbouring threads hold neighbouring channels, so every map access of a warp is one
// contiguous run of 32 channels.
//
// What bounds it on an H100: bytes.  The function reads x and g and writes dx (3 maps) and
// does ~60 flops an element (9 fmas each for z, dx and dw, one erf and one exp), below the
// card's fp32 flops-per-byte ratio.  This design also writes and reads the fp32 g' map
// (up to 8 more bytes an element) and reads x and g' through L1/L2 for each of the 9
// taps; it is the simple kernel of the first port, not yet a halo tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;      // channels per block of dx_dwdb
constexpr int LANES = 8;    // pixel lanes per block
constexpr int RUN = 256;    // pixels per block
constexpr int TAPS = 10;    // 9 weight taps and the bias

// Weight tap (i, j) of channel c at w[i*wi + j*wj + c*wc].
struct WStrides {
  int i, j, c;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float gelu_grad(float z) {
  // Phi(z) + z * phi(z), phi(z) = exp(-z^2/2) / sqrt(2 pi)
  const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
  const float pdf = 0.39894228040143268f * expf(-0.5f * z * z);
  return cdf + z * pdf;
}

template <typename T>
__global__ void __launch_bounds__(256)
    dwconv_bwd_gprime_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ b, const T* __restrict__ g,
                             float* __restrict__ gp, int H, int W, int C, long long total,
                             WStrides ws) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long p = idx / C;
  const int xw = (int)(p % W);
  const long long t = p / W;
  const int yh = (int)(t % H);
  const long long img = t / H;
  const T* xi = x + img * H * W * C + c;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int yy = yh + i - 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int xx = xw + j - 1;
      if (xx < 0 || xx >= W) continue;
      acc = fmaf(to_f(xi[((long long)yy * W + xx) * C]), to_f(w[i * ws.i + j * ws.j + c * ws.c]),
                 acc);
    }
  }
  const float z = acc + to_f(b[c]);
  gp[idx] = to_f(g[idx]) * gelu_grad(z);
}

template <typename T>
__global__ void __launch_bounds__(CH * LANES)
    dwconv_bwd_dx_dwdb_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const float* __restrict__ gp, T* __restrict__ dx,
                              float* __restrict__ part, int H, int W, int C, long long P,
                              WStrides ws) {
  __shared__ float red[LANES][TAPS][CH];
  const int tx = threadIdx.x % CH, ty = threadIdx.x / CH;
  const int c = blockIdx.y * CH + tx;
  const long long p0 = (long long)blockIdx.x * RUN;
  const long long p1 = p0 + RUN < P ? p0 + RUN : P;
  float sw[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) sw[t] = 0.f;
  if (c < C) {
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = to_f(w[(t / 3) * ws.i + (t % 3) * ws.j + c * ws.c]);
    for (long long p = p0 + ty; p < p1; p += LANES) {
      const int xw = (int)(p % W);
      const long long t = p / W;
      const int yh = (int)(t % H);
      const long long base = (t / H) * H * W * C + c;  // (image, channel c) origin
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int yy = yh - i + 1;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int xx = xw - j + 1;
          if (xx < 0 || xx >= W) continue;
          acc = fmaf(gp[base + ((long long)yy * W + xx) * C], wt[i * 3 + j], acc);
        }
      }
      dx[p * C + c] = from_f<T>(acc);
      const float gc = gp[p * C + c];
      sw[9] += gc;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int yy = yh + i - 1;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int xx = xw + j - 1;
          if (xx < 0 || xx >= W) continue;
          sw[i * 3 + j] = fmaf(to_f(x[base + ((long long)yy * W + xx) * C]), gc, sw[i * 3 + j]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TAPS; ++t) red[ty][t][tx] = sw[t];
  __syncthreads();
  for (int k = threadIdx.x; k < TAPS * CH; k += CH * LANES) {
    const int t = k / CH, cc = k % CH, ch = blockIdx.y * CH + cc;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) s += red[l][t][cc];
    if (ch < C) part[((long long)blockIdx.x * TAPS + t) * C + ch] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    dwconv_bwd_reduce_kernel(const float* __restrict__ part, int runs, int C,
                             T* __restrict__ dw, T* __restrict__ db, WStrides ws) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= TAPS * C) return;
  const int t = k / C, c = k % C;
  float s = 0.f;
  for (int r = 0; r < runs; ++r) s += part[((long long)r * TAPS + t) * C + c];
  if (t < 9)
    dw[(t / 3) * ws.i + (t % 3) * ws.j + c * ws.c] = from_f<T>(s);
  else
    db[c] = from_f<T>(s);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* g, void* dx, void* dw,
           void* db, float* gp, float* part, int B, int H, int W, int C, WStrides ws,
           WStrides dws, cudaStream_t s) {
  const long long P = (long long)B * H * W;
  const long long total = P * C;
  const long long runs = (P + RUN - 1) / RUN;
  const int cgroups = (C + CH - 1) / CH;
  if (runs > 0x7fffffffll || cgroups > 65535 || (long long)TAPS * C > 0x7fffffffll)
    return (int)cudaErrorInvalidConfiguration;
  const long long gblocks = (total + 255) / 256;
  if (gblocks > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  dwconv_bwd_gprime_kernel<T><<<(unsigned)gblocks, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(g), gp, H, W, C, total, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dwconv_bwd_dx_dwdb_kernel<T><<<dim3((unsigned)runs, cgroups), CH * LANES, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gp, static_cast<T*>(dx), part, H, W,
      C, P, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dwconv_bwd_reduce_kernel<T><<<(TAPS * C + 255) / 256, 256, 0, s>>>(
      part, (int)runs, C, static_cast<T*>(dw), static_cast<T*>(db), dws);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, dx: (B, H, W, C) contiguous in the storage type (bf16 or fp32); w, dw: the 3x3
// depthwise weights, tap (i, j) of channel c at w[i*w_si + j*w_sj + c*w_sc] (dw at its own
// strides); b, db: (C,).  Scratch: gp, B*H*W*C floats; part, ceil(B*H*W/256)*10*C floats.
// Returns the CUDA error of the launches (0 on success).
extern "C" int dwconv3x3_gelu_backward(const void* x, const void* w, const void* b,
                                       const void* g, void* dx, void* dw, void* db, void* gp,
                                       void* part, int is_bf16, int B, int H, int W, int C,
                                       int w_si, int w_sj, int w_sc, int dw_si, int dw_sj,
                                       int dw_sc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WStrides ws{w_si, w_sj, w_sc}, dws{dw_si, dw_sj, dw_sc};
  float* gpf = static_cast<float*>(gp);
  float* pf = static_cast<float*>(part);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, b, g, dx, dw, db, gpf, pf, B, H, W, C, ws, dws, s);
  return launch<float>(x, w, b, g, dx, dw, db, gpf, pf, B, H, W, C, ws, dws, s);
}

// Scratch sizes in floats, for the wrapper's allocation.
extern "C" long long dwconv3x3_gelu_backward_partials(int B, int H, int W, int C) {
  const long long P = (long long)B * H * W;
  return (P + RUN - 1) / RUN * TAPS * C;
}
