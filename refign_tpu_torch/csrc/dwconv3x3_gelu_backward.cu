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
// storage type.  z is recomputed in the forward kernel's order (i outer, j inner, an fmaf
// chain from 0, then the bias), so it is the forward's z bit for bit.  dw and db sum over
// the whole batch: each block writes one fp32 partial (9 taps and the bias) per channel,
// and dwconv_bwd_reduce adds the partials in a fixed order (deterministic, no atomics)
// and writes dw through the weight's own strides (OIHW (C,1,3,3) or HWIO (3,3,1,C)) and
// db.
//
// What bounds it on an H100: the function reads x and g and writes dx (3 maps) and does
// ~60 flops an element (9 fmas each for z, dx and dw, one erf and one exp); counted at
// the card's peak that is bytes, but the erff and expf on the CUDA cores set the pace of
// a design that moves only those bytes, as in the forward (dwconv3x3_gelu.cu).
//
// Two bodies, chosen by the storage type and layout (a dispatch, not a fallback):
//
// bf16 with C % 8 == 0 and 16-byte aligned x, g and dx (the train step's path): one halo
// tile that keeps g' on chip.
//  * One block of 128 threads per (32-channel slice, TH x TW pixel tile, image), slices
//    varying fastest; TH, TW <= 16, near-equal tiles per map (128, 64, 32, 16 -> 16).
//  * x is staged with a 2-pixel halo by 16-byte cp.async, zero-filled outside the image
//    (src-size 0).  A thread keeps one 8-channel vector of the slice (its weights and
//    bias in registers, fp32) and walks pixels.
//  * z over the tile and its one-pixel ring from the staged x, g read once from device
//    memory (16 bytes a pixel vector; no staging, it is read once), g' = g * GELU'(z) in
//    fp32 into shared memory, 0 outside the image.  The ring recomputes
//    (TH+2)(TW+2)/(TH*TW) = 1.27 times the tile's erff and expf at 16 x 16.
//  * dx over the tile from g''s flipped-tap stencil in shared memory, rounded once;
//    then x * g' (9 taps) and g' summed per channel over the tile, reduced over the
//    block in a fixed order (warp shuffles, then the 4 warps in order), one fp32 partial
//    per tile.
//  * Shared memory at 16 x 16: x 20*20*32 bf16 (25.6 KB), g' 18*18*32 fp32 (41.5 KB),
//    the weights 1.3 KB: 68 KB a block, so three fit on an SM, and the launch bound
//    (at most 170 registers a thread) lets three in by registers too: 12 warps an SM.
//    A thread's 8 channels hold 72 weights in registers for z and dx and then 80 sums
//    for dw and db; 256-thread blocks, at most 128 registers, spilled and ran 1.33x
//    slower at the train step's shapes (NVIDIA H100 80GB HBM3, 700 W, kernel_ab.py).
//
// fp32, C % 8 != 0 or unaligned pointers (the precision checks and odd widths): three
// kernels.
//  1. dwconv_bwd_gprime: one thread per (pixel, channel).  z is recomputed from the 9
//     taps in the forward's order, and g' is written to an fp32 scratch map: dx at a
//     pixel needs g' at its 8 neighbours, so the stencil of the second kernel reads g'
//     instead of recomputing 9 erf per tap.
//  2. dwconv_bwd_dx_dwdb: a block is 32 channels x 8 pixel lanes over a run of 256
//     consecutive pixels.  A thread keeps one channel's 9 weights in registers and walks
//     its lane of the run: it writes dx of each pixel and sums its 9 products x * g' and
//     g' in registers.  The 8 lanes of a channel add through shared memory and the block
//     writes one fp32 partial (9 taps and the bias) per channel per run.
//  3. dwconv_bwd_reduce, as above.
// Neighbouring threads hold neighbouring channels, so every map access of a warp is one
// contiguous run of 32 channels.
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

// ---------------------------------------------------------------- halo tile

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int CS = 32;                 // channels per block
constexpr int LV = CS / 8;             // 8-channel (16-byte) vectors per pixel of a slice
constexpr int MAX_T = 16;              // tile rows and columns at most
constexpr int NT = 128;                // threads per block
constexpr int WARPS = NT / 32;
constexpr int PARAM_VECS = TAPS * CS / 4;   // 9 taps + bias, fp32, in 16-byte units
constexpr int RED_VECS = WARPS * TAPS * CS / 4;

// 16-byte units of x's staged halo: the block's partial sums reuse it at the end
__host__ __device__ __forceinline__ int x_vecs(int TH, int TW) {
  const int v = (TH + 4) * (TW + 4) * LV;
  return v > RED_VECS ? v : RED_VECS;
}

__host__ __device__ __forceinline__ int smem_bytes(int TH, int TW) {
  return 16 * (PARAM_VECS + x_vecs(TH, TW) + 2 * (TH + 2) * (TW + 2) * LV);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void unpack(const uint4& u, float (&r)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Block (slice, tile, image): dx over the tile and the tile's partial of dw and db.
__global__ void __launch_bounds__(NT, 3)
dwconv_bwd_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, const bf16* __restrict__ g,
                       bf16* __restrict__ dx, float* __restrict__ part, int H, int W, int C,
                       int TH, int TW, int tiles_w, WStrides ws) {
  extern __shared__ uint4 smem[];
  float* wsm = reinterpret_cast<float*>(smem);  // [9][CS] taps, then [CS] bias
  uint4* xs = smem + PARAM_VECS;                // [TH+4][TW+4][LV]
  const int XW = TW + 4, GW = TW + 2, GH = TH + 2;
  float4* gp0 = reinterpret_cast<float4*>(xs + x_vecs(TH, TW));  // [TH+2][TW+2][LV], ch 0-3
  float4* gp1 = gp0 + GH * GW * LV;                                // the same, ch 4-7
  const int tid = threadIdx.x, lane = tid % LV;  // NT % LV == 0: a thread keeps its vector
  const int cs = blockIdx.x * CS, c0 = cs + lane * 8;
  const int ty = blockIdx.y / tiles_w;
  const int y0 = ty * TH, x0 = (blockIdx.y - ty * tiles_w) * TW;
  const size_t img = (size_t)blockIdx.z * H * W * C;

  for (int i = tid; i < (TH + 4) * XW * LV; i += NT) {
    const int p = i / LV, r = p / XW;
    const int gy = y0 - 2 + r, gx = x0 - 2 + (p - r * XW), ch = cs + (i % LV) * 8;
    const bool ok = (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W && ch < C;
    cp_async16(xs + i, x + img + (ok ? ((size_t)gy * W + gx) * C + ch : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int cc = tid; cc < CS; cc += NT) {
    const int c = cs + cc;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      float val = 0.f;
      if (c < C)
        val = __bfloat162float(t < 9 ? w[(t / 3) * ws.i + (t % 3) * ws.j + c * ws.c] : bias[c]);
      wsm[t * CS + cc] = val;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const bool cin = c0 < C;  // C % 8 == 0: a vector is wholly in or past C
  float wr[9][8], br[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wr[t][e] = wsm[t * CS + lane * 8 + e];
    br[e] = wsm[9 * CS + lane * 8 + e];
  }

  // g' over the tile and its ring (ring pixel (r, c) is image (y0-1+r, x0-1+c))
  for (int i = tid; i < GH * GW * LV; i += NT) {
    const int p = i / LV, r = p / GW, c = p - r * GW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float gpv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) gpv[e] = 0.f;
    if ((unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W && cin) {
      float gv[8], z[8];
      unpack(*reinterpret_cast<const uint4*>(g + img + ((size_t)gy * W + gx) * C + c0), gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = 0.f;
      // x at (gy-1+i, gx-1+j) is staged at (r+i, c+j)
      const uint4* xr = xs + (r * XW + c) * LV + lane;
#pragma unroll
      for (int ti = 0; ti < 3; ++ti)
#pragma unroll
        for (int tj = 0; tj < 3; ++tj) {
          float xv[8];
          unpack(xr[(ti * XW + tj) * LV], xv);
#pragma unroll
          for (int e = 0; e < 8; ++e) z[e] = fmaf(xv[e], wr[ti * 3 + tj][e], z[e]);
        }
#pragma unroll
      for (int e = 0; e < 8; ++e) gpv[e] = gv[e] * gelu_grad(z[e] + br[e]);
    }
    gp0[i] = make_float4(gpv[0], gpv[1], gpv[2], gpv[3]);
    gp1[i] = make_float4(gpv[4], gpv[5], gpv[6], gpv[7]);
  }
  __syncthreads();

  // dx over the tile: g' at (gy+1-i, gx+1-j) is ring pixel (t+2-i, u+2-j)
  for (int i = tid; i < TH * TW * LV; i += NT) {
    const int p = i / LV, t = p / TW, u = p - t * TW;
    const int gy = y0 + t, gx = x0 + u;
    if (gy >= H || gx >= W || !cin) continue;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int ti = 0; ti < 3; ++ti)
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        const int k = ((t + 2 - ti) * GW + (u + 2 - tj)) * LV + lane;
        const float4 a = gp0[k], b = gp1[k];
        const float gv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(gv[e], wr[ti * 3 + tj][e], acc[e]);
      }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
    *reinterpret_cast<uint4*>(dx + img + ((size_t)gy * W + gx) * C + c0) = o;
  }

  // x * g' (tap (i, j): x at (gy+i-1, gx+j-1), staged at (t+i+1, u+j+1)) and g' over
  // the tile, per channel
  float sw[TAPS][8];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) sw[t][e] = 0.f;
  for (int i = tid; i < TH * TW * LV; i += NT) {
    const int p = i / LV, t = p / TW, u = p - t * TW;
    if (y0 + t >= H || x0 + u >= W || !cin) continue;
    const int k = ((t + 1) * GW + u + 1) * LV + lane;
    const float4 a = gp0[k], b = gp1[k];
    const float gv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) sw[9][e] += gv[e];
#pragma unroll
    for (int ti = 0; ti < 3; ++ti)
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        float xv[8];
        unpack(xs[((t + ti + 1) * XW + u + tj + 1) * LV + lane], xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sw[ti * 3 + tj][e] = fmaf(xv[e], gv[e], sw[ti * 3 + tj][e]);
      }
  }
  // the 8 threads of a warp that hold one vector, then the warps in order
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = sw[t][e];
#pragma unroll
      for (int off = LV; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      sw[t][e] = v;
    }
  __syncthreads();  // every read of xs is done: it holds the warps' sums now
  float* red = reinterpret_cast<float*>(xs);  // [WARPS][TAPS][CS]
  const int warp = tid / 32;
  if (tid % 32 < LV)
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * TAPS + t) * CS + lane * 8 + e] = sw[t][e];
  __syncthreads();
  const size_t r = (size_t)blockIdx.z * gridDim.y + blockIdx.y;  // tile order
  for (int k = tid; k < TAPS * CS; k += NT) {
    const int t = k / CS, cc = k % CS;
    float s = 0.f;
#pragma unroll
    for (int wv = 0; wv < WARPS; ++wv) s += red[(wv * TAPS + t) * CS + cc];
    if (cs + cc < C) part[(r * TAPS + t) * C + cs + cc] = s;
  }
}

}  // namespace tile

// dw and db: the R partials of each (tap, channel) added in a fixed order, 8 groups of
// consecutive partials and then the groups in order, so repeated calls give the same
// bits.  A block is 32 channels x 8 groups of one tap.
constexpr int RG = 8;

template <typename T>
__global__ void __launch_bounds__(CH * RG)
    dwconv_bwd_reduce_kernel(const float* __restrict__ part, int R, int C, T* __restrict__ dw,
                             T* __restrict__ db, WStrides ws) {
  __shared__ float sums[RG][CH];
  const int cc = threadIdx.x % CH, grp = threadIdx.x / CH;
  const int c = blockIdx.x * CH + cc, t = blockIdx.y;
  const int per = (R + RG - 1) / RG, r0 = grp * per, r1 = min(R, r0 + per);
  float s = 0.f;
  if (c < C)
    for (int r = r0; r < r1; ++r) s += part[((long long)r * TAPS + t) * C + c];
  sums[grp][cc] = s;
  __syncthreads();
  if (grp != 0 || c >= C) return;
  float tot = 0.f;
#pragma unroll
  for (int q = 0; q < RG; ++q) tot += sums[q][cc];
  if (t < 9)
    dw[(t / 3) * ws.i + (t % 3) * ws.j + c * ws.c] = from_f<T>(tot);
  else
    db[c] = from_f<T>(tot);
}

template <typename T>
int reduce(const float* part, long long R, int C, void* dw, void* db, WStrides dws,
           cudaStream_t s) {
  dwconv_bwd_reduce_kernel<T><<<dim3((C + CH - 1) / CH, TAPS), CH * RG, 0, s>>>(
      part, (int)R, C, static_cast<T*>(dw), static_cast<T*>(db), dws);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_three(const void* x, const void* w, const void* b, const void* g, void* dx,
                 void* dw, void* db, float* gp, float* part, int B, int H, int W, int C,
                 WStrides ws, WStrides dws, cudaStream_t s) {
  const long long P = (long long)B * H * W;
  const long long total = P * C;
  const long long runs = (P + RUN - 1) / RUN;
  const int cgroups = (C + CH - 1) / CH;
  const long long gblocks = (total + 255) / 256;
  if (runs > 0x7fffffffll || cgroups > 65535 || gblocks > 0x7fffffffll)
    return (int)cudaErrorInvalidConfiguration;
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
  return reduce<T>(part, runs, C, dw, db, dws, s);
}

// near-equal tiles of at most tile::MAX_T: 128, 64, 32, 16 -> 16; 33 -> 11
int tile_size(int n) {
  const int tiles = (n + tile::MAX_T - 1) / tile::MAX_T;
  return (n + tiles - 1) / tiles;
}

// The halo tile takes bf16 maps of whole 16-byte channel vectors, 16-byte aligned.
bool use_tile(const void* x, const void* g, const void* dx, int is_bf16, int B, int H, int W,
              int C) {
  const long long tiles =
      (long long)((H + tile_size(H) - 1) / tile_size(H)) * ((W + tile_size(W) - 1) / tile_size(W));
  return is_bf16 && C % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0 &&
         (uintptr_t)dx % 16 == 0 && (long long)H * W * C < (1ll << 31) && tiles <= 65535 &&
         B <= 65535;
}

int launch_tile(const void* x, const void* w, const void* b, const void* g, void* dx, void* dw,
                void* db, float* part, int B, int H, int W, int C, WStrides ws, WStrides dws,
                cudaStream_t s) {
  const int TH = tile_size(H), TW = tile_size(W);
  const int tiles_w = (W + TW - 1) / TW, tiles = tiles_w * ((H + TH - 1) / TH);
  const int smem = tile::smem_bytes(TH, TW);
  // the attribute belongs to the current device: set it before every launch
  cudaError_t err = cudaFuncSetAttribute(tile::dwconv_bwd_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tile::smem_bytes(tile::MAX_T, tile::MAX_T));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + tile::CS - 1) / tile::CS, tiles, B);
  tile::dwconv_bwd_tile_kernel<<<grid, tile::NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dx), part, H, W, C, TH, TW, tiles_w, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce<__nv_bfloat16>(part, (long long)B * tiles, C, dw, db, dws, s);
}

}  // namespace

// x, g, dx: (B, H, W, C) contiguous in the storage type (bf16 or fp32); w, dw: the 3x3
// depthwise weights, tap (i, j) of channel c at w[i*w_si + j*w_sj + c*w_sc] (dw at its own
// strides); b, db: (C,).  Scratch (fp32) of the sizes dwconv3x3_gelu_backward_scratch
// gives: gp, the g' map of the three-kernel body (null on the halo-tile body); part, the
// partials.  Returns the CUDA error of the launches (0 on success).
extern "C" int dwconv3x3_gelu_backward(const void* x, const void* w, const void* b,
                                       const void* g, void* dx, void* dw, void* db, void* gp,
                                       void* part, int is_bf16, int B, int H, int W, int C,
                                       int w_si, int w_sj, int w_sc, int dw_si, int dw_sj,
                                       int dw_sc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WStrides ws{w_si, w_sj, w_sc}, dws{dw_si, dw_sj, dw_sc};
  float* pf = static_cast<float*>(part);
  if (use_tile(x, g, dx, is_bf16, B, H, W, C))
    return launch_tile(x, w, b, g, dx, dw, db, pf, B, H, W, C, ws, dws, s);
  float* gpf = static_cast<float*>(gp);
  if (is_bf16)
    return launch_three<__nv_bfloat16>(x, w, b, g, dx, dw, db, gpf, pf, B, H, W, C, ws, dws,
                                       s);
  return launch_three<float>(x, w, b, g, dx, dw, db, gpf, pf, B, H, W, C, ws, dws, s);
}

// Scratch sizes in floats for the wrapper's allocation, for the body the same arguments
// select: sizes[0] the g' map (0 on the halo tile), sizes[1] the partials.
extern "C" void dwconv3x3_gelu_backward_scratch(const void* x, const void* g, const void* dx,
                                                int is_bf16, int B, int H, int W, int C,
                                                long long* sizes) {
  const long long P = (long long)B * H * W;
  if (use_tile(x, g, dx, is_bf16, B, H, W, C)) {
    const long long tiles = (long long)((H + tile_size(H) - 1) / tile_size(H)) *
                            ((W + tile_size(W) - 1) / tile_size(W));
    sizes[0] = 0;
    sizes[1] = B * tiles * TAPS * C;
  } else {
    sizes[0] = P * C;
    sizes[1] = (P + RUN - 1) / RUN * TAPS * C;
  }
}
