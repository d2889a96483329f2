// Depthwise 3x3 conv (stride 1, zero pad 1) + bias + exact-erf GELU on NHWC.
//
// Replaces the TPU kernel refign_tpu/ops/dwconv.py:_dwconv3x3_gelu_pallas
// (Pallas body _kernel): the 9 taps accumulate in fp32 (i outer, j inner, an
// fmaf chain from 0), then the bias, then GELU with erff, then one cast to
// the storage type.
//
// What bounds it on an H100: bytes.  It does 9 multiply-adds and one erf per
// element, below the card's ~20 flops per byte of fp32 CUDA-core rate
// against 3.35 TB/s, so the least time is (input + output bytes) / 3.35 TB/s:
// 3.19 ms per HRDA* forward (52 launches, bf16).
//
// bf16 with C % 8 == 0 (the HRDA* path): a shared-memory halo tile, whose
// staging and strip walk K4 shares (dwconv_tile.cuh).
//  * One block per (64-channel slice, TH x TW pixel tile, image), slices
//    varying fastest so blocks that run together read whole pixels; TW <= 32
//    (a multiple of 4, so 8 * TW threads fill whole warps) and TH <= 16 are
//    chosen per shape so the tiles cover the map with little waste (135 ->
//    28 x 15, 68 -> 24 x 14, 34 -> 20 x 12, 17 -> 20 x 9) and every MiT-B5
//    stage gives thousands of blocks for 132 SMs.
//  * The (TH+2) x (TW+2) x 64 halo tile is staged once with 16-byte cp.async;
//    out-of-image halo is zero-filled (src-size 0), nothing is padded in
//    device memory.  A thread keeps one halo column and vector and walks its
//    rows, so staging needs no division.  The block's 9 x 64 weights and 64
//    biases are staged once as fp32, read through the caller's strides, so
//    both the HWIO (3,3,1,C) and the OIHW (C,1,3,3) layouts are taken
//    without a copy.
//  * A thread owns one 8-channel vector (16 bytes) of one column and walks
//    down its strip: each staged row is read once per column tap (3 times in
//    all, instead of 9 loads from L1), and feeds three rolling accumulators,
//    the output rows it is tap row 2, 1 and 0 of.  Each accumulator still
//    receives its taps in the order i outer, j inner from 0, and a zero halo
//    adds exactly nothing, so the output equals the direct loop bit for bit.
//    The 72 weights live in registers; indices are 32-bit within an image.
//  * A quarter-warp reads one pixel's 128 contiguous bytes from shared memory
//    and writes them to device memory, so both are conflict-free/coalesced.
// What holds it back: instructions.  erff alone compiles to ~30 (two
// polynomials with a select per coefficient, and one MUFU), so GELU plus
// the 9 taps is ~45 per element: ~3.6 ms of issue per HRDA* forward at the
// full rate, above the bytes bound.
//
// fp32, C % 8 != 0 or unaligned pointers (the precision checks and odd
// widths): the direct loop, one thread per (pixel, 8-channel vector) or per
// (pixel, channel), out-of-image taps skipped, the halo from L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dwconv_tile.cuh"

namespace {

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// Weight tap (i, j) of channel c at w[i*wi + j*wj + c*wc].
struct WStrides {
  int i, j, c;
};

// ---------------------------------------------------------------- halo tile

namespace tile {

using namespace dwtile;

constexpr int PARAM_BYTES = 10 * SLICE * 4;  // 9 taps + bias, fp32
constexpr int MAX_SMEM = PARAM_BYTES + (MAX_TH + 2) * (MAX_TW + 2) * SLICE * 2;

__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&acc)[CPT],
                                          const float* __restrict__ bias) {
  Vec u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < CPT / 2; ++i) {
    const float2 b = reinterpret_cast<const float2*>(bias)[i];
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(gelu(acc[2 * i] + b.x), gelu(acc[2 * i + 1] + b.y));
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<Vec*>(dst) = u;
}

// Block (slice, tile, image): stage the halo and the slice's weights, then
// each thread computes its column strip.
__global__ void __launch_bounds__(MAX_THREADS, 2)
dwconv3x3_gelu_kernel_tile(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                           int H, int W, int C, int TH, int TW, int tiles_w, WStrides ws) {
  extern __shared__ uint4 smem[];
  float* wsm = reinterpret_cast<float*>(smem);  // [9][SLICE] taps, then [SLICE] bias
  uint4* halo = smem + PARAM_BYTES / 16;        // [TH+2][TW+2][VECS]
  const int tid = threadIdx.x;
  const int cs = blockIdx.x * SLICE;
  const int ty = blockIdx.y / tiles_w;
  const int y0 = ty * TH, x0 = (blockIdx.y - ty * tiles_w) * TW;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const int SW = TW + 2;

  stage_halo(halo, x + img, H, W, C, 1, cs, y0 - 1, x0 - 1, TH, SW);
  // a thread per channel stages its 9 taps and bias as fp32 (a block of a
  // map narrower than 8 pixels has fewer threads than channels)
  for (int cc = tid; cc < SLICE; cc += blockDim.x) {
    const int c = cs + cc;
#pragma unroll
    for (int t = 0; t < 10; ++t) {
      float val = 0.f;
      if (c < C)
        val = __bfloat162float(t < 9 ? w[(t / 3) * ws.i + (t % 3) * ws.j + c * ws.c] : bias[c]);
      wsm[t * SLICE + cc] = val;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = tid % LANES, col = tid / LANES;
  const int c0 = cs + lane * CPT, gx = x0 + col;
  if (c0 >= C || gx >= W) return;
  float wr[9][CPT];
  load_taps(wsm + lane * CPT, wr);
  const float* bsm = wsm + 9 * SLICE + lane * CPT;
  conv_strip(reinterpret_cast<const Vec*>(halo) + col * LANES + lane, SW * LANES,
             y + img + (y0 * W + gx) * C + c0, (size_t)W * C, min(TH, H - y0), wr,
             [bsm](__nv_bfloat16* dst, const float (&acc)[CPT]) { store_row(dst, acc, bsm); });
}

}  // namespace tile

// ---------------------------------------------------------------- direct loop

namespace direct {

constexpr int NT = 256;

using namespace dwtile;

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
dwconv3x3_gelu_kernel_direct(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ bias, T* __restrict__ y, int B, int H,
                             int W, int C, WStrides ws) {
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
      float xv[VEC];
      loadv<VEC>(x + ((img * H + yy) * W + xx) * C + c0, xv);
      const T* wt = w + i * ws.i + j * ws.j + (long long)c0 * ws.c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv[e], to_float(wt[e * ws.c]), acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = gelu(acc[e] + to_float(bias[c0 + e]));
  storev<VEC>(y + pix * C + c0, acc);
}

}  // namespace direct

using dwtile::tile_size;

template <typename T>
int launch_direct(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                  int C, WStrides ws, cudaStream_t stream) {
  const bool vec8 = (C % 8 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long total = (long long)B * H * W * (vec8 ? C / 8 : C);
  const unsigned int blocks = (unsigned int)((total + direct::NT - 1) / direct::NT);
  const T* xs = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bs = static_cast<const T*>(b);
  T* ys = static_cast<T*>(y);
  if (vec8)
    direct::dwconv3x3_gelu_kernel_direct<T, 8>
        <<<blocks, direct::NT, 0, stream>>>(xs, wp, bs, ys, B, H, W, C, ws);
  else
    direct::dwconv3x3_gelu_kernel_direct<T, 1>
        <<<blocks, direct::NT, 0, stream>>>(xs, wp, bs, ys, B, H, W, C, ws);
  return (int)cudaGetLastError();
}

int launch_tile(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                int C, int TH, int TW, WStrides ws, cudaStream_t stream) {
  // the attribute belongs to the current device: set it before every launch
  const cudaError_t err = cudaFuncSetAttribute(
      tile::dwconv3x3_gelu_kernel_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile::MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int smem = tile::PARAM_BYTES + (TH + 2) * (TW + 2) * tile::SLICE * 2;
  // channel slices vary fastest: blocks that run together read whole pixels
  const dim3 grid((C + tile::SLICE - 1) / tile::SLICE, tiles_h * tiles_w, B);
  tile::dwconv3x3_gelu_kernel_tile<<<grid, tile::LANES * TW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), H, W, C, TH, TW,
      tiles_w, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B,H,W,C) contiguous; w any (3,3) x C layout, tap (i, j) of channel c
// at w[i*w_si + j*w_sj + c*w_sc] (HWIO (3,3,1,C): (3C, C, 1); OIHW (C,1,3,3):
// (3, 1, 9)); b (C,) contiguous; all of one type (fp32, or bf16 when
// is_bf16).  Returns cudaGetLastError().
extern "C" int dwconv3x3_gelu_forward(const void* x, const void* w, const void* b, void* y,
                                      int is_bf16, int B, int H, int W, int C, int w_si,
                                      int w_sj, int w_sc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WStrides ws{w_si, w_sj, w_sc};
  if (!is_bf16) return launch_direct<float>(x, w, b, y, B, H, W, C, ws, s);
  // a multiple of 4 columns fills whole warps; the last tile's idle warps exit
  const int TH = tile_size(H, tile::MAX_TH), TW = (tile_size(W, tile::MAX_TW) + 3) & ~3;
  const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const bool tiled = C % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                     (long long)H * W * C < (1ll << 31) && tiles <= 65535 && B <= 65535;
  if (tiled) return launch_tile(x, w, b, y, B, H, W, C, TH, TW, ws, s);
  return launch_direct<__nv_bfloat16>(x, w, b, y, B, H, W, C, ws, s);
}
