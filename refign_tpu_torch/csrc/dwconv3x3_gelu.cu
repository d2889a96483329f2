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
// bf16 with C % 8 == 0 (the HRDA* path): a shared-memory halo tile.
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

constexpr int SLICE = 64;            // channels per block
constexpr int VECS = SLICE / 8;      // 16-byte vectors per staged pixel slice
constexpr int CPT = 8;               // channels per thread
constexpr int LANES = SLICE / CPT;   // threads per pixel
constexpr int MAX_TW = 32, MAX_TH = 16;
constexpr int MAX_THREADS = LANES * MAX_TW;
constexpr int PARAM_BYTES = 10 * SLICE * 4;  // 9 taps + bias, fp32
constexpr int MAX_SMEM = PARAM_BYTES + (MAX_TH + 2) * (MAX_TW + 2) * SLICE * 2;

using Vec = uint4;  // one thread's 8 bf16 channels

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void unpack(const Vec& u, float (&r)[CPT]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < CPT / 2; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Staged row s of the strip: it is tap row 2 of output row s-2 (fin), tap
// row 1 of s-1 (mid) and tap row 0 of s (fresh, which starts here at 0).
__device__ __forceinline__ void row_step(const Vec* __restrict__ src, const float (&wr)[9][CPT],
                                         float (&fin)[CPT], float (&mid)[CPT],
                                         float (&fresh)[CPT]) {
#pragma unroll
  for (int e = 0; e < CPT; ++e) fresh[e] = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float xv[CPT];
    unpack(src[j * LANES], xv);
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      fresh[e] = fmaf(xv[e], wr[j][e], fresh[e]);
      mid[e] = fmaf(xv[e], wr[3 + j][e], mid[e]);
      fin[e] = fmaf(xv[e], wr[6 + j][e], fin[e]);
    }
  }
}

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

// Stage the (TH+2) x (TW+2) x SLICE halo of the tile at (y0, x0) into
// `halo`, one cp.async group.  Each thread keeps one (column, 16-byte vector)
// and walks down its rows, so the addresses need no division.
__device__ __forceinline__ void stage_halo(uint4* halo, const __nv_bfloat16* __restrict__ xi,
                                           int H, int W, int C, int cs, int y0, int x0, int TH,
                                           int SW) {
  for (int i = threadIdx.x; i < SW * VECS; i += blockDim.x) {
    const int gx = x0 + (i >> 3) - 1, ch = cs + (i & 7) * 8;
    const bool okx = (unsigned)gx < (unsigned)W && ch < C;
    const __nv_bfloat16* src = xi + ((y0 - 1) * W + gx) * C + ch;
    for (int r = 0, gy = y0 - 1; r < TH + 2; ++r, ++gy, src += W * C) {
      const bool ok = okx && (unsigned)gy < (unsigned)H;
      cp_async16(halo + r * SW * VECS + i, ok ? src : xi, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One thread's column strip of `rows` output rows from the staged halo.
__device__ __forceinline__ void conv_strip(const Vec* __restrict__ src, int drow_s,
                                           __nv_bfloat16* dst, int drow, int rows,
                                           const float (&wr)[9][CPT],
                                           const float* __restrict__ bsm) {
  float a0[CPT], a1[CPT], a2[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) a0[e] = a1[e] = a2[e] = 0.f;
  // staged rows 0..rows+1; accumulator names rotate every row, so the loop
  // is unrolled by three.  Staged row s completes output row s-2.
  row_step(src, wr, a0, a1, a2);
  row_step(src + drow_s, wr, a1, a2, a0);
  src += 2 * drow_s;
  for (int s = 2; s < rows + 2; s += 3, src += 3 * drow_s, dst += 3 * drow) {
    row_step(src, wr, a2, a0, a1);
    store_row(dst, a2, bsm);
    if (s + 1 >= rows + 2) break;
    row_step(src + drow_s, wr, a0, a1, a2);
    store_row(dst + drow, a0, bsm);
    if (s + 2 >= rows + 2) break;
    row_step(src + 2 * drow_s, wr, a1, a2, a0);
    store_row(dst + 2 * drow, a1, bsm);
  }
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

  stage_halo(halo, x + img, H, W, C, cs, y0, x0, TH, SW);
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
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < CPT; e += 4) {
      const float4 a = *reinterpret_cast<const float4*>(wsm + t * SLICE + lane * CPT + e);
      wr[t][e] = a.x;
      wr[t][e + 1] = a.y;
      wr[t][e + 2] = a.z;
      wr[t][e + 3] = a.w;
    }
  conv_strip(reinterpret_cast<const Vec*>(halo) + col * LANES + lane, SW * LANES,
             y + img + (y0 * W + gx) * C + c0, W * C, min(TH, H - y0), wr,
             wsm + 9 * SLICE + lane * CPT);
}

}  // namespace tile

// ---------------------------------------------------------------- direct loop

namespace direct {

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// near-equal tiles of at most `max_t`: 135 -> 27 (of 32), 68 -> 14 (of 16)
int tile_size(int n, int max_t) {
  const int tiles = (n + max_t - 1) / max_t;
  return (n + tiles - 1) / tiles;
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
