// Dilated depthwise 3x3 conv (stride 1, zero pad d, dilation d, no bias) on
// NHWC, with an optional eval-BatchNorm + ReLU epilogue: kernel K4.
//
// Replaces no TPU kernel: the JAX package leaves this conv, the three
// dilated branches (d = 6, 12, 18, 1024 channels) of the DAFormer head's
// depthwise-separable ASPP (refign_tpu/models/heads/daformer.py), to XLA.
// It was added because cuDNN's grouped direct kernel ran these convs at
// about 2 % of their bytes bound on an H100, the furthest any device work of
// the HRDA* forward sat from the card's limits.
//
// Arithmetic.  The 9 taps accumulate in fp32 (i outer, j inner, an fmaf
// chain from 0) and the sum rounds to the storage type.  With the epilogue
// (bf16 only), y * a then + c in fp32 (__fmul_rn, __fadd_rn: no
// contraction), a round to bf16, then ReLU (a negative value becomes +0; -0 and NaN pass,
// as F.relu).  a = w * rsqrt(var + eps) and c = b - mean * a are the eval
// BatchNorm's fold, computed by the caller as TorchBatchNorm computes them,
// so the fused output equals the conv followed by TorchBatchNorm (eval, bf16)
// and F.relu bit for bit.
//
// What bounds it on an H100: bytes.  It does 9 multiply-adds per element,
// far below the card's ~20 flops per byte of fp32 CUDA-core rate against
// 3.35 TB/s, so the least time is (input + output bytes) / 3.35 TB/s: 0.668 ms
// a launch at the HRDA* 1080p slide shape (30, 135, 135, 1024) bf16, 2.005 ms
// for the three branches of a frame.  The epilogue moves no extra byte.
//
// bf16 with C % 8 == 0 (the HRDA* path): a sub-lattice halo tile.
//  * A dilation-d conv splits into d * d residue classes (y mod d, x mod d).
//    Each class is a dilation-1 3x3 conv on its own grid of ceil((H-ry)/d) x
//    ceil((W-rx)/d) pixels, d pixels apart in the image, and the image's zero
//    padding is the zero ring around that grid.  So the taps of one output
//    are neighbours in a class grid, and a class tile is K2's halo tile
//    (dwconv_tile.cuh, shared with csrc/dwconv3x3_gelu.cu) with its pixels
//    d apart in the image.
//  * One block per (64-channel slice, TH x TW tile of one class grid, image),
//    slices varying fastest so blocks that run together read whole pixels.
//    TH <= 16 and TW <= 32 (a multiple of 4, so 8 * TW threads fill whole
//    warps) are near-equal tiles of the largest class grid: at 135^2, d = 6
//    gives 23 -> 12 x 24 (two tiles a class), d = 12 one 12 x 12 tile and
//    d = 18 one 8 x 8 tile a class.  A tile that holds its whole class has a
//    halo outside the image: every input byte is then read from device memory
//    exactly once; d = 6's two tiles read 2 of a class's 23 rows twice, and
//    the second read of each is of rows the class's other tile, running
//    beside it, has just brought into L2.
//  * The tile's halo is staged once with 16-byte cp.async and zero fill, and
//    a thread walks one 8-channel vector of one class column down its strip
//    with the tile's three rolling accumulators, so the output equals the
//    direct loop bit for bit (tests/test_torch_dilated_dwconv.py emulates the
//    tiling).  The slice's 9 x 64 taps (read through the caller's strides,
//    so the OIHW (C,1,3,3) parameter is taken in place) and the 64 a and c
//    are staged once as fp32.
//  * A quarter-warp writes one pixel's 128 contiguous bytes of the slice.
//
// fp32, C % 8 != 0 or unaligned pointers (the precision checks and odd
// widths): the direct loop, one thread per (pixel, 8-channel vector) or per
// (pixel, channel), out-of-image taps skipped, the taps from L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dwconv_tile.cuh"

namespace {

// Weight tap (i, j) of channel c at w[i*wi + j*wj + c*wc].
struct WStrides {
  int i, j, c;
};

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue (bf16 only) on a conv output already rounded to bf16.
__device__ __forceinline__ float bn_relu(float y, float a, float c) {
  const float z = round_to(__fadd_rn(__fmul_rn(y, a), c), __nv_bfloat16());
  return z < 0.f ? 0.f : z;
}

// ---------------------------------------------------------------- halo tile

namespace tile {

using namespace dwtile;

constexpr int PARAM_BYTES = 11 * SLICE * 4;  // 9 taps, a and c, fp32
constexpr int MAX_SMEM = PARAM_BYTES + (MAX_TH + 2) * (MAX_TW + 2) * SLICE * 2;

// acc rounded to bf16 (FUSED: then the BatchNorm fold and ReLU with the
// thread's 8 a and c in shared memory) and stored as one 16-byte vector.
template <bool FUSED>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&acc)[CPT],
                                          const float* __restrict__ a,
                                          const float* __restrict__ c) {
  Vec u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < CPT / 2; ++i) {
    float v0 = acc[2 * i], v1 = acc[2 * i + 1];
    if constexpr (FUSED) {
      v0 = bn_relu(round_to(v0, __nv_bfloat16()), a[2 * i], c[2 * i]);
      v1 = bn_relu(round_to(v1, __nv_bfloat16()), a[2 * i + 1], c[2 * i + 1]);
    }
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<Vec*>(dst) = u;
}

// Block (slice, class tile, image): blockIdx.y is class * tiles + tile, the
// class (ry, rx) = (cls / d, cls % d); tiles of the largest class, so a
// smaller class's last tile may be empty.
template <bool FUSED>
__global__ void __launch_bounds__(MAX_THREADS, 2)
dilated_dwconv_fwd_kernel_tile(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ w, const float* __restrict__ a,
                               const float* __restrict__ c, __nv_bfloat16* __restrict__ y,
                               int H, int W, int C, int d, int TH, int TW, int tiles_h,
                               int tiles_w, WStrides ws) {
  extern __shared__ uint4 smem[];
  float* psm = reinterpret_cast<float*>(smem);  // [9][SLICE] taps, [SLICE] a, [SLICE] c
  uint4* halo = smem + PARAM_BYTES / 16;        // [TH+2][TW+2][VECS]
  const int tid = threadIdx.x;
  const int cs = blockIdx.x * SLICE;
  const int per_class = tiles_h * tiles_w;
  const int cls = blockIdx.y / per_class, t = blockIdx.y - cls * per_class;
  const int ry = cls / d, rx = cls - ry * d;
  const int ty = t / tiles_w;
  const int ky0 = ty * TH, kx0 = (t - ty * tiles_w) * TW;
  const int Hc = (H - ry + d - 1) / d, Wc = (W - rx + d - 1) / d;
  if (ky0 >= Hc || kx0 >= Wc) return;  // the whole block: nothing to compute
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const int SW = TW + 2;

  stage_halo(halo, x + img, H, W, C, d, cs, ry + d * (ky0 - 1), rx + d * (kx0 - 1), TH, SW);
  // a thread per channel stages its 9 taps, a and c as fp32 (a block of a
  // class narrower than 8 columns has fewer threads than channels)
  for (int cc = tid; cc < SLICE; cc += blockDim.x) {
    const int ch = cs + cc;
    const bool ok = ch < C;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      psm[k * SLICE + cc] = ok ? __bfloat162float(w[(k / 3) * ws.i + (k % 3) * ws.j + ch * ws.c]) : 0.f;
    psm[9 * SLICE + cc] = FUSED && ok ? a[ch] : 0.f;
    psm[10 * SLICE + cc] = FUSED && ok ? c[ch] : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = tid % LANES, col = tid / LANES;
  const int c0 = cs + lane * CPT, kx = kx0 + col;
  if (c0 >= C || kx >= Wc) return;
  float wr[9][CPT];
  load_taps(psm + lane * CPT, wr);
  const float *as = psm + 9 * SLICE + lane * CPT, *cs_ = psm + 10 * SLICE + lane * CPT;
  const size_t out = img + ((size_t)(ry + d * ky0) * W + rx + (size_t)d * kx) * C + c0;
  conv_strip(reinterpret_cast<const Vec*>(halo) + col * LANES + lane, SW * LANES, y + out,
             (size_t)d * W * C, min(TH, Hc - ky0), wr,
             [as, cs_](__nv_bfloat16* dst, const float (&acc)[CPT]) {
               store_row<FUSED>(dst, acc, as, cs_);
             });
}

}  // namespace tile

// ---------------------------------------------------------------- direct loop

namespace direct {

constexpr int NT = 256;

using namespace dwtile;

template <typename T, int VEC, bool FUSED>
__global__ void __launch_bounds__(NT)
dilated_dwconv_fwd_kernel_direct(const T* __restrict__ x, const T* __restrict__ w,
                                 const float* __restrict__ a, const float* __restrict__ c,
                                 T* __restrict__ y, int B, int H, int W, int C, int d,
                                 WStrides ws) {
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
    const int yy = py + (i - 1) * d;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int xx = px + (j - 1) * d;
      if (xx < 0 || xx >= W) continue;
      float xv[VEC];
      loadv<VEC>(x + ((img * H + yy) * W + xx) * C + c0, xv);
      const T* wt = w + i * ws.i + j * ws.j + (long long)c0 * ws.c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv[e], to_float(wt[e * ws.c]), acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    acc[e] = round_to(acc[e], T());
    if constexpr (FUSED) acc[e] = bn_relu(acc[e], a[c0 + e], c[c0 + e]);
  }
  storev<VEC>(y + pix * C + c0, acc);
}

}  // namespace direct

using dwtile::tile_size;

template <typename T, int VEC>
void launch_direct_vec(const T* x, const T* w, const float* a, const float* c, T* y, int B,
                       int H, int W, int C, int d, WStrides ws, cudaStream_t stream) {
  const long long total = (long long)B * H * W * (C / VEC);
  const unsigned int blocks = (unsigned int)((total + direct::NT - 1) / direct::NT);
  // the epilogue is bf16's alone: fp32 builds the conv only
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (a != nullptr) {
      direct::dilated_dwconv_fwd_kernel_direct<T, VEC, true>
          <<<blocks, direct::NT, 0, stream>>>(x, w, a, c, y, B, H, W, C, d, ws);
      return;
    }
  }
  direct::dilated_dwconv_fwd_kernel_direct<T, VEC, false>
      <<<blocks, direct::NT, 0, stream>>>(x, w, a, c, y, B, H, W, C, d, ws);
}

template <typename T>
int launch_direct(const void* x, const void* w, const float* a, const float* c, void* y, int B,
                  int H, int W, int C, int d, WStrides ws, cudaStream_t stream) {
  const bool vec8 = (C % 8 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const T* xs = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* ys = static_cast<T*>(y);
  if (vec8)
    launch_direct_vec<T, 8>(xs, wp, a, c, ys, B, H, W, C, d, ws, stream);
  else
    launch_direct_vec<T, 1>(xs, wp, a, c, ys, B, H, W, C, d, ws, stream);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch_tile(const void* x, const void* w, const float* a, const float* c, void* y, int B,
                int H, int W, int C, int d, int TH, int TW, int tiles_h, int tiles_w,
                WStrides ws, cudaStream_t stream) {
  // the attribute belongs to the current device: set it before every launch
  const cudaError_t err =
      cudaFuncSetAttribute(tile::dilated_dwconv_fwd_kernel_tile<FUSED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, tile::MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int smem = tile::PARAM_BYTES + (TH + 2) * (TW + 2) * tile::SLICE * 2;
  // channel slices vary fastest: blocks that run together read whole pixels
  const dim3 grid((C + tile::SLICE - 1) / tile::SLICE, d * d * tiles_h * tiles_w, B);
  tile::dilated_dwconv_fwd_kernel_tile<FUSED><<<grid, tile::LANES * TW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), a, c,
      static_cast<__nv_bfloat16*>(y), H, W, C, d, TH, TW, tiles_h, tiles_w, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B,H,W,C) contiguous, of one type (fp32, or bf16 when is_bf16); w of
// that type in any (3,3) x C layout, tap (i, j) of channel c at
// w[i*w_si + j*w_sj + c*w_sc] (OIHW (C,1,3,3): (3, 1, 9)); dilation d >= 1.
// a, c: (C,) fp32 contiguous for the BatchNorm + ReLU epilogue (bf16 only),
// or both null for the conv alone.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for the epilogue on fp32.
extern "C" int dilated_dwconv_forward(const void* x, const void* w, const float* a,
                                      const float* c, void* y, int is_bf16, int B, int H, int W,
                                      int C, int d, int w_si, int w_sj, int w_sc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WStrides ws{w_si, w_sj, w_sc};
  if (!is_bf16) {
    if (a != nullptr) return (int)cudaErrorInvalidValue;
    return launch_direct<float>(x, w, a, c, y, B, H, W, C, d, ws, s);
  }
  // tiles of the largest class grid, (0, 0); a multiple of 4 columns fills
  // whole warps, and a narrower class's idle columns exit
  const int Hc = (H + d - 1) / d, Wc = (W + d - 1) / d;
  const int TH = tile_size(Hc, tile::MAX_TH), TW = (tile_size(Wc, tile::MAX_TW) + 3) & ~3;
  const int tiles_h = (Hc + TH - 1) / TH, tiles_w = (Wc + TW - 1) / TW;
  const long long blocks_y = (long long)d * d * tiles_h * tiles_w;
  const bool tiled = C % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                     (long long)(H + 2 * d) * W * C < (1ll << 31) && blocks_y <= 65535 &&
                     B <= 65535;
  if (!tiled) return launch_direct<__nv_bfloat16>(x, w, a, c, y, B, H, W, C, d, ws, s);
  if (a != nullptr)
    return launch_tile<true>(x, w, a, c, y, B, H, W, C, d, TH, TW, tiles_h, tiles_w, ws, s);
  return launch_tile<false>(x, w, a, c, y, B, H, W, C, d, TH, TW, tiles_h, tiles_w, ws, s);
}
