// The shared-memory halo tile and the direct loop's vector loads and stores
// of the depthwise 3x3 forward kernels K2 (dwconv3x3_gelu.cu) and K4
// (dilated_dwconv.cu); K2's backward (dwconv3x3_gelu_backward.cu) takes the
// 16-byte copy and the bf16 unpack.
//
// The tile.  A block owns one 64-channel slice of a TH x TW tile (TH <=
// MAX_TH, TW <= MAX_TW) of one image.  Its (TH+2) x (TW+2) x 64 halo is
// staged once with 16-byte cp.async and zero fill (src-size 0) outside the
// image, so nothing is padded in device memory; each staged pixel is 128
// contiguous bytes, whole cache lines.  The halo's pixels lie d apart in
// the image: K2 stages neighbours (d = 1), K4 one residue class of a
// dilation-d conv.  A thread owns one 8-channel vector (16 bytes) of one
// column and walks down its strip with three rolling accumulators, the
// output rows a staged row is tap row 2, 1 and 0 of: each staged row is
// read 3 times from shared memory instead of 9 loads, and each accumulator
// still receives its taps in the order i outer, j inner, an fmaf chain from
// 0.  A zero halo adds exactly nothing, so the tile's sums equal the direct
// loop's bit for bit.  The caller's store writes each finished row.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dwtile {

constexpr int SLICE = 64;            // channels per block
constexpr int VECS = SLICE / 8;      // 16-byte vectors per staged pixel slice
constexpr int CPT = 8;               // channels per thread
constexpr int LANES = SLICE / CPT;   // threads per pixel
constexpr int MAX_TW = 32, MAX_TH = 16;
constexpr int MAX_THREADS = LANES * MAX_TW;

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

// The thread's 9 x 8 fp32 taps into registers from the block's staged
// [9][SLICE] taps, `p` at the thread's first channel.
__device__ __forceinline__ void load_taps(const float* p, float (&wr)[9][CPT]) {
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int e = 0; e < CPT; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k * SLICE + e);
      wr[k][e] = v.x;
      wr[k][e + 1] = v.y;
      wr[k][e + 2] = v.z;
      wr[k][e + 3] = v.w;
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

// Stage the (TH+2) x (TW+2) x SLICE halo whose first pixel is (gy0, gx0) in
// the image, its pixels d apart, into `halo`: one cp.async group.  Each
// thread keeps one (column, 16-byte vector) and walks down its rows, so the
// addresses need no division.
__device__ __forceinline__ void stage_halo(Vec* halo, const __nv_bfloat16* __restrict__ xi, int H,
                                           int W, int C, int d, int cs, int gy0, int gx0, int TH,
                                           int SW) {
  const size_t drow = (size_t)d * W * C;
  for (int i = threadIdx.x; i < SW * VECS; i += blockDim.x) {
    const int gx = gx0 + (i >> 3) * d, ch = cs + (i & 7) * 8;
    const bool okx = (unsigned)gx < (unsigned)W && ch < C;
    const __nv_bfloat16* src = xi + ((long long)gy0 * W + gx) * C + ch;
    for (int r = 0, gy = gy0; r < TH + 2; ++r, gy += d, src += drow) {
      const bool ok = okx && (unsigned)gy < (unsigned)H;
      cp_async16(halo + r * SW * VECS + i, ok ? src : xi, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One thread's column strip of `rows` output rows from the staged halo
// (staged rows `drow_s` vectors apart); output rows are `drow` elements
// apart in the image, and store(dst, acc) writes one finished row.
template <typename Store>
__device__ __forceinline__ void conv_strip(const Vec* __restrict__ src, int drow_s,
                                           __nv_bfloat16* dst, size_t drow, int rows,
                                           const float (&wr)[9][CPT], Store store) {
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
    store(dst, a2);
    if (s + 1 >= rows + 2) break;
    row_step(src + drow_s, wr, a0, a1, a2);
    store(dst + drow, a0);
    if (s + 2 >= rows + 2) break;
    row_step(src + 2 * drow_s, wr, a1, a2, a0);
    store(dst + 2 * drow, a1);
  }
}

// near-equal tiles of at most `max_t`: 135 -> 27 (of 32), 23 -> 12 (of 16)
inline int tile_size(int n, int max_t) {
  const int tiles = (n + max_t - 1) / max_t;
  return (n + tiles - 1) / tiles;
}

// ------------------------------------------- the direct loop's vectors

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
    for (int e = 0; e < VEC; ++e) p[e] = __float2bfloat16_rn(r[e]);
  }
}

}  // namespace dwtile
