// Local correlation volume (K3) on NHWC feature maps, forward only.
//
//   out[b, h, w, (dy+R)*P + (dx+R)] = sum_c t[b, h, w, c] * s[b, h+dy, w+dx, c]
//
// with zeros where (h+dy, w+dx) falls outside the image, P odd <= 9,
// R = (P-1)/2.  Inputs are bf16 or fp32, read through their strides; the
// sums are fp32.  Two modes, one launch each:
//   raw    the volume, (B, H, W, P*P) fp32, contiguous;
//   fused  relu_l2norm of each pixel's P*P sums, applied before anything
//          leaves the block: v = max(v, 0) / sqrt(max(sum v^2, 1e-24))
//          (F.normalize's eps on the norm; the division is a product with
//          the pixel's reciprocal norm, within 2 ulp), written as fp32 or
//          bf16.
//
// Replaces the TPU kernel refign_tpu/ops/correlation.py:106,
// _local_correlation_pallas (Pallas body _corr_kernel), and in the fused
// mode also the ReLU + L2 that local_correlation_relu_l2norm
// (refign_tpu/ops/correlation.py:174-184) runs after it.  That kernel walks
// pre-stacked overlapping source strips kept whole in VMEM on the VPU; here
// a block stages a halo tile of the source in shared memory, so nothing is
// padded or copied in device memory.
//
// What bounds it on an H100: bytes.  Per pixel it reads 2*C inputs and
// writes P*P outputs (4 bytes raw, 2 in the fused bf16 mode) for 2*P*P*C
// useful flops: at P = 9 in bf16 ~25-31 flops per byte, far under the
// card's ridge at the bf16 tensor-core rate (~295).  On the CUDA cores the
// same flops were the limit (the previous body, 7-95x off the bytes bound).
// Design of the bf16 body:
//
// * The volume is a banded batched product on the tensor cores (mma.sync
//   m16n8k16, bf16 operands from ldmatrix, fp32 accumulators).  Target row
//   y with displacement dy and row y+1 with dy-1 read the same source row,
//   so the mma's 16 rows are 8 pixels of row y over 8 pixels of row y+1,
//   and one product with the 16-column source window of that row (x0-4 ..
//   x0+12: two n-tiles) serves both: pixel g, window column n is dx =
//   n - g - 4.  The P + 1 source rows that such a 2 x 8 tile sees cost
//   2(P+1) products and (P+1) x 8 accumulators a lane (80 at P = 9).  The
//   band's useful share is 81/160 at P = 9 (a 16-pixel
//   row segment against a 24-wide window would keep 9/24): 10.7 GFLOP of
//   tensor work at the largest level, ~0.02 ms at the mma.sync rate, under
//   the level's 0.065 ms bytes bound.  Products of bf16 values are exact in
//   fp32, so only the order of the sums differs from the plain version.
// * What limits a tile is the traffic from L2: a block of TH x 16 target
//   pixels stages TH + P - 1 source rows of 24 columns (a 48-byte run per
//   channel that touches three 32-byte sectors), so taller tiles read each
//   source byte fewer times (3x for 8 rows, 4.5x for 4, 9x for 1).  A block
//   of 8 rows runs 16 warps: each 2 x 8 tile's P + 1 source rows are split
//   over 2 warps (40 accumulators each), which fits 128 registers without a
//   spill; 80 accumulators a warp spilled at that cap, and fewer rows a
//   block cost more than the second block per SM gained (all timed on an
//   H100).  The 32^2 level (B = 4) would give 32 such blocks for 132 SMs,
//   so where a map gives fewer blocks than SMs the launcher takes 2-row
//   tiles (128 blocks of 4 warps there).  A persistent grid (a block a SM
//   walking its tiles, the next tile's chunks loading during this one's
//   epilogue) timed 18 % slower than one block a tile.
// * Channels advance KC = 32 at a time through a 3-stage cp.async ring, so
//   the next chunks load while this one is multiplied (4 stages, or 64
//   channels a chunk, timed no faster).  Channels past C and
//   pixels outside the image are zero-filled (src-size 0), which gives both
//   the K padding and the zero padding.
// * Each operand is staged in the layout its main-path input arrives in,
//   with no copy in device memory.  The target (the head's normalised NHWC
//   features, channels contiguous) stages as [pixel][channel] with 16-byte
//   cp.async and is read with ldmatrix; rows are padded to 80 bytes so the
//   8 rows of an 8x8 matrix hit distinct banks.  The warped source is the
//   NHWC view of grid_sample's NCHW output (channel stride H*W): it stages
//   as [row][channel][column] with 8-byte cp.async (8 lanes per channel
//   row, coalesced along W, one running pointer per thread) and is read
//   with ldmatrix.trans; its 48-byte channel rows already fall in distinct
//   banks.  Other strides or alignments of either stage element by element
//   into the same layouts (tests only).
// * Epilogue: each lane scatters its band into shared memory (the ring is
//   reused) and, in the fused mode, sums the squares of its ReLU'd values
//   per pixel, reduced over the quad with shuffles; then each row
//   segment's 16 x P*P outputs leave with 16-byte stores (8-byte in bf16).
//
// fp32 inputs (the tests and the small fp32 network) keep a CUDA-core body:
// TF32 tensor cores would break the 1e-5 fp32 check.  A block owns
// an 8 x 32 target tile and runs P warps, one per dy; lane (y, xg) of warp
// dy owns 8 neighbouring pixels and their P column displacements (8*P sums
// in registers); channels are staged 8 at a time as fp32 in shared memory
// with the source halo.  It shares the writer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "local_correlation_tile.cuh"

namespace {

// -------------------------------------------------------------- the writer

// Write a block's sums, staged in shared memory as so[r * RS + x * PP + k]
// for its TH x TW target pixels, to out (B, H, W, PP) contiguous; with
// `fused`, as max(v, 0) * inv[r * TW + x] (inv: reciprocal norms).  A row
// segment is contiguous in out: 16-byte (fp32) or 8-byte (bf16) stores of 4
// values where RS and the segment's start allow, else one value a store.
template <int PP, int TH, int TW, int RS>
__device__ __forceinline__ void write_out(const float* so, const float* inv, void* out,
                                          int fused, int out_bf16, int b, int y0, int x0,
                                          int H, int W) {
  const int nt = blockDim.x;
  const int n = min(TW, W - x0) * PP;
  for (int r = 0; r < TH; ++r) {
    const int gy = y0 + r;
    if (gy >= H) break;
    const long long o = (((long long)b * H + gy) * W + x0) * PP;
    const float* srow = so + r * RS;
    const float* irow = inv + r * TW;
    int done = 0;
    if (RS % 4 == 0 && o % 4 == 0) {
      done = n / 4 * 4;
      for (int i = 4 * threadIdx.x; i < done; i += 4 * nt) {
        float4 v = *reinterpret_cast<const float4*>(srow + i);
        if (fused) {
          v.x = fmaxf(v.x, 0.f) * irow[i / PP];
          v.y = fmaxf(v.y, 0.f) * irow[(i + 1) / PP];
          v.z = fmaxf(v.z, 0.f) * irow[(i + 2) / PP];
          v.w = fmaxf(v.w, 0.f) * irow[(i + 3) / PP];
        }
        if (out_bf16) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&lo);
          u.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o + i) = u;
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o + i) = v;
        }
      }
    }
    for (int i = done + threadIdx.x; i < n; i += nt) {
      float v = srow[i];
      if (fused) v = fmaxf(v, 0.f) * irow[i / PP];
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o + i] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o + i] = v;
    }
  }
}

__device__ __forceinline__ float inv_norm(float ss) { return 1.f / sqrtf(fmaxf(ss, 1e-24f)); }

// ------------------------------------------------- bf16: the tensor cores

namespace tcore {

using namespace lcorr;

// Stage channels [c0, c0 + KC) of the source halo (rows y0 - R.., columns
// x0 - HALO..) as [row][channel][column].  vec: 8-byte cp.async of 4
// pixels along W (stride 1, W % 4 == 0, aligned), so a group lies wholly
// inside or outside the image.  8 lanes take one channel row (SWIN / 4 of
// them busy), the threads cover NT / 8 channel rows a pass, and each
// thread walks its channel down the staged rows with one running pointer.
// Otherwise element by element.
template <int P, int TH, int KS>
__device__ __forceinline__ void stage_source(__nv_bfloat16* dst, const __nv_bfloat16* s,
                                             int y0, int x0, int c0, int H, int W, int C,
                                             long long sh, long long sw, long long sc,
                                             bool vec) {
  using G = Geo<P, TH, KS>;
  const int gy0 = y0 - G::R, gx0 = x0 - HALO;
  if (vec) {
    constexpr int CPT = G::NT / 8 < KC ? G::NT / 8 : KC;  // channels a pass covers
    constexpr int RPP = G::NT / 8 / CPT;                  // source rows a pass covers
    static_assert(KC % CPT == 0 && G::NT / 8 % CPT == 0, "whole passes");
    const int g = threadIdx.x % 8;
    const int gx = gx0 + 4 * g;
    const int r0 = threadIdx.x / 8 / CPT;
    const bool col_ok = g < SWIN / 4 && gx >= 0 && gx < W;
    if (g < SWIN / 4) {
#pragma unroll
      for (int j = 0; j < KC / CPT; ++j) {
        const int c = threadIdx.x / 8 % CPT + j * CPT;
        const bool c_ok = col_ok && c0 + c < C;
        const __nv_bfloat16* p = s + (gy0 + r0) * sh + gx + (c0 + c) * sc;
        __nv_bfloat16* d = dst + (r0 * KC + c) * SWIN + 4 * g;
#pragma unroll 1
        for (int row = 0; row < G::SROWS; row += RPP) {
          if (row + r0 < G::SROWS) {
            const int gy = gy0 + r0 + row;
            const bool ok = c_ok && gy >= 0 && gy < H;
            cp_async8(d, ok ? p : s, ok);
          }
          p += RPP * sh;
          d += RPP * KC * SWIN;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < G::SROWS * KC * SWIN; i += G::NT) {
      const int row = i / (KC * SWIN), rem = i % (KC * SWIN);
      const int c = rem / SWIN, x = rem % SWIN;
      const int gy = gy0 + row, gx = gx0 + x;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
      dst[(row * KC + c) * SWIN + x] =
          ok ? s[gy * sh + gx * sw + (c0 + c) * sc] : __float2bfloat16(0.f);
    }
  }
}

template <int P, int TH, int KS, int MINB>
__global__ void __launch_bounds__(32 * TH * KS, MINB)
local_correlation_tc_kernel(const __nv_bfloat16* __restrict__ t,
                            const __nv_bfloat16* __restrict__ s, void* __restrict__ out,
                            int H, int W, int C, long long tb, long long th, long long tw,
                            long long tc, long long sb, long long sh, long long sw,
                            long long sc, int t_vec, int s_vec, int fused, int out_bf16) {
  using G = Geo<P, TH, KS>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TWB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpart = warp % KS;          // which share of the source rows
  const int seg = warp / KS % 2;        // columns [8 seg, 8 seg + 8) of the block
  const int pair = warp / KS / 2;       // target rows 2 pair, 2 pair + 1
  const int k0 = kpart * G::NK;         // first source row, relative to row 2 pair - R
  const __nv_bfloat16* tb_ = t + b * tb;
  const __nv_bfloat16* sb_ = s + b * sb;
  const int nchunks = (C + KC - 1) / KC;

  auto t_buf = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * G::STAGE_BYTES);
  };
  auto s_buf = [&](int st) { return t_buf(st) + G::T_ELEMS; };
  auto load = [&](int ci) {
    if (ci < nchunks) {
      const int st = ci % NSTAGE;
      stage_target<TH, TWB, G::NT>(t_buf(st), tb_, y0, x0, ci * KC, H, W, C, th, tw, tc, t_vec);
      stage_source<P, TH, KS>(s_buf(st), sb_, y0, x0, ci * KC, H, W, C, sh, sw, sc, s_vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[G::NK][2][4];
  band_products<P, TH, KS>(
      acc, nchunks, pair, seg, k0, lane, load, [&](int ci) { return t_buf(ci % NSTAGE); },
      [&](int ci) { return s_buf(ci % NSTAGE); });
  // the ring becomes the output staging

  // Keep the band.  Accumulator e of n-tile j of source row k holds pixel
  // g of target row 2 pair + e / 2, window column n = 8 j + 2 q + e % 2:
  // displacement dy index k0 + k - e / 2, dx index n - g - HALO + R.
  float* so = reinterpret_cast<float*>(smem);
  float* part = so + TH * G::OUT_RS;     // [KS][NPIX] sums of squares
  float* inv = part + KS * G::NPIX;      // [NPIX] reciprocal norms
  const int g = lane / 4, q = lane % 4;
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < G::NK; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int dyi = k0 + k - h;
        const int dxi = 8 * j + 2 * q + e % 2 - g - HALO + G::R;
        if (dyi >= 0 && dyi < P && dxi >= 0 && dxi < P) {
          const float v = acc[k][j][e];
          so[(2 * pair + h) * G::OUT_RS + (SEG * seg + g) * G::PP + dyi * P + dxi] = v;
          const float r = fmaxf(v, 0.f);
          ss[h] = fmaf(r, r, ss[h]);
        }
      }
  if (fused) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
      ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
      if (q == 0) part[kpart * G::NPIX + (2 * pair + h) * TWB + SEG * seg + g] = ss[h];
    }
  }
  __syncthreads();
  if (fused) {
    for (int p = threadIdx.x; p < G::NPIX; p += G::NT) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) sum += part[k * G::NPIX + p];
      inv[p] = inv_norm(sum);
    }
    __syncthreads();
  }
  write_out<G::PP, TH, TWB, G::OUT_RS>(so, inv, out, fused, out_bf16, b, y0, x0, H, W);
}

}  // namespace tcore

// --------------------------------------------------- fp32: the CUDA cores

namespace fp {

constexpr int TH = 8;        // target rows per block
constexpr int TW = 32;       // target columns per block
constexpr int NP = 8;        // pixels per lane, along a row
constexpr int XG = TW / NP;  // lanes per row: TH * XG = 32, one warp per dy
constexpr int CC = 8;        // channels per staged chunk
constexpr int TWS = 36;      // target row stride in floats (= 4 mod 32)
constexpr int SWS = 44;      // source row stride in floats (= 12 mod 32)
// per-channel plane strides = 4 mod 32, so the staging stores of
// neighbouring channels spread over the banks
constexpr int TPLANE = TH * TWS + 4;

static_assert(TH * XG == 32, "one warp per row displacement");

template <int P>
struct Geo {
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int SH = TH + 2 * R;  // staged source rows
  static constexpr int SW = TW + 2 * R;  // staged source columns
  static constexpr int SPLANE = (SH * SWS + 31) / 32 * 32 + 4;
  static constexpr int NS = (NP + P - 1 + 3) / 4 * 4;  // source values, float4-rounded
  // output staging: a row of TW pixels x PP floats, plus one float so that
  // lanes of different rows land on different banks; then TH * TW norms
  static constexpr int OUT_RS = TW * PP + 1;
  static constexpr int IN_FLOATS = CC * (TPLANE + SPLANE);
  static constexpr int OUT_FLOATS = TH * OUT_RS + TH * TW;
  static constexpr int SMEM_BYTES =
      4 * (IN_FLOATS > OUT_FLOATS ? IN_FLOATS : OUT_FLOATS);
  static constexpr int THREADS = 32 * P;
  static_assert(SWS >= SW && SWS >= (XG - 1) * NP + NS, "source rows too short");
};

// 8 consecutive values
__device__ __forceinline__ void load8(const float* p, float (&v)[CC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

static_assert(CC == 8, "load8 stages one chunk");

// Stage a ROWS x COLS box of one image, channels c0 .. c0+CC-1, into
// dst[c * plane + r * row_stride + col]; zero outside the image and past C.
// Each thread owns whole pixels of the box (consecutive threads,
// consecutive columns) and loads the chunk's CC channels of each: one
// address per pixel, CC loads in flight.  ``vec8`` (channels contiguous,
// C % 8 == 0, 16-byte aligned) makes them vector loads; for the NHWC view
// of an NCHW tensor the lanes' scalar loads are coalesced along W.
template <int NT, int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int plane, int row_stride,
                                      const float* src, int gy0, int gx0, int c0,
                                      int H, int W, int C, long long sh,
                                      long long sw, long long sc, bool vec8) {
  for (int p = threadIdx.x; p < ROWS * COLS; p += NT) {
    const int r = p / COLS, x = p % COLS;
    const int gy = gy0 + r, gx = gx0 + x;
    float v[CC];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* q = src + gy * sh + gx * sw + c0 * sc;
      if (vec8) {
        load8(q, v);
      } else {
#pragma unroll
        for (int c = 0; c < CC; ++c) v[c] = c0 + c < C ? q[c * sc] : 0.f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CC; ++c) v[c] = 0.f;
    }
    float* d = dst + r * row_stride + x;
#pragma unroll
    for (int c = 0; c < CC; ++c) d[c * plane] = v[c];
  }
}

// one block per SM at P = 9 leaves the 72 sums room without a spill
template <int P>
__global__ void __launch_bounds__(32 * P, P == 9 ? 1 : 2)
local_correlation_kernel(const float* __restrict__ t, const float* __restrict__ s,
                         void* __restrict__ out, int H, int W, int C,
                         long long tb, long long th, long long tw, long long tc,
                         long long sb, long long sh, long long sw, long long sc,
                         int t_vec8, int s_vec8, int fused, int out_bf16) {
  using G = Geo<P>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* st = smem;                // [CC][TH][TWS]
  float* ss = smem + CC * TPLANE;  // [CC][SH][SWS]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int dyi = threadIdx.x / 32;  // row displacement dy + R
  const int lane = threadIdx.x % 32;
  const int ty = lane / XG;
  const int xg = lane % XG;
  const float* tb_ = t + b * tb;
  const float* sb_ = s + b * sb;

  float acc[NP][P];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int d = 0; d < P; ++d) acc[j][d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    stage<G::THREADS, TH, TW>(st, TPLANE, TWS, tb_, y0, x0, c0, H, W, C, th, tw, tc, t_vec8);
    stage<G::THREADS, G::SH, G::SW>(ss, G::SPLANE, SWS, sb_, y0 - G::R, x0 - G::R, c0, H, W,
                                    C, sh, sw, sc, s_vec8);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      float tv[NP], sv[G::NS];
      const float4* tp =
          reinterpret_cast<const float4*>(st + c * TPLANE + ty * TWS + xg * NP);
#pragma unroll
      for (int q = 0; q < NP / 4; ++q) {
        const float4 v = tp[q];
        tv[4 * q] = v.x; tv[4 * q + 1] = v.y; tv[4 * q + 2] = v.z; tv[4 * q + 3] = v.w;
      }
      const float4* sp = reinterpret_cast<const float4*>(
          ss + c * G::SPLANE + (ty + dyi) * SWS + xg * NP);
#pragma unroll
      for (int q = 0; q < G::NS / 4; ++q) {
        const float4 v = sp[q];
        sv[4 * q] = v.x; sv[4 * q + 1] = v.y; sv[4 * q + 2] = v.z; sv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int d = 0; d < P; ++d) acc[j][d] = fmaf(tv[j], sv[j + d], acc[j][d]);
    }
    __syncthreads();
  }

  float* so = smem;  // [row][col * PP + k], then the reciprocal norms
  float* inv = so + TH * G::OUT_RS;
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int d = 0; d < P; ++d)
      so[ty * G::OUT_RS + (xg * NP + j) * G::PP + dyi * P + d] = acc[j][d];
  __syncthreads();
  if (fused) {
    for (int p = threadIdx.x; p < TH * TW; p += G::THREADS) {
      const float* v = so + (p / TW) * G::OUT_RS + (p % TW) * G::PP;
      float sum = 0.f;
#pragma unroll 9
      for (int k = 0; k < G::PP; ++k) {
        const float r = fmaxf(v[k], 0.f);
        sum = fmaf(r, r, sum);
      }
      inv[p] = inv_norm(sum);
    }
    __syncthreads();
  }
  write_out<G::PP, TH, TW, G::OUT_RS>(so, inv, out, fused, out_bf16, b, y0, x0, H, W);
}

}  // namespace fp

// ---------------------------------------------------------------- launch

// bf16 with W contiguous: 4-pixel groups are 8-byte aligned and never
// straddle the image's edge
bool vec_width4(const void* p, const long long* st, int W) {
  return st[2] == 1 && W % 4 == 0 && (uintptr_t)p % 8 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[3] % 4 == 0;
}

struct Args {
  const void* t;
  const void* s;
  void* out;
  int B, H, W, C;
  const long long* ts;
  const long long* ss;
  int fused, out_bf16;
  cudaStream_t stream;
};

template <int P, int TH, int KS, int MINB>
int launch_tc(const Args& a) {
  using G = tcore::Geo<P, TH, KS>;
  auto kern = tcore::local_correlation_tc_kernel<P, TH, KS, MINB>;
  // the attribute belongs to the current device: set it before every
  // launch so a process that launches on several cards gets it on each
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + tcore::TWB - 1) / tcore::TWB, (a.H + TH - 1) / TH, a.B);
  kern<<<grid, G::NT, G::SMEM_BYTES, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.t), static_cast<const __nv_bfloat16*>(a.s), a.out,
      a.H, a.W, a.C, a.ts[0], a.ts[1], a.ts[2], a.ts[3], a.ss[0], a.ss[1], a.ss[2], a.ss[3],
      (int)lcorr::vec_channels(a.t, a.ts, a.C, 2), (int)vec_width4(a.s, a.ss, a.W), a.fused,
      a.out_bf16);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bf16(const Args& a) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 8-row tiles where they give every SM a block, else 2-row tiles; each
  // pair's source rows split over 2 warps
  const long long blocks8 =
      (long long)a.B * ((a.H + 7) / 8) * ((a.W + tcore::TWB - 1) / tcore::TWB);
  return blocks8 < sms ? launch_tc<P, 2, 2, 2>(a) : launch_tc<P, 8, 2, 1>(a);
}

template <int P>
int launch_fp32(const Args& a) {
  using G = fp::Geo<P>;
  auto kern = fp::local_correlation_kernel<P>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + fp::TW - 1) / fp::TW, (a.H + fp::TH - 1) / fp::TH, a.B);
  kern<<<grid, G::THREADS, G::SMEM_BYTES, a.stream>>>(
      static_cast<const float*>(a.t), static_cast<const float*>(a.s), a.out, a.H, a.W, a.C,
      a.ts[0], a.ts[1], a.ts[2], a.ts[3], a.ss[0], a.ss[1], a.ss[2], a.ss[3],
      (int)lcorr::vec_channels(a.t, a.ts, a.C, 4),
      (int)lcorr::vec_channels(a.s, a.ss, a.C, 4), a.fused, a.out_bf16);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<P>(a) : launch_fp32<P>(a);
}

}  // namespace

// t, s (B,H,W,C) of one type (bf16 when is_bf16, else fp32), element
// strides (b, h, w, c) for each; out (B,H,W,P*P) contiguous, fp32 unless
// out_bf16.  fused = 0: the raw volume (out_bf16 must be 0); fused = 1:
// its relu_l2norm.  Returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int local_correlation_forward(
    const void* t, const void* s, void* out, int is_bf16, int B, int H, int W, int C,
    int P, long long tb, long long th, long long tw, long long tc, long long sb,
    long long sh, long long sw, long long sc, int fused, int out_bf16, void* stream) {
  if (out_bf16 && !fused) return (int)cudaErrorInvalidValue;
  const long long ts[4] = {tb, th, tw, tc};
  const long long ss[4] = {sb, sh, sw, sc};
  const Args a{t, s, out, B, H, W, C, ts, ss, fused, out_bf16,
               static_cast<cudaStream_t>(stream)};
  switch (P) {
    case 1: return launch_p<1>(a, is_bf16);
    case 3: return launch_p<3>(a, is_bf16);
    case 5: return launch_p<5>(a, is_bf16);
    case 7: return launch_p<7>(a, is_bf16);
    case 9: return launch_p<9>(a, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}
