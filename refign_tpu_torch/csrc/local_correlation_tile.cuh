// The banded raw product of K3's bf16 body on Hopper, shared by its forward
// (local_correlation.cu) and by the raw-sum kernel of its backward
// (local_correlation_backward.cu), so that both form the same fp32 raw sums
// bit for bit.
//
// A block owns TH target rows x TWB columns; warp w takes the P + 1 source
// rows that its 2 x SEG tile (row pair (w / KS) / 2, segment (w / KS) % 2)
// sees, split over KS warps.  The mma's 16 rows are SEG pixels of target
// row y over the same pixels of row y + 1; one product with the 16-column
// window (x - HALO ..) of a source row serves both (dy for row y, dy - 1
// for row y + 1).  mma.sync m16n8k16, bf16 operands from ldmatrix, fp32
// accumulators; channels advance KC at a time through an NSTAGE-deep
// cp.async ring.  The target stages as [pixel][channel] (PSTR-padded rows),
// the source as [row][channel][column] (SWIN columns from x0 - HALO).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lcorr {

constexpr int SEG = 8;               // pixels of one target row in a warp tile
constexpr int HALO = 4;              // window origin x - HALO, for every P
constexpr int WIN = SEG + 2 * HALO;  // a warp's window: two n-tiles of 8
constexpr int TWB = 2 * SEG;         // target columns per block
constexpr int SWIN = TWB + 2 * HALO;  // staged source columns
constexpr int KC = 32;               // channels per staged chunk: two k-steps
constexpr int PSTR = KC + 8;         // [pixel][channel] row: 80 bytes
constexpr int NSTAGE = 3;            // cp.async ring depth

static_assert(WIN == 16 && SWIN % 4 == 0 && KC % 16 == 0, "two n-tiles, whole k-steps");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile geometry.  TH (even) target rows x TWB columns per block; warp w
// takes source rows [NK * (w % KS), +NK) of the P + 1 that its 2 x SEG
// tile (row pair (w / KS) / 2, segment (w / KS) % 2) sees.
template <int P, int TH, int KS>
struct Geo {
  static constexpr int R = (P - 1) / 2;
  static constexpr int PP = P * P;
  static constexpr int NK = (P + 1) / KS;
  static constexpr int NT = 32 * TH * KS;
  static constexpr int NPIX = TH * TWB;
  static constexpr int SROWS = TH + P - 1;               // staged source rows
  static constexpr int T_ELEMS = NPIX * PSTR;             // [pixel][channel]
  static constexpr int S_ROW = KC * SWIN;                 // [channel][column]
  static constexpr int S_ELEMS = SROWS * S_ROW;
  static constexpr int STAGE_BYTES = 2 * (T_ELEMS + S_ELEMS);
  static constexpr int OUT_RS = TWB * PP + 4;  // output staging row, in floats
  static constexpr int OUT_FLOATS = TH * OUT_RS + (KS + 1) * NPIX;  // + partials, norms
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  static constexpr int SMEM_BYTES =
      RING_BYTES > 4 * OUT_FLOATS ? RING_BYTES : 4 * OUT_FLOATS;
  static_assert(TH % 2 == 0 && (P + 1) % KS == 0, "row pairs, whole source-row splits");
  static_assert(STAGE_BYTES % 16 == 0 && OUT_RS % 4 == 0, "16-byte aligned");
};

// Stage channels [c0, c0 + KC) of ROWS x COLS target pixels (rows y0..,
// columns x0..) as [pixel][channel], zero outside the image and past C;
// vec: 16-byte cp.async (channels contiguous, C % 8 == 0, aligned), else
// element by element.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_target(__nv_bfloat16* dst, const __nv_bfloat16* t,
                                             int y0, int x0, int c0, int H, int W, int C,
                                             long long th, long long tw, long long tc,
                                             bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * COLS * (KC / 8); i += NT) {
      const int p = i / (KC / 8), g = i % (KC / 8);
      const int gy = y0 + p / COLS, gx = x0 + p % COLS, c = c0 + 8 * g;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      cp_async16(dst + p * PSTR + 8 * g, ok ? t + gy * th + gx * tw + c : t, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS * KC; i += NT) {
      const int p = i / KC, c = i % KC;
      const int gy = y0 + p / COLS, gx = x0 + p % COLS;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
      dst[p * PSTR + c] = ok ? t[gy * th + gx * tw + (c0 + c) * tc] : __float2bfloat16(0.f);
    }
  }
}

// channels contiguous, whole 8-channel groups 16-byte aligned vectors
inline bool vec_channels(const void* p, const long long* st, int C, int itemsize) {
  return st[3] == 1 && C % 8 == 0 && (uintptr_t)p % 16 == 0 &&
         (st[0] * itemsize) % 16 == 0 && (st[1] * itemsize) % 16 == 0 &&
         (st[2] * itemsize) % 16 == 0;
}

// The raw sums of a block: acc[k][j][e] of this warp's tile over its NK
// source rows.  load(ci) stages chunk ci into ring stage ci % NSTAGE and
// commits one cp.async group (also past the last chunk); target(ci) is the
// [pixel][channel] buffer of chunk ci; source(ci) the [row][channel][column]
// buffer its products read, called once chunk ci has landed and the block
// has synchronised (it may finish the chunk's staging in shared memory and
// synchronise again).  Ends with the ring drained and the block in step.
template <int P, int TH, int KS, class Load, class Target, class Source>
__device__ __forceinline__ void band_products(float (&acc)[Geo<P, TH, KS>::NK][2][4],
                                              int nchunks, int pair, int seg, int k0,
                                              int lane, Load load, Target target,
                                              Source source) {
  using G = Geo<P, TH, KS>;
  // ldmatrix lane offsets (elements).  A, 16 rows x 16 channels, rows 0-7
  // = pixels of target row 2 pair, rows 8-15 = the same pixels of the row
  // below: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k
  // 8-15), (rows 8-15, k 8-15) are a0..a3.  B, the 16-column window of one
  // source row, transposed from [channel][column]: (nt0, k 0-7), (nt0, k
  // 8-15), (nt1, k 0-7), (nt1, k 8-15).
  const int a_off = ((2 * pair + (lane >> 3) % 2) * TWB + SEG * seg + lane % 8) * PSTR +
                    lane / 16 * 8;
  const int b_off = (lane / 8 % 2 * 8 + lane % 8) * SWIN + lane / 16 * 8 + SEG * seg;
  constexpr int KSTEP = 16 * SWIN;  // 16 channels further

#pragma unroll
  for (int k = 0; k < G::NK; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][j][e] = 0.f;

#pragma unroll
  for (int ci = 0; ci < NSTAGE - 1; ++ci) load(ci);

  for (int ci = 0; ci < nchunks; ++ci) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 2) : "memory");
    __syncthreads();  // chunk ci is in; chunk ci - 1's buffer is free
    load(ci + NSTAGE - 1);
    const __nv_bfloat16* ta = target(ci) + a_off;
    const __nv_bfloat16* sr = source(ci) + (2 * pair + k0) * G::S_ROW + b_off;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, ta + ks * 16);
#pragma unroll
      for (int k = 0; k < G::NK; ++k) {
        uint32_t bf[4];
        ldsm_x4_t(bf, sr + k * G::S_ROW + ks * KSTEP);
        mma(acc[k][0], a, bf[0], bf[1]);
        mma(acc[k][1], a, bf[2], bf[3]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free
}

}  // namespace lcorr
