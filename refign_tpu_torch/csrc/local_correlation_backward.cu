// Backward of the local correlation volume (K3) on NHWC feature maps.
//
// The forward (local_correlation.cu) is
//
//   raw[p, k] = sum_c t[p, c] * s[p + d_k, c],   d_k = (dy - R, dx - R),
//
// with k = dy * P + dx, P odd <= 9, R = (P - 1) / 2 and s zero outside the
// image.  For the volume's gradient graw this computes
//
//   gt[p, c] = sum_k graw[p, k] * s[p + d_k, c]
//   gs[q, c] = sum_k graw[q - d_k, k] * t[q - d_k, c]   (zero outside),
//
// and writes gt and gs in the input type, NHWC contiguous.  In the fused
// mode the forward's output was n = r / max(|r|, 1e-12), r = max(raw, 0),
// and graw is first formed per pixel from the output gradient g:
//
//   graw = relu'(raw) * (g - n <g, n>) / |r|    where sum r^2 >= 1e-24,
//   graw = relu'(raw) * g / 1e-12               where it is clamped,
//
// with relu'(0) = 0.5 (1 above, 0 below): the gradient that JAX's
// jnp.maximum(corr, 0) and jnp.maximum(ss, 1e-24) give
// (refign_tpu/ops/correlation.py:181-184).  The raw sums are recomputed
// here in fp32 rather than read back from the forward's normalised output,
// which cannot tell raw == 0 from raw < 0.
//
// Replaces the backward of the TPU kernel refign_tpu/ops/correlation.py:106
// (_local_correlation_pallas): its custom_vjp (:124-144) takes jax.vjp of
// the XLA shift loop (:49-63), and local_correlation_relu_l2norm
// (:174-184) puts the ReLU + L2 before it.  JAX's VJP of the shift loop
// scatters graw back with pads and slices; here every output element has
// one owner that gathers its sum (gs in gather form), so there are no
// atomics and the result does not depend on the schedule.
//
// What bounds it on an H100: bytes.  The function reads t, s and g and
// writes gt and gs once, 4 C + P^2 (g's size) elements a pixel, for 4 P^2 C
// flops a pixel (8 P^2 C with the fused mode's recompute): at P = 9 in bf16
// ~40 flops a byte, far under the card's ridge at the bf16 tensor-core rate
// (~295).  Design of the bf16 body, two kernels:
//
// * A (fused mode): the forward's banded raw product on the tensor cores
//   (local_correlation_tile.cuh: 8 x 16 target tiles, mma.sync m16n8k16,
//   32-channel chunks in a 3-stage cp.async ring), so its fp32 raw sums are
//   the forward's bit for bit; its epilogue forms graw per pixel with the
//   rule above (a warp a pixel, g read through its strides: on the path a
//   slice of the decoder's concatenated gradient) and writes an fp32
//   (B, H, W, P^2) scratch map.  The raw mode skips it: graw is g.
// * B: both gradients as banded products on the tensor cores.  As in the
//   forward, a warp's 16 mma rows are 8 pixels of a row pair, and the
//   16-column window (x - 4 .. x + 11) of one other row serves both rows:
//   gt = sum over the pair's P + 1 source rows of A W_s, A the band of
//   graw of the pair's target pixels (9 taps a row), W_s the source window;
//   gs = sum over the P + 1 target rows that the pair's source pixels
//   gather from of A' W_t, A' the band of graw gathered from the 9 target
//   pixels that see each source pixel, W_t the target window.  graw is
//   fp32 and reaches ~1e12 on clamped pixels, whose terms cancel to
//   ordinary sizes: it enters as a bf16 hi + lo pair (two products; one
//   bf16 or one TF32 operand breaks the 3e-5 limit of the backward check,
//   tests/test_torch_correlation_bwd_tiling.py).  t and s are bf16, so
//   exact as operands.  Each pass (gs, then gt) first builds every warp's
//   bands for its P + 1 other rows in shared memory (each graw element is
//   one band element of one warp, read once from device memory) while its
//   first channel chunk stages; then for each 32-channel chunk (2-stage
//   cp.async ring) the windows come by ldmatrix (the source's
//   [channel][column] layout as is, the target's [pixel][channel]
//   transposed).  A block is 8 rows x 16 columns (2 rows where 8-row
//   tiles leave SMs idle, the 32^2 level), so a staged window row serves 4
//   row pairs: each input byte is read (8 + 8) / 8 x 24 / 16 = 3x from L2
//   (the first design: 13.5x).  Only the wanted gradients are formed and
//   only their windows staged: on the UAWarpC path the target is frozen,
//   gs alone.
// * Staging the warped source, the NHWC view of grid_sample's NCHW output
//   (column stride 1, channel stride H W).  At W = 130 every staged row
//   starts on a 4-byte word and goes by 4-byte cp.async straight into the
//   forward's [row][channel][column] layout (8-byte where rows start on
//   8-byte words, W = 32).  At W = 65 rows start at every 2-byte phase: the
//   8-byte-aligned words that cover each row go by 8-byte cp.async into a
//   64-byte landing slot, words across the image's edge element by
//   element, and one pass in shared memory shifts each row into place (a
//   funnel shift of 32-bit words where the phase is odd).  Landing serves
//   every phase, but the in-place words save its pass: staging the W = 130
//   and 32 levels by landing too took 5 % and 28 % longer with both
//   gradients (kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W).  The target
//   (NHWC contiguous) stages by 16-byte cp.async.  Other layouts stage
//   element by element.
// * Occupancy on an H100 (nvcc -Xptxas -v in chip_smoke.py's build): A
//   <9, 8, 2, 1> 128 registers with 64 bytes spilled, 150 KB of shared
//   memory, one block (16 warps) an SM; B <9, 8> 166 registers, 140 KB (gs
//   alone) or 168 KB (both), one block (8 warps) an SM; at the 32^2 level
//   A <9, 2, 2, 2> 187 registers, 82.5 KB, two blocks, and B <9, 2> 162
//   registers, 57.5 KB (gs alone), three blocks.  Latency, not the tensor
//   cores or the bytes, bounds both kernels: few warps an SM wait on L2.
//
// fp32 inputs keep the first design on the CUDA cores (fp32 products: a
// bf16 or TF32 product of fp32 values would break the fp32 check): in the
// fused mode raw_grad_kernel recomputes the raw sums and writes graw, then
// input_grad_kernel gathers gt and gs over 16-pixel row segments, channels
// 16 at a time through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "local_correlation_tile.cuh"

namespace {

// --------------------------------------------------- fp32: the CUDA cores

namespace fp {

constexpr int MAXP = 9;             // patch sizes 1, 3, ..., 9
constexpr int MAXPP = MAXP * MAXP;  // taps a pixel
constexpr int TX = 16;              // target pixels of one row a block
constexpr int KC = 16;              // channels a staged chunk
constexpr int CS = KC + 1;          // padded channel row of a staged pixel
constexpr int HWIN = TX + MAXP - 1;  // staged halo columns
constexpr int NT = 256;             // threads a block
constexpr int NPAIR = (TX * MAXPP + NT - 1) / NT;  // (pixel, tap) sums a thread

static_assert(NT == TX * KC, "a thread owns one channel of one pixel");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage channels [c0, c0 + KC) of rows y - R .. y + R, columns
// x0 - R .. x0 + TX + R - 1 of image b of x into dst[row][col][c] (CS
// floats a column, HWIN columns a row), zero outside the image and past C.
// The loop walks channels fastest where they are contiguous (xc == 1),
// else columns.
template <int P, typename T>
__device__ __forceinline__ void stage_halo(float* dst, const T* x, int b, int y, int x0,
                                           int c0, int H, int W, int C, long long xb,
                                           long long xh, long long xw, long long xc) {
  constexpr int R = (P - 1) / 2, cols = TX + 2 * R, n = P * cols * KC;
  const T* base = x + b * xb;
  for (int i = threadIdx.x; i < n; i += NT) {
    int r, col, c;
    if (xc == 1) {
      c = i % KC;
      col = (i / KC) % cols;
      r = i / (KC * cols);
    } else {
      col = i % cols;
      c = (i / cols) % KC;
      r = i / (cols * KC);
    }
    const int gy = y - R + r, gx = x0 - R + col, gc = c0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
      v = ld(base + gy * xh + gx * xw + gc * xc);
    dst[(r * HWIN + col) * CS + c] = v;
  }
}

// graw of the fused mode for the 16 pixels (b, y, x0 ..) of a block.
template <int P, typename T, typename G>
__global__ void __launch_bounds__(NT) raw_grad_kernel(
    const T* __restrict__ t, const T* __restrict__ s, const G* __restrict__ g,
    float* __restrict__ graw, int H, int W, int C, long long tb, long long th,
    long long tw, long long tc, long long sb, long long sh, long long sw, long long sc,
    long long gb, long long gh, long long gw, long long gk) {
  __shared__ float t_sh[TX * CS];
  __shared__ float s_sh[MAXP * HWIN * CS];
  __shared__ float raw_sh[TX * MAXPP];
  const int x0 = blockIdx.x * TX, y = blockIdx.y, b = blockIdx.z;
  constexpr int PP = P * P;

  // pair j of this thread: pixel (tid + j NT) % TX, tap (tid + j NT) / TX,
  // so a warp reads 16 neighbouring pixels of two taps
  float acc[NPAIR];
#pragma unroll
  for (int j = 0; j < NPAIR; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    for (int i = threadIdx.x; i < TX * KC; i += NT) {
      int px, c;
      if (tc == 1) {
        c = i % KC;
        px = i / KC;
      } else {
        px = i % TX;
        c = i / TX;
      }
      const int gx = x0 + px, gc = c0 + c;
      t_sh[px * CS + c] =
          (gx < W && gc < C) ? ld(t + b * tb + y * th + gx * tw + gc * tc) : 0.f;
    }
    stage_halo<P>(s_sh, s, b, y, x0, c0, H, W, C, sb, sh, sw, sc);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NPAIR; ++j) {
      const int pair = threadIdx.x + j * NT;
      if (pair < TX * PP) {
        const int px = pair % TX, k = pair / TX;
        const int dy = k / P, dx = k % P;
        const float* tp = t_sh + px * CS;
        const float* sp = s_sh + (dy * HWIN + px + dx) * CS;
        float a = acc[j];
#pragma unroll
        for (int c = 0; c < KC; ++c) a = fmaf(tp[c], sp[c], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NPAIR; ++j) {
    const int pair = threadIdx.x + j * NT;
    if (pair < TX * PP) raw_sh[(pair % TX) * MAXPP + pair / TX] = acc[j];
  }
  __syncthreads();

  // one warp a pixel, lanes over the taps
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int px = warp; px < TX; px += NT / 32) {
    const int gx = x0 + px;
    if (gx >= W) break;
    const float* rp = raw_sh + px * MAXPP;
    const G* gp = g + b * gb + y * gh + gx * gw;
    float raw[3], gv[3];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int k = lane + 32 * i;
      raw[i] = k < PP ? rp[k] : 0.f;
      gv[i] = k < PP ? ld(gp + k * gk) : 0.f;
      const float r = fmaxf(raw[i], 0.f);
      ss = fmaf(r, r, ss);
    }
    ss = warp_sum(ss);
    const float den = sqrtf(fmaxf(ss, 1e-24f));
    const bool clamped = ss < 1e-24f;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) dot = fmaf(gv[i], fmaxf(raw[i], 0.f) / den, dot);
    dot = warp_sum(dot);
    float* op = graw + (((long long)b * H + y) * W + gx) * PP;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int k = lane + 32 * i;
      if (k >= PP) break;
      const float n = fmaxf(raw[i], 0.f) / den;
      const float d = clamped ? gv[i] / den : (gv[i] - n * dot) / den;
      const float slope = raw[i] > 0.f ? 1.f : (raw[i] == 0.f ? 0.5f : 0.f);
      op[k] = slope * d;
    }
  }
}

// gt and gs for the 16 pixels (b, y, x0 ..) of a block from graw (G,
// strides gb, gh, gw, gk); either output may be null.
template <int P, typename T, typename G>
__global__ void __launch_bounds__(NT) input_grad_kernel(
    const T* __restrict__ t, const T* __restrict__ s, const G* __restrict__ graw,
    T* __restrict__ gt, T* __restrict__ gs, int H, int W, int C, long long tb,
    long long th, long long tw, long long tc, long long sb, long long sh, long long sw,
    long long sc, long long gb, long long gh, long long gw, long long gk) {
  __shared__ float s_sh[MAXP * HWIN * CS];
  __shared__ float t_sh[MAXP * HWIN * CS];
  __shared__ float gr_t[MAXPP * TX];  // graw[(y, x0 + px), k]
  __shared__ float gr_s[MAXPP * TX];  // graw[(y, x0 + px) - d_k, k]
  const int x0 = blockIdx.x * TX, y = blockIdx.y, b = blockIdx.z;
  constexpr int R = (P - 1) / 2, PP = P * P;
  const bool want_t = gt != nullptr, want_s = gs != nullptr;

  for (int i = threadIdx.x; i < PP * TX; i += NT) {
    const int px = i % TX, k = i / TX;
    const int gx = x0 + px;
    float vt = 0.f, vs = 0.f;
    if (want_t && gx < W) vt = ld(graw + b * gb + y * gh + gx * gw + k * gk);
    const int py = y - (k / P - R), pxs = gx - (k % P - R);
    if (want_s && gx < W && py >= 0 && py < H && pxs >= 0 && pxs < W)
      vs = ld(graw + b * gb + py * gh + pxs * gw + k * gk);
    gr_t[k * TX + px] = vt;
    gr_s[k * TX + px] = vs;
  }

  const int c = threadIdx.x % KC, px = threadIdx.x / KC;
  const int gx = x0 + px;
  const long long o = (((long long)b * H + y) * W + gx) * C;
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    if (want_t) stage_halo<P>(s_sh, s, b, y, x0, c0, H, W, C, sb, sh, sw, sc);
    if (want_s) stage_halo<P>(t_sh, t, b, y, x0, c0, H, W, C, tb, th, tw, tc);
    __syncthreads();
    if (gx >= W || c0 + c >= C) continue;
    if (want_t) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < PP; ++k) {
        const int dy = k / P, dx = k % P;
        a = fmaf(gr_t[k * TX + px], s_sh[(dy * HWIN + px + dx) * CS + c], a);
      }
      st(gt + o + c0 + c, a);
    }
    if (want_s) {
      // source pixel q gathers from target pixel q - d_k: halo row
      // 2R - dy, column px + 2R - dx
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < PP; ++k) {
        const int dy = k / P, dx = k % P;
        a = fmaf(gr_s[k * TX + px],
                 t_sh[((P - 1 - dy) * HWIN + px + P - 1 - dx) * CS + c], a);
      }
      st(gs + o + c0 + c, a);
    }
  }
}

}  // namespace fp

// ------------------------------------------------- bf16: the tensor cores

namespace tcb {

using namespace lcorr;
using fp::ld;
using bf16 = __nv_bfloat16;

constexpr int LSLOT = 32;  // landing slot of one staged source row, elements
constexpr int LWORDS = 7;  // 8-byte words that cover SWIN columns from any phase
constexpr int BTH = 8;     // kernel B's tile rows (2 where they leave SMs idle)

static_assert(4 * LWORDS >= SWIN + 3 && 4 * LWORDS <= LSLOT && LSLOT % 8 == 0,
              "a slot holds the words over a row from any phase");

// Where a staged row's first column lies within its 8-byte word: the low two
// bits of its element index from s's word, (base + gy sh + c sc + gx) mod 4
// with base = the element phase of s and sh4, sc4 = sh, sc mod 4.
struct Phase {
  int base, sh4, sc4;
  __device__ __forceinline__ Phase(const bf16* s, long long sh, long long sc)
      : base((int)((reinterpret_cast<uintptr_t>(s) >> 1) & 3)), sh4((int)(sh & 3)),
        sc4((int)(sc & 3)) {}
  __device__ __forceinline__ int operator()(int gy, int c, int gx) const {
    return (base + gy * sh4 + c * sc4 + gx) & 3;
  }
};

// How the source stages (source_mode picks one per call):
//   LAND    column stride 1 with rows of any 2-byte phase (W = 65): the
//           8-byte-aligned words that cover each row go by 8-byte cp.async
//           into a slot of LSLOT elements, so the row's first column lands at
//           its phase, and realign() then shifts the rows into the operand
//           layout; a word wholly outside the image is zero-filled, one
//           across its left or right edge copied element by element;
//   WORD2/4 column stride 1, every row's phase a multiple of 2 (W = 130) or 4
//           (W = 32): 4- or 8-byte cp.async straight into the operand layout
//           (a word never straddles the image's edge: gx0 and W are
//           multiples of the word);
//   ELEM    any other layout: element by element into the operand layout.
constexpr int LAND = 0, ELEM = 1, WORD2 = 2, WORD4 = 4;

// Stage channels [c0, c0 + CH) of ROWS source rows from gy0 and SWIN columns
// from gx0: into slots dst[(row * CH + c) * LSLOT ..] (LAND) or the operand
// layout dst[(row * CH + c) * SWIN + col]; zero outside the image and past C.
template <int ROWS, int CH, int NT>
__device__ __forceinline__ void stage_source_rows(bf16* dst, const bf16* s, int gy0, int gx0,
                                                  int c0, int H, int W, int C, long long sh,
                                                  long long sw, long long sc, int mode) {
  if (mode == LAND) {
    const Phase ph(s, sh, sc);
    for (int i = threadIdx.x; i < ROWS * CH * LWORDS; i += NT) {
      const int j = i % LWORDS, rc = i / LWORDS;
      const int gy = gy0 + rc / CH, c = c0 + rc % CH;
      const long long row = gy * sh + c * sc;  // column 0 of the row
      const int x = gx0 - ph(gy, c, gx0) + 4 * j;  // first column of word j
      bf16* d = dst + rc * LSLOT + 4 * j;
      if (gy < 0 || gy >= H || c >= C || x + 4 <= 0 || x >= W) {
        cp_async8(d, s, false);
      } else if (x >= 0 && x + 4 <= W) {
        cp_async8(d, s + row + x, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = x + e >= 0 && x + e < W ? s[row + x + e] : __float2bfloat16(0.f);
      }
    }
  } else if (mode == ELEM) {
    for (int i = threadIdx.x; i < ROWS * CH * SWIN; i += NT) {
      const int x = i % SWIN, rc = i / SWIN;
      const int gy = gy0 + rc / CH, gx = gx0 + x, c = c0 + rc % CH;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      dst[rc * SWIN + x] = ok ? s[gy * sh + gx * sw + c * sc] : __float2bfloat16(0.f);
    }
  } else {
    const int wpr = SWIN / mode;  // words a row
    for (int i = threadIdx.x; i < ROWS * CH * wpr; i += NT) {
      const int j = i % wpr, rc = i / wpr;
      const int gy = gy0 + rc / CH, c = c0 + rc % CH, x = gx0 + mode * j;
      const bool ok = gy >= 0 && gy < H && c < C && x >= 0 && x < W;
      const bf16* src = ok ? s + gy * sh + c * sc + x : s;
      if (mode == WORD4)
        cp_async8(dst + rc * SWIN + 4 * j, src, ok);
      else
        cp_async4(dst + rc * SWIN + 2 * j, src, ok);
    }
  }
}

// LAND: the landed rows into the operand layout dst[(row * CH + c) * SWIN +
// col], as 32-bit words from each row's phase (a funnel shift where it is
// odd).
template <int ROWS, int CH, int NT>
__device__ __forceinline__ void realign(bf16* dst, const bf16* land, const bf16* s, int gy0,
                                        int gx0, int c0, long long sh, long long sc) {
  constexpr int WPR = SWIN / 2;  // 32-bit words a row
  const Phase ph(s, sh, sc);
  for (int i = threadIdx.x; i < ROWS * CH * WPR; i += NT) {
    const int w = i % WPR, rc = i / WPR;
    const int a = ph(gy0 + rc / CH, c0 + rc % CH, gx0);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(land + rc * LSLOT) + a / 2 + w;
    uint32_t v = src[0];
    if (a & 1) v = __funnelshift_r(v, src[1], 16);
    reinterpret_cast<uint32_t*>(dst + rc * SWIN)[w] = v;
  }
}

// ------------------------------------------------ kernel A: graw

// The forward's ring with source stages the size of LAND's slots, and the
// buffer that LAND realigns into for the products.
template <int P, int TH, int KS>
struct AGeo {
  using G = Geo<P, TH, KS>;
  static constexpr int LAND_ELEMS = G::SROWS * KC * LSLOT;
  static constexpr int STAGE_BYTES = 2 * (G::T_ELEMS + LAND_ELEMS);
  static constexpr int OP_OFF = NSTAGE * STAGE_BYTES;
  static constexpr int IN_BYTES = OP_OFF + 2 * G::S_ELEMS;
  static constexpr int OUT_BYTES = 4 * TH * G::OUT_RS;
  static constexpr int SMEM_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
  static_assert(STAGE_BYTES % 16 == 0 && OP_OFF % 16 == 0, "16-byte aligned");
};

// graw (B, H, W, P*P) fp32 of a TH x TWB block: the forward's raw sums,
// bit for bit (its band_products on the same staged values), then per pixel
// JAX's gradient of the ReLU + L2 for the output gradient g (GT, strided).
template <int P, int TH, int KS, int MINB, typename GT>
__global__ void __launch_bounds__(32 * TH * KS, MINB)
graw_kernel(const bf16* __restrict__ t, const bf16* __restrict__ s,
            const GT* __restrict__ g, float* __restrict__ graw, int H, int W, int C,
            long long tb, long long th, long long tw, long long tc, long long sb,
            long long sh, long long sw, long long sc, long long gb, long long gh,
            long long gw, long long gk, int t_vec, int s_mode) {
  using G = Geo<P, TH, KS>;
  using A = AGeo<P, TH, KS>;
  constexpr int PP = G::PP;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TWB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpart = warp % KS;
  const int seg = warp / KS % 2;
  const int pair = warp / KS / 2;
  const int k0 = kpart * G::NK;
  const bf16* tb_ = t + b * tb;
  const bf16* sb_ = s + b * sb;
  const int nchunks = (C + KC - 1) / KC;
  const int gy0 = y0 - G::R, gx0 = x0 - HALO;

  auto t_buf = [&](int st) { return reinterpret_cast<bf16*>(smem + st * A::STAGE_BYTES); };
  auto land = [&](int st) { return t_buf(st) + G::T_ELEMS; };
  bf16* op = reinterpret_cast<bf16*>(smem + A::OP_OFF);
  auto load = [&](int ci) {
    if (ci < nchunks) {
      const int st = ci % NSTAGE;
      stage_target<TH, TWB, G::NT>(t_buf(st), tb_, y0, x0, ci * KC, H, W, C, th, tw, tc,
                                   t_vec);
      stage_source_rows<G::SROWS, KC, G::NT>(land(st), sb_, gy0, gx0, ci * KC, H, W, C, sh,
                                             sw, sc, s_mode);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto source = [&](int ci) {
    if (s_mode != LAND) return static_cast<const bf16*>(land(ci % NSTAGE));
    realign<G::SROWS, KC, G::NT>(op, land(ci % NSTAGE), sb_, gy0, gx0, ci * KC, sh, sc);
    __syncthreads();
    return static_cast<const bf16*>(op);
  };

  float acc[G::NK][2][4];
  band_products<P, TH, KS>(
      acc, nchunks, pair, seg, k0, lane, load, [&](int ci) { return t_buf(ci % NSTAGE); },
      source);

  // the band into shared memory, so[row][pixel * PP + tap], as the forward
  float* so = reinterpret_cast<float*>(smem);
  const int gq = lane / 4, q = lane % 4;
#pragma unroll
  for (int k = 0; k < G::NK; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int dyi = k0 + k - h;
        const int dxi = 8 * j + 2 * q + e % 2 - gq - HALO + G::R;
        if (dyi >= 0 && dyi < P && dxi >= 0 && dxi < P)
          so[(2 * pair + h) * G::OUT_RS + (SEG * seg + gq) * PP + dyi * P + dxi] =
              acc[k][j][e];
      }
  __syncthreads();

  // TPP neighbouring threads a pixel, each over every TPP-th tap
  constexpr int TPP = G::NT / G::NPIX, KPT = (PP + TPP - 1) / TPP;
  static_assert(TPP == 4 && G::NT == TPP * G::NPIX, "4 lanes a pixel");
  const int p = threadIdx.x / TPP, part = threadIdx.x % TPP;
  const int gy = y0 + p / TWB, gx = x0 + p % TWB;
  const bool in = gy < H && gx < W;
  const float* rp = so + p / TWB * G::OUT_RS + p % TWB * PP;
  const GT* gp = g + b * gb + gy * gh + gx * gw;
  float raw[KPT], gv[KPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = part + TPP * i;
    raw[i] = k < PP ? rp[k] : 0.f;
    gv[i] = in && k < PP ? ld(gp + k * gk) : 0.f;
    const float rr = fmaxf(raw[i], 0.f);
    ss = fmaf(rr, rr, ss);
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float den = sqrtf(fmaxf(ss, 1e-24f));
  const bool clamped = ss < 1e-24f;
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < KPT; ++i) dot = fmaf(gv[i], fmaxf(raw[i], 0.f) / den, dot);
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  if (!in) return;
  float* o = graw + (((long long)b * H + gy) * W + gx) * PP;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = part + TPP * i;
    if (k >= PP) break;
    const float n = fmaxf(raw[i], 0.f) / den;
    const float d = clamped ? gv[i] / den : (gv[i] - n * dot) / den;
    const float slope = raw[i] > 0.f ? 1.f : (raw[i] == 0.f ? 0.5f : 0.f);
    o[k] = slope * d;
  }
}

// ----------------------------------------- kernel B: gt and gs from graw

// A TH x TWB block of pixels, a warp per (row pair, segment); the windows
// of its P + 1 other rows: TH + P - 1 rows of SWIN columns from x0 - HALO.
// Shared memory: each warp's band (A operands, hi and lo, of its P + 1
// other rows, built once for all chunks), then per KC-channel chunk two
// stages of the target window [pixel][channel] (gs), or of the landed
// source rows plus one realigned source buffer (gt).
template <int P, int TH>
struct BGeo {
  static constexpr int R = (P - 1) / 2;
  static constexpr int NT = 32 * TH;
  static constexpr int SROWS = TH + P - 1;
  static constexpr int BAND_BYTES = TH * (P + 1) * 2 * 32 * 16;  // uint4 a lane
  static constexpr int T_ELEMS = SROWS * SWIN * PSTR;
  static constexpr int LAND_ELEMS = SROWS * KC * LSLOT;
  static constexpr int S_ELEMS = SROWS * KC * SWIN;
  static constexpr int OP_OFF = BAND_BYTES + 2 * 2 * LAND_ELEMS;
  static constexpr int SMEM_S = BAND_BYTES + 2 * 2 * T_ELEMS;  // the gs pass
  static constexpr int SMEM_T = OP_OFF + 2 * S_ELEMS;          // the gt pass
  static constexpr int SMEM_ALL = SMEM_S > SMEM_T ? SMEM_S : SMEM_T;
  static_assert(TH % 2 == 0 && BAND_BYTES % 16 == 0 && OP_OFF % 16 == 0, "16-byte aligned");
};

// graw values v[0..7] as the A operand of m16n8k16, a bf16 hi + lo pair:
// register i holds elements 2i, 2i + 1 (the lower column low).
__device__ __forceinline__ void split(const float (&v)[8], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(v[2 * i] - hf.x, v[2 * i + 1] - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// A lane's 8 band elements: e -> row h = (e >> 1) & 1 of the pair, window
// column n = 2 q + (e & 1) + 8 (e >> 2).
__device__ __forceinline__ int band_h(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int band_n(int q, int e) { return 2 * q + (e & 1) + 8 * (e >> 2); }

// gt and/or gs (either may be null), bf16 NHWC contiguous, for a TH x TWB
// block from graw (GR, strides gb, gh, gw, gk), one pass each (gs first).
// For other row k = 0..P (source row 2 pair - R + k for gt, target row
// 2 pair - R + k for gs, ascending): D += A_hi W + A_lo W, A the 16 x 16
// band of graw for the pair's two rows, W the row's 16-column window
// (ldmatrix from shared memory) over the chunk's channels.  A pass first
// builds its bands from device memory into shared memory (each graw
// element is one element of one warp's band) while its first chunk
// stages.
template <int P, int TH, typename GR>
__global__ void __launch_bounds__(32 * TH)
grad_kernel(const bf16* __restrict__ t, const bf16* __restrict__ s,
            const GR* __restrict__ graw, bf16* __restrict__ gt, bf16* __restrict__ gs,
            int H, int W, int C, long long tb, long long th, long long tw, long long tc,
            long long sb, long long sh, long long sw, long long sc, long long gb,
            long long gh, long long gw, long long gk, int t_vec, int s_mode) {
  using K = BGeo<P, TH>;
  constexpr int R = K::R;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TWB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = warp % 2, pair = warp / 2;
  const int g = lane / 4, q = lane % 4;
  const bf16* tb_ = t + b * tb;
  const bf16* sb_ = s + b * sb;
  const GR* gb_ = graw + b * gb;
  const int nchunks = (C + KC - 1) / KC;
  const int gy0 = y0 - R, gx0 = x0 - HALO;
  const int ys = y0 + 2 * pair;      // the pair's first row
  const int xs = x0 + SEG * seg + g;  // this lane's band-row pixel column

  // this warp's bands: [k][hi, lo][lane] of 4 words
  uint4* band = reinterpret_cast<uint4*>(smem) + warp * (P + 1) * 2 * 32;
  bf16* stage = reinterpret_cast<bf16*>(smem + K::BAND_BYTES);
  bf16* op = reinterpret_cast<bf16*>(smem + K::OP_OFF);

  // ldmatrix lane offsets.  gt: the source window [channel][column], no
  // transpose: (ch 0-7, col 0-7), (ch 0-7, col 8-15), (ch 8-15, col 0-7),
  // (ch 8-15, col 8-15) are b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
  // gs: the target window [pixel][channel], transposed: (pixel 0-7, ch
  // 0-7), (pixel 8-15, ch 0-7), (pixel 0-7, ch 8-15), (pixel 8-15, ch 8-15).
  const int t_off = (lane / 16 * 8 + lane % 8) * SWIN + lane / 8 % 2 * 8 + SEG * seg;
  const int s_off = (lane / 8 % 2 * 8 + lane % 8 + SEG * seg) * PSTR + lane / 16 * 8;

  for (int pass = 0; pass < 2; ++pass) {
    const bool for_s = pass == 0;
    bf16* out = for_s ? gs : gt;
    if (out == nullptr) continue;
    auto load = [&](int ci) {
      if (ci < nchunks) {
        if (for_s)
          stage_target<K::SROWS, SWIN, K::NT>(stage + ci % 2 * K::T_ELEMS, tb_, gy0, gx0,
                                              ci * KC, H, W, C, th, tw, tc, t_vec);
        else
          stage_source_rows<K::SROWS, KC, K::NT>(stage + ci % 2 * K::LAND_ELEMS, sb_, gy0,
                                                 gx0, ci * KC, H, W, C, sh, sw, sc, s_mode);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    load(0);

    // the bands.  gt: row h is target pixel (ys + h, xs), tap dy = k - h,
    // dx = n - g + R - HALO.  gs: row h is source pixel (ys + h, xs),
    // gathering from target pixel (ys - R + k, x0 + SEG seg - HALO + n)
    // its tap dy = h + 2R - k, dx = g + HALO + R - n.
#pragma unroll
    for (int k = 0; k <= P; ++k) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = band_h(e), n = band_n(q, e);
        int y, x, dy, dx;
        if (for_s) {
          y = ys - R + k, x = x0 + SEG * seg - HALO + n;
          dy = h + 2 * R - k, dx = g + HALO + R - n;
        } else {
          y = ys + h, x = xs;
          dy = k - h, dx = n - g + R - HALO;
        }
        const bool ok = dy >= 0 && dy < P && dx >= 0 && dx < P && y >= 0 && y < H &&
                        x >= 0 && x < W;
        v[e] = ok ? ld(gb_ + y * gh + x * gw + (dy * P + dx) * gk) : 0.f;
      }
      uint32_t hi[4], lo[4];
      split(v, hi, lo);
      band[(2 * k) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      band[(2 * k + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }

    for (int ci = 0; ci < nchunks; ++ci) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // chunk ci is in; chunk ci - 1's buffers are free
      load(ci + 1);
      const bf16* ws = stage + ci % 2 * K::LAND_ELEMS;  // the source rows (gt)
      if (!for_s && s_mode == LAND) {
        realign<K::SROWS, KC, K::NT>(op, ws, sb_, gy0, gx0, ci * KC, sh, sc);
        ws = op;
      }
      __syncthreads();
      const bf16* wt = stage + ci % 2 * K::T_ELEMS;

      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int k = 0; k <= P; ++k) {
        const int row = 2 * pair + k;  // window row of other row k
        const uint4 h4 = band[(2 * k) * 32 + lane], l4 = band[(2 * k + 1) * 32 + lane];
        const uint32_t hi[4] = {h4.x, h4.y, h4.z, h4.w};
        const uint32_t lo[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          if (for_s)
            ldsm_x4_t(bf, wt + row * SWIN * PSTR + 16 * np + s_off);
          else
            ldsm_x4(bf, ws + (row * KC + 16 * np) * SWIN + t_off);
          mma(acc[2 * np], hi, bf[0], bf[1]);
          mma(acc[2 * np], lo, bf[0], bf[1]);
          mma(acc[2 * np + 1], hi, bf[2], bf[3]);
          mma(acc[2 * np + 1], lo, bf[2], bf[3]);
        }
      }

      // D row g is pixel (ys, xs), row g + 8 pixel (ys + 1, xs); column
      // 2 q + (e & 1) of n-tile nt is channel ci KC + 8 nt + 2 q + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ys + h >= H || xs >= W) continue;
        bf16* o = out + (((long long)b * H + ys + h) * W + xs) * C;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = ci * KC + 8 * nt + 2 * q;
          const float v0 = acc[nt][2 * h], v1 = acc[nt][2 * h + 1];
          if (C % 2 == 0 && c + 1 < C) {
            *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < C) o[c] = __float2bfloat16_rn(v0);
            if (c + 1 < C) o[c + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the stages and bands are free for the next pass
  }
}

}  // namespace tcb

struct Args {
  const void *t, *s, *g;
  float* graw;
  void *gt, *gs;
  int B, H, W, C;
  const long long *ts, *ss, *gst;
  int fused;
  cudaStream_t stream;
};

// ------------------------------------------------------------ fp32 launch

template <int P, typename T, typename G>
int launch_fp32(const Args& a) {
  using namespace fp;
  const dim3 grid((a.W + TX - 1) / TX, a.H, a.B);
  const T* t = static_cast<const T*>(a.t);
  const T* s = static_cast<const T*>(a.s);
  if (a.fused) {
    raw_grad_kernel<P, T, G><<<grid, NT, 0, a.stream>>>(
        t, s, static_cast<const G*>(a.g), a.graw, a.H, a.W, a.C, a.ts[0], a.ts[1],
        a.ts[2], a.ts[3], a.ss[0], a.ss[1], a.ss[2], a.ss[3], a.gst[0], a.gst[1], a.gst[2],
        a.gst[3]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    constexpr long long PP = P * P;
    input_grad_kernel<P, T, float><<<grid, NT, 0, a.stream>>>(
        t, s, a.graw, static_cast<T*>(a.gt), static_cast<T*>(a.gs), a.H, a.W, a.C,
        a.ts[0], a.ts[1], a.ts[2], a.ts[3], a.ss[0], a.ss[1], a.ss[2], a.ss[3],
        (long long)a.H * a.W * PP, (long long)a.W * PP, PP, 1);
  } else {
    input_grad_kernel<P, T, G><<<grid, NT, 0, a.stream>>>(
        t, s, static_cast<const G*>(a.g), static_cast<T*>(a.gt), static_cast<T*>(a.gs),
        a.H, a.W, a.C, a.ts[0], a.ts[1], a.ts[2], a.ts[3], a.ss[0], a.ss[1], a.ss[2],
        a.ss[3], a.gst[0], a.gst[1], a.gst[2], a.gst[3]);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 launch

template <int P, int TH, int KS, int MINB, typename GT>
int launch_graw(const Args& a, int t_vec, int s_mode) {
  using bf16 = __nv_bfloat16;
  constexpr int smem = tcb::AGeo<P, TH, KS>::SMEM_BYTES;
  auto kern = tcb::graw_kernel<P, TH, KS, MINB, GT>;
  // the attribute belongs to the current device: set it before every launch
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + lcorr::TWB - 1) / lcorr::TWB, (a.H + TH - 1) / TH, a.B);
  kern<<<grid, 32 * TH * KS, smem, a.stream>>>(
      static_cast<const bf16*>(a.t), static_cast<const bf16*>(a.s),
      static_cast<const GT*>(a.g), a.graw, a.H, a.W, a.C, a.ts[0], a.ts[1], a.ts[2],
      a.ts[3], a.ss[0], a.ss[1], a.ss[2], a.ss[3], a.gst[0], a.gst[1], a.gst[2], a.gst[3],
      t_vec, s_mode);
  return (int)cudaGetLastError();
}

template <int P, int TH, typename GR>
int launch_grad(const Args& a, const GR* graw, const long long* gst, int t_vec,
                int s_mode) {
  using bf16 = __nv_bfloat16;
  using K = tcb::BGeo<P, TH>;
  const int smem = a.gt != nullptr ? K::SMEM_ALL : K::SMEM_S;
  auto kern = tcb::grad_kernel<P, TH, GR>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM_ALL);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + lcorr::TWB - 1) / lcorr::TWB, (a.H + TH - 1) / TH, a.B);
  kern<<<grid, K::NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.t), static_cast<const bf16*>(a.s), graw,
      static_cast<bf16*>(a.gt), static_cast<bf16*>(a.gs), a.H, a.W, a.C, a.ts[0], a.ts[1],
      a.ts[2], a.ts[3], a.ss[0], a.ss[1], a.ss[2], a.ss[3], gst[0], gst[1], gst[2], gst[3],
      t_vec, s_mode);
  return (int)cudaGetLastError();
}

// The source's staging mode (tcb::LAND, ELEM, WORD2, WORD4): whole words of
// 4, else 2 elements where every row starts on one and W is a multiple of it
int source_mode(const void* s, const long long* st, int W) {
  if (st[2] != 1) return tcb::ELEM;
  const uintptr_t e = reinterpret_cast<uintptr_t>(s) / 2;  // element address
  for (int w = tcb::WORD4; w >= tcb::WORD2; w /= 2)
    if (W % w == 0 && e % w == 0 && st[0] % w == 0 && st[1] % w == 0 && st[3] % w == 0)
      return w;
  return tcb::LAND;
}

template <int P, typename GT>
int launch_bf16(const Args& a) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 8-row tiles where they give every SM a block, else 2-row tiles (the
  // 32^2 level), in both kernels
  const bool small = (long long)a.B * ((a.H + 7) / 8) *
                         ((a.W + lcorr::TWB - 1) / lcorr::TWB) < sms;
  const int t_vec = (int)lcorr::vec_channels(a.t, a.ts, a.C, 2);
  const int s_mode = source_mode(a.s, a.ss, a.W);
  if (!a.fused) {
    const GT* g = static_cast<const GT*>(a.g);
    return small ? launch_grad<P, 2>(a, g, a.gst, t_vec, s_mode)
                 : launch_grad<P, tcb::BTH>(a, g, a.gst, t_vec, s_mode);
  }
  const int e = small ? launch_graw<P, 2, 2, 2, GT>(a, t_vec, s_mode)
                      : launch_graw<P, 8, 2, 1, GT>(a, t_vec, s_mode);
  if (e != 0) return e;
  constexpr long long PP = P * P;
  const long long gst[4] = {(long long)a.H * a.W * PP, (long long)a.W * PP, PP, 1};
  return small ? launch_grad<P, 2>(a, (const float*)a.graw, gst, t_vec, s_mode)
               : launch_grad<P, tcb::BTH>(a, (const float*)a.graw, gst, t_vec, s_mode);
}

template <int P>
int launch_p(const Args& a, int is_bf16, int g_bf16) {
  using bf16 = __nv_bfloat16;
  if (is_bf16) return g_bf16 ? launch_bf16<P, bf16>(a) : launch_bf16<P, float>(a);
  return g_bf16 ? launch_fp32<P, float, bf16>(a) : launch_fp32<P, float, float>(a);
}

}  // namespace

// t, s (B,H,W,C) of one type (bf16 when is_bf16, else fp32) and g
// (B,H,W,P*P, bf16 when g_bf16, else fp32), each with its element strides
// (b, h, w, c); gt and gs (B,H,W,C) contiguous in t's type, either may be
// null (not wanted).  fused = 0: g is the raw volume's gradient; fused = 1:
// g is the gradient of its relu_l2norm, and graw must be an fp32
// (B,H,W,P*P) scratch map.  Returns the first launch error (0 if none).
extern "C" int local_correlation_backward(
    const void* t, const void* s, const void* g, float* graw, void* gt, void* gs,
    int is_bf16, int g_bf16, int B, int H, int W, int C, int P, long long tb,
    long long th, long long tw, long long tc, long long sb, long long sh, long long sw,
    long long sc, long long gb, long long gh, long long gw, long long gk, int fused,
    void* stream) {
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (fused && graw == nullptr) return (int)cudaErrorInvalidValue;
  const long long ts[4] = {tb, th, tw, tc};
  const long long ss[4] = {sb, sh, sw, sc};
  const long long gst[4] = {gb, gh, gw, gk};
  const Args a{t, s, g, graw, gt, gs, B, H, W, C, ts, ss, gst, fused,
               static_cast<cudaStream_t>(stream)};
  switch (P) {
    case 1: return launch_p<1>(a, is_bf16, g_bf16);
    case 3: return launch_p<3>(a, is_bf16, g_bf16);
    case 5: return launch_p<5>(a, is_bf16, g_bf16);
    case 7: return launch_p<7>(a, is_bf16, g_bf16);
    case 9: return launch_p<9>(a, is_bf16, g_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}
