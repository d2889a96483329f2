// Backward of the local correlation volume (K3) on NHWC feature maps.
//
// The forward (local_correlation.cu) is
//
//   raw[p, k] = sum_c t[p, c] * s[p + d_k, c],   d_k = (dy - R, dx - R),
//
// with k = dy * P + dx, P odd <= 9, R = (P - 1) / 2 and s zero outside the
// image.  For the volume's gradient graw this computes, in fp32 whatever
// the input type,
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
// What bounds it on an H100: bytes, read t, s and g and write gt and gs
// once, 4 C + P^2 (g's size) elements a pixel; the products are 4 P^2 C
// flops a pixel (8 P^2 C with the fused mode's recompute), on the CUDA
// cores in fp32 here.  This first design is simple: two kernels, each
// block one 16-pixel row segment, channels 16 at a time through shared
// memory, compiled for each P.
//   1. (fused mode) raw_grad_kernel: stages the target segment and the
//      P source rows of its halo (16 + 2R columns), recomputes the P^2 raw
//      sums of its 16 pixels in registers, and writes graw, fp32
//      (B, H, W, P^2), to a scratch map.
//   2. input_grad_kernel: stages the P^2 graw values of its 16 pixels
//      (gt) and the P^2 values its 16 source pixels gather (gs), then for
//      each channel chunk the source and target halos, and sums both
//      products; a thread owns one channel of one pixel of each.
// Each halo is read P x (16 + 2R) / 16 times from L2 (13.5x at P = 9), and
// the fp32 CUDA-core products are the other cost.  Halo loads walk the
// tensor's contiguous axis: channels where the channel stride is 1 (the
// head's normalised target), columns where it is not (the warped source,
// the NHWC view of grid_sample's NCHW output).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Args {
  const void *t, *s, *g;
  float* graw;
  void *gt, *gs;
  int B, H, W, C;
  const long long *ts, *ss, *gst;
  int fused;
  cudaStream_t stream;
};

template <int P, typename T, typename G>
int launch(const Args& a) {
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

template <int P>
int launch_p(const Args& a, int is_bf16, int g_bf16) {
  using bf16 = __nv_bfloat16;
  if (is_bf16) return g_bf16 ? launch<P, bf16, bf16>(a) : launch<P, bf16, float>(a);
  return g_bf16 ? launch<P, float, bf16>(a) : launch<P, float, float>(a);
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
