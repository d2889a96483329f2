// Local correlation volume (K3) on NHWC feature maps, forward only.
//
//   out[b, h, w, (dy+R)*P + (dx+R)] = sum_c t[b, h, w, c] * s[b, h+dy, w+dx, c]
//
// with zeros where (h+dy, w+dx) falls outside the image, P odd <= 9,
// R = (P-1)/2.  Inputs are bf16 or fp32, read through their strides; the
// sums are fp32 and the output is (B, H, W, P*P) fp32, contiguous.
//
// Replaces the TPU kernel refign_tpu/ops/correlation.py:
// _local_correlation_pallas (Pallas body _corr_kernel).  That kernel walks
// pre-stacked overlapping source strips kept whole in VMEM; here a block
// stages a halo tile of the source in shared memory instead, so nothing is
// padded or copied in device memory.
//
// What bounds it on an H100: operations.  It does 2*P*P*C flops per pixel
// on the CUDA cores (fp32, 67 TFLOP/s) against 2*C*itemsize + 4*P*P bytes
// (3.35 TB/s): at P = 9 in bf16 that is 25 flops per byte at C = 128 and
// 31 at C = 256, above the card's 20.  The fp32 rate is within reach only
// if each shared-memory load feeds several FMAs.  Design:
//
// * A block owns a tile of TH x TW = 8 x 32 target pixels of one image and
//   runs P warps, one per row displacement dy.  Lane (y, xg) of warp dy owns
//   NP = 8 neighbouring pixels of row y and their P column displacements:
//   8*P sums in registers.  Per channel it loads its 8 target values and
//   the 8+P-1 source values of row y+dy that those pixels see (float4
//   loads), so each source value feeds up to P FMAs.
// * Channels are staged CC = 8 at a time: the target tile and the source
//   halo ((TH+2R) x (TW+2R)) are converted to fp32 in shared memory, laid
//   out [c][row][col] with row strides chosen so that the float4 loads of a
//   quarter-warp hit distinct banks.  A staging thread owns whole pixels
//   and loads their 8 channels at once (one 16-byte load for NHWC bf16), so
//   the address arithmetic is paid once per pixel, not per value.
//   Out-of-image pixels and channels past C stage as zeros, which gives the
//   zero padding.
// * The sums leave through shared memory (the input buffers are reused), so
//   that each output row segment of 32 pixels x P*P floats is written with
//   coalesced stores.
//
// Later work, not here: tensor cores (the volume is a banded batched
// product), double-buffered cp.async/TMA staging, and a fused ReLU + L2
// epilogue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  // lanes of different rows land on different banks
  static constexpr int OUT_RS = TW * PP + 1;
  static constexpr int IN_FLOATS = CC * (TPLANE + SPLANE);
  static constexpr int OUT_FLOATS = TH * OUT_RS;
  static constexpr int SMEM_BYTES =
      4 * (IN_FLOATS > OUT_FLOATS ? IN_FLOATS : OUT_FLOATS);
  static constexpr int THREADS = 32 * P;
  static_assert(SWS >= SW && SWS >= (XG - 1) * NP + NS, "source rows too short");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive values, one 16-byte load for bf16 (two for fp32)
__device__ __forceinline__ void load8(const float* p, float (&v)[CC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[CC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

static_assert(CC == 8, "load8 stages one chunk");

// Stage a ROWS x COLS box of one image, channels c0 .. c0+CC-1, into
// dst[c * plane + r * row_stride + col] as fp32; zero outside the image and
// past C.  Each thread owns whole pixels of the box (consecutive threads,
// consecutive columns) and loads the chunk's CC channels of each: one
// address per pixel, CC loads in flight.  ``vec8`` (channels contiguous,
// C % 8 == 0, 16-byte aligned) makes them one vector load; for the NHWC
// view of an NCHW tensor the lanes' scalar loads are coalesced along W.
template <typename T, int NT, int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int plane, int row_stride,
                                      const T* src, int gy0, int gx0, int c0,
                                      int H, int W, int C, long long sh,
                                      long long sw, long long sc, bool vec8) {
  for (int p = threadIdx.x; p < ROWS * COLS; p += NT) {
    const int r = p / COLS, x = p % COLS;
    const int gy = gy0 + r, gx = gx0 + x;
    float v[CC];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const T* q = src + gy * sh + gx * sw + c0 * sc;
      if (vec8) {
        load8(q, v);
      } else {
#pragma unroll
        for (int c = 0; c < CC; ++c) v[c] = c0 + c < C ? to_f32(q[c * sc]) : 0.f;
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

template <typename T, int P>
__global__ void __launch_bounds__(32 * P, 2)
local_correlation_kernel(const T* __restrict__ t, const T* __restrict__ s,
                         float* __restrict__ out, int H, int W, int C,
                         long long tb, long long th, long long tw, long long tc,
                         long long sb, long long sh, long long sw, long long sc,
                         int t_vec8, int s_vec8) {
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
  const T* tb_ = t + b * tb;
  const T* sb_ = s + b * sb;

  float acc[NP][P];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int d = 0; d < P; ++d) acc[j][d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    stage<T, G::THREADS, TH, TW>(st, TPLANE, TWS, tb_, y0, x0, c0, H, W, C, th, tw,
                                 tc, t_vec8);
    stage<T, G::THREADS, G::SH, G::SW>(ss, G::SPLANE, SWS, sb_, y0 - G::R, x0 - G::R,
                                       c0, H, W, C, sh, sw, sc, s_vec8);
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

  // sums -> shared memory [row][col * PP + k] -> coalesced row segments
  float* so = smem;
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int d = 0; d < P; ++d)
      so[ty * G::OUT_RS + (xg * NP + j) * G::PP + dyi * P + d] = acc[j][d];
  __syncthreads();
  const int ncols = min(TW, W - x0);
  for (int r = 0; r < TH; ++r) {
    const int gy = y0 + r;
    if (gy >= H) break;
    float* orow = out + (((long long)b * H + gy) * W + x0) * G::PP;
    for (int i = threadIdx.x; i < ncols * G::PP; i += blockDim.x)
      orow[i] = so[r * G::OUT_RS + i];
  }
}

// whole 8-channel chunks of every pixel are 16-byte aligned vectors
bool vec8_ok(const void* p, const long long* st, int C, int itemsize) {
  return st[3] == 1 && C % CC == 0 && (uintptr_t)p % 16 == 0 &&
         (st[0] * itemsize) % 16 == 0 && (st[1] * itemsize) % 16 == 0 &&
         (st[2] * itemsize) % 16 == 0;
}

template <typename T, int P>
int launch_p(const void* t, const void* s, float* out, int B, int H, int W, int C,
             const long long* ts, const long long* ss, cudaStream_t stream) {
  using G = Geo<P>;
  auto kern = local_correlation_kernel<T, P>;
  // the attribute belongs to the current device: set it before every
  // launch so a process that launches on several cards gets it on each
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), out, H, W, C, ts[0], ts[1],
      ts[2], ts[3], ss[0], ss[1], ss[2], ss[3], (int)vec8_ok(t, ts, C, sizeof(T)),
      (int)vec8_ok(s, ss, C, sizeof(T)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* t, const void* s, float* out, int B, int H, int W, int C,
           int P, const long long* ts, const long long* ss, cudaStream_t stream) {
  switch (P) {
    case 1: return launch_p<T, 1>(t, s, out, B, H, W, C, ts, ss, stream);
    case 3: return launch_p<T, 3>(t, s, out, B, H, W, C, ts, ss, stream);
    case 5: return launch_p<T, 5>(t, s, out, B, H, W, C, ts, ss, stream);
    case 7: return launch_p<T, 7>(t, s, out, B, H, W, C, ts, ss, stream);
    case 9: return launch_p<T, 9>(t, s, out, B, H, W, C, ts, ss, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// t, s (B,H,W,C) of one type (bf16 when is_bf16, else fp32), element
// strides (b, h, w, c) for each; out (B,H,W,P*P) fp32 contiguous.  Returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int local_correlation_forward(
    const void* t, const void* s, void* out, int is_bf16, int B, int H, int W, int C,
    int P, long long tb, long long th, long long tw, long long tc, long long sb,
    long long sh, long long sw, long long sc, void* stream) {
  const long long ts[4] = {tb, th, tw, tc};
  const long long ss[4] = {sb, sh, sw, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_bf16) return launch<__nv_bfloat16>(t, s, o, B, H, W, C, P, ts, ss, st);
  return launch<float>(t, s, o, B, H, W, C, P, ts, ss, st);
}
