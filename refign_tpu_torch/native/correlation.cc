// Local spatial correlation: native CPU implementation (OpenMP), the
// host-side numerics oracle of the port's local correlation
// (refign_tpu_torch/ops/correlation.py, kernel K3) and a copy of the JAX
// package's refign_tpu/native/correlation.cc.  Layout is NHWC
// (channel-last); the math is
//
//   out[n, h, w, (dy+R)*P + (dx+R)] = sum_c t[n,h,w,c] * s[n,h+dy,w+dx,c]
//
// with zero padding outside bounds, P the (odd) patch size, R = (P-1)/2.
// Forward and backward (gradients w.r.t. both inputs) are provided; the
// backward parallelizes over batch only, so accumulation into the gradient
// buffers is race-free.
#include <cstdint>
#include <cstring>

extern "C" {

void correlation_forward_nhwc(const float* target, const float* source,
                              float* out, int64_t N, int64_t H, int64_t W,
                              int64_t C, int64_t P) {
  const int64_t R = (P - 1) / 2;
  const int64_t PP = P * P;
#pragma omp parallel for collapse(2)
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t h = 0; h < H; ++h) {
      for (int64_t w = 0; w < W; ++w) {
        const float* t = target + ((n * H + h) * W + w) * C;
        float* o = out + ((n * H + h) * W + w) * PP;
        for (int64_t dy = -R; dy <= R; ++dy) {
          const int64_t h2 = h + dy;
          for (int64_t dx = -R; dx <= R; ++dx) {
            const int64_t w2 = w + dx;
            const int64_t pi = (dy + R) * P + (dx + R);
            if (h2 < 0 || h2 >= H || w2 < 0 || w2 >= W) {
              o[pi] = 0.0f;
              continue;
            }
            const float* s = source + ((n * H + h2) * W + w2) * C;
            float acc = 0.0f;
            for (int64_t c = 0; c < C; ++c) acc += t[c] * s[c];
            o[pi] = acc;
          }
        }
      }
    }
  }
}

void correlation_backward_nhwc(const float* target, const float* source,
                               const float* grad_out, float* grad_target,
                               float* grad_source, int64_t N, int64_t H,
                               int64_t W, int64_t C, int64_t P) {
  const int64_t R = (P - 1) / 2;
  const int64_t PP = P * P;
  std::memset(grad_target, 0, sizeof(float) * N * H * W * C);
  std::memset(grad_source, 0, sizeof(float) * N * H * W * C);
#pragma omp parallel for
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t h = 0; h < H; ++h) {
      for (int64_t w = 0; w < W; ++w) {
        const float* t = target + ((n * H + h) * W + w) * C;
        float* gt = grad_target + ((n * H + h) * W + w) * C;
        const float* go = grad_out + ((n * H + h) * W + w) * PP;
        for (int64_t dy = -R; dy <= R; ++dy) {
          const int64_t h2 = h + dy;
          if (h2 < 0 || h2 >= H) continue;
          for (int64_t dx = -R; dx <= R; ++dx) {
            const int64_t w2 = w + dx;
            if (w2 < 0 || w2 >= W) continue;
            const float g = go[(dy + R) * P + (dx + R)];
            if (g == 0.0f) continue;
            const float* s = source + ((n * H + h2) * W + w2) * C;
            float* gs = grad_source + ((n * H + h2) * W + w2) * C;
            for (int64_t c = 0; c < C; ++c) {
              gt[c] += g * s[c];
              gs[c] += g * t[c];
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
