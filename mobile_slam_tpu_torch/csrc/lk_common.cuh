// Device helpers shared by the LK kernels (lk_kernels.cu) and the LK
// cost-attribution probe (probe_kernels.cu): warp reductions, the clamped
// block origin, fp32 bilinear weights, the template block with its block
// Scharr gradients, the per-iteration window sample and the 2x2 setup.
// Every helper runs on one warp (one 32-thread block per point slot).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define LK_MAX_WIN 31
#define LK_MAX_LEVELS 8
#define LK_WARP 32

struct LevelMeta {
  long long off[LK_MAX_LEVELS];  // element offset of each padded level
  int h[LK_MAX_LEVELS];          // logical (unpadded) heights
  int w[LK_MAX_LEVELS];          // logical widths
  int n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(x) as int; NaN maps to 0 and out-of-range values saturate (the
// caller clamps the result into the padded image either way).
__device__ __forceinline__ int floor_int(float x) { return __float2int_rd(x); }

// Bilinear value at (r, c) + (fy, fx) inside a row-major block of width ld.
__device__ __forceinline__ float bil(const float* b, int ld, int r, int c,
                                     float w00, float w01, float w10,
                                     float w11) {
  const float* p = b + r * ld + c;
  return w00 * p[0] + w01 * p[1] + w10 * p[ld] + w11 * p[ld + 1];
}

// Loads the (win+3)^2 template block at padded origin (by, bx), computes
// its block Scharr gradients and the bilinear template / gradient patches
// (win*win each) into shared memory. Returns the structure-tensor sums.
__device__ void build_template(const float* __restrict__ img, int wp, int by,
                               int bx, float fx, float fy, int win,
                               float* tb, float* gxb, float* gyb, float* tp,
                               float* gx, float* gy, float* sxx, float* sxy,
                               float* syy) {
  const int lane = threadIdx.x;
  const int n3 = win + 3, n1 = win + 1, nw = win * win;
  for (int i = lane; i < n3 * n3; i += LK_WARP) {
    const int r = i / n3, c = i - r * n3;
    tb[i] = img[(long long)(by + r) * wp + bx + c];
  }
  __syncwarp();
  for (int i = lane; i < n1 * n1; i += LK_WARP) {
    const int r = i / n1, c = i - r * n1;
    const float* t = tb + r * n3 + c;
    const float right = 3.0f * t[2] + 10.0f * t[n3 + 2] + 3.0f * t[2 * n3 + 2];
    const float left = 3.0f * t[0] + 10.0f * t[n3] + 3.0f * t[2 * n3];
    const float bot = 3.0f * t[2 * n3] + 10.0f * t[2 * n3 + 1] + 3.0f * t[2 * n3 + 2];
    const float top = 3.0f * t[0] + 10.0f * t[1] + 3.0f * t[2];
    gxb[i] = (right - left) / 32.0f;
    gyb[i] = (bot - top) / 32.0f;
  }
  __syncwarp();
  const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
  float a = 0.f, b = 0.f, c2 = 0.f;
  for (int i = lane; i < nw; i += LK_WARP) {
    const int r = i / win, c = i - r * win;
    const float t = bil(tb, n3, r + 1, c + 1, w00, w01, w10, w11);
    const float u = bil(gxb, n1, r, c, w00, w01, w10, w11);
    const float v = bil(gyb, n1, r, c, w00, w01, w10, w11);
    tp[i] = t;
    gx[i] = u;
    gy[i] = v;
    a += u * u;
    b += u * v;
    c2 += v * v;
  }
  *sxx = warp_sum(a);
  *sxy = warp_sum(b);
  *syy = warp_sum(c2);
  __syncwarp();
}

// Bilinear win x win patch of the padded image at subpixel (x, y), with the
// (win+1)^2 block origin clamped in padded coordinates; written to out.
__device__ void sample_patch(const float* __restrict__ img, int hp, int wp,
                             int pad, int win, float x, float y, float* out) {
  const int half = (win - 1) / 2, n1 = win + 1, nw = win * win;
  const float x0 = floorf(x), y0 = floorf(y);
  const int bx = clampi(floor_int(x) - half + pad, 0, wp - n1);
  const int by = clampi(floor_int(y) - half + pad, 0, hp - n1);
  const float fx = x - x0, fy = y - y0;
  const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
  const float* base = img + (long long)by * wp + bx;
  for (int i = threadIdx.x; i < nw; i += LK_WARP) {
    const int r = i / win, c = i - r * win;
    out[i] = bil(base, wp, r, c, w00, w01, w10, w11);
  }
  __syncwarp();
}

__device__ __forceinline__ void solve_setup(float gxx, float gxy, float gyy,
                                            float win2, float thr,
                                            bool* invertible, float* inv_det) {
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f))) / win2;
  *invertible = min_eig > thr;
  *inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
}
