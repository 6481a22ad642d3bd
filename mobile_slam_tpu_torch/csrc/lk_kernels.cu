// Hand-written Hopper (sm_90a) kernels for the three LK operations of the
// tracker: pyramidal KLT (K1), anchor-template refinement (K2) and patch +
// gradient extraction (K3). Each is bound through a plain C entry point
// (pointers, ints, floats and a cudaStream_t) that returns
// cudaGetLastError(); mobile_slam_tpu_torch/ops/cuda_build.py builds this
// file with nvcc at first use and ops/lk.py loads it with ctypes. The device
// helpers live in lk_common.cuh, shared with the probe kernels.
//
// K1 lk_track_kernel replaces mobile_slam_tpu/ops/lk_pallas.py
//    _track_pyramidal (pallas_call at :490, bodies _lk_kernel :197 /
//    _lk_kernel_packed :319).
// K2 lk_refine_kernel replaces lk_pallas.py _refine_template (pallas_call
//    at :763, bodies _refine_kernel :516 / _refine_kernel_packed :615).
// K3 lk_extract_kernel replaces lk_pallas.py _extract_patches (pallas_call
//    at :884, bodies _extract_kernel :792 / _extract_kernel_packed :822).
//
// Design. One warp (one 32-thread block) per point slot. The 441-element
// (21x21) window is strided over the lanes; the template block, its block
// Scharr gradients and the bilinear template/gradient patches are staged
// in shared memory; the per-iteration window of the next image is read
// straight from global memory (it stays in L1/L2: a whole 512x512 f32
// pyramid is ~1.4 MB); the 2x2 normal equations and the iteration loop
// live in registers, reduced with warp shuffles (the xor butterfly leaves
// the bitwise-identical sum in every lane, so every lane takes the same
// early-exit branch).
//
// What bounds it on this card: at K = 160 slots the grid is 160 warps on
// 132 SMs, so the card is mostly idle and each kernel is latency-bound by
// the dependent iteration chain (up to 30 Gauss-Newton steps per level,
// each a shared-memory pass, two shuffle reductions and a scalar 2x2
// solve). The design keeps that chain short (no block-wide barriers, no
// atomics) and leaves filling the card (folding a batch of streams into
// the grid, CUDA graphs over the frame) to later work.
//
// Semantics kept from the TPU kernels: levels arrive replicate-padded by
// pad = half + 2 and every block origin is clamped in PADDED coordinates
// (a point that wanders further reads a shifted block); gradients are
// Scharr (/32) on the fetched block; bilinear weights are computed in
// fp32 arithmetic (no texture filtering); the template at level l is
// built at pt / 2^l while the search starts from the propagated guess;
// the per-level inside/finite/invertible gate ANDs into ok; K2 clamps the
// TOTAL excursion from pos0 every iteration and reports the mean absolute
// zero-mean residual at the end point.

#include "lk_common.cuh"

__global__ void __launch_bounds__(LK_WARP)
lk_track_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                LevelMeta lv, int pad, const float* __restrict__ pts,
                const int* __restrict__ active, int K, int win, int iters,
                float eps, float min_eig_thr, float* __restrict__ out_pos,
                int* __restrict__ out_ok) {
  __shared__ float tb[(LK_MAX_WIN + 3) * (LK_MAX_WIN + 3)];
  __shared__ float gxb[(LK_MAX_WIN + 1) * (LK_MAX_WIN + 1)];
  __shared__ float gyb[(LK_MAX_WIN + 1) * (LK_MAX_WIN + 1)];
  __shared__ float tp[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float gx[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float gy[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float cp[LK_MAX_WIN * LK_MAX_WIN];

  const int k = blockIdx.x;
  if (k >= K) return;
  const int lane = threadIdx.x;
  const float px = pts[2 * k], py = pts[2 * k + 1];
  if (!active[k]) {
    if (lane == 0) {
      out_pos[2 * k] = px;
      out_pos[2 * k + 1] = py;
      out_ok[k] = 0;
    }
    return;
  }
  const int half = (win - 1) / 2, n3 = win + 3, nw = win * win;
  const float win2 = (float)nw, eps2 = eps * eps;
  const float top_scale = (float)(1 << (lv.n - 1));
  float cx = px / top_scale, cy = py / top_scale;
  bool ok = true;
  for (int lvl = lv.n - 1; lvl >= 0; --lvl) {
    const int h = lv.h[lvl], w = lv.w[lvl];
    const int hp = h + 2 * pad, wp = w + 2 * pad;
    const float* P = prev + lv.off[lvl];
    const float* N = next + lv.off[lvl];
    const float scale = (float)(1 << lvl);
    const float tx = px / scale, ty = py / scale;
    const int tbx = clampi(floor_int(tx) - half - 1 + pad, 0, wp - n3);
    const int tby = clampi(floor_int(ty) - half - 1 + pad, 0, hp - n3);
    float gxx, gxy, gyy;
    build_template(P, wp, tby, tbx, tx - floorf(tx), ty - floorf(ty), win, tb,
                   gxb, gyb, tp, gx, gy, &gxx, &gxy, &gyy);
    bool invertible;
    float inv_det;
    solve_setup(gxx, gxy, gyy, win2, min_eig_thr, &invertible, &inv_det);
    if (invertible) {
      for (int it = 0; it < iters; ++it) {
        sample_patch(N, hp, wp, pad, win, cx, cy, cp);
        float b1 = 0.f, b2 = 0.f;
        for (int i = lane; i < nw; i += LK_WARP) {
          const float diff = cp[i] - tp[i];
          b1 += diff * gx[i];
          b2 += diff * gy[i];
        }
        b1 = warp_sum(b1);
        b2 = warp_sum(b2);
        __syncwarp();
        const float dx = -(gyy * b1 - gxy * b2) * inv_det;
        const float dy = -(gxx * b2 - gxy * b1) * inv_det;
        cx += dx;
        cy += dy;
        if (dx * dx + dy * dy <= eps2) break;
      }
    }
    const bool inside = (cx >= 0.0f) && (cx < w - 1.0f) && (cy >= 0.0f) &&
                        (cy < h - 1.0f);
    ok = ok && invertible && inside && isfinite(cx) && isfinite(cy);
    if (lvl > 0) {
      cx *= 2.0f;
      cy *= 2.0f;
    }
  }
  if (lane == 0) {
    out_pos[2 * k] = cx;
    out_pos[2 * k + 1] = cy;
    out_ok[k] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(LK_WARP)
lk_refine_kernel(const float* __restrict__ img, int h, int w, int pad,
                 const float* __restrict__ t_patch,
                 const float* __restrict__ gx_g, const float* __restrict__ gy_g,
                 const float* __restrict__ pos0, const int* __restrict__ active,
                 int K, int win, int iters, float eps, float max_shift,
                 float* __restrict__ out_pos, int* __restrict__ out_ok,
                 float* __restrict__ out_res) {
  __shared__ float tzm[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float gx[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float gy[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float cp[LK_MAX_WIN * LK_MAX_WIN];

  const int k = blockIdx.x;
  if (k >= K) return;
  const int lane = threadIdx.x;
  const float x0 = pos0[2 * k], y0 = pos0[2 * k + 1];
  if (!active[k]) {
    if (lane == 0) {
      out_pos[2 * k] = x0;
      out_pos[2 * k + 1] = y0;
      out_ok[k] = 0;
      out_res[k] = 0.0f;
    }
    return;
  }
  const int nw = win * win, hp = h + 2 * pad, wp = w + 2 * pad;
  const float win2 = (float)nw, eps2 = eps * eps;
  const long long row = (long long)k * nw;
  float st = 0.f, a = 0.f, b = 0.f, c2 = 0.f;
  for (int i = lane; i < nw; i += LK_WARP) {
    const float t = t_patch[row + i], u = gx_g[row + i], v = gy_g[row + i];
    tzm[i] = t;
    gx[i] = u;
    gy[i] = v;
    st += t;
    a += u * u;
    b += u * v;
    c2 += v * v;
  }
  const float tmean = warp_sum(st) / win2;
  const float gxx = warp_sum(a), gxy = warp_sum(b), gyy = warp_sum(c2);
  __syncwarp();
  for (int i = lane; i < nw; i += LK_WARP) tzm[i] = tzm[i] - tmean;
  __syncwarp();
  bool invertible;
  float inv_det;
  solve_setup(gxx, gxy, gyy, win2, 1e-4f, &invertible, &inv_det);

  float cx = x0, cy = y0;
  if (invertible) {
    for (int it = 0; it < iters; ++it) {
      sample_patch(img, hp, wp, pad, win, cx, cy, cp);
      float s = 0.f;
      for (int i = lane; i < nw; i += LK_WARP) s += cp[i];
      const float cmean = warp_sum(s) / win2;
      float b1 = 0.f, b2 = 0.f;
      for (int i = lane; i < nw; i += LK_WARP) {
        const float diff = (cp[i] - cmean) - tzm[i];
        b1 += diff * gx[i];
        b2 += diff * gy[i];
      }
      b1 = warp_sum(b1);
      b2 = warp_sum(b2);
      __syncwarp();
      const float dx = -(gyy * b1 - gxy * b2) * inv_det;
      const float dy = -(gxx * b2 - gxy * b1) * inv_det;
      const float ox = (cx + dx) - x0, oy = (cy + dy) - y0;
      const float r = sqrtf(ox * ox + oy * oy);
      const float sc = r > max_shift ? max_shift / fmaxf(r, 1e-9f) : 1.0f;
      cx = x0 + ox * sc;
      cy = y0 + oy * sc;
      if (dx * dx + dy * dy <= eps2) break;
    }
  }
  sample_patch(img, hp, wp, pad, win, cx, cy, cp);
  float s = 0.f;
  for (int i = lane; i < nw; i += LK_WARP) s += cp[i];
  const float cmean = warp_sum(s) / win2;
  float ra = 0.f;
  for (int i = lane; i < nw; i += LK_WARP) ra += fabsf((cp[i] - cmean) - tzm[i]);
  const float resid = warp_sum(ra) / win2;
  if (lane == 0) {
    const bool inside = (cx >= 0.0f) && (cx < w - 1.0f) && (cy >= 0.0f) &&
                        (cy < h - 1.0f);
    out_pos[2 * k] = cx;
    out_pos[2 * k + 1] = cy;
    out_ok[k] = (invertible && inside && isfinite(cx) && isfinite(cy)) ? 1 : 0;
    out_res[k] = resid;
  }
}

__global__ void __launch_bounds__(LK_WARP)
lk_extract_kernel(const float* __restrict__ img, int h, int w, int pad,
                  const float* __restrict__ centers, int K, int win,
                  float* __restrict__ out_t, float* __restrict__ out_gx,
                  float* __restrict__ out_gy) {
  __shared__ float tb[(LK_MAX_WIN + 3) * (LK_MAX_WIN + 3)];
  __shared__ float gxb[(LK_MAX_WIN + 1) * (LK_MAX_WIN + 1)];
  __shared__ float gyb[(LK_MAX_WIN + 1) * (LK_MAX_WIN + 1)];
  __shared__ float tp[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float gx[LK_MAX_WIN * LK_MAX_WIN];
  __shared__ float gy[LK_MAX_WIN * LK_MAX_WIN];

  const int k = blockIdx.x;
  if (k >= K) return;
  const int half = (win - 1) / 2, n3 = win + 3, nw = win * win;
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const float tx = centers[2 * k], ty = centers[2 * k + 1];
  const int tbx = clampi(floor_int(tx) - half - 1 + pad, 0, wp - n3);
  const int tby = clampi(floor_int(ty) - half - 1 + pad, 0, hp - n3);
  float sxx, sxy, syy;
  build_template(img, wp, tby, tbx, tx - floorf(tx), ty - floorf(ty), win, tb,
                 gxb, gyb, tp, gx, gy, &sxx, &sxy, &syy);
  const long long row = (long long)k * nw;
  for (int i = threadIdx.x; i < nw; i += LK_WARP) {
    out_t[row + i] = tp[i];
    out_gx[row + i] = gx[i];
    out_gy[row + i] = gy[i];
  }
}

extern "C" {

int lk_track_launch(const float* prev, const float* next,
                    const long long* level_off, const int* level_h,
                    const int* level_w, int n_levels, int pad,
                    const float* pts, const int* active, int K, int win,
                    int iters, float eps, float min_eig_thr, float* out_pos,
                    int* out_ok, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > LK_MAX_LEVELS || win < 3 ||
      win > LK_MAX_WIN || K < 1)
    return (int)cudaErrorInvalidValue;
  LevelMeta lv;
  for (int i = 0; i < n_levels; ++i) {
    lv.off[i] = level_off[i];
    lv.h[i] = level_h[i];
    lv.w[i] = level_w[i];
  }
  lv.n = n_levels;
  lk_track_kernel<<<K, LK_WARP, 0, stream>>>(prev, next, lv, pad, pts, active,
                                             K, win, iters, eps, min_eig_thr,
                                             out_pos, out_ok);
  return (int)cudaGetLastError();
}

int lk_refine_launch(const float* img, int h, int w, int pad,
                     const float* t_patch, const float* gx, const float* gy,
                     const float* pos0, const int* active, int K, int win,
                     int iters, float eps, float max_shift, float* out_pos,
                     int* out_ok, float* out_res, cudaStream_t stream) {
  if (win < 3 || win > LK_MAX_WIN || K < 1) return (int)cudaErrorInvalidValue;
  lk_refine_kernel<<<K, LK_WARP, 0, stream>>>(img, h, w, pad, t_patch, gx, gy,
                                              pos0, active, K, win, iters, eps,
                                              max_shift, out_pos, out_ok,
                                              out_res);
  return (int)cudaGetLastError();
}

int lk_extract_launch(const float* img, int h, int w, int pad,
                      const float* centers, int K, int win, float* out_t,
                      float* out_gx, float* out_gy, cudaStream_t stream) {
  if (win < 3 || win > LK_MAX_WIN || K < 1) return (int)cudaErrorInvalidValue;
  lk_extract_kernel<<<K, LK_WARP, 0, stream>>>(img, h, w, pad, centers, K, win,
                                               out_t, out_gx, out_gy);
  return (int)cudaGetLastError();
}

}  // extern "C"
