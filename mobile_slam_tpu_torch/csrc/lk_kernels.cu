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
// Design of K1 and K2. One block of LK_THREADS (4 warps) per point slot,
// each thread holding at most lk_per_thread(win) pixels of the window (4 of
// the 441 at the main path's 21x21) in registers: their window coordinates,
// template and gradient values. A Gauss-Newton step is ONE fused pass: the
// thread samples its pixels of the next image straight from global memory
// (the pyramid stays in L1/L2), subtracts the template and accumulates the
// right-hand side in registers; block_sum reduces it with warp shuffles,
// one shared-memory exchange and one __syncthreads(), and leaves the
// bitwise-identical sum in every thread, so the early exit and the
// invertible branch are uniform across the block (a barrier in a divergent
// branch would hang). No window is written back to shared memory.
//  - K1 builds the templates of ALL levels before the first step, warp l
//    building level l (and l + 4, ...) into its own slice of dynamic shared
//    memory: the template at level l depends on pts / 2^l of the previous
//    frame only, never on the propagated guess, so the four builds run side
//    by side instead of one after the other on the chain.
//  - K2 keeps the sampled window in registers and takes two reductions per
//    step, as its plain version does: the window's mean, then the two dot
//    products of (c - mean c) - (t - mean t) with the gradients; the raw
//    template's mean comes once, beside the structure tensor. The one-round
//    form, b1 = sum(d gx) - sum(d) / n * sum(gx) with d = c - t
//    (refine_rhs_one_round in ops/lk.py), is 0.0005 ms per launch faster on
//    the main path and as close to the plain version, but moved the serving
//    run's trajectory error out of the reference's band (PERF.md, Findings),
//    so the two-round form stays. The end-point residual samples once and
//    reuses the same two rounds.
//  - The main path's window, 21, is a template parameter (constant
//    divisions, every trip unrolled, no bounds test on a thread's first
//    three pixels); WIN = 0 is the same body with the window read at run
//    time, for every other window in [3, LK_MAX_WIN].
//  - Borders inside the kernel: levels arrive UNPADDED, one pointer per
//    level; block origins are clamped in padded coordinates as before and
//    each pixel's row and column are clamped into the level at the load
//    (lk_common.cuh), which is what the replicate-padded copy held.
//
// What bounds them on this card: neither bytes (a 512x512 pyramid pair is
// 2.8 MB) nor operations, but the dependent chain of the slowest point:
// its steps over all levels x (loads + shuffles + one barrier + the 2x2
// solve), after one template build. 160 blocks of 4 warps on 132 SMs leave
// the card mostly idle; a fleet of B sequences fills it in one launch.
//
// Batch axis (the fleet, mobile_slam_tpu_torch/parallel/batch.py): every
// kernel runs a grid of (K, B) blocks, blockIdx.y the sequence. The point
// arrays (points, active, templates, outputs) are (B, K, ...) contiguous,
// slot b * K + k; each image or level is one contiguous (h, w) plane per
// sequence, the planes a batch stride apart (0 when all sequences share
// one). The block body does not depend on B: B = 1 with stride 0 is the
// single-stream launch, bit for bit.
//
// Design of K3, the same block form with no loop: all LK_THREADS threads
// load the (win+3)^2 template block (576 pixels at window 21, ~4.5 per
// thread) into shared memory with the border clamp, one barrier, the block
// Scharr gradients over the inner (win+1)^2, one barrier; then each thread
// forms the template and gradients of its <= 4 window pixels in registers
// and writes them straight to global memory, consecutive threads to
// consecutive floats (coalesced). No reduction feeds an output and the
// per-pixel expressions are those of the plain version, so the patches do
// not depend on the block shape. Bound: bytes (the pixels of the slots'
// blocks read once, 3 x win^2 floats written per slot), which at the main
// path's shapes is below the cost of one launch, so the launch is what is
// left; window 21 is again a template parameter.
//
// Semantics kept from the TPU kernels: every block origin is clamped in
// PADDED coordinates, pad = half + 2 (a point that wanders further reads a
// shifted block); gradients are
// Scharr (/32) on the fetched block; bilinear weights are computed in
// fp32 arithmetic (no texture filtering); the template at level l is
// built at pt / 2^l while the search starts from the propagated guess;
// the per-level inside/finite/invertible gate ANDs into ok; K2 clamps the
// TOTAL excursion from pos0 every iteration and reports the mean absolute
// zero-mean residual at the end point.

#include "lk_common.cuh"

// Floats of dynamic shared memory K1 needs: three win^2 patches per level
// and, per warp, the scratch of one template build.
static int track_smem_floats(int win, int n_levels) {
  const int n3 = win + 3, n1 = win + 1;
  return n_levels * 3 * win * win + LK_NWARP * (n3 * n3 + 2 * n1 * n1);
}

template <int WIN>
__global__ void __launch_bounds__(LK_THREADS)
lk_track_kernel(LevelMeta lv, const float* __restrict__ pts,
                const unsigned char* __restrict__ active, int win_rt,
                int iters, float eps, float min_eig_thr,
                float* __restrict__ out_pos,
                unsigned char* __restrict__ out_ok) {
  constexpr int PER = lk_per_thread(WIN);
  extern __shared__ float smem[];
  __shared__ float red[2][LK_NWARP * 2];
  __shared__ float sums[LK_MAX_LEVELS][3];

  const long long k = (long long)blockIdx.y * gridDim.x + blockIdx.x;  // slot
  const long long seq = blockIdx.y;                                     // sequence
  const int tid = threadIdx.x, lane = tid & (LK_WARP - 1), warp = tid / LK_WARP;
  const float px = pts[2 * k], py = pts[2 * k + 1];
  if (!active[k]) {  // uniform across the block, ahead of every barrier
    if (tid == 0) {
      out_pos[2 * k] = px;
      out_pos[2 * k + 1] = py;
      out_ok[k] = 0;
    }
    return;
  }
  const int win = WIN > 0 ? WIN : win_rt;
  const int half = (win - 1) / 2, pad = half + 2;
  const int n1 = win + 1, n3 = win + 3, nw = win * win;

  // Templates of every level, warp by warp.
  float* scr = smem + lv.n * 3 * nw + warp * (n3 * n3 + 2 * n1 * n1);
  for (int l = warp; l < lv.n; l += LK_NWARP) {
    const float scale = (float)(1 << l);
    const float tx = px / scale, ty = py / scale;
    float* t = smem + l * 3 * nw;
    float a, b, c;
    build_template_clamped<WIN>(
        lv.prev[l] + seq * lv.bs_prev[l], lv.h[l], lv.w[l],
        block_origin(ty, half + 1, pad, lv.h[l], n3),
        block_origin(tx, half + 1, pad, lv.w[l], n3), tx - floorf(tx),
        ty - floorf(ty), win, scr, scr + n3 * n3, scr + n3 * n3 + n1 * n1, t,
        t + nw, t + 2 * nw, &a, &b, &c);
    if (lane == 0) {
      sums[l][0] = a;
      sums[l][1] = b;
      sums[l][2] = c;
    }
  }
  __syncthreads();

  int pr[PER], pc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * LK_THREADS;
    pr[j] = i / win;
    pc[j] = i - pr[j] * win;
  }
  const float win2 = (float)nw, eps2 = eps * eps;
  const float top_scale = (float)(1 << (lv.n - 1));
  float cx = px / top_scale, cy = py / top_scale;
  bool ok = true;
  int par = 0;
  for (int l = lv.n - 1; l >= 0; --l) {
    const int h = lv.h[l], w = lv.w[l];
    const float* __restrict__ N = lv.next[l] + seq * lv.bs_next[l];
    const float* t = smem + l * 3 * nw;
    float tv[PER], gxv[PER], gyv[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * LK_THREADS;
      const bool live = lk_live<WIN>(j, i, nw);
      tv[j] = live ? t[i] : 0.f;
      gxv[j] = live ? t[nw + i] : 0.f;
      gyv[j] = live ? t[2 * nw + i] : 0.f;
    }
    const float gxx = sums[l][0], gxy = sums[l][1], gyy = sums[l][2];
    bool invertible;
    float inv_det;
    solve_setup(gxx, gxy, gyy, win2, min_eig_thr, &invertible, &inv_det);
    if (invertible) {
      for (int it = 0; it < iters; ++it) {
        const int bx = block_origin(cx, half, pad, w, n1);
        const int by = block_origin(cy, half, pad, h, n1);
        const float fx = cx - floorf(cx), fy = cy - floorf(cy);
        const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
        const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
        float b[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (lk_live<WIN>(j, tid + j * LK_THREADS, nw)) {
            const float diff = sample_clamped(N, h, w, by, bx, pr[j], pc[j], w00,
                                              w01, w10, w11) - tv[j];
            b[0] += diff * gxv[j];
            b[1] += diff * gyv[j];
          }
        }
        block_sum<2>(b, red[par]);
        par ^= 1;
        const float dx = -(gyy * b[0] - gxy * b[1]) * inv_det;
        const float dy = -(gxx * b[1] - gxy * b[0]) * inv_det;
        cx += dx;
        cy += dy;
        if (dx * dx + dy * dy <= eps2) break;
      }
    }
    const bool inside = (cx >= 0.0f) && (cx < w - 1.0f) && (cy >= 0.0f) &&
                        (cy < h - 1.0f);
    ok = ok && invertible && inside && isfinite(cx) && isfinite(cy);
    if (l > 0) {
      cx *= 2.0f;
      cy *= 2.0f;
    }
  }
  if (tid == 0) {
    out_pos[2 * k] = cx;
    out_pos[2 * k + 1] = cy;
    out_ok[k] = ok ? 1 : 0;
  }
}

template <int WIN>
__global__ void __launch_bounds__(LK_THREADS)
lk_refine_kernel(const float* __restrict__ img, long long img_bs, int h, int w,
                 const float* __restrict__ t_patch,
                 const float* __restrict__ gx_g, const float* __restrict__ gy_g,
                 const float* __restrict__ pos0,
                 const unsigned char* __restrict__ active, int win_rt,
                 int iters, float eps, float max_shift,
                 float* __restrict__ out_pos,
                 unsigned char* __restrict__ out_ok,
                 float* __restrict__ out_res) {
  constexpr int PER = lk_per_thread(WIN);
  __shared__ float red[2][LK_NWARP * 4];

  const long long k = (long long)blockIdx.y * gridDim.x + blockIdx.x;  // slot
  img += blockIdx.y * img_bs;                                           // its sequence
  const int tid = threadIdx.x;
  const float x0 = pos0[2 * k], y0 = pos0[2 * k + 1];
  if (!active[k]) {  // uniform across the block, ahead of every barrier
    if (tid == 0) {
      out_pos[2 * k] = x0;
      out_pos[2 * k + 1] = y0;
      out_ok[k] = 0;
      out_res[k] = 0.0f;
    }
    return;
  }
  const int win = WIN > 0 ? WIN : win_rt;
  const int half = (win - 1) / 2, pad = half + 2, n1 = win + 1, nw = win * win;
  const float win2 = (float)nw, eps2 = eps * eps;
  const long long row = k * nw;

  // The template rows, read once and coalesced into registers, with the
  // structure tensor and the raw template's sum (for its mean).
  int pr[PER], pc[PER];
  float tv[PER], gxv[PER], gyv[PER];
  float g[4] = {0.f, 0.f, 0.f, 0.f};  // gxx, gxy, gyy, sum t
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * LK_THREADS;
    const bool live = lk_live<WIN>(j, i, nw);
    pr[j] = i / win;
    pc[j] = i - pr[j] * win;
    tv[j] = live ? t_patch[row + i] : 0.f;
    gxv[j] = live ? gx_g[row + i] : 0.f;
    gyv[j] = live ? gy_g[row + i] : 0.f;
    g[0] += gxv[j] * gxv[j];
    g[1] += gxv[j] * gyv[j];
    g[2] += gyv[j] * gyv[j];
    g[3] += tv[j];
  }
  int par = 0;
  block_sum<4>(g, red[par]);
  par ^= 1;
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float tmean = g[3] / win2;
  bool invertible;
  float inv_det;
  solve_setup(gxx, gxy, gyy, win2, 1e-4f, &invertible, &inv_det);

  float cx = x0, cy = y0;
  if (invertible) {
    for (int it = 0; it < iters; ++it) {
      const int bx = block_origin(cx, half, pad, w, n1);
      const int by = block_origin(cy, half, pad, h, n1);
      const float fx = cx - floorf(cx), fy = cy - floorf(cy);
      const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
      const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
      float c[PER];  // the window, held over both rounds
      float sc0[1] = {0.f};
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        c[j] = 0.f;
        if (lk_live<WIN>(j, tid + j * LK_THREADS, nw)) {
          c[j] = sample_clamped(img, h, w, by, bx, pr[j], pc[j], w00, w01, w10, w11);
          sc0[0] += c[j];
        }
      }
      block_sum<1>(sc0, red[par]);
      par ^= 1;
      const float cmean = sc0[0] / win2;
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (lk_live<WIN>(j, tid + j * LK_THREADS, nw)) {
          const float d = (c[j] - cmean) - (tv[j] - tmean);
          s[0] += d * gxv[j];
          s[1] += d * gyv[j];
        }
      }
      block_sum<2>(s, red[par]);
      par ^= 1;
      const float b1 = s[0], b2 = s[1];
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

  // Mean absolute zero-mean residual at the end point: one sampling, the
  // window kept in registers over the two reductions.
  const int bx = block_origin(cx, half, pad, w, n1);
  const int by = block_origin(cy, half, pad, h, n1);
  const float fx = cx - floorf(cx), fy = cy - floorf(cy);
  const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
  float c[PER];
  float sc0[1] = {0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = 0.f;
    if (lk_live<WIN>(j, tid + j * LK_THREADS, nw)) {
      c[j] = sample_clamped(img, h, w, by, bx, pr[j], pc[j], w00, w01, w10, w11);
      sc0[0] += c[j];
    }
  }
  block_sum<1>(sc0, red[par]);
  par ^= 1;
  const float cmean = sc0[0] / win2;
  float ra[1] = {0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (lk_live<WIN>(j, tid + j * LK_THREADS, nw))
      ra[0] += fabsf((c[j] - cmean) - (tv[j] - tmean));
  block_sum<1>(ra, red[par]);
  if (tid == 0) {
    const bool inside = (cx >= 0.0f) && (cx < w - 1.0f) && (cy >= 0.0f) &&
                        (cy < h - 1.0f);
    out_pos[2 * k] = cx;
    out_pos[2 * k + 1] = cy;
    out_ok[k] = (invertible && inside && isfinite(cx) && isfinite(cy)) ? 1 : 0;
    out_res[k] = ra[0] / win2;
  }
}

template <int WIN>
__global__ void __launch_bounds__(LK_THREADS)
lk_extract_kernel(const float* __restrict__ img, long long img_bs, int h, int w,
                  const float* __restrict__ centers, int win_rt,
                  float* __restrict__ out_t, float* __restrict__ out_gx,
                  float* __restrict__ out_gy) {
  constexpr int PER = lk_per_thread(WIN);
  constexpr int NMAX = WIN > 0 ? WIN : LK_MAX_WIN;
  __shared__ float tb[(NMAX + 3) * (NMAX + 3)];
  __shared__ float gxb[(NMAX + 1) * (NMAX + 1)];
  __shared__ float gyb[(NMAX + 1) * (NMAX + 1)];

  const long long k = (long long)blockIdx.y * gridDim.x + blockIdx.x;  // slot
  img += blockIdx.y * img_bs;                                           // its sequence
  const int tid = threadIdx.x;
  const int win = WIN > 0 ? WIN : win_rt;
  const int half = (win - 1) / 2, pad = half + 2, n3 = win + 3, nw = win * win;
  const float tx = centers[2 * k], ty = centers[2 * k + 1];
  int pr[PER], pc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * LK_THREADS;
    pr[j] = i / win;
    pc[j] = i - pr[j] * win;
  }
  float tv[PER], gxv[PER], gyv[PER];
  block_template<WIN>(img, h, w, block_origin(ty, half + 1, pad, h, n3),
                      block_origin(tx, half + 1, pad, w, n3), tx - floorf(tx),
                      ty - floorf(ty), win, tb, gxb, gyb, pr, pc, tv, gxv, gyv);
  // Straight from registers: consecutive threads write consecutive floats.
  const long long row = k * nw;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * LK_THREADS;
    if (lk_live<WIN>(j, i, nw)) {
      out_t[row + i] = tv[j];
      out_gx[row + i] = gxv[j];
      out_gy[row + i] = gyv[j];
    }
  }
}

extern "C" {

// Dynamic shared memory K1 asks for, in bytes (ops/lk.py holds the same
// formula and refuses what passes LK_SMEM_LIMIT before it launches).
int lk_track_smem_bytes(int win, int n_levels) {
  return (int)sizeof(float) * track_smem_floats(win, n_levels);
}

// Lets both K1 bodies ask for up to LK_SMEM_LIMIT bytes of dynamic shared
// memory on the current device. Called once per device before its first K1
// launch, outside any stream capture.
int lk_configure(void) {
  cudaError_t e = cudaFuncSetAttribute(
      lk_track_kernel<21>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LK_SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      lk_track_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LK_SMEM_LIMIT);
}

// prev / next: host arrays of n_levels device pointers, each to B
// contiguous (level_h[l], level_w[l]) float32 planes bs_prev[l] /
// bs_next[l] floats apart (0: one plane for all sequences). pts (B, K, 2);
// active / out_ok: one byte per slot (0 or 1), (B, K).
int lk_track_launch(const float* const* prev, const float* const* next,
                    const long long* bs_prev, const long long* bs_next,
                    const int* level_h, const int* level_w, int n_levels,
                    const float* pts, const unsigned char* active, int B,
                    int K, int win, int iters, float eps, float min_eig_thr,
                    float* out_pos, unsigned char* out_ok,
                    cudaStream_t stream) {
  if (n_levels < 1 || n_levels > LK_MAX_LEVELS || win < 3 ||
      win > LK_MAX_WIN || K < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = lk_track_smem_bytes(win, n_levels);
  if (smem > LK_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  LevelMeta lv;
  for (int i = 0; i < n_levels; ++i) {
    if (level_h[i] < 1 || level_w[i] < 1) return (int)cudaErrorInvalidValue;
    lv.prev[i] = prev[i];
    lv.next[i] = next[i];
    lv.bs_prev[i] = bs_prev[i];
    lv.bs_next[i] = bs_next[i];
    lv.h[i] = level_h[i];
    lv.w[i] = level_w[i];
  }
  lv.n = n_levels;
  const dim3 grid(K, B);
  if (win == 21)
    lk_track_kernel<21><<<grid, LK_THREADS, smem, stream>>>(
        lv, pts, active, win, iters, eps, min_eig_thr, out_pos, out_ok);
  else
    lk_track_kernel<0><<<grid, LK_THREADS, smem, stream>>>(
        lv, pts, active, win, iters, eps, min_eig_thr, out_pos, out_ok);
  return (int)cudaGetLastError();
}

// img: B contiguous (h, w) float32 images, unpadded, img_bs floats apart
// (0: one image for all sequences). t_patch / gx / gy (B, K, win^2), pos0
// (B, K, 2), active (B, K).
int lk_refine_launch(const float* img, long long img_bs, int h, int w,
                     const float* t_patch, const float* gx, const float* gy,
                     const float* pos0, const unsigned char* active, int B,
                     int K, int win, int iters, float eps, float max_shift,
                     float* out_pos, unsigned char* out_ok, float* out_res,
                     cudaStream_t stream) {
  if (win < 3 || win > LK_MAX_WIN || K < 1 || B < 1 || B > 65535 || h < 1 ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(K, B);
  if (win == 21)
    lk_refine_kernel<21><<<grid, LK_THREADS, 0, stream>>>(
        img, img_bs, h, w, t_patch, gx, gy, pos0, active, win, iters, eps,
        max_shift, out_pos, out_ok, out_res);
  else
    lk_refine_kernel<0><<<grid, LK_THREADS, 0, stream>>>(
        img, img_bs, h, w, t_patch, gx, gy, pos0, active, win, iters, eps,
        max_shift, out_pos, out_ok, out_res);
  return (int)cudaGetLastError();
}

// img: B contiguous (h, w) float32 images, unpadded, img_bs floats apart
// (0: one image for all sequences). centers (B, K, 2); out_* (B, K, win^2).
int lk_extract_launch(const float* img, long long img_bs, int h, int w,
                      const float* centers, int B, int K, int win,
                      float* out_t, float* out_gx, float* out_gy,
                      cudaStream_t stream) {
  if (win < 3 || win > LK_MAX_WIN || K < 1 || B < 1 || B > 65535 || h < 1 ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(K, B);
  if (win == 21)
    lk_extract_kernel<21><<<grid, LK_THREADS, 0, stream>>>(
        img, img_bs, h, w, centers, win, out_t, out_gx, out_gy);
  else
    lk_extract_kernel<0><<<grid, LK_THREADS, 0, stream>>>(
        img, img_bs, h, w, centers, win, out_t, out_gx, out_gy);
  return (int)cudaGetLastError();
}

}  // extern "C"
