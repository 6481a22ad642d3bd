// Device helpers shared by the LK kernels (lk_kernels.cu) and the LK
// cost-attribution probe (probe_kernels.cu): warp and block reductions, the
// clamped block origin, fp32 bilinear weights, the template block with its
// block Scharr gradients, the clamped window sample and the 2x2 setup.
//
// Every LK kernel (K1-K3, P2) runs LK_THREADS threads (LK_NWARP warps) per
// point slot and takes the border clamp at the load.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define LK_MAX_WIN 31
#define LK_MAX_LEVELS 8
#define LK_WARP 32
#define LK_NWARP 4  // warps per point slot
#define LK_THREADS (LK_NWARP * LK_WARP)
// Dynamic shared memory a block may ask for: the 232,448 bytes an H100 SM
// gives one block, less 1 KB kept for the kernels' static arrays.
#define LK_SMEM_LIMIT (232448 - 1024)

struct LevelMeta {
  const float* prev[LK_MAX_LEVELS];  // contiguous (h, w) float32 levels
  const float* next[LK_MAX_LEVELS];
  long long bs_prev[LK_MAX_LEVELS];  // floats from one sequence's level to
  long long bs_next[LK_MAX_LEVELS];  // the next one's (0: shared by all)
  int h[LK_MAX_LEVELS];
  int w[LK_MAX_LEVELS];
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

// Bilinear value at (r, c) + (fy, fx) inside a row-major block of width ld.
__device__ __forceinline__ float bil(const float* b, int ld, int r, int c,
                                     float w00, float w01, float w10,
                                     float w11) {
  const float* p = b + r * ld + c;
  return w00 * p[0] + w01 * p[1] + w10 * p[ld] + w11 * p[ld + 1];
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

// ---------------------------------------------------------------------------
// Block helpers: LK_THREADS threads per point slot, borders clamped at the
// load.
//
// The replicate-padded copy of an (h, w) level holds, at padded (r, c),
// img[clamp(r - pad, 0, h - 1)][clamp(c - pad, 0, w - 1)]. The kernels keep
// clamping every block ORIGIN in padded coordinates, subtract pad, and clamp
// each pixel's row and column into the level as they load it: the same
// values, and no padded copy.
// ---------------------------------------------------------------------------

// floor(x) as int, held to +-2^24 so that a window offset cannot overflow
// it; NaN maps to 0. The caller clamps the block origin either way.
__device__ __forceinline__ int floor_sat(float x) {
  return clampi(__float2int_rd(x), -(1 << 24), 1 << 24);
}

// Window pixels one thread holds: ceil(win^2 / LK_THREADS), from the window
// where it is a template parameter, else from LK_MAX_WIN.
__host__ __device__ constexpr int lk_per_thread(int win) {
  return ((win > 0 ? win * win : LK_MAX_WIN * LK_MAX_WIN) + LK_THREADS - 1) /
         LK_THREADS;
}

// Whether a thread's j-th pixel (index i) lies in the window; known when
// compiling for every j but the last where the window is a template
// parameter.
template <int WIN>
__device__ __forceinline__ bool lk_live(int j, int i, int nw) {
  return (WIN > 0 && (j + 1) * LK_THREADS <= WIN * WIN) || i < nw;
}

// Bilinear value at window pixel (r, c) of the block whose origin in the
// unpadded (h, w) level is (by, bx); by and bx may be negative.
__device__ __forceinline__ float sample_clamped(const float* __restrict__ img,
                                                int h, int w, int by, int bx,
                                                int r, int c, float w00,
                                                float w01, float w10,
                                                float w11) {
  const int r0 = clampi(by + r, 0, h - 1) * w;
  const int r1 = clampi(by + r + 1, 0, h - 1) * w;
  const int c0 = clampi(bx + c, 0, w - 1), c1 = clampi(bx + c + 1, 0, w - 1);
  return w00 * img[r0 + c0] + w01 * img[r0 + c1] + w10 * img[r1 + c0] +
         w11 * img[r1 + c1];
}

// Origin (unpadded, possibly negative) of an n x n block whose padded
// origin floor(x) - back + pad is clamped into the padded level of side
// len + 2 * pad.
__device__ __forceinline__ int block_origin(float x, int back, int pad, int len,
                                            int n) {
  return clampi(floor_sat(x) - back + pad, 0, len + 2 * pad - n) - pad;
}

// The (win+3)^2 block at unpadded origin (by, bx) of an (h, w) level into
// tb, each pixel's row and column clamped into the level: thread t of NT
// loads pixels t, t + NT, ... The caller synchronises before reading tb.
template <int WIN, int NT>
__device__ __forceinline__ void load_block(const float* __restrict__ img,
                                           int h, int w, int by, int bx,
                                           int win_rt, int t, float* tb) {
  const int n3 = (WIN > 0 ? WIN : win_rt) + 3;
  for (int i = t; i < n3 * n3; i += NT) {
    const int r = i / n3, c = i - r * n3;
    tb[i] = img[clampi(by + r, 0, h - 1) * w + clampi(bx + c, 0, w - 1)];
  }
}

// Block Scharr gradients (/32) of tb over its inner (win+1)^2 into gxb /
// gyb: thread t of NT takes pixels t, t + NT, ... The caller synchronises
// before reading them.
template <int WIN, int NT>
__device__ __forceinline__ void scharr_block(const float* tb, int win_rt, int t,
                                             float* gxb, float* gyb) {
  const int n1 = (WIN > 0 ? WIN : win_rt) + 1, n3 = n1 + 2;
  for (int i = t; i < n1 * n1; i += NT) {
    const int r = i / n1, c = i - r * n1;
    const float* p = tb + r * n3 + c;
    const float right = 3.0f * p[2] + 10.0f * p[n3 + 2] + 3.0f * p[2 * n3 + 2];
    const float left = 3.0f * p[0] + 10.0f * p[n3] + 3.0f * p[2 * n3];
    const float bot = 3.0f * p[2 * n3] + 10.0f * p[2 * n3 + 1] + 3.0f * p[2 * n3 + 2];
    const float top = 3.0f * p[0] + 10.0f * p[1] + 3.0f * p[2];
    gxb[i] = (right - left) / 32.0f;
    gyb[i] = (bot - top) / 32.0f;
  }
}

// The template of ONE WARP of a larger block (K1 builds one level per
// warp), reading the unpadded level with the border clamp: the (win+3)^2
// block at unpadded origin (by, bx), its block Scharr gradients and the
// bilinear template / gradient patches (win*win each) into shared memory.
// Returns the structure-tensor sums in every lane. WIN > 0 fixes the window
// when compiling (constant divisions).
template <int WIN>
__device__ void build_template_clamped(const float* __restrict__ img, int h,
                                       int w, int by, int bx, float fx,
                                       float fy, int win_rt, float* tb,
                                       float* gxb, float* gyb, float* tp,
                                       float* gx, float* gy, float* sxx,
                                       float* sxy, float* syy) {
  const int win = WIN > 0 ? WIN : win_rt;
  const int lane = threadIdx.x & (LK_WARP - 1);
  const int n3 = win + 3, n1 = win + 1, nw = win * win;
  load_block<WIN, LK_WARP>(img, h, w, by, bx, win, lane, tb);
  __syncwarp();
  scharr_block<WIN, LK_WARP>(tb, win, lane, gxb, gyb);
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

// The template of a point on the WHOLE block (K3, P2): all LK_THREADS
// threads load the (win+3)^2 block at unpadded origin (by, bx) with the
// border clamp into tb (about 4.5 pixels each at window 21), one barrier,
// its block Scharr gradients into gxb / gyb, one barrier; then each thread
// forms the bilinear template and gradients at (fx, fy) of its own window
// pixels (pr[j], pc[j]) in registers, 0 where a pixel lies outside the
// window. tb, gxb and gyb stay readable until the caller writes them.
// Must be reached by every thread of the block.
template <int WIN>
__device__ __forceinline__ void block_template(
    const float* __restrict__ img, int h, int w, int by, int bx, float fx,
    float fy, int win_rt, float* tb, float* gxb, float* gyb,
    const int (&pr)[lk_per_thread(WIN)], const int (&pc)[lk_per_thread(WIN)],
    float (&tv)[lk_per_thread(WIN)], float (&gxv)[lk_per_thread(WIN)],
    float (&gyv)[lk_per_thread(WIN)]) {
  const int win = WIN > 0 ? WIN : win_rt;
  const int n3 = win + 3, n1 = win + 1, nw = win * win;
  load_block<WIN, LK_THREADS>(img, h, w, by, bx, win, threadIdx.x, tb);
  __syncthreads();
  scharr_block<WIN, LK_THREADS>(tb, win, threadIdx.x, gxb, gyb);
  __syncthreads();
  const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
#pragma unroll
  for (int j = 0; j < lk_per_thread(WIN); ++j) {
    tv[j] = gxv[j] = gyv[j] = 0.f;
    if (lk_live<WIN>(j, threadIdx.x + j * LK_THREADS, nw)) {
      tv[j] = bil(tb, n3, pr[j] + 1, pc[j] + 1, w00, w01, w10, w11);
      gxv[j] = bil(gxb, n1, pr[j], pc[j], w00, w01, w10, w11);
      gyv[j] = bil(gyb, n1, pr[j], pc[j], w00, w01, w10, w11);
    }
  }
}

// Sums v[0..N) over the LK_THREADS threads of the block: warp shuffles, one
// exchange through slot (LK_NWARP * N floats of shared memory) and one
// __syncthreads(). Every thread adds the warps' partial sums in the same
// order, so every thread holds the bitwise-identical result and a branch on
// it is uniform across the block. Two calls in a row must use two different
// slots (a slow thread may still be reading the first): callers alternate.
// Must be reached by every thread of the block.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* slot) {
  const int lane = threadIdx.x & (LK_WARP - 1), warp = threadIdx.x / LK_WARP;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) slot[warp * N + n] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = slot[n];
#pragma unroll
    for (int q = 1; q < LK_NWARP; ++q) s += slot[q * N + n];
    v[n] = s;
  }
}
