// Hand-written Hopper (sm_90a) kernels for the two measurement probes of
// the chunked frame loop. Each is bound through a plain C entry point that
// returns cudaGetLastError(); mobile_slam_tpu_torch/ops/cuda_build.py builds
// this file with nvcc at first use and the drivers in
// mobile_slam_tpu_torch/probes/ load it with ctypes.
//
// P1 probe_touch_kernel replaces scripts/dev_call_overhead.py _call /
//    _tiny_kernel (pallas_call at :46, body :31): read one 8x128 image
//    block, reduce it, and add 1e-12 x its sum to each of K (x, y) points.
//    Bound: nothing but its launch (4 KB read, 2K floats written), which is
//    the point: the driver times N launches per step of a 50-step loop,
//    eagerly and captured in one CUDA graph, and the slope is the per-launch
//    cost. One block of P1_THREADS: a strided read of the block, warp
//    shuffles, one shared-memory step across the warps, then a strided write.
//
// P2 lk_probe_kernel<MODE> replaces scripts/dev_lk_pack_probe.py
//    build -> once / _kernel (pallas_call at :124, body :46): single-level LK
//    with a fixed iteration count (no early exit) on replicate-padded
//    images, with parts of the work stripped per MODE so that timings
//    attribute the cost of K1's body to its template, its per-iteration
//    window load, its arithmetic and its loop. The body is K1's
//    (lk_kernels.cu): one block of LK_THREADS (4 warps) per point slot; the
//    template built once by the whole block (block_template: one level, so
//    all four warps share it), each thread's <= 4 template and gradient
//    values in registers; a step is one fused sample-subtract-accumulate
//    pass and one block_sum (one barrier). The padded image is handed over
//    as one (hp, wp) level: block origins are clamped into it as the
//    reference clamps them, so the border clamp at the load never bites.
//    Bound: like K1, the dependent chain of ITERS steps of a point; the
//    bytes are the template blocks and the windows the steps sweep. The
//    window is the reference's, P2_WIN = 21, fixed when compiling.
//
// MODE, as in the reference:
//   full    template + per-iteration window load + bilinear + reductions +
//           2x2 solve
//   notmpl  template replaced by constants (0.5 / 0.25 / 0.25); the loop is
//           that of full (the constant gradients give det = 0, so no step)
//   noload  the window is resampled from the template block (no load)
//   noarith load + bilinear, then a constant step (no reductions or solve);
//           the step reads pixel (0, 0) of the window, which every thread
//           samples alike, so the position stays uniform across the block
//   empty   the loop body is scalar math only
//
// Besides the end position, each point writes a witness: the sum of every
// window it compared, over all steps (the template in empty mode), each
// thread's share added up as the steps go and one block_sum after the loop.
// Most modes barely move the points (notmpl has det = 0, noload compares
// the template with itself, noarith and empty step by constants), so the
// witness is what shows that a mode really loaded and resampled its
// windows; it also keeps every step's window live, so the compiler cannot
// sink noarith's loads out of the loop, where only the last step's would
// be made.

#include "lk_common.cuh"

#define P1_THREADS 256
#define P1_ROWS 8
#define P1_COLS 128

__global__ void __launch_bounds__(P1_THREADS)
probe_touch_kernel(const float* __restrict__ pts, const float* __restrict__ img,
                   int ld, int K, float* __restrict__ out) {
  __shared__ float part[P1_THREADS / LK_WARP];
  const int t = threadIdx.x;
  float s = 0.f;
  for (int i = t; i < P1_ROWS * P1_COLS; i += P1_THREADS)
    s += img[(i / P1_COLS) * ld + (i % P1_COLS)];
  s = warp_sum(s);
  if ((t & (LK_WARP - 1)) == 0) part[t / LK_WARP] = s;
  __syncthreads();
  if (t < LK_WARP) {
    float v = t < P1_THREADS / LK_WARP ? part[t] : 0.f;
    v = warp_sum(v);
    if (t == 0) part[0] = v * 1e-12f;
  }
  __syncthreads();
  const float add = part[0];
  for (int i = t; i < 2 * K; i += P1_THREADS) out[i] = pts[i] + add;
}

enum ProbeMode { MODE_FULL = 0, MODE_NOTMPL, MODE_NOLOAD, MODE_NOARITH, MODE_EMPTY };

#define P2_WIN 21

template <int MODE>
__global__ void __launch_bounds__(LK_THREADS)
lk_probe_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int hp, int wp, int pad, const float* __restrict__ pts,
                int iters, float* __restrict__ out, float* __restrict__ wit) {
  constexpr int WIN = P2_WIN, PER = lk_per_thread(WIN);
  constexpr int half = (WIN - 1) / 2, n1 = WIN + 1, n3 = WIN + 3, nw = WIN * WIN;
  __shared__ float tb[n3 * n3];
  __shared__ float gxb[n1 * n1];
  __shared__ float gyb[n1 * n1];
  __shared__ float red[2][LK_NWARP * 3];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float tx = pts[2 * k], ty = pts[2 * k + 1];
  int pr[PER], pc[PER];
  float tv[PER], gxv[PER], gyv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * LK_THREADS;
    pr[j] = i / WIN;
    pc[j] = i - pr[j] * WIN;
  }
  if (MODE == MODE_NOTMPL) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const bool live = lk_live<WIN>(j, tid + j * LK_THREADS, nw);
      tv[j] = live ? 0.5f : 0.f;
      gxv[j] = gyv[j] = live ? 0.25f : 0.f;
    }
  } else {
    block_template<WIN>(prev, hp, wp, clampi(floor_sat(ty) - half - 1 + pad, 0, hp - n3),
                        clampi(floor_sat(tx) - half - 1 + pad, 0, wp - n3),
                        tx - floorf(tx), ty - floorf(ty), WIN, tb, gxb, gyb, pr,
                        pc, tv, gxv, gyv);
  }
  float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {  // pixels outside the window hold 0
    g[0] += gxv[j] * gxv[j];
    g[1] += gxv[j] * gyv[j];
    g[2] += gyv[j] * gyv[j];
  }
  int par = 0;
  block_sum<3>(g, red[par]);
  par ^= 1;
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = gxx * gyy - gxy * gxy;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

  float ix = tx, iy = ty;
  float ws[1] = {0.f};  // this thread's share of every window compared
  for (int it = 0; it < iters; ++it) {
    if (MODE == MODE_EMPTY) {
      ix += 1e-4f;
      iy += 1e-4f;
      continue;
    }
    const float fx = ix - floorf(ix), fy = iy - floorf(iy);
    const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
    const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
    const int bx = clampi(floor_sat(ix) - half + pad, 0, wp - n1);
    const int by = clampi(floor_sat(iy) - half + pad, 0, hp - n1);
    float c[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      c[j] = 0.f;
      if (lk_live<WIN>(j, tid + j * LK_THREADS, nw))
        c[j] = MODE == MODE_NOLOAD
                   ? bil(tb, n3, pr[j] + 1, pc[j] + 1, w00, w01, w10, w11)
                   : sample_clamped(next, hp, wp, by, bx, pr[j], pc[j], w00,
                                    w01, w10, w11);
      ws[0] += c[j];
    }
    if (MODE == MODE_NOARITH) {
      ix += sample_clamped(next, hp, wp, by, bx, 0, 0, w00, w01, w10, w11) * 1e-9f;
      iy += 1e-4f;
      continue;
    }
    float b[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float diff = c[j] - tv[j];
      b[0] += diff * gxv[j];
      b[1] += diff * gyv[j];
    }
    block_sum<2>(b, red[par]);
    par ^= 1;
    ix += -(gyy * b[0] - gxy * b[1]) * inv_det;
    iy += -(gxx * b[1] - gxy * b[0]) * inv_det;
  }
  if (MODE == MODE_EMPTY) {
#pragma unroll
    for (int j = 0; j < PER; ++j) ws[0] += tv[j];
  }
  block_sum<1>(ws, red[par]);
  if (tid == 0) {
    out[2 * k] = ix;
    out[2 * k + 1] = iy;
    wit[k] = ws[0];
  }
}

extern "C" {

int probe_touch_launch(const float* pts, const float* img, int ld, int K,
                       float* out, cudaStream_t stream) {
  if (K < 1 || ld < P1_COLS) return (int)cudaErrorInvalidValue;
  probe_touch_kernel<<<1, P1_THREADS, 0, stream>>>(pts, img, ld, K, out);
  return (int)cudaGetLastError();
}

int lk_probe_launch(const float* prev, const float* next, int hp, int wp,
                    int pad, const float* pts, int K, int win, int iters,
                    int mode, float* out, float* wit, cudaStream_t stream) {
  if (win != P2_WIN || K < 1 || hp < win + 3 || wp < win + 3)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(K), block(LK_THREADS);
  switch (mode) {
    case MODE_FULL:
      lk_probe_kernel<MODE_FULL><<<grid, block, 0, stream>>>(
          prev, next, hp, wp, pad, pts, iters, out, wit);
      break;
    case MODE_NOTMPL:
      lk_probe_kernel<MODE_NOTMPL><<<grid, block, 0, stream>>>(
          prev, next, hp, wp, pad, pts, iters, out, wit);
      break;
    case MODE_NOLOAD:
      lk_probe_kernel<MODE_NOLOAD><<<grid, block, 0, stream>>>(
          prev, next, hp, wp, pad, pts, iters, out, wit);
      break;
    case MODE_NOARITH:
      lk_probe_kernel<MODE_NOARITH><<<grid, block, 0, stream>>>(
          prev, next, hp, wp, pad, pts, iters, out, wit);
      break;
    case MODE_EMPTY:
      lk_probe_kernel<MODE_EMPTY><<<grid, block, 0, stream>>>(
          prev, next, hp, wp, pad, pts, iters, out, wit);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
