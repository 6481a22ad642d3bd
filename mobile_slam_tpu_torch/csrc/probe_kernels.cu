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
// P2 lk_probe_kernel<MODE> replaces scripts/dev_lk_pack_probe.py build ->
//    once / _kernel (pallas_call at :125, body :46): single-level LK with a
//    fixed iteration count (no early exit) on replicate-padded images, with
//    parts of the work stripped per MODE so that timings attribute K1's cost
//    to its template, its per-iteration window load, its arithmetic and its
//    loop. Bound: like K1, latency of the dependent iteration chain at one
//    warp per point (160 warps on 132 SMs); the bytes (two padded 536^2
//    images) are ~2.3 MB. It is K1's own structure (lk_common.cuh helpers:
//    block fetch, block Scharr, fp32 bilinear, shuffle reductions), so the
//    attribution carries over to K1.
//
// MODE, as in the reference:
//   full    template + per-iteration window load + bilinear + reductions +
//           2x2 solve
//   notmpl  template replaced by constants (0.5 / 0.25 / 0.25); the loop is
//           that of full (the constant gradients give det = 0, so no step)
//   noload  the window is resampled from the template block (no load)
//   noarith load + bilinear, then a constant step (no reductions or solve)
//   empty   the loop body is scalar math only
//
// Besides the end position, each point writes a witness: the sum of the
// last window it compared (the template in empty mode), one warp reduction
// after the loop in every mode. Most modes barely move the points (notmpl
// has det = 0, noload compares the template with itself, noarith and empty
// step by constants), so the witness is what shows that a mode really
// loaded and resampled its windows.

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

template <int MODE>
__global__ void __launch_bounds__(LK_WARP)
lk_probe_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int hp, int wp, int pad, const float* __restrict__ pts, int K,
                int win, int iters, float* __restrict__ out,
                float* __restrict__ wit) {
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
  const int half = (win - 1) / 2, n3 = win + 3, nw = win * win;
  const float tx = pts[2 * k], ty = pts[2 * k + 1];
  float gxx, gxy, gyy;
  if (MODE == MODE_NOTMPL) {
    float a = 0.f, b = 0.f, c2 = 0.f;
    for (int i = lane; i < nw; i += LK_WARP) {
      tp[i] = 0.5f;
      gx[i] = 0.25f;
      gy[i] = 0.25f;
      a += 0.25f * 0.25f;
      b += 0.25f * 0.25f;
      c2 += 0.25f * 0.25f;
    }
    gxx = warp_sum(a);
    gxy = warp_sum(b);
    gyy = warp_sum(c2);
    __syncwarp();
  } else {
    const int tbx = clampi(floor_int(tx) - half - 1 + pad, 0, wp - n3);
    const int tby = clampi(floor_int(ty) - half - 1 + pad, 0, hp - n3);
    build_template(prev, wp, tby, tbx, tx - floorf(tx), ty - floorf(ty), win,
                   tb, gxb, gyb, tp, gx, gy, &gxx, &gxy, &gyy);
  }
  const float det = gxx * gyy - gxy * gxy;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

  float ix = tx, iy = ty;
  for (int it = 0; it < iters; ++it) {
    if (MODE == MODE_EMPTY) {
      ix += 1e-4f;
      iy += 1e-4f;
      continue;
    }
    if (MODE == MODE_NOLOAD) {
      const float fx = ix - floorf(ix), fy = iy - floorf(iy);
      const float w00 = (1.0f - fx) * (1.0f - fy), w01 = fx * (1.0f - fy);
      const float w10 = (1.0f - fx) * fy, w11 = fx * fy;
      for (int i = lane; i < nw; i += LK_WARP) {
        const int r = i / win, c = i - r * win;
        cp[i] = bil(tb, n3, r + 1, c + 1, w00, w01, w10, w11);
      }
      __syncwarp();
    } else {
      sample_patch(next, hp, wp, pad, win, ix, iy, cp);
    }
    if (MODE == MODE_NOARITH) {
      ix += cp[0] * 1e-9f;
      iy += 1e-4f;
      __syncwarp();
      continue;
    }
    float b1 = 0.f, b2 = 0.f;
    for (int i = lane; i < nw; i += LK_WARP) {
      const float diff = cp[i] - tp[i];
      b1 += diff * gx[i];
      b2 += diff * gy[i];
    }
    b1 = warp_sum(b1);
    b2 = warp_sum(b2);
    __syncwarp();
    ix += -(gyy * b1 - gxy * b2) * inv_det;
    iy += -(gxx * b2 - gxy * b1) * inv_det;
  }
  const float* last = (MODE == MODE_EMPTY || iters == 0) ? tp : cp;
  __syncwarp();
  float ws = 0.f;
  for (int i = lane; i < nw; i += LK_WARP) ws += last[i];
  ws = warp_sum(ws);
  if (lane == 0) {
    out[2 * k] = ix;
    out[2 * k + 1] = iy;
    wit[k] = ws;
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
  if (win < 3 || win > LK_MAX_WIN || K < 1 || hp < win + 3 || wp < win + 3)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_FULL:
      lk_probe_kernel<MODE_FULL><<<K, LK_WARP, 0, stream>>>(
          prev, next, hp, wp, pad, pts, K, win, iters, out, wit);
      break;
    case MODE_NOTMPL:
      lk_probe_kernel<MODE_NOTMPL><<<K, LK_WARP, 0, stream>>>(
          prev, next, hp, wp, pad, pts, K, win, iters, out, wit);
      break;
    case MODE_NOLOAD:
      lk_probe_kernel<MODE_NOLOAD><<<K, LK_WARP, 0, stream>>>(
          prev, next, hp, wp, pad, pts, K, win, iters, out, wit);
      break;
    case MODE_NOARITH:
      lk_probe_kernel<MODE_NOARITH><<<K, LK_WARP, 0, stream>>>(
          prev, next, hp, wp, pad, pts, K, win, iters, out, wit);
      break;
    case MODE_EMPTY:
      lk_probe_kernel<MODE_EMPTY><<<K, LK_WARP, 0, stream>>>(
          prev, next, hp, wp, pad, pts, K, win, iters, out, wit);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
