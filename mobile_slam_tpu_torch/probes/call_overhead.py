"""P1, the per-launch overhead probe of the chunked frame loop (torch twin
of scripts/dev_call_overhead.py).

The tracker launches five LK kernels per frame. If each launch carries a
fixed cost, fusing launches or capturing the frame loop in a CUDA graph is
worth more than faster kernel bodies. This probe runs a loop of 50 steps,
each launching a kernel that touches one 8x128 block of a 512x512 image
and every one of K = 160 (x, y) points (``touch_points``) N times, and
reports ms/step against N, eagerly and with the whole loop captured once
in a ``torch.cuda.CUDAGraph``. The slope is the cost of one launch.

    python -m mobile_slam_tpu_torch.probes.call_overhead

``touch_points`` launches ``probe_touch_kernel`` (csrc/probe_kernels.cu)
for a CUDA tensor, or raises; a CPU tensor takes ``touch_points_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from mobile_slam_tpu_torch.ops import cuda_build

K = 160
H = W = 512
STEPS = 50
CALLS = (0, 1, 2, 5)
BLOCK_ROWS, BLOCK_COLS = 8, 128     # P1_ROWS / P1_COLS in the CUDA source
# The kernel's 1e-12f: a float32 product with it rounds alike whether torch
# multiplies in float32 or in float64.
SCALE = float(np.float32(1e-12))

launch_counts = {"touch_points": 0}


def reset_launch_counts() -> None:
    launch_counts["touch_points"] = 0


def touch_points_ref(pts: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Plain version: pts + 1e-12 * sum(img[:8, :128]), float32."""
    s = torch.sum(img[:BLOCK_ROWS, :BLOCK_COLS].to(torch.float32)) * SCALE
    return pts.to(torch.float32) + s


@functools.cache
def build_kernels() -> ctypes.CDLL:
    lib = cuda_build.load("probe_kernels")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_touch_launch.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.probe_touch_launch.restype = ci
    return lib


def _touch_points_cuda(pts: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    k = pts.shape[0]
    if pts.shape != (k, 2) or k < 1 or pts.dtype != torch.float32 or not pts.is_contiguous():
        raise ValueError("points must be a contiguous (K, 2) float32 tensor, K >= 1")
    if (img.dim() != 2 or img.dtype != torch.float32 or img.device != pts.device
            or img.stride(1) != 1 or img.shape[0] < BLOCK_ROWS
            or img.shape[1] < BLOCK_COLS):
        raise ValueError("image must be a float32 (H >= 8, W >= 128) tensor with "
                         "unit column stride on the device of the points")
    lib = build_kernels()
    out = torch.empty_like(pts)
    with torch.cuda.device(pts.device):
        rc = lib.probe_touch_launch(pts.data_ptr(), img.data_ptr(), img.stride(0),
                                    k, out.data_ptr(), cuda_build.stream(pts))
    cuda_build.check(rc, "probe_touch_launch")
    launch_counts["touch_points"] += 1
    return out


def touch_points(pts: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    if pts.is_cuda:
        return _touch_points_cuda(pts, img)
    return touch_points_ref(pts, img)


def _loop(pts, imgs, n_calls: int):
    c = pts
    for s in range(imgs.shape[0]):
        img = imgs[s]
        for _ in range(n_calls):
            c = touch_points(c, img)
        if n_calls == 0:
            c = c + img[0, 0] * 1e-12
    return c


def inputs(device="cuda", k: int = K, size: int = H, steps: int = STEPS,
           seed: int = 0):
    """The reference's inputs: K points uniform in [30, 480) and ``steps``
    uniform-noise images, float32, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(30, 480, (k, 2)).astype(np.float32), device=device)
    imgs = torch.as_tensor(rng.uniform(0, 255, (steps, size, size)).astype(np.float32),
                           device=device)
    return pts, imgs


def check_inputs(device="cuda", k: int = K, size: int = H, seed: int = 0):
    """Inputs on which the kernel's whole arithmetic shows: points uniform in
    [0, 1e-6) and an integer-valued image in [0, 255]. The block sum is then
    exact in float32 in any order of summation, so the kernel and the plain
    version agree bit for bit, and 1e-12 x the sum (~1.3e-7) is about a
    million ulps of the points. On the reference's inputs (points in
    [30, 480)) it is below half an ulp and the output equals the points."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(0.0, 1e-6, (k, 2)).astype(np.float32), device=device)
    img = torch.as_tensor(rng.integers(0, 256, (size, size)).astype(np.float32),
                          device=device)
    return pts, img


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device="cuda", calls=CALLS, reps: int = 10, passes: int = 3, **kw) -> dict:
    """ms per step of the loop against the launches per step, eagerly and,
    on a CUDA device, replayed from one CUDA graph of the whole loop; best
    of ``passes`` passes of ``reps`` loops each. Returns {"eager": {n: ms},
    "graph": {n: ms} or None, "slope_eager_us", "slope_graph_us"}."""
    dev = torch.device(device)
    pts, imgs = inputs(dev, **kw)
    steps = imgs.shape[0]
    eager, graph = {}, ({} if dev.type == "cuda" else None)
    for n in calls:
        _loop(pts, imgs, n)
        _sync(dev)
        best = float("inf")
        for _ in range(passes):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = _loop(pts, imgs, n)
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / (reps * steps))
        eager[n] = 1e3 * best
        if graph is None:
            continue
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = _loop(pts, imgs, n)
        g.replay()
        _sync(dev)
        best = float("inf")
        for _ in range(passes):
            t0 = time.perf_counter()
            for _ in range(reps):
                g.replay()
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / (reps * steps))
        graph[n] = 1e3 * best
        del g, out

    def slope_us(ms):
        return float(1e3 * np.polyfit(list(ms), list(ms.values()), 1)[0])

    return {"eager": eager, "graph": graph, "slope_eager_us": slope_us(eager),
            "slope_graph_us": slope_us(graph) if graph else None}


def main() -> None:
    res = run()
    for n in res["eager"]:
        g = res["graph"][n] if res["graph"] else float("nan")
        print(f"calls/step={n}: eager {res['eager'][n]:7.4f} ms/step  "
              f"graph {g:7.4f} ms/step", flush=True)
    print(f"per launch: eager {res['slope_eager_us']:.3f} us, "
          f"graph {res['slope_graph_us']:.3f} us")


if __name__ == "__main__":
    main()
