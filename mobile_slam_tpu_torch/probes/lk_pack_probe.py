"""P2, the LK cost-attribution probe (torch twin of
scripts/dev_lk_pack_probe.py).

Times stripped single-level LK kernels with a FIXED iteration count (no
early exit, so the variants are load-for-load comparable), on K1's body:
one block of four warps per point, the template built once by the whole
block, a step one fused sample-subtract-accumulate pass and one barrier:

  full    template + per-iteration window load + bilinear + reductions +
          2x2 solve
  notmpl  template replaced by constants; the loop of full
  noload  the window resampled from the template block; bilinear +
          reductions + solve
  noarith load + bilinear, then a constant step
  empty   the loop body is scalar math only

full - notmpl ~ the template, full - noload ~ the load, full - noarith ~
reductions + solve, empty ~ loop + template.

Each call returns the end positions (K, 2) and a witness (K,): the sum of
every window the point compared, over all steps (the template in empty
mode). Apart from full, the modes barely move the points (notmpl has det =
0, noload compares the template with itself, noarith and empty step by
constants), so the witness is what shows that a mode loaded and resampled
its windows; in the kernel it also keeps every step's window live.

    python -m mobile_slam_tpu_torch.probes.lk_pack_probe

``lk_probe`` launches ``lk_probe_kernel<mode>`` (csrc/probe_kernels.cu,
built for the reference's window, WIN, only) for CUDA tensors, or raises;
CPU tensors take ``lk_probe_ref``, at any window. Images are
replicate-padded by ``pad`` beforehand, as the reference's are.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mobile_slam_tpu_torch.ops import cuda_build, lk
from mobile_slam_tpu_torch.ops import image as im

K = 160
H = W = 512
WIN = 21
ITERS = 8
PAD = (WIN - 1) // 2 + 2
MODES = ("full", "notmpl", "noload", "noarith", "empty")

launch_counts = {"lk_probe": 0}


def reset_launch_counts() -> None:
    launch_counts["lk_probe"] = 0


def lk_probe_ref(pts: torch.Tensor, prev_p: torch.Tensor, next_p: torch.Tensor,
                 pad: int, mode: str, iters: int = ITERS,
                 window: int = WIN):
    """Plain version, vectorized over the K points: the (K, 2) float32 end
    positions after ``iters`` iterations of ``mode`` on the padded
    ``prev_p``/``next_p`` images, and the (K,) witness."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    hp, wp = prev_p.shape
    win = window
    half = (win - 1) // 2
    k = pts.shape[0]
    tx = pts[:, 0].to(torch.float32)
    ty = pts[:, 1].to(torch.float32)
    if mode == "notmpl":
        const = torch.ones((k, win, win), dtype=torch.float32, device=pts.device)
        t, gx, gy = 0.5 * const, 0.25 * const, 0.25 * const
    else:
        tbx = torch.clamp(lk._floor_int(tx) - half - 1 + pad, 0, wp - (win + 3))
        tby = torch.clamp(lk._floor_int(ty) - half - 1 + pad, 0, hp - (win + 3))
        ftx, fty = tx - torch.floor(tx), ty - torch.floor(ty)
        tb = lk._gather_block(prev_p, tby, tbx, win + 3, win + 3)
        gxb, gyb = lk._scharr_on_block(tb, win + 1)
        t = lk._bilinear_block(tb[:, 1:win + 2, 1:win + 2], ftx, fty, win)
        gx = lk._bilinear_block(gxb, ftx, fty, win)
        gy = lk._bilinear_block(gyb, ftx, fty, win)
    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))
    ix, iy = tx, ty
    witness = torch.zeros_like(tx)
    for _ in range(iters):
        if mode == "empty":
            ix, iy = ix + 1e-4, iy + 1e-4
            continue
        if mode == "noload":
            c = lk._bilinear_block(tb[:, 1:win + 2, 1:win + 2], ix - torch.floor(ix),
                                   iy - torch.floor(iy), win)
        else:
            c = lk._sample(next_p, ix, iy, win, pad)
        witness = witness + torch.sum(c, dim=(1, 2))
        if mode == "noarith":
            ix, iy = ix + c[:, 0, 0] * 1e-9, iy + 1e-4
            continue
        diff = c - t
        b1 = torch.sum(diff * gx, dim=(1, 2))
        b2 = torch.sum(diff * gy, dim=(1, 2))
        ix = ix + -(gyy * b1 - gxy * b2) * inv_det
        iy = iy + -(gxx * b2 - gxy * b1) * inv_det
    if mode == "empty":
        witness = torch.sum(t, dim=(1, 2))
    return torch.stack([ix, iy], dim=-1), witness


@functools.cache
def build_kernels() -> ctypes.CDLL:
    lib = cuda_build.load("probe_kernels")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lk_probe_launch.argtypes = [vp, vp, ci, ci, ci, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.lk_probe_launch.restype = ci
    return lib


def _lk_probe_cuda(pts, prev_p, next_p, pad: int, mode: str, iters: int = ITERS,
                   window: int = WIN):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    k = pts.shape[0]
    if pts.shape != (k, 2) or k < 1 or pts.dtype != torch.float32 or not pts.is_contiguous():
        raise ValueError("points must be a contiguous (K, 2) float32 tensor, K >= 1")
    for img in (prev_p, next_p):
        if (img.shape != prev_p.shape or img.dim() != 2 or img.dtype != torch.float32
                or img.device != pts.device or not img.is_contiguous()):
            raise ValueError("images must be contiguous float32 2-D tensors of one "
                             "shape on the device of the points")
    if window != WIN:
        raise ValueError(f"P2's kernel is built for window {WIN}, not {window}")
    lib = build_kernels()
    hp, wp = prev_p.shape
    out = torch.empty_like(pts)
    wit = torch.empty((k,), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        rc = lib.lk_probe_launch(prev_p.data_ptr(), next_p.data_ptr(), hp, wp, pad,
                                 pts.data_ptr(), k, window, iters, MODES.index(mode),
                                 out.data_ptr(), wit.data_ptr(), cuda_build.stream(pts))
    cuda_build.check(rc, "lk_probe_launch")
    launch_counts["lk_probe"] += 1
    return out, wit


def lk_probe(pts, prev_p, next_p, pad: int, mode: str, iters: int = ITERS,
             window: int = WIN):
    """(positions (K, 2), witness (K,)) of ``mode``, on the card for CUDA
    tensors."""
    if pts.is_cuda:
        return _lk_probe_cuda(pts, prev_p, next_p, pad, mode, iters, window)
    return lk_probe_ref(pts, prev_p, next_p, pad, mode, iters, window)


def inputs(device="cuda", k: int = K, size: int = H, seed: int = 0):
    """The reference's inputs: two 5x5 box-summed noise images, the second
    the first shifted by (-3, +3) px, replicate-padded by PAD; K points
    uniform in [30, size - 30). Made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.uniform(0, 255, (size + 8, size + 8)).astype(np.float32))
    img0 = im.box_filter(base[4:4 + size, 4:4 + size], 5)
    img1 = im.box_filter(base[1:1 + size, 7:7 + size], 5)
    pts = torch.as_tensor(rng.uniform(30, size - 30, (k, 2)).astype(np.float32))
    return (pts.to(device), lk._pad(img0, PAD).contiguous().to(device),
            lk._pad(img1, PAD).contiguous().to(device))


def run(device="cuda", modes=MODES, reps: int = 20, passes: int = 3,
        iters: int = ITERS, data=None, **kw) -> dict:
    """ms per call of each mode and the per point-iteration attribution in
    us. Each mode's ``reps`` back-to-back launches are captured in one CUDA
    graph, so the replay timed with CUDA events is device-bound (the
    reference chained its calls inside one jit for the same reason); best
    of ``passes`` interleaved passes. ``data`` = (pts, prev_p, next_p),
    images padded by PAD, replaces the reference's inputs (for example a
    pair of frames of the image path). Needs a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the probe times kernels on a CUDA device")
    pts, prev_p, next_p = data if data is not None else inputs(dev, **kw)
    k = pts.shape[0]
    full, _ = lk_probe(pts, prev_p, next_p, PAD, "full", iters)
    disp = (full - pts).median(dim=0).values.tolist()
    graphs = {}
    for m in modes:
        lk_probe(pts, prev_p, next_p, PAD, m, iters)
        torch.cuda.synchronize(dev)
        graphs[m] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[m]):
            for _ in range(reps):
                lk_probe(pts, prev_p, next_p, PAD, m, iters)
        graphs[m].replay()
    torch.cuda.synchronize(dev)
    samples = {m: [] for m in modes}
    for _ in range(passes):     # interleaved, so drift hits every mode alike
        for m in modes:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[m].replay()
            b.record()
            torch.cuda.synchronize(dev)
            samples[m].append(a.elapsed_time(b) / reps)
    ms = {m: min(v) for m, v in samples.items()}

    def per_iter(t):
        return t / (k * iters) * 1e3

    attribution = {"total": per_iter(ms["full"])}
    if "notmpl" in ms:
        attribution["template (full-notmpl)"] = per_iter(ms["full"] - ms["notmpl"])
    if "noload" in ms:
        attribution["load (full-noload)"] = per_iter(ms["full"] - ms["noload"])
    if "noarith" in ms:
        attribution["solve+red (full-noarith)"] = per_iter(ms["full"] - ms["noarith"])
    if "empty" in ms:
        attribution["loop+template (empty)"] = per_iter(ms["empty"])
    return {"ms": ms, "samples": samples, "median_displacement": disp,
            "per_point_iter_us": attribution}


def main() -> None:
    res = run()
    print(f"[sanity] median displacement {res['median_displacement']} (expect ~[-3, 3])")
    for m, t in res["ms"].items():
        print(f"{m:8s}: {t:7.4f} ms/call  (samples "
              f"{['%.4f' % s for s in res['samples'][m]]})")
    print("\nper point-iteration (us):")
    for name, us in res["per_point_iter_us"].items():
        print(f"  {name:24s}: {us:6.4f}")


if __name__ == "__main__":
    main()
