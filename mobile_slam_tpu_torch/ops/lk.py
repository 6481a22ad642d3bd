"""Pyramidal Lucas-Kanade tracking: plain PyTorch versions, the CUDA
kernel wrappers and the device dispatch.

The three public operations dispatch on the device of their inputs:

* ``track_pyramidal``  — coarse-to-fine KLT over a pyramid (K1),
* ``refine_template``  — zero-mean KLT of stored templates (K2),
* ``extract_patches``  — template + Scharr gradient patches (K3).

A CPU tensor goes to the plain version (``*_ref``); a CUDA tensor launches
the hand-written kernel of ``csrc/lk_kernels.cu`` or raises. There is no
fallback between the two. Both compute the function of
``mobile_slam_tpu.ops.lk_pallas`` in float32: each level behaves as if
replicate-padded by ``half + 2``, every block origin clamped in padded
coordinates, so gradients at the border follow replicate (not ops/lk.py's
reflect-101) semantics; gradients are Scharr on the fetched block;
per-point early exit is the masked fixed-count loop that freezes converged
points. The plain versions make the padded copy; the three kernels read the
tracker's own unpadded images and clamp each pixel's row and column at the
load, which gives the same values (``_gather_clamped``), so their wrappers
copy nothing when the images are contiguous float32.

Each public operation is a ``torch.library`` custom op with a vmap rule,
so that ``torch.func.vmap`` of the tracker (the fleet, parallel/batch.py)
takes a batch of B sequences through it: on CUDA tensors the rule makes ONE
launch over all B x K point slots (the kernels' grid is (K, B)); on CPU
tensors it runs the plain version once per sequence (the reference's
``lax.map`` in ``lk_pallas._sequential_vmap``). On the card it never loops
over single launches and never takes the plain version.

Each wrapper adds one to ``launch_counts[name]`` where it launches its
kernel (one per batched launch too), and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mobile_slam_tpu_torch.ops import cuda_build

F32 = torch.float32


class LKParams(NamedTuple):
    window: int = 21
    levels: int = 3
    iters: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 1e-4


launch_counts = {"track_pyramidal": 0, "refine_template": 0,
                 "extract_patches": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (vectorized over the K point slots)
# ---------------------------------------------------------------------------

def _pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad an (H, W) image by ``pad`` on all four sides."""
    return F.pad(img[None, None].to(F32), (pad, pad, pad, pad),
                 mode="replicate")[0, 0]


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    # NaN / huge values map to an arbitrary integer; every caller clamps.
    return torch.floor(torch.nan_to_num(x, nan=0.0, posinf=1e9, neginf=-1e9)).long()


def _gather_block(imgp: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
                  rows: int, cols: int) -> torch.Tensor:
    r = torch.arange(rows, device=imgp.device)
    c = torch.arange(cols, device=imgp.device)
    return imgp[by[:, None, None] + r[None, :, None],
                bx[:, None, None] + c[None, None, :]]


def _gather_clamped(img: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
                    rows: int, cols: int, pad: int) -> torch.Tensor:
    """``_gather_block(_pad(img, pad), by, bx, rows, cols)`` without the
    padded copy: each row and column is clamped into the image. The
    identity K1 and K2 rest on for their borders."""
    h, w = img.shape
    r = torch.arange(rows, device=img.device)
    c = torch.arange(cols, device=img.device)
    rr = torch.clamp(by[:, None] + r[None, :] - pad, 0, h - 1)
    cc = torch.clamp(bx[:, None] + c[None, :] - pad, 0, w - 1)
    return img[rr[:, :, None], cc[:, None, :]]


def _bilinear_block(block: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                    win: int) -> torch.Tensor:
    """(K, win, win) bilinear patches from (K, >=win+1, >=win+1) blocks."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    return (w00 * block[:, 0:win, 0:win] + w01 * block[:, 0:win, 1:win + 1]
            + w10 * block[:, 1:win + 1, 0:win]
            + w11 * block[:, 1:win + 1, 1:win + 1])


def _scharr_on_block(tb: torch.Tensor, n: int):
    """Scharr x/y (/32) of the interior (n, n) of (K, n+2, n+2) blocks."""
    right = (3.0 * tb[:, 0:n, 2:n + 2] + 10.0 * tb[:, 1:n + 1, 2:n + 2]
             + 3.0 * tb[:, 2:n + 2, 2:n + 2])
    left = (3.0 * tb[:, 0:n, 0:n] + 10.0 * tb[:, 1:n + 1, 0:n]
            + 3.0 * tb[:, 2:n + 2, 0:n])
    bot = (3.0 * tb[:, 2:n + 2, 0:n] + 10.0 * tb[:, 2:n + 2, 1:n + 1]
           + 3.0 * tb[:, 2:n + 2, 2:n + 2])
    top = (3.0 * tb[:, 0:n, 0:n] + 10.0 * tb[:, 0:n, 1:n + 1]
           + 3.0 * tb[:, 0:n, 2:n + 2])
    return (right - left) / 32.0, (bot - top) / 32.0


def _template(imgp: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
              win: int, pad: int):
    """Template + gradient patches (K, win, win) at subpixel (tx, ty) of a
    padded image."""
    hp, wp = imgp.shape
    half = (win - 1) // 2
    tbx = torch.clamp(_floor_int(tx) - half - 1 + pad, 0, wp - (win + 3))
    tby = torch.clamp(_floor_int(ty) - half - 1 + pad, 0, hp - (win + 3))
    ftx = tx - torch.floor(tx)
    fty = ty - torch.floor(ty)
    tb = _gather_block(imgp, tby, tbx, win + 3, win + 3)
    gxb, gyb = _scharr_on_block(tb, win + 1)
    t = _bilinear_block(tb[:, 1:win + 2, 1:win + 2], ftx, fty, win)
    return t, _bilinear_block(gxb, ftx, fty, win), _bilinear_block(gyb, ftx, fty, win)


def _sample(imgp: torch.Tensor, x: torch.Tensor, y: torch.Tensor, win: int,
            pad: int) -> torch.Tensor:
    """(K, win, win) bilinear window at subpixel (x, y), origin clamped in
    padded coordinates."""
    hp, wp = imgp.shape
    half = (win - 1) // 2
    bx = torch.clamp(_floor_int(x) - half + pad, 0, wp - (win + 1))
    by = torch.clamp(_floor_int(y) - half + pad, 0, hp - (win + 1))
    nb = _gather_block(imgp, by, bx, win + 1, win + 1)
    return _bilinear_block(nb, x - torch.floor(x), y - torch.floor(y), win)


def _normal_matrix(gx, gy, win2: float, thr: float):
    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))) / win2
    invertible = min_eig > thr
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))
    return gxx, gxy, gyy, invertible, inv_det


def _inside(x, y, h: int, w: int):
    return ((x >= 0.0) & (x < w - 1.0) & (y >= 0.0) & (y < h - 1.0)
            & torch.isfinite(x) & torch.isfinite(y))


def track_pyramidal_ref(prev_pyr, next_pyr, pts: torch.Tensor,
                        active: torch.Tensor, params: LKParams,
                        iterations: list | None = None,
                        steps: list | None = None,
                        windows: list | None = None):
    """Plain version of K1. Returns (pos (K, 2) float32, ok (K,) bool).
    Given a list as ``iterations``, appends to it the point-iterations run
    at each level, coarse first (the work K1 does on these inputs). Given a
    list as ``steps``, appends one (K,) int64 tensor: the Gauss-Newton steps
    each point ran over all levels (its chain; 0 for an inactive slot, at
    most ``iters`` per level). Given a list as ``windows``, appends
    (level, x, y) for every step: the level and the positions at which the
    points still moving sample their window in ``next_pyr``."""
    win = params.window
    half = (win - 1) // 2
    pad = half + 2
    win2 = float(win * win)
    eps2 = params.eps * params.eps
    n_lvl = len(prev_pyr)
    px = pts[:, 0].to(F32)
    py = pts[:, 1].to(F32)
    act = active.bool()
    top = float(2 ** (n_lvl - 1))
    cx, cy = px / top, py / top
    ok = torch.ones_like(act)
    count = iterations is not None or steps is not None
    n_steps = torch.zeros(px.shape[0], dtype=torch.int64, device=px.device)
    for lvl in range(n_lvl - 1, -1, -1):
        h, w = prev_pyr[lvl].shape
        prev_p = _pad(prev_pyr[lvl], pad)
        next_p = _pad(next_pyr[lvl], pad)
        scale = float(2 ** lvl)
        t, gx, gy = _template(prev_p, px / scale, py / scale, win, pad)
        gxx, gxy, gyy, invertible, inv_det = _normal_matrix(
            gx, gy, win2, params.min_eig_threshold)
        conv = ~(act & invertible)
        before = n_steps
        for _ in range(params.iters):
            if bool(conv.all()):
                break
            if count:
                n_steps = n_steps + ~conv
            if windows is not None:
                windows.append((lvl, cx[~conv], cy[~conv]))
            diff = _sample(next_p, cx, cy, win, pad) - t
            b1 = torch.sum(diff * gx, dim=(1, 2))
            b2 = torch.sum(diff * gy, dim=(1, 2))
            dx = -(gyy * b1 - gxy * b2) * inv_det
            dy = -(gxx * b2 - gxy * b1) * inv_det
            step_conv = dx * dx + dy * dy <= eps2
            cx = torch.where(conv, cx, cx + dx)
            cy = torch.where(conv, cy, cy + dy)
            conv = conv | step_conv
        if iterations is not None:
            iterations.append(int((n_steps - before).sum()))
        ok = ok & invertible & _inside(cx, cy, h, w)
        if lvl > 0:
            cx, cy = cx * 2.0, cy * 2.0
    if steps is not None:
        steps.append(n_steps)
    pos = torch.stack([torch.where(act, cx, px), torch.where(act, cy, py)], dim=-1)
    return pos, act & ok


def refine_rhs_two_round(c: torch.Tensor, t: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor):
    """Right-hand side (b1, b2) of K2's step from (K, win, win) windows
    ``c`` and raw templates ``t``: both are made zero-mean first (one
    reduction), then differenced and summed (a second). The form the plain
    version and the K2 kernel take."""
    n = float(c.shape[1] * c.shape[2])
    c_zm = c - (torch.sum(c, dim=(1, 2)) / n)[:, None, None]
    t_zm = t - (torch.sum(t, dim=(1, 2)) / n)[:, None, None]
    diff = c_zm - t_zm
    return torch.sum(diff * gx, dim=(1, 2)), torch.sum(diff * gy, dim=(1, 2))


def refine_rhs_one_round(c: torch.Tensor, t: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor):
    """The same (b1, b2) from one reduction round: with d = c - t,
    (c - mean c) - (t - mean t) = d - mean d, so
    b1 = sum(d gx) - sum(d) / n * sum(gx), likewise b2. d is a residual, so
    no large numbers cancel (sum(c gx) - mean c * sum(gx) would, on 0..255
    images). One barrier fewer per step in a kernel; the K2 kernel does not
    take it (csrc/lk_kernels.cu says why), and ``refine_template_ref`` takes
    it only on request."""
    n = float(c.shape[1] * c.shape[2])
    d = c - t
    dmean = torch.sum(d, dim=(1, 2)) / n
    return (torch.sum(d * gx, dim=(1, 2)) - dmean * torch.sum(gx, dim=(1, 2)),
            torch.sum(d * gy, dim=(1, 2)) - dmean * torch.sum(gy, dim=(1, 2)))


def refine_template_ref(img: torch.Tensor, t_patch: torch.Tensor,
                        gx: torch.Tensor, gy: torch.Tensor, pos0: torch.Tensor,
                        active: torch.Tensor, window: int, iters: int,
                        eps: float, max_shift: float,
                        iterations: list | None = None,
                        steps: list | None = None, one_round: bool = False,
                        windows: list | None = None):
    """Plain version of K2. Returns (pos (K, 2), ok (K,), resid (K,)),
    float32. Given a list as ``iterations``, appends to it the
    point-iterations run (the work K2 does on these inputs); given a list
    as ``steps``, appends one (K,) int64 tensor of the steps each point ran
    (0 for an inactive slot, at most ``iters``). Given a list as
    ``windows``, appends (x, y) for every step, the positions at which the
    points still moving sample their window, and last the end positions of
    the active points (their residual's window). ``one_round`` takes the
    step's right-hand side from ``refine_rhs_one_round`` instead of from the
    two zero-mean patches."""
    k = pos0.shape[0]
    win = window
    pad = (win - 1) // 2 + 2
    win2 = float(win * win)
    eps2 = eps * eps
    h, w = img.shape
    imgp = _pad(img, pad)
    t3 = t_patch.reshape(k, win, win).to(F32)
    gx3 = gx.reshape(k, win, win).to(F32)
    gy3 = gy.reshape(k, win, win).to(F32)
    x0 = pos0[:, 0].to(F32)
    y0 = pos0[:, 1].to(F32)
    act = active.bool()
    t_zm = t3 - (torch.sum(t3, dim=(1, 2)) / win2)[:, None, None]
    gxx, gxy, gyy, invertible, inv_det = _normal_matrix(gx3, gy3, win2, 1e-4)

    cx, cy = x0, y0
    conv = ~(act & invertible)
    count = iterations is not None or steps is not None
    n_steps = torch.zeros(k, dtype=torch.int64, device=pos0.device)
    rhs = refine_rhs_one_round if one_round else refine_rhs_two_round
    for _ in range(iters):
        if bool(conv.all()):
            break
        if count:
            n_steps = n_steps + ~conv
        if windows is not None:
            windows.append((cx[~conv], cy[~conv]))
        b1, b2 = rhs(_sample(imgp, cx, cy, win, pad), t3, gx3, gy3)
        dx = -(gyy * b1 - gxy * b2) * inv_det
        dy = -(gxx * b2 - gxy * b1) * inv_det
        ox, oy = (cx + dx) - x0, (cy + dy) - y0
        r = torch.sqrt(ox * ox + oy * oy)
        s = torch.where(r > max_shift, max_shift / torch.clamp(r, min=1e-9),
                        torch.ones_like(r))
        step_conv = dx * dx + dy * dy <= eps2
        cx = torch.where(conv, cx, x0 + ox * s)
        cy = torch.where(conv, cy, y0 + oy * s)
        conv = conv | step_conv

    if iterations is not None:
        iterations.append(int(n_steps.sum()))
    if steps is not None:
        steps.append(n_steps)
    if windows is not None:
        windows.append((cx[act], cy[act]))
    c = _sample(imgp, cx, cy, win, pad)
    c_zm = c - (torch.sum(c, dim=(1, 2)) / win2)[:, None, None]
    resid = torch.sum(torch.abs(c_zm - t_zm), dim=(1, 2)) / win2
    ok = act & invertible & _inside(cx, cy, h, w)
    pos = torch.stack([torch.where(act, cx, x0), torch.where(act, cy, y0)], dim=-1)
    return pos, ok, torch.where(act, resid, torch.zeros_like(resid))


def extract_patches_ref(img: torch.Tensor, centers: torch.Tensor, window: int):
    """Plain version of K3: (t, gx, gy), each (K, window*window) float32."""
    k = centers.shape[0]
    pad = (window - 1) // 2 + 2
    imgp = _pad(img, pad)
    t, gx, gy = _template(imgp, centers[:, 0].to(F32), centers[:, 1].to(F32),
                          window, pad)
    n = window * window
    return t.reshape(k, n), gx.reshape(k, n), gy.reshape(k, n)


def track_level(prev_img, next_img, prev_pts, guess, params: LKParams, active):
    """One pyramid level of plain iterative KLT (the reference's non-Pallas
    ``ops/lk.py:track_level``; no kernel stands behind it and the tracker
    does not call it): bilinear window patches (border-clamped sampling),
    Scharr gradients of the whole image (reflect-101), the structure
    tensor's min-eigenvalue gate, ``params.iters`` masked Gauss-Newton steps
    from ``guess`` that freeze converged points. prev_pts / guess (K, 2),
    active (K,) bool. Returns (positions (K, 2), ok (K,))."""
    from mobile_slam_tpu_torch.ops import image as im

    dtype, dev = prev_img.dtype, prev_img.device
    win2 = params.window * params.window
    o = torch.arange(params.window, dtype=dtype, device=dev) - (params.window - 1) / 2.0
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    offsets = torch.stack([ox, oy], dim=-1).reshape(-1, 2)     # (win², 2)

    def patch(img, centers):
        return im.bilinear_sample(img, centers[:, None, :] + offsets[None, :, :])

    ix, iy = im.scharr_derivatives(prev_img)
    t_patch = patch(prev_img, prev_pts)
    gx = patch(ix, prev_pts)
    gy = patch(iy, prev_pts)
    gxx = torch.sum(gx * gx, dim=1)
    gxy = torch.sum(gx * gy, dim=1)
    gyy = torch.sum(gy * gy, dim=1)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / win2
    invertible = min_eig > params.min_eig_threshold
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))

    pos = guess
    converged = torch.zeros(guess.shape[0], dtype=torch.bool, device=dev)
    for _ in range(params.iters):
        diff = patch(next_img, pos) - t_patch
        b1 = torch.sum(diff * gx, dim=1)
        b2 = torch.sum(diff * gy, dim=1)
        delta = torch.stack([-(gyy * b1 - gxy * b2) * inv_det,
                             -(gxx * b2 - gxy * b1) * inv_det], dim=-1)
        step_ok = active & invertible & ~converged
        pos = torch.where(step_ok[:, None], pos + delta, pos)
        converged = converged | (torch.sum(delta * delta, dim=-1) <= params.eps * params.eps)
    h, w = prev_img.shape
    inside = ((pos[:, 0] >= 0) & (pos[:, 0] < w - 1)
              & (pos[:, 1] >= 0) & (pos[:, 1] < h - 1))
    ok = active & invertible & inside & torch.all(torch.isfinite(pos), dim=-1)
    return pos, ok


# ---------------------------------------------------------------------------
# CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------
#
# Each wrapper is split in two: ``_*_prep`` checks and lays out the inputs
# and ``_*_launch`` allocates the outputs and launches the kernel on the
# current stream, so that a launch can be timed alone on prepared inputs.
# Each prep hands the kernel the caller's own tensors: an image or level
# that is contiguous float32 (what ``ops/image.build_pyramid`` makes) is not
# copied, any other is copied once to that layout; ``active`` and ``ok`` are
# bool tensors the kernel reads and writes as bytes.

MAX_WINDOW = 31          # LK_MAX_WIN in csrc/lk_common.cuh
MAX_LEVELS = 8           # LK_MAX_LEVELS
BLOCK_WARPS = 4          # LK_NWARP: warps per point slot
SMEM_LIMIT = 232448 - 1024   # LK_SMEM_LIMIT: dynamic bytes a block may ask for


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of csrc/lk_kernels.cu's entry points."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_configure.argtypes = []
    lib.lk_track_smem_bytes.argtypes = [ci, ci]
    cl = ctypes.c_longlong
    lib.lk_track_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, ci,
                                    ci, ci, cf, cf, vp, vp, vp]
    lib.lk_refine_launch.argtypes = [vp, cl, ci, ci, vp, vp, vp, vp, vp, ci, ci,
                                     ci, ci, cf, cf, vp, vp, vp, vp]
    lib.lk_extract_launch.argtypes = [vp, cl, ci, ci, vp, ci, ci, ci, vp, vp, vp,
                                      vp]
    for fn in (lib.lk_configure, lib.lk_track_smem_bytes, lib.lk_track_launch,
               lib.lk_refine_launch, lib.lk_extract_launch):
        fn.restype = ci
    return lib


@functools.cache
def build_kernels() -> ctypes.CDLL:
    """Compile csrc/lk_kernels.cu for sm_90a (ops/cuda_build.py) and load
    it. Raises with nvcc's output if the build fails, and when no CUDA
    device is present."""
    return _bind(cuda_build.load("lk_kernels"))


_configured: set = set()    # indices of the devices lk_configure has run on


def _configure(lib: ctypes.CDLL) -> None:
    """Let K1 ask for its dynamic shared memory on the current device. The
    attribute is per device, so this runs once for each card, at its first
    K1 launch; that launch must not be inside a CUDA-graph capture."""
    index = torch.cuda.current_device()
    if index not in _configured:
        cuda_build.check(lib.lk_configure(), "lk_configure")
        _configured.add(index)


def track_smem_bytes(window: int, n_levels: int) -> int:
    """Dynamic shared memory K1 asks for (lk_track_smem_bytes in
    csrc/lk_kernels.cu): three window^2 patches per level and one template
    build's scratch per warp, in float32."""
    n3, n1 = window + 3, window + 1
    return 4 * (n_levels * 3 * window * window
                + BLOCK_WARPS * (n3 * n3 + 2 * n1 * n1))


def _check_window(window: int) -> None:
    if not 3 <= window <= MAX_WINDOW:
        raise ValueError(f"LK window {window} outside [3, {MAX_WINDOW}]")


def _check_points(pts: torch.Tensor, active: torch.Tensor | None = None) -> int:
    k = pts.shape[0]
    if pts.shape != (k, 2) or k < 1:
        raise ValueError(f"points must be (K, 2) with K >= 1, got {tuple(pts.shape)}")
    if active is not None and active.shape != (k,):
        raise ValueError(f"active must be ({k},), got {tuple(active.shape)}")
    return k


def _f32c(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous float32, else one copy that is."""
    return t.to(F32).contiguous()


def _planes(t: torch.Tensor) -> torch.Tensor:
    """(B, h, w) float32 whose every (h, w) plane is contiguous: ``t``
    itself when it is (a batch stride of 0 included: one plane shared by all
    sequences), else one contiguous copy."""
    t = t.to(F32)
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        t = t.contiguous()
    return t


def _batch_stride(t: torch.Tensor) -> int:
    """Floats from one sequence's plane to the next: 0 for a single (h, w)
    plane (the single-stream launch)."""
    return t.stride(0) if t.dim() == 3 else 0


def _check_batch(b: int, *ts) -> None:
    for t in ts:
        if t.dim() != 3 or t.shape[0] != b or t.numel() == 0:
            raise ValueError(f"batched images must be non-empty (B={b}, H, W), "
                             f"got {tuple(t.shape)}")


def _track_prep(prev_pyr, next_pyr, pts, active, params: LKParams):
    _check_window(params.window)
    n_lvl = len(prev_pyr)
    if not 1 <= n_lvl <= MAX_LEVELS or len(next_pyr) != n_lvl:
        raise ValueError(f"bad pyramid depth {n_lvl}/{len(next_pyr)}")
    dev = pts.device
    for im in (*prev_pyr, *next_pyr):
        if im.device != dev or im.dim() != 2 or im.numel() == 0:
            raise ValueError("pyramid levels must be non-empty 2-D tensors "
                             "on the device of the points")
    for a, b in zip(prev_pyr, next_pyr):
        if a.shape != b.shape:
            raise ValueError(f"pyramid levels differ: {tuple(a.shape)} / {tuple(b.shape)}")
    _check_points(pts, active)
    smem = track_smem_bytes(params.window, n_lvl)
    if smem > SMEM_LIMIT:
        raise ValueError(f"LK window {params.window} over {n_lvl} levels asks "
                         f"{smem} bytes of shared memory; a block may have {SMEM_LIMIT}")
    return (tuple(_f32c(p) for p in prev_pyr), tuple(_f32c(p) for p in next_pyr),
            _f32c(pts), active.bool().contiguous(), params)


def _track_prep_batched(prev_pyr, next_pyr, pts, active, params: LKParams):
    """``_track_prep`` for a batch: levels (B, H_l, W_l), points (B, K, 2),
    active (B, K). Levels whose planes are contiguous float32 are handed
    over as they are, a batch stride of 0 included."""
    if pts.dim() != 3 or pts.shape[0] < 1:
        raise ValueError(f"batched points must be (B, K, 2), got {tuple(pts.shape)}")
    b = pts.shape[0]
    if active.shape != pts.shape[:2]:
        raise ValueError(f"active must be {tuple(pts.shape[:2])}, got {tuple(active.shape)}")
    _check_batch(b, *prev_pyr, *next_pyr)
    _track_prep([p[0] for p in prev_pyr], [p[0] for p in next_pyr], pts[0],
                active[0], params)
    return (tuple(_planes(p) for p in prev_pyr), tuple(_planes(p) for p in next_pyr),
            _f32c(pts), active.bool().contiguous(), params)


def _track_launch(prev_lv, next_lv, pts_c, act, params: LKParams):
    """One launch over every slot: (K, 2) points and (H_l, W_l) levels, or
    a batch of (B, K, 2) points and (B, H_l, W_l) levels."""
    lib = build_kernels()
    n_lvl, dev = len(prev_lv), pts_c.device
    b = pts_c.shape[0] if pts_c.dim() == 3 else 1
    k = pts_c.shape[-2]
    out_pos = torch.empty(pts_c.shape, dtype=F32, device=dev)
    out_ok = torch.empty(pts_c.shape[:-1], dtype=torch.bool, device=dev)
    prev_a = (ctypes.c_void_p * n_lvl)(*[p.data_ptr() for p in prev_lv])
    next_a = (ctypes.c_void_p * n_lvl)(*[p.data_ptr() for p in next_lv])
    bsp_a = (ctypes.c_longlong * n_lvl)(*[_batch_stride(p) for p in prev_lv])
    bsn_a = (ctypes.c_longlong * n_lvl)(*[_batch_stride(p) for p in next_lv])
    h_a = (ctypes.c_int * n_lvl)(*[p.shape[-2] for p in prev_lv])
    w_a = (ctypes.c_int * n_lvl)(*[p.shape[-1] for p in prev_lv])
    with torch.cuda.device(dev):
        _configure(lib)
        rc = lib.lk_track_launch(
            ctypes.addressof(prev_a), ctypes.addressof(next_a),
            ctypes.addressof(bsp_a), ctypes.addressof(bsn_a),
            ctypes.addressof(h_a), ctypes.addressof(w_a), n_lvl,
            pts_c.data_ptr(), act.data_ptr(), b, k, params.window, params.iters,
            float(params.eps), float(params.min_eig_threshold),
            out_pos.data_ptr(), out_ok.data_ptr(), cuda_build.stream(pts_c))
    cuda_build.check(rc, "lk_track_launch")
    launch_counts["track_pyramidal"] += 1
    return out_pos, out_ok


def _track_pyramidal_cuda(prev_pyr, next_pyr, pts, active, params: LKParams):
    return _track_launch(*_track_prep(prev_pyr, next_pyr, pts, active, params))


def _refine_prep(img, t_patch, gx, gy, pos0, active, window, iters, eps,
                 max_shift):
    _check_window(window)
    dev = pos0.device
    k = _check_points(pos0, active)
    nw = window * window
    for t in (img, t_patch, gx, gy, active):
        if t.device != dev:
            raise ValueError("refine_template inputs must share one device")
    if img.dim() != 2 or img.numel() == 0:
        raise ValueError("refine_template needs a non-empty 2-D image")
    if t_patch.shape != (k, nw) or gx.shape != (k, nw) or gy.shape != (k, nw):
        raise ValueError("templates must be (K, window*window)")
    return (_f32c(img), _f32c(t_patch), _f32c(gx), _f32c(gy), _f32c(pos0),
            active.bool().contiguous(), window, iters, eps, max_shift)


def _refine_prep_batched(img, t_patch, gx, gy, pos0, active, window, iters,
                         eps, max_shift):
    """``_refine_prep`` for a batch: images (B, H, W), templates (B, K,
    window^2), pos0 (B, K, 2), active (B, K)."""
    if pos0.dim() != 3 or pos0.shape[0] < 1:
        raise ValueError(f"batched points must be (B, K, 2), got {tuple(pos0.shape)}")
    b = pos0.shape[0]
    for t in (t_patch, gx, gy, active):
        if t.shape[0] != b:
            raise ValueError(f"every batched input must lead with B={b}")
    _check_batch(b, img)
    _refine_prep(img[0], t_patch[0], gx[0], gy[0], pos0[0], active[0], window,
                 iters, eps, max_shift)
    return (_planes(img), _f32c(t_patch), _f32c(gx), _f32c(gy), _f32c(pos0),
            active.bool().contiguous(), window, iters, eps, max_shift)


def _refine_launch(img, tp, gxc, gyc, p0, act, window, iters, eps, max_shift):
    """One launch over every slot: (K, ...) inputs and an (H, W) image, or a
    batch of (B, K, ...) inputs and (B, H, W) images."""
    lib = build_kernels()
    dev = p0.device
    b = p0.shape[0] if p0.dim() == 3 else 1
    k = p0.shape[-2]
    h, w = img.shape[-2:]
    out_pos = torch.empty(p0.shape, dtype=F32, device=dev)
    out_ok = torch.empty(p0.shape[:-1], dtype=torch.bool, device=dev)
    out_res = torch.empty(p0.shape[:-1], dtype=F32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.lk_refine_launch(
            img.data_ptr(), _batch_stride(img), h, w, tp.data_ptr(), gxc.data_ptr(),
            gyc.data_ptr(), p0.data_ptr(), act.data_ptr(), b, k, window, iters,
            float(eps), float(max_shift), out_pos.data_ptr(), out_ok.data_ptr(),
            out_res.data_ptr(), cuda_build.stream(p0))
    cuda_build.check(rc, "lk_refine_launch")
    launch_counts["refine_template"] += 1
    return out_pos, out_ok, out_res


def _refine_template_cuda(img, t_patch, gx, gy, pos0, active, window, iters,
                          eps, max_shift):
    return _refine_launch(*_refine_prep(img, t_patch, gx, gy, pos0, active,
                                        window, iters, eps, max_shift))


def _extract_prep(img, centers, window):
    _check_window(window)
    dev = centers.device
    if img.device != dev or img.dim() != 2 or img.numel() == 0:
        raise ValueError("extract_patches needs a non-empty 2-D image on the device "
                         "of the centers")
    _check_points(centers)
    return _f32c(img), _f32c(centers), window


def _extract_prep_batched(img, centers, window):
    """``_extract_prep`` for a batch: images (B, H, W), centers (B, K, 2)."""
    if centers.dim() != 3 or centers.shape[0] < 1:
        raise ValueError(f"batched points must be (B, K, 2), got {tuple(centers.shape)}")
    _check_batch(centers.shape[0], img)
    _extract_prep(img[0], centers[0], window)
    return _planes(img), _f32c(centers), window


def _extract_launch(img, c, window):
    """One launch over every slot: (K, 2) centers and an (H, W) image, or a
    batch of (B, K, 2) centers and (B, H, W) images."""
    lib = build_kernels()
    dev = c.device
    b = c.shape[0] if c.dim() == 3 else 1
    k = c.shape[-2]
    h, w = img.shape[-2:]
    outs = [torch.empty(c.shape[:-1] + (window * window,), dtype=F32, device=dev)
            for _ in range(3)]
    with torch.cuda.device(dev):
        rc = lib.lk_extract_launch(
            img.data_ptr(), _batch_stride(img), h, w, c.data_ptr(), b, k, window,
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            cuda_build.stream(c))
    cuda_build.check(rc, "lk_extract_launch")
    launch_counts["extract_patches"] += 1
    return tuple(outs)


def _extract_patches_cuda(img, centers, window):
    return _extract_launch(*_extract_prep(img, centers, window))


# ---------------------------------------------------------------------------
# Public dispatch: custom ops with a vmap rule
# ---------------------------------------------------------------------------

def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"LK ops run on CPU or CUDA tensors, not {t.device}")


def _batched(t: torch.Tensor, dim, b: int) -> torch.Tensor:
    """``t`` with its vmapped dimension first; an input that is not vmapped
    is expanded to B without a copy (batch stride 0)."""
    return t.expand(b, *t.shape) if dim is None else t.movedim(dim, 0)


def _member(t: torch.Tensor, dim, i: int) -> torch.Tensor:
    """Sequence ``i`` of a vmapped input (the input itself if not vmapped)."""
    return t if dim is None else t.select(dim, i)


def _per_sequence(fn, info, in_dims, args):
    """The CPU vmap rule: ``fn`` once per sequence, outputs stacked."""
    def arg(a, d, i):
        if isinstance(a, (list, tuple)):
            return [_member(x, dx, i) for x, dx in zip(a, d)]
        return _member(a, d, i) if isinstance(a, torch.Tensor) else a

    outs = [fn(*[arg(a, d, i) for a, d in zip(args, in_dims)])
            for i in range(info.batch_size)]
    return tuple(torch.stack(x) for x in zip(*outs))


_NS = "mobile_slam_tpu_torch"


@torch.library.custom_op(
    f"{_NS}::track_pyramidal", mutates_args=(),
    schema="(Tensor[] prev_pyr, Tensor[] next_pyr, Tensor pts, Tensor active, "
           "int window, int iters, float eps, float min_eig) -> (Tensor, Tensor)")
def _track_op(prev_pyr, next_pyr, pts, active, window, iters, eps, min_eig):
    params = LKParams(window, len(prev_pyr) - 1, iters, eps, min_eig)
    if _route(pts) == "cuda":
        return _track_pyramidal_cuda(prev_pyr, next_pyr, pts, active, params)
    return track_pyramidal_ref(prev_pyr, next_pyr, pts, active, params)


@torch.library.register_vmap(f"{_NS}::track_pyramidal")
def _track_vmap(info, in_dims, prev_pyr, next_pyr, pts, active, window, iters,
                eps, min_eig):
    args = (prev_pyr, next_pyr, pts, active, window, iters, eps, min_eig)
    if _route(pts) == "cpu":
        return _per_sequence(_track_op, info, in_dims, args), (0, 0)
    b = info.batch_size
    params = LKParams(window, len(prev_pyr) - 1, iters, eps, min_eig)
    prep = _track_prep_batched(
        [_batched(t, d, b) for t, d in zip(prev_pyr, in_dims[0])],
        [_batched(t, d, b) for t, d in zip(next_pyr, in_dims[1])],
        _batched(pts, in_dims[2], b), _batched(active, in_dims[3], b), params)
    return _track_launch(*prep), (0, 0)


@torch.library.custom_op(
    f"{_NS}::refine_template", mutates_args=(),
    schema="(Tensor img, Tensor t_patch, Tensor gx, Tensor gy, Tensor pos0, "
           "Tensor active, int window, int iters, float eps, float max_shift) "
           "-> (Tensor, Tensor, Tensor)")
def _refine_op(img, t_patch, gx, gy, pos0, active, window, iters, eps, max_shift):
    if _route(pos0) == "cuda":
        return _refine_template_cuda(img, t_patch, gx, gy, pos0, active, window,
                                     iters, eps, max_shift)
    return refine_template_ref(img, t_patch, gx, gy, pos0, active, window,
                               iters, eps, max_shift)


@torch.library.register_vmap(f"{_NS}::refine_template")
def _refine_vmap(info, in_dims, *args):
    if _route(args[4]) == "cpu":
        return _per_sequence(_refine_op, info, in_dims, args), (0, 0, 0)
    b = info.batch_size
    tensors = [_batched(t, d, b) for t, d in zip(args[:6], in_dims[:6])]
    return _refine_launch(*_refine_prep_batched(*tensors, *args[6:])), (0, 0, 0)


@torch.library.custom_op(
    f"{_NS}::extract_patches", mutates_args=(),
    schema="(Tensor img, Tensor centers, int window) -> (Tensor, Tensor, Tensor)")
def _extract_op(img, centers, window):
    if _route(centers) == "cuda":
        return _extract_patches_cuda(img, centers, window)
    return extract_patches_ref(img, centers, window)


@torch.library.register_vmap(f"{_NS}::extract_patches")
def _extract_vmap(info, in_dims, img, centers, window):
    if _route(centers) == "cpu":
        return _per_sequence(_extract_op, info, in_dims, (img, centers, window)), (0, 0, 0)
    b = info.batch_size
    prep = _extract_prep_batched(_batched(img, in_dims[0], b),
                                 _batched(centers, in_dims[1], b), window)
    return _extract_launch(*prep), (0, 0, 0)


def track_pyramidal(prev_pyr, next_pyr, prev_pts, active, params: LKParams):
    """Coarse-to-fine KLT. prev_pyr/next_pyr: sequences of (H/2^l, W/2^l)
    images; prev_pts (K, 2); active (K,). Returns (pos (K, 2) float32, ok (K,))."""
    return _track_op(list(prev_pyr), list(next_pyr), prev_pts, active, params.window,
                     params.iters, float(params.eps), float(params.min_eig_threshold))


def refine_template(img, t_patch, gx, gy, pos0, active, window, iters, eps,
                    max_shift):
    """Zero-mean KLT of (K, window*window) templates against ``img`` from
    ``pos0``, total excursion clamped to ``max_shift``. Returns (pos, ok,
    resid)."""
    return _refine_op(img, t_patch, gx, gy, pos0, active, window, iters,
                      float(eps), float(max_shift))


def extract_patches(img, centers, window):
    """Template + Scharr gradient patches, each (K, window*window)."""
    return _extract_op(img, centers, window)
