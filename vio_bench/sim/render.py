"""Frames of a recording, rendered with torch on the run's device: the
port's ``eval/simulation.render_frame`` (a raycast box room with a smooth
3D texture, and a blurred 2x2 checker sprite at every visible landmark,
composited in landmark order), for all frames of a recording at once.

The background is computed in batches of frames; the sprites in one loop
over the landmarks, each step compositing that landmark into every frame
that sees it (a sprite that a frame does not see is composited with alpha
0, which leaves the pixel exactly as it was). Frames differ from the numpy
renderer's by rounding only: at most one grey level at a pixel (the
harness's tests hold them to that).
"""

from __future__ import annotations

import numpy as np
import torch

from vio_bench.sim.cameras import Camera
from vio_bench.sim.world import Recording, quat_to_rot

MARGIN = 8.0
SPRITE = 7
SPRITE_SEED = 3
ROOM_HALF = 4.0
PLANES = ((0, ROOM_HALF), (0, -ROOM_HALF), (1, ROOM_HALF), (1, -ROOM_HALF), (2, 2.8), (2, -0.4))


def _ray_grid(cam: Camera, device) -> torch.Tensor:
    h, w = cam.height, cam.width
    f64 = dict(dtype=torch.float64, device=device)
    vv, uu = torch.meshgrid(torch.arange(h, **f64) + 0.5, torch.arange(w, **f64) + 0.5,
                            indexing="ij")
    rays = cam.lift(torch.stack([uu, vv], dim=-1))
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def _walls(rays, r_wc, t_wc) -> torch.Tensor:
    """(n, H, W) background of n frames: the texture at each ray's first
    hit of the box room."""
    d = torch.einsum("hwk,njk->nhwj", rays, r_wc)
    o = t_wc[:, None, None, :]
    t_best = torch.full(d.shape[:3], float("inf"), dtype=d.dtype, device=d.device)
    for axis, val in PLANES:
        da = d[..., axis]
        t = (val - o[..., axis]) / torch.where(torch.abs(da) < 1e-9, 1e-9, da)
        t_best = torch.where((t > 0.05) & (t < t_best), t, t_best)
    t_best = torch.where(torch.isfinite(t_best), t_best, 12.0)
    hit = o + d * t_best[..., None]
    x, y, z = hit[..., 0], hit[..., 1], hit[..., 2]
    return (55.0
            + 16.0 * torch.sin(2.1 * x + 0.7) * torch.cos(1.7 * y + 0.3)
            + 10.0 * torch.sin(3.3 * y + 1.9) * torch.cos(2.7 * z + 1.1)
            + 7.0 * torch.sin(4.9 * z + 0.5) * torch.cos(3.9 * x + 2.3))


def render(rec: Recording, cam: Camera, r_ic: np.ndarray, t_ic: np.ndarray, device,
           batch: int = 32) -> np.ndarray:
    """(N, H, W) uint8 frames of ``rec`` as the camera (mounted at r_ic,
    t_ic in the body) sees the poses ``rec.seen_*``."""
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    n, h, w = len(rec.cam_ts), cam.height, cam.width
    r_wb = torch.as_tensor(quat_to_rot(rec.seen_q), **f64)
    r_wc = r_wb @ torch.as_tensor(r_ic, **f64)
    t_wc = torch.as_tensor(rec.seen_p, **f64) + r_wb @ torch.as_tensor(t_ic, **f64)
    rays = _ray_grid(cam, dev)
    img = torch.empty((n, h, w), **f64)
    for a in range(0, n, batch):
        img[a:a + batch] = _walls(rays, r_wc[a:a + batch], t_wc[a:a + batch])
    del rays

    lm = torch.as_tensor(rec.landmarks, **f64)
    pts = torch.einsum("nli,nij->nlj", lm[None] - t_wc[:, None], r_wc)     # (N, L, 3)
    uv = cam.project(pts)
    depth = pts[..., 2]
    vis = ((depth > 0.3) & (depth < 12.0)
           & (uv[..., 0] > MARGIN) & (uv[..., 0] < w - MARGIN)
           & (uv[..., 1] > MARGIN) & (uv[..., 1] < h - MARGIN))
    uv = torch.where(vis[..., None], uv, torch.tensor([w / 2.0, h / 2.0], **f64))
    rng = np.random.default_rng(SPRITE_SEED)
    brightness = rng.uniform(120, 195, len(rec.landmarks))
    phases = rng.integers(0, 2, len(rec.landmarks))

    half, side = SPRITE // 2, SPRITE + 1
    span = torch.arange(side, device=dev)
    frames = torch.arange(n, device=dev)[:, None, None]
    for li in range(len(rec.landmarks)):
        fl = torch.floor(uv[:, li])                                     # (N, 2)
        frac = uv[:, li] - fl
        x0 = fl[:, 0].long() - half
        y0 = fl[:, 1].long() - half
        u_rel = span.to(torch.float64)[None, None, :] - half - frac[:, 0, None, None]
        v_rel = span.to(torch.float64)[None, :, None] - half - frac[:, 1, None, None]
        checker = (torch.tanh(u_rel / 0.7) * torch.tanh(v_rel / 0.7) + 1) / 2
        if phases[li]:
            checker = 1 - checker
        env = torch.exp(-(u_rel ** 2 + v_rel ** 2) / (2 * (half * 0.9) ** 2))
        alpha = env * vis[:, li, None, None]
        rows = (y0[:, None] + span)[:, :, None]
        cols = (x0[:, None] + span)[:, None, :]
        old = img[frames, rows, cols]
        img[frames, rows, cols] = old * (1 - alpha) + (40.0 + checker * brightness[li]) * alpha
    out = img.clamp_(0, 255).to(torch.uint8).cpu().numpy()
    del img
    return out
