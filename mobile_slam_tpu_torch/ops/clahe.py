"""CLAHE (torch twin of mobile_slam_tpu.ops.clahe).

cv::createCLAHE(3.0, {8, 8}) semantics: per-tile 256-bin histograms, clip
and redistribute at max(clip*area/256, 1), CDF lookup tables scaled by
255/area, and bilinear blending of the four neighbouring tile LUTs with
OpenCV's t = p/tile - 0.5 convention. Histograms are exact integer counts
(bincount); the LUT math runs in float32 like the reference.
"""

from __future__ import annotations

import torch


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    h, w = img.shape
    assert h % tiles == 0 and w % tiles == 0, "image must divide into tiles"
    th, tw = h // tiles, w // tiles
    area = th * tw
    dtype = img.dtype
    dev = img.device

    xi = torch.round(torch.clamp(img, 0.0, 255.0)).long()
    ty = torch.arange(h, device=dev) // th
    tx = torch.arange(w, device=dev) // tw
    tile = ty[:, None] * tiles + tx[None, :]
    # Counts by scatter-add: bincount would read its output size on the host;
    # out of place, as torch.func.vmap batches the counts.
    bins = (tile * 256 + xi).reshape(-1)
    hist = torch.zeros(tiles * tiles * 256, dtype=torch.int64, device=dev)
    hist = hist.scatter_add(0, bins, torch.ones_like(bins))
    hist = hist.reshape(tiles * tiles, 256).to(torch.float32)

    limit = max(clip_limit * area / 256.0, 1.0)
    clipped = torch.clamp(hist, max=limit)
    excess = torch.sum(hist - clipped, dim=1, keepdim=True)
    clipped = clipped + excess / 256.0
    cdf = torch.cumsum(clipped, dim=1)
    lut = torch.round(cdf * (255.0 / area)).reshape(tiles, tiles, 256)

    # Neighbour tiles are constant per half-tile block: floor(p/tile - 0.5)
    # for the pixels of block b is (b - 1) // 2.
    by = torch.arange(h, device=dev) // (th // 2)
    bx = torch.arange(w, device=dev) // (tw // 2)
    y0 = torch.clamp(torch.div(by - 1, 2, rounding_mode="floor"), 0, tiles - 1)
    y1 = torch.clamp(torch.div(by - 1, 2, rounding_mode="floor") + 1, 0, tiles - 1)
    x0 = torch.clamp(torch.div(bx - 1, 2, rounding_mode="floor"), 0, tiles - 1)
    x1 = torch.clamp(torch.div(bx - 1, 2, rounding_mode="floor") + 1, 0, tiles - 1)
    v00 = lut[y0[:, None], x0[None, :], xi].to(dtype)
    v01 = lut[y0[:, None], x1[None, :], xi].to(dtype)
    v10 = lut[y1[:, None], x0[None, :], xi].to(dtype)
    v11 = lut[y1[:, None], x1[None, :], xi].to(dtype)

    yy = torch.arange(h, dtype=dtype, device=dev) / th - 0.5
    xx = torch.arange(w, dtype=dtype, device=dev) / tw - 0.5
    fy2 = (yy - torch.floor(yy))[:, None]
    fx2 = (xx - torch.floor(xx))[None, :]
    out = (v00 * (1 - fy2) * (1 - fx2) + v01 * (1 - fy2) * fx2
           + v10 * fy2 * (1 - fx2) + v11 * fy2 * fx2)
    return out.to(dtype)
