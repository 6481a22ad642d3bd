"""Shi-Tomasi corners with grid-cell suppression (torch twin of
mobile_slam_tpu.ops.corners)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mobile_slam_tpu_torch.ops import image as im


def _max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, SAME (XLA padding: lo=(k-1)//2), as two
    separable 1-D passes."""
    lo, hi = (k - 1) // 2, k // 2
    y = F.pad(x[None, None], (0, 0, lo, hi), value=float("-inf"))
    y = F.max_pool2d(y, (k, 1), stride=1)
    y = F.pad(y, (lo, hi, 0, 0), value=float("-inf"))
    return F.max_pool2d(y, (1, k), stride=1)[0, 0]


def min_eig_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """cornerMinEigenVal: smaller eigenvalue of the box-summed Sobel
    structure tensor."""
    ix, iy = im.sobel_derivatives(img)
    sxx = im.box_filter(ix * ix, block_size)
    sxy = im.box_filter(ix * iy, block_size)
    syy = im.box_filter(iy * iy, block_size)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))
    return 0.5 * (tr - disc)


def occupancy_suppression(response: torch.Tensor, pts: torch.Tensor,
                          active: torch.Tensor, min_dist: int) -> torch.Tensor:
    """Zero the response within ~min_dist of the active points."""
    h, w = response.shape
    xi = torch.clamp(torch.round(pts[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(pts[:, 1]).long(), 0, h - 1)
    flat = torch.where(active, yi * w + xi, h * w)      # h*w = dropped
    occ = torch.zeros(h * w + 1, dtype=response.dtype, device=response.device)
    occ = occ.index_fill(0, flat, 1.0)
    occ = _max_pool_same(occ[:h * w].reshape(h, w), 2 * min_dist + 1)
    return torch.where(occ > 0, torch.zeros_like(response), response)


def detect_grid(response: torch.Tensor, cell: int, max_new: int,
                quality_level: float = 0.01, border: int = 8):
    """Best corner per NMS neighbourhood, then the global top-``max_new``
    (ties to the lower index, as lax.top_k). Returns (pts (max_new, 2),
    valid (max_new,)); invalid slots hold (0, 0)."""
    h, w = response.shape
    dev, dtype = response.device, response.dtype
    mask = torch.zeros_like(response)
    mask[border:h - border, border:w - border] = 1.0
    r = response * mask
    thresh = quality_level * torch.max(r)
    r = torch.where(r >= thresh, r, torch.zeros_like(r))

    iota = (torch.arange(h, device=dev)[:, None] * w
            + torch.arange(w, device=dev)[None, :]).to(dtype)
    r_j = torch.where(r > 0, r * (1.0 + 1e-6) + iota * 1e-7, torch.zeros_like(r))
    local_max = _max_pool_same(r_j, cell + 1)
    is_peak = (r_j > 0) & (r_j >= local_max)
    peaks = torch.where(is_peak, r_j, torch.zeros_like(r_j))

    b = 1
    while b * 2 <= min(cell // 2 + 1, 16):
        b *= 2
    hp = -(-h // b) * b
    wp = -(-w // b) * b
    if (hp, wp) != (h, w):
        peaks = F.pad(peaks, (0, wp - w, 0, hp - h))
    hb, wb = hp // b, wp // b
    blk = peaks.reshape(hb, b, wb, b).permute(0, 2, 1, 3).reshape(hb, wb, b * b)
    off = torch.argmax(blk, dim=-1)
    vals = torch.gather(blk, -1, off[..., None])[..., 0]
    ys = torch.arange(hb, device=dev)[:, None] * b + torch.div(off, b, rounding_mode="floor")
    xs = torch.arange(wb, device=dev)[None, :] * b + off % b

    top_val, top_idx = torch.sort(vals.reshape(-1), descending=True, stable=True)
    top_val, top_idx = top_val[:max_new], top_idx[:max_new]
    pts = torch.stack([xs.reshape(-1)[top_idx].to(dtype),
                       ys.reshape(-1)[top_idx].to(dtype)], dim=-1)
    valid = top_val > 0
    pts = torch.where(valid[:, None], pts, torch.zeros_like(pts))
    return pts, valid
