"""Image primitives (torch twin of mobile_slam_tpu.ops.image).

Bilinear sampling, separable Gaussian pyrDown, Scharr/Sobel derivatives and
box sums. Filters are shift-and-add over shifted slices (cross-correlation,
reflect-101 borders as cv2's default), so no convolution path — and no TF32
rounding — is involved. Images are (H, W) float tensors on a 0..255 scale;
points are (..., 2) in (x, y) pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation at float (x, y), border-clamped."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _sep_filter(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2-D correlation with reflect-101 padding; kx/ky are
    sequences of Python floats."""
    h, w = img.shape
    rx = len(kx) // 2
    ry = len(ky) // 2
    p = F.pad(img[None, None], (rx, rx, ry, ry), mode="reflect")[0, 0]
    acc = torch.zeros((h, w + 2 * rx), dtype=img.dtype, device=img.device)
    for j, k in enumerate(ky):
        acc = acc + k * p[j:j + h, :]
    out = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for i, k in enumerate(kx):
        out = out + k * acc[:, i:i + w]
    return out


GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown: 5x5 Gaussian then 2x decimation. The level is
    contiguous (not a strided view of the filtered image), which is the
    layout the LK kernels read without a copy."""
    return _sep_filter(img, GAUSS5, GAUSS5)[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """levels+1 octaves, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_derivatives(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr 3x3 x/y derivatives scaled by 1/32 (calcScharrDeriv)."""
    d = (-1.0, 0.0, 1.0)
    s = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    return _sep_filter(img, d, s), _sep_filter(img, s, d)


def sobel_derivatives(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d = (-1.0, 0.0, 1.0)
    s = (1.0, 2.0, 1.0)
    return _sep_filter(img, d, s), _sep_filter(img, s, d)


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size box sum (not normalized), reflect-101 borders."""
    k = (1.0,) * size
    return _sep_filter(img, k, k)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample (the mobile app's preprocessing,
    web/js/app.js:337); an odd last row or column is dropped."""
    h2 = (img.shape[0] // 2) * 2
    w2 = (img.shape[1] // 2) * 2
    c = img[:h2, :w2]
    return 0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2])
