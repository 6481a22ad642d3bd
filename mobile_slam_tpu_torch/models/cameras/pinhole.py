"""Pinhole camera with radial-tangential distortion (torch twin of
mobile_slam_tpu.models.cameras.pinhole).

params layout (shape (8,)): [fx, fy, cx, cy, k1, k2, p1, p2]
"""

from __future__ import annotations

import torch

LIFT_ITERS = 20


def distortion(params: torch.Tensor, p_u: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
    x, y = p_u[..., 0], p_u[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    rho2 = x2 + y2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = x * rad + 2.0 * p1 * xy + p2 * (rho2 + 2.0 * x2)
    dy = y * rad + 2.0 * p2 * xy + p1 * (rho2 + 2.0 * y2)
    return torch.stack([dx, dy], dim=-1)


def project(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """3D points (..., 3) -> pixels (..., 2)."""
    p_u = pts[..., 0:2] / pts[..., 2:3]
    p_d = p_u + distortion(params, p_u)
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return torch.stack([fx * p_d[..., 0] + cx, fy * p_d[..., 1] + cy], dim=-1)


def lift(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-z rays (..., 3), fixed-point undistortion."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    p_d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    p_u = p_d
    for _ in range(LIFT_ITERS):
        p_u = p_d - distortion(params, p_u)
    return torch.cat([p_u, torch.ones_like(p_u[..., :1])], dim=-1)


def make_params(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                dtype=torch.float32, *, device) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy, k1, k2, p1, p2], dtype=dtype,
                        device=device)
