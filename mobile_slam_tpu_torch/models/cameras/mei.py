"""Mei unified catadioptric camera (torch twin of
mobile_slam_tpu.models.cameras.mei): projection through the unit sphere
with mirror parameter xi, then radial-tangential distortion; lift by a
fixed-point undistortion and the inverse of the sphere map.

params layout (shape (9,)): [gamma1, gamma2, u0, v0, k1, k2, p1, p2, xi]
"""

from __future__ import annotations

import torch

N_PARAMS = 9
LIFT_ITERS = 20


def _distortion(params: torch.Tensor, p_u: torch.Tensor) -> torch.Tensor:
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
    z = pts[..., 2] + params[8] * torch.linalg.vector_norm(pts, dim=-1)
    p_u = pts[..., 0:2] / z[..., None]
    p_d = p_u + _distortion(params, p_u)
    g1, g2, u0, v0 = params[0], params[1], params[2], params[3]
    return torch.stack([g1 * p_d[..., 0] + u0, g2 * p_d[..., 1] + v0], dim=-1)


def lift(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> projective rays (..., 3) (the general xi branch)."""
    g1, g2, u0, v0, xi = params[0], params[1], params[2], params[3], params[8]
    p_d = torch.stack([(uv[..., 0] - u0) / g1, (uv[..., 1] - v0) / g2], dim=-1)
    p_u = p_d - _distortion(params, p_d)
    for _ in range(LIFT_ITERS):
        p_u = p_d - _distortion(params, p_u)
    rho2 = torch.sum(p_u * p_u, dim=-1)
    z = 1.0 - xi * (rho2 + 1.0) / (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2))
    return torch.cat([p_u, z[..., None]], dim=-1)


def lift_sphere(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit rays on the sphere."""
    ray = lift(params, uv)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def make_params(gamma1, gamma2, u0, v0, k1=0.0, k2=0.0, p1=0.0, p2=0.0, xi=1.0,
                dtype=torch.float32, *, device) -> torch.Tensor:
    return torch.tensor([gamma1, gamma2, u0, v0, k1, k2, p1, p2, xi],
                        dtype=dtype, device=device)
