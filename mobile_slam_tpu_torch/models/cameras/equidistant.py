"""Kannala-Brandt equidistant fisheye camera (torch twin of
mobile_slam_tpu.models.cameras.equidistant).

r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹; lift by fixed-iteration Newton.
params layout (shape (8,)): [mu, mv, u0, v0, k2, k3, k4, k5]
"""

from __future__ import annotations

import torch

NEWTON_ITERS = 10


def _r_theta(params: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    k2, k3, k4, k5 = params[4], params[5], params[6], params[7]
    t2 = theta * theta
    return theta * (1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5))))


def _r_prime(params: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    k2, k3, k4, k5 = params[4], params[5], params[6], params[7]
    t2 = theta * theta
    return 1.0 + t2 * (3.0 * k2 + t2 * (5.0 * k3 + t2 * (7.0 * k4 + t2 * 9.0 * k5)))


def project(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(pts, dim=-1)
    theta = torch.arccos(torch.clamp(pts[..., 2] / norm, -1.0, 1.0))
    phi = torch.atan2(pts[..., 1], pts[..., 0])
    r = _r_theta(params, theta)
    mu, mv, u0, v0 = params[0], params[1], params[2], params[3]
    return torch.stack([mu * r * torch.cos(phi) + u0,
                        mv * r * torch.sin(phi) + v0], dim=-1)


def lift(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit rays on the sphere."""
    mu, mv, u0, v0 = params[0], params[1], params[2], params[3]
    p_u = torch.stack([(uv[..., 0] - u0) / mu, (uv[..., 1] - v0) / mv], dim=-1)
    phi = torch.atan2(p_u[..., 1], p_u[..., 0])
    r_obs = torch.linalg.vector_norm(p_u, dim=-1)
    theta = r_obs
    for _ in range(NEWTON_ITERS):
        f = _r_theta(params, theta) - r_obs
        fp = _r_prime(params, theta)
        theta = theta - f / torch.where(torch.abs(fp) < 1e-12, 1e-12, fp)
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def lift_unit_plane(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel(s) -> ray normalized to z=1 (the 7-vector convention the
    estimator consumes)."""
    ray = lift(params, uv)
    return ray / ray[..., 2:3]


def make_params(mu, mv, u0, v0, k2=0.0, k3=0.0, k4=0.0, k5=0.0,
                dtype=torch.float32, *, device) -> torch.Tensor:
    return torch.tensor([mu, mv, u0, v0, k2, k3, k4, k5], dtype=dtype,
                        device=device)
