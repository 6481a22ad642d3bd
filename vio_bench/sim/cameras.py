"""Camera models of the benchmark's simulator and reference, in torch
(float64 on any device): pinhole with radial-tangential distortion and the
Kannala-Brandt equidistant fisheye, the formulas of the port's
``models/cameras/{pinhole,equidistant}.py``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PINHOLE = "PINHOLE"
KANNALA_BRANDT = "KANNALA_BRANDT"
LIFT_ITERS = {PINHOLE: 20, KANNALA_BRANDT: 10}


@dataclasses.dataclass(frozen=True)
class Camera:
    model: str
    width: int
    height: int
    params: tuple           # (fx, fy, cx, cy, d0, d1, d2, d3)

    @classmethod
    def from_config(cls, cam: dict) -> "Camera":
        return cls(cam["model_type"], int(cam["width"]), int(cam["height"]),
                   (cam["fx"], cam["fy"], cam["cx"], cam["cy"], *cam["dist"]))

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2)."""
        fx, fy, cx, cy, d0, d1, d2, d3 = self.params
        if self.model == PINHOLE:
            x, y = pts[..., 0] / pts[..., 2], pts[..., 1] / pts[..., 2]
            dx, dy = _radtan(x, y, d0, d1, d2, d3)
            return torch.stack([fx * (x + dx) + cx, fy * (y + dy) + cy], dim=-1)
        norm = torch.linalg.vector_norm(pts, dim=-1)
        theta = torch.arccos(torch.clamp(pts[..., 2] / norm, -1.0, 1.0))
        phi = torch.atan2(pts[..., 1], pts[..., 0])
        r = _r_theta(theta, d0, d1, d2, d3)
        return torch.stack([fx * r * torch.cos(phi) + cx, fy * r * torch.sin(phi) + cy], dim=-1)

    def lift(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> rays (..., 3) (unit z for the pinhole, unit
        length for the fisheye)."""
        fx, fy, cx, cy, d0, d1, d2, d3 = self.params
        x, y = (uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy
        if self.model == PINHOLE:
            xu, yu = x, y
            for _ in range(LIFT_ITERS[PINHOLE]):
                dx, dy = _radtan(xu, yu, d0, d1, d2, d3)
                xu, yu = x - dx, y - dy
            return torch.stack([xu, yu, torch.ones_like(xu)], dim=-1)
        phi = torch.atan2(y, x)
        r_obs = torch.sqrt(x * x + y * y)
        theta = r_obs
        for _ in range(LIFT_ITERS[KANNALA_BRANDT]):
            f = _r_theta(theta, d0, d1, d2, d3) - r_obs
            t2 = theta * theta
            fp = 1.0 + t2 * (3.0 * d0 + t2 * (5.0 * d1 + t2 * (7.0 * d2 + t2 * 9.0 * d3)))
            theta = theta - f / torch.where(torch.abs(fp) < 1e-12, 1e-12, fp)
        st = torch.sin(theta)
        return torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)

    def project_np(self, pts: np.ndarray) -> np.ndarray:
        return self.project(torch.as_tensor(pts, dtype=torch.float64)).numpy()


def _radtan(x, y, k1, k2, p1, p2):
    x2, y2, xy = x * x, y * y, x * y
    rho2 = x2 + y2
    rad = k1 * rho2 + k2 * rho2 * rho2
    return (x * rad + 2.0 * p1 * xy + p2 * (rho2 + 2.0 * x2),
            y * rad + 2.0 * p2 * xy + p1 * (rho2 + 2.0 * y2))


def _r_theta(theta, k2, k3, k4, k5):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5))))
