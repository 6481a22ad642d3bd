"""Scaramuzza omnidirectional polynomial camera (torch twin of
mobile_slam_tpu.models.cameras.scaramuzza): lift by the forward
polynomial rho -> z, project by the inverse polynomial theta -> rho, both
with the affine sensor-misalignment transform (c, d, e);
``fit_inverse_poly`` is the host-side least-squares inverse fit (numpy,
float64).

params: dict of tensors
    poly:      (P,)  forward polynomial coefficients (rho -> z)
    inv_poly:  (Q,)  inverse polynomial coefficients (theta -> rho)
    center:    (2,)  image center (cx, cy)
    affine:    (3,)  (c, d, e)
"""

from __future__ import annotations

import numpy as np
import torch

POLY_SIZE = 5
INV_POLY_SIZE = 12


def _polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[i] * x^i in Horner form."""
    acc = torch.zeros_like(x)
    for i in range(coeffs.shape[0] - 1, -1, -1):
        acc = acc * x + coeffs[i]
    return acc


def lift(params: dict, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> projective rays (xc, yc, -poly(rho)) (..., 3)."""
    cx, cy = params["center"][0], params["center"][1]
    c, d, e = params["affine"][0], params["affine"][1], params["affine"][2]
    xc = uv[..., 0] - cx
    yc = uv[..., 1] - cy
    inv_scale = 1.0 / (c - d * e)
    xa = inv_scale * (xc - d * yc)
    ya = inv_scale * (-e * xc + c * yc)
    z = _polyval(params["poly"], torch.sqrt(xa * xa + ya * ya))
    return torch.stack([xc, yc, -z], dim=-1)


def project(params: dict, pts: torch.Tensor) -> torch.Tensor:
    """3D points (..., 3) -> pixels (..., 2)."""
    norm = torch.sqrt(pts[..., 0] ** 2 + pts[..., 1] ** 2)
    theta = torch.atan2(-pts[..., 2], norm)
    rho = _polyval(params["inv_poly"], theta)
    inv_norm = 1.0 / torch.where(norm < 1e-12, torch.full_like(norm, 1e-12), norm)
    xn = pts[..., 0] * inv_norm * rho
    yn = pts[..., 1] * inv_norm * rho
    c, d, e = params["affine"][0], params["affine"][1], params["affine"][2]
    cx, cy = params["center"][0], params["center"][1]
    return torch.stack([xn * c + yn * d + cx, xn * e + yn + cy], dim=-1)


def fit_inverse_poly(poly: np.ndarray, max_rho: float,
                     order: int = INV_POLY_SIZE - 1) -> np.ndarray:
    """Least-squares fit of rho(theta) from the forward polynomial."""
    rho = np.linspace(1e-4, max_rho, 1000)
    z = np.polyval(poly[::-1], rho)
    theta = np.arctan2(z, rho)
    A = np.stack([theta ** i for i in range(order + 1)], axis=-1)
    coeffs, *_ = np.linalg.lstsq(A, rho, rcond=None)
    return coeffs


def make_params(poly, inv_poly, center, affine=(1.0, 0.0, 0.0),
                dtype=torch.float32, *, device) -> dict:
    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=device)

    return {"poly": t(poly), "inv_poly": t(inv_poly), "center": t(center),
            "affine": t(affine)}
