"""Whitened IMU preintegration factor (torch twin of
mobile_slam_tpu.factors.imu_factor)."""

from __future__ import annotations

import torch

from mobile_slam_tpu_torch.imu import preintegration as preint
from mobile_slam_tpu_torch.utils.linalg import cholesky_or_nan


def sqrt_info_from_cov(cov: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Upper-triangular W with Wᵀ W = cov⁻¹, computed on the diagonally
    equilibrated covariance (batched)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=eps))
    c = cov / (d[..., :, None] * d[..., None, :])
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    c = c + eps * eye
    c_inv = torch.cholesky_solve(eye.expand(c.shape), cholesky_or_nan(c))
    c_inv = 0.5 * (c_inv + c_inv.transpose(-1, -2))
    w = cholesky_or_nan(c_inv).transpose(-1, -2)
    return w / d[..., None, :]


def whitened_residual(pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j,
                      bg_j, gravity, sqrt_info) -> torch.Tensor:
    r = preint.evaluate(pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j,
                        bg_j, gravity)
    return torch.einsum("...ij,...j->...i", sqrt_info, r)
