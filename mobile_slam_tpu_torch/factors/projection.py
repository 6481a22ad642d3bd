"""Visual reprojection factor (torch twin of
mobile_slam_tpu.factors.projection): inverse depth in the anchor frame,
transported through body/extrinsic poses, compared with the observed unit-z
ray and whitened by focal/1.5."""

from __future__ import annotations

import torch

from mobile_slam_tpu_torch.utils import rotations as rot


def residual(ray_i, ray_j, inv_dep, p_i, q_i, p_j, q_j, t_ic, q_ic, sqrt_info,
             vel_i=None, vel_j=None, td=None) -> torch.Tensor:
    if td is not None:
        ray_i = ray_i - td * torch.cat([vel_i, torch.zeros_like(vel_i[..., :1])], dim=-1)
        ray_j = ray_j - td * torch.cat([vel_j, torch.zeros_like(vel_j[..., :1])], dim=-1)
    pts_cam_i = ray_i / inv_dep[..., None]
    pts_imu_i = rot.quat_rotate(q_ic, pts_cam_i) + t_ic
    pts_w = rot.quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = rot.quat_rotate(rot.quat_conjugate(q_j), pts_w - p_j)
    pts_cam_j = rot.quat_rotate(rot.quat_conjugate(q_ic), pts_imu_j - t_ic)
    dep_j = pts_cam_j[..., 2]
    small = torch.where(dep_j < 0, torch.full_like(dep_j, -1e-8),
                        torch.full_like(dep_j, 1e-8))
    safe_dep = torch.where(torch.abs(dep_j) < 1e-8, small, dep_j)
    return sqrt_info * (pts_cam_j[..., 0:2] / safe_dep[..., None] - ray_j[..., 0:2])


def cauchy_weight(r: torch.Tensor, scale=1.0) -> torch.Tensor:
    """IRLS weight sqrt(ρ'(s)) of CauchyLoss(scale), s = ||r||²."""
    s = torch.sum(r * r, dim=-1)
    return torch.sqrt(1.0 / (1.0 + s / (scale * scale)))
