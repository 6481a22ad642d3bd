"""Fixed-shape state of the sliding-window estimator (torch twin of
mobile_slam_tpu.models.state): ``WindowState`` (11 keyframe slots with
their preintegration and raw IMU buffers) and ``FeatureTable`` (a padded
(F, 11) observation grid)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.imu.preintegration import (Preintegration,
                                                      identity_preintegration)


class WindowState(NamedTuple):
    ts: torch.Tensor        # (11,)
    p: torch.Tensor         # (11, 3)
    q: torch.Tensor         # (11, 4) wxyz
    v: torch.Tensor         # (11, 3)
    ba: torch.Tensor        # (11, 3)
    bg: torch.Tensor        # (11, 3)
    pre: Preintegration     # interval (slot-1, slot] stored at slot
    imu_dt: torch.Tensor    # (11, M)
    imu_acc: torch.Tensor   # (11, M, 3)
    imu_gyr: torch.Tensor   # (11, M, 3)
    imu_cnt: torch.Tensor   # (11,) int32
    imu_acc0: torch.Tensor  # (11, 3)
    imu_gyr0: torch.Tensor  # (11, 3)


class FeatureTable(NamedTuple):
    fid: torch.Tensor         # (F,) int32, -1 = free
    start: torch.Tensor       # (F,) int32
    obs: torch.Tensor         # (F, 11, 3)
    uv: torch.Tensor          # (F, 11, 2)
    vel: torch.Tensor         # (F, 11, 2)
    mask: torch.Tensor        # (F, 11) bool
    depth: torch.Tensor       # (F,) -1 = unset
    solve_flag: torch.Tensor  # (F,) int32: 0 unsolved, 1 solved, 2 failed

    @property
    def used_num(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1).to(torch.int32)

    def slot_used(self) -> torch.Tensor:
        return self.fid >= 0


def init_window(max_imu: int, dtype=torch.float32, *, device) -> WindowState:
    W = NUM_SLOTS
    kw = dict(dtype=dtype, device=device)
    zeros3 = torch.zeros((W, 3), **kw)
    pre = identity_preintegration(torch.zeros((W, 3), **kw), torch.zeros((W, 3), **kw))
    return WindowState(
        ts=torch.zeros((W,), **kw), p=zeros3, q=torch.tensor(
            [1.0, 0.0, 0.0, 0.0], **kw).repeat(W, 1),
        v=zeros3, ba=zeros3, bg=zeros3, pre=pre,
        imu_dt=torch.zeros((W, max_imu), **kw),
        imu_acc=torch.zeros((W, max_imu, 3), **kw),
        imu_gyr=torch.zeros((W, max_imu, 3), **kw),
        imu_cnt=torch.zeros((W,), dtype=torch.int32, device=device),
        imu_acc0=zeros3, imu_gyr0=zeros3,
    )


def init_feature_table(max_features: int, dtype=torch.float32, *,
                       device) -> FeatureTable:
    F, W = max_features, NUM_SLOTS
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return FeatureTable(
        fid=torch.full((F,), -1, **i32), start=torch.zeros((F,), **i32),
        obs=torch.zeros((F, W, 3), **kw), uv=torch.zeros((F, W, 2), **kw),
        vel=torch.zeros((F, W, 2), **kw),
        mask=torch.zeros((F, W), dtype=torch.bool, device=device),
        depth=torch.full((F,), -1.0, **kw), solve_flag=torch.zeros((F,), **i32),
    )


def eligible_mask(table: FeatureTable, window_size: int = NUM_SLOTS - 1) -> torch.Tensor:
    """used_num >= 2 and start < WINDOW_SIZE - 2 (feature_manager.cpp:20)."""
    return (table.fid >= 0) & (table.used_num >= 2) & (table.start < window_size - 2)
