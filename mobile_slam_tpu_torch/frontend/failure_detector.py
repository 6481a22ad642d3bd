"""Failure detector — threshold checks over the estimator state (torch twin
of mobile_slam_tpu.frontend.failure_detector, with the original VINS-Mono
thresholds of ``frontend::FailureDetector``).

As in the reference, the engine's active failure handling lives inline
(the divergence and scale-runaway gates of engine/vio_engine.py); this
module offers the same checks standalone. Every field of the report is a
tensor on the state's device: nothing is read on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.models.state import FeatureTable, WindowState
from mobile_slam_tpu_torch.utils import rotations as rot

W = NUM_SLOTS

BA_LIMIT = 2.5      # |accel bias|
BG_LIMIT = 1.0      # |gyro bias|
DP_LIMIT = 5.0      # position jump between updates (m)
DZ_LIMIT = 1.0      # vertical jump (m)
DROT_LIMIT_DEG = 50.0  # rotation jump


class FailureReport(NamedTuple):
    failed: torch.Tensor
    big_acc_bias: torch.Tensor
    big_gyr_bias: torch.Tensor
    big_translation: torch.Tensor
    big_z: torch.Tensor
    big_rotation: torch.Tensor
    tracked_features: torch.Tensor


def detect_failure(window: WindowState, table: FeatureTable, last_p: torch.Tensor,
                   last_q: torch.Tensor) -> FailureReport:
    """Every check of FailureDetector::detectFailure on the window tip
    against the last pose (``last_p`` (3,), ``last_q`` (4,))."""
    tip = W - 1
    ba = torch.linalg.vector_norm(window.ba[tip])
    bg = torch.linalg.vector_norm(window.bg[tip])
    dp = window.p[tip] - last_p
    big_t = torch.linalg.vector_norm(dp) > DP_LIMIT
    big_z = torch.abs(dp[2]) > DZ_LIMIT
    dtheta = rot.quat_boxminus(window.q[tip], last_q)
    big_r = torch.linalg.vector_norm(dtheta) > math.radians(DROT_LIMIT_DEG)
    big_ba, big_bg = ba > BA_LIMIT, bg > BG_LIMIT
    return FailureReport(
        failed=big_ba | big_bg | big_t | big_z | big_r,
        big_acc_bias=big_ba, big_gyr_bias=big_bg, big_translation=big_t,
        big_z=big_z, big_rotation=big_r,
        tracked_features=torch.sum(table.fid >= 0))
