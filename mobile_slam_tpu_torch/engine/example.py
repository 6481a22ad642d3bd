"""Example configurations: the bench sequence the port's smoke run drives.

``bench_config`` is the image-path configuration of the repo's bench
(``bench.py:make_cfg``): TUM-VI-like Kannala-Brandt fisheye at 512x512,
160 tracker slots, 384 landmark slots, 16 IMU samples per interval and 2
LM iterations. ``bench_sim_config`` is its synthetic sequence (seed 7, 900
landmarks, 20 fps camera, 200 Hz IMU, noise and biases).
"""

from __future__ import annotations

import numpy as np

from mobile_slam_tpu_torch.config import (CameraConfig, EstimatorConfig,
                                    TrackerConfig, VIOConfig)
from mobile_slam_tpu_torch.eval.simulation import SimConfig

R_IC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def bench_config() -> VIOConfig:
    cam = CameraConfig(
        model_type="KANNALA_BRANDT", width=512, height=512,
        focal_length=190.97847715128717,
        fx=190.97847715128717, fy=190.9733070521226,
        cx=254.93170605935475, cy=256.8974428996504,
        dist=(0.0034823894022493434, 0.0007150348452162257,
              -0.0020532361418706202, 0.00020293673591811182),
        r_ic=tuple(R_IC.reshape(-1)), t_ic=(0.045, 0.073, -0.044),
    )
    return VIOConfig(
        camera=cam,
        tracker=TrackerConfig(max_cnt=150, min_dist=20, max_points=160,
                              fisheye=True),
        estimator=EstimatorConfig(
            max_features=384, max_imu_per_interval=16, num_iterations=2,
            acc_n=0.04, gyr_n=0.004, acc_w=4e-4, gyr_w=2e-5,
        ),
    )


def bench_sim_config(duration: float) -> SimConfig:
    return SimConfig(
        duration=duration, cam_rate=20.0, imu_rate=200.0, num_landmarks=900,
        max_features=150, acc_noise=0.02, gyr_noise=0.002, pixel_noise=0.25,
        acc_bias=(0.01, -0.005, 0.015), gyr_bias=(0.001, -0.0005, 0.0008),
        seed=7,
    )
