"""Example configurations and a deterministic example state.

``tiny_config`` is the small pinhole configuration of the parity tests,
``production_config`` the bench's shapes at 3 LM iterations, and
``make_example_state`` a populated estimator state and one frame input
built without the simulator or the image frontend. ``bench_config`` is the image-path configuration of the repo's bench
(``bench.py:make_cfg``): TUM-VI-like Kannala-Brandt fisheye at 512x512,
160 tracker slots, 384 landmark slots, 16 IMU samples per interval and 2
LM iterations. ``bench_sim_config`` is its synthetic sequence (seed 7, 900
landmarks, 20 fps camera, 200 Hz IMU, noise and biases).
"""

from __future__ import annotations

import numpy as np
import torch

from mobile_slam_tpu_torch.config import (NUM_SLOTS, CameraConfig, EstimatorConfig,
                                    TrackerConfig, VIOConfig)
from mobile_slam_tpu_torch.eval.simulation import SimConfig

R_IC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
W = NUM_SLOTS


def tiny_config(max_features: int = 64, max_imu: int = 8,
                max_points: int = 32, num_iterations: int = 2) -> VIOConfig:
    cam = CameraConfig(
        model_type="PINHOLE", width=64, height=64,
        focal_length=60.0, fx=60.0, fy=60.0, cx=32.0, cy=32.0,
    )
    return VIOConfig(
        camera=cam,
        tracker=TrackerConfig(max_cnt=24, min_dist=8, max_points=max_points,
                              lk_pyramid_levels=2),
        estimator=EstimatorConfig(
            max_features=max_features, max_imu_per_interval=max_imu,
            num_iterations=num_iterations,
        ),
    )


def production_config() -> VIOConfig:
    """The bench's shapes (``bench_config``) at 3 LM iterations, the
    reference's multichip dry-run configuration."""
    import dataclasses

    cfg = bench_config()
    return dataclasses.replace(cfg, estimator=dataclasses.replace(cfg.estimator,
                                                                  num_iterations=3))


def make_example_state(cfg: VIOConfig, params, dtype=torch.float32,
                       seed: int = 0, device=None):
    """A NON_LINEAR-phase estimator state and one FrameInput, consistent
    enough for the solver to run: the window on a small arc at constant
    velocity, up to 48 landmarks tracked in every slot, the IMU buffers of
    that motion. ``params`` (engine/estimator.make_params) lives on
    ``device``, the card unless given."""
    from mobile_slam_tpu_torch.engine import estimator as est

    kw = dict(dtype=dtype, device="cuda" if device is None else device)
    i32 = dict(dtype=torch.int32, device=kw["device"])
    rng = np.random.default_rng(seed)
    state = est.init_state(cfg, params, dtype)
    g_norm = float(cfg.estimator.g_norm)
    F, m, k = cfg.estimator.max_features, cfg.estimator.max_imu_per_interval, cfg.tracker.max_points

    dt_f = 0.05
    ts = np.arange(W) * dt_f
    p = np.stack([0.3 * ts, 0.05 * np.sin(2 * ts), 0.02 * ts], -1)
    v = np.gradient(p, ts, axis=0)
    n_feat = min(F, 48)
    lm = np.stack([rng.uniform(-1.5, 1.5, n_feat), rng.uniform(-1.0, 1.0, n_feat),
                   rng.uniform(2.5, 6.0, n_feat)], -1)
    rel = lm[:, None, :] - p[None, :, :]                      # (n_feat, W, 3)
    obs = np.zeros((F, W, 3))
    obs[:n_feat] = np.concatenate([rel[..., :2] / rel[..., 2:], np.ones((n_feat, W, 1))], -1)
    mask = np.zeros((F, W), bool)
    mask[:n_feat] = True
    fid = np.full(F, -1, np.int32)
    fid[:n_feat] = np.arange(n_feat)
    table = state.table._replace(
        fid=torch.as_tensor(fid, **i32), start=torch.zeros(F, **i32),
        obs=torch.as_tensor(obs, **kw), mask=torch.as_tensor(mask, device=kw["device"]))

    # The IMU buffers of that motion (no rotation), 5 samples per interval.
    n_s = min(m, 5)
    acc_meas = np.gradient(v, ts, axis=0) + [0, 0, g_norm]
    imu_dt = np.zeros((W, m))
    imu_acc = np.zeros((W, m, 3))
    imu_cnt = np.zeros(W, np.int32)
    imu_dt[1:, :n_s] = dt_f / n_s
    imu_acc[1:, :n_s] = acc_meas[1:, None, :]
    imu_cnt[1:] = n_s
    window = state.window._replace(
        ts=torch.as_tensor(ts, **kw), p=torch.as_tensor(p, **kw),
        q=torch.as_tensor(np.tile([1.0, 0, 0, 0], (W, 1)), **kw),
        v=torch.as_tensor(v, **kw), imu_dt=torch.as_tensor(imu_dt, **kw),
        imu_acc=torch.as_tensor(imu_acc, **kw), imu_gyr=torch.zeros((W, m, 3), **kw),
        imu_cnt=torch.as_tensor(imu_cnt, **i32), imu_acc0=torch.as_tensor(acc_meas, **kw))
    window = est.repropagate_window(window, torch.zeros(3, **kw), torch.zeros(3, **kw),
                                    params.noise)
    state = state._replace(
        window=window, table=table, frame_count=torch.tensor(W - 1, **i32),
        first_imu_seen=torch.tensor(True, device=kw["device"]),
        prev_acc=torch.as_tensor(acc_meas[-1], **kw), prev_gyr=torch.zeros(3, **kw))

    # One new frame's input.
    n_in = min(n_feat, k)
    ids = np.full(k, -1, np.int32)
    ids[:n_in] = np.arange(n_in)
    rel_in = lm[:n_in] - (p[-1] + v[-1] * dt_f)
    obs_in = np.zeros((k, 3))
    obs_in[:n_in] = np.concatenate([rel_in[:, :2] / rel_in[:, 2:], np.ones((n_in, 1))], -1)
    inp = est.FrameInput(
        ts=torch.tensor(ts[-1] + dt_f, **kw), ids=torch.as_tensor(ids, **i32),
        obs=torch.as_tensor(obs_in, **kw), uv=torch.zeros((k, 2), **kw),
        vel=torch.zeros((k, 2), **kw),
        valid=torch.as_tensor(np.arange(k) < n_in, device=kw["device"]),
        imu_dt=torch.as_tensor(imu_dt[1], **kw), imu_acc=torch.as_tensor(imu_acc[1], **kw),
        imu_gyr=torch.zeros((m, 3), **kw), imu_cnt=torch.tensor(int(imu_cnt[1]), **i32))
    return state, inp


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
