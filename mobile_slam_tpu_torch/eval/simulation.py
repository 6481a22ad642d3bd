"""Synthetic visual-inertial world generator (host-side, float64) — the
port's copy of mobile_slam_tpu.eval.simulation, with the camera calls
going through a mobile_slam_tpu_torch camera, so that a machine without
JAX can generate sequences.

Produces physically-consistent ground truth for testing and benchmarking the
estimator without real datasets: a smooth room-scale trajectory, IMU at
configurable rate (with biases + noise), box-room landmarks, and per-frame
feature observations through any of the camera models — the same data
contract the reference gets from TUM-VI/EuRoC replay
(src/utility/measurement_processor.cpp).

Also renders simple textured frames (Gaussian splats at feature locations)
so the full image frontend (pyramidal LK + Shi-Tomasi) can be exercised
end-to-end without dataset files.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _cam_call(fn, camera, x: np.ndarray) -> np.ndarray:
    """Apply a camera function to a float64 numpy batch."""
    t = torch.as_tensor(x, dtype=camera.dtype, device=camera.device)
    return fn(t).cpu().numpy()


def _quat_mul_np(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _quat_to_rot_np(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


@dataclasses.dataclass
class Trajectory:
    ts: np.ndarray      # (N,)
    p: np.ndarray       # (N, 3)
    q: np.ndarray       # (N, 4) wxyz body-to-world
    v: np.ndarray       # (N, 3)
    acc_body: np.ndarray  # (N, 3) ideal accelerometer (no bias/noise)
    gyr_body: np.ndarray  # (N, 3) ideal gyroscope


def make_trajectory(duration: float, rate: float, g_norm: float = 9.81007,
                    scale: float = 1.5, seed: int = 0,
                    excitation_warmup: float = 2.0) -> Trajectory:
    """Smooth room-scale figure trajectory with full 3-axis rotation.

    The first ``excitation_warmup`` seconds add a high-frequency wiggle —
    the deliberate calibration motion TUM-VI/EuRoC sequences start with,
    which visual-inertial initialization relies on for scale/bias
    observability."""
    n = int(duration * rate) + 1
    ts = np.arange(n) / rate
    w1 = 2 * np.pi / 9.0
    w2 = 2 * np.pi / 6.5
    p = np.stack([
        scale * np.sin(w1 * ts),
        scale * 0.8 * np.sin(w2 * ts + 0.7),
        0.35 * np.sin(2 * w1 * ts + 0.3),
    ], axis=-1)

    yaw = 0.55 * np.sin(w1 * ts + 0.4)
    pitch = 0.22 * np.sin(w2 * ts + 1.1)
    roll = 0.18 * np.sin(1.7 * w1 * ts + 2.0)

    if excitation_warmup > 0:
        # Smoothly-windowed wiggle: strong acceleration + rotation variation
        # with small net displacement.
        env = np.clip(1.0 - ts / excitation_warmup, 0.0, 1.0)
        env = env * env * (3 - 2 * env)  # smoothstep taper
        ww = 2 * np.pi * 1.6
        p = p + env[:, None] * np.stack([
            0.12 * np.sin(ww * ts),
            0.10 * np.sin(1.3 * ww * ts + 0.9),
            0.08 * np.sin(1.7 * ww * ts + 0.4),
        ], axis=-1)
        yaw = yaw + env * 0.25 * np.sin(ww * ts + 0.2)
        pitch = pitch + env * 0.18 * np.sin(1.2 * ww * ts + 1.3)
        roll = roll + env * 0.15 * np.sin(1.5 * ww * ts + 2.1)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    # ZYX composition.
    q = np.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], axis=-1)

    v = np.gradient(p, ts, axis=0)
    a_w = np.gradient(v, ts, axis=0)

    # Body rates from quaternion derivative: q̇ = 0.5 q ⊗ (0, ω_body).
    qdot = np.gradient(q, ts, axis=0)
    q_conj = q * np.asarray([1.0, -1, -1, -1])
    omega_quat = 2.0 * _quat_mul_np(q_conj, qdot)
    gyr_body = omega_quat[:, 1:4]

    g = np.asarray([0.0, 0.0, g_norm])
    R = _quat_to_rot_np(q)
    acc_body = np.einsum("nji,nj->ni", R, a_w + g)
    return Trajectory(ts=ts, p=p, q=q, v=v, acc_body=acc_body,
                      gyr_body=gyr_body)


def make_landmarks(num: int, seed: int = 1, room_half: float = 4.0,
                   min_sep: float = 0.30) -> np.ndarray:
    """Landmarks on the walls/floor/ceiling of a box room, with a minimum
    3D separation (greedy rejection) so rendered corner sprites rarely
    overlap — overlapping sprites create view-dependent 'ghost' corners at
    their intersections, which no real static scene produces at the density
    an unconstrained uniform draw does."""
    rng = np.random.default_rng(seed)
    n_try = num * 6
    face = rng.integers(0, 6, n_try)
    uvw = rng.uniform(-room_half, room_half, (n_try, 3))
    pts = uvw.copy()
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    pts[np.arange(n_try), axis] = sign * room_half
    pts[:, 2] = pts[:, 2] * 0.35 + 1.2  # compress height to room-ish
    pts[face % 3 == 2, 2] = np.where(sign[face % 3 == 2] > 0, 2.8, -0.4)

    from scipy.spatial import cKDTree

    kept: list[np.ndarray] = []
    for p in pts:
        if len(kept) >= num:
            break
        if kept:
            tree = cKDTree(np.asarray(kept))
            if tree.query(p)[0] < min_sep:
                continue
        kept.append(p)
    return np.asarray(kept)


@dataclasses.dataclass
class SimConfig:
    duration: float = 20.0
    cam_rate: float = 20.0
    imu_rate: float = 200.0
    num_landmarks: int = 600
    max_features: int = 120
    acc_noise: float = 0.0
    gyr_noise: float = 0.0
    acc_bias: tuple = (0.0, 0.0, 0.0)
    gyr_bias: tuple = (0.0, 0.0, 0.0)
    pixel_noise: float = 0.0
    g_norm: float = 9.81007
    seed: int = 0
    # Camera-IMU time offset (seconds): observations are SAMPLED from the
    # pose at cam_ts + offset but REPORTED at cam_ts (what a real rolling
    # pipeline does). Quantized to imu_rate steps. Ground-truth poses stay
    # at the reported stamps, so an estimator without td correction sees a
    # systematic reprojection bias.
    cam_time_offset: float = 0.0


@dataclasses.dataclass
class SimData:
    """Everything a test / benchmark needs."""

    cam_ts: np.ndarray            # (Nf,)
    gt_p: np.ndarray              # (Nf, 3) body positions at frame times
    gt_q: np.ndarray              # (Nf, 4)
    gt_v: np.ndarray              # (Nf, 3)
    imu_ts: np.ndarray            # (Ni,)
    imu_acc: np.ndarray           # (Ni, 3) with bias+noise
    imu_gyr: np.ndarray           # (Ni, 3)
    frames: list                  # per frame: dict(ids, rays, uv, vel)
    landmarks: np.ndarray         # (L, 3)
    gravity: np.ndarray           # (3,)


def simulate(cfg: SimConfig, camera, r_ic: np.ndarray, t_ic: np.ndarray) -> SimData:
    """Generate a full synthetic sequence through ``camera`` (a
    mobile_slam_tpu_torch camera)."""
    rng = np.random.default_rng(cfg.seed)
    traj = make_trajectory(cfg.duration, cfg.imu_rate, cfg.g_norm,
                           seed=cfg.seed)
    lm = make_landmarks(cfg.num_landmarks, cfg.seed + 1)

    imu_acc = (traj.acc_body + np.asarray(cfg.acc_bias)
               + rng.normal(size=traj.acc_body.shape) * cfg.acc_noise)
    imu_gyr = (traj.gyr_body + np.asarray(cfg.gyr_bias)
               + rng.normal(size=traj.gyr_body.shape) * cfg.gyr_noise)

    stride = int(round(cfg.imu_rate / cfg.cam_rate))
    cam_idx = np.arange(0, len(traj.ts), stride)
    cam_ts = traj.ts[cam_idx]

    R_wb = _quat_to_rot_np(traj.q[cam_idx])       # (Nf,3,3)
    p_wb = traj.p[cam_idx]
    # Observation poses: shifted by the camera-IMU time offset (reported
    # stamps stay cam_ts; see SimConfig.cam_time_offset).
    shift = int(round(cfg.cam_time_offset * cfg.imu_rate))
    obs_idx = np.clip(cam_idx + shift, 0, len(traj.ts) - 1)
    R_wb_o = _quat_to_rot_np(traj.q[obs_idx])
    p_wb_o = traj.p[obs_idx]
    R_wc = R_wb_o @ r_ic[None]
    t_wc = p_wb_o + np.einsum("nij,j->ni", R_wb_o, t_ic)

    # Project all landmarks into all frames (host, float64).
    pts_c = np.einsum("nji,lnj->lni", R_wc,
                      lm[:, None, :] - t_wc[None, :, :])     # (L, Nf, 3)
    depth = pts_c[..., 2]
    margin = 8.0
    w_img, h_img = camera.width, camera.height
    uv = _cam_call(camera.project, camera, pts_c.reshape(-1, 3)
                   ).reshape(pts_c.shape[0], -1, 2)
    visible = (
        (depth > 0.3) & (depth < 12.0)
        & (uv[..., 0] > margin) & (uv[..., 0] < w_img - margin)
        & (uv[..., 1] > margin) & (uv[..., 1] < h_img - margin)
    )

    if cfg.pixel_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * cfg.pixel_noise

    rays_all = _cam_call(camera.lift_normalized, camera, uv.reshape(-1, 2)
                         ).reshape(uv.shape[0], -1, 3)

    # Per-frame feature selection with track continuity.
    frames = []
    active: dict[int, int] = {}  # landmark id -> consecutive track count
    prev_norm: dict[int, np.ndarray] = {}
    prev_t: float | None = None
    for fi in range(len(cam_idx)):
        vis_ids = np.where(visible[:, fi])[0]
        keep = [i for i in active if visible[i, fi]]
        free = cfg.max_features - len(keep)
        fresh = [i for i in vis_ids if i not in active][:max(free, 0)]
        sel = np.asarray(keep + fresh, dtype=np.int64)
        active = {i: active.get(i, 0) + 1 for i in sel}

        rays = rays_all[sel, fi]
        uvs = uv[sel, fi]
        vel = np.zeros((len(sel), 2))
        if prev_t is not None:
            dt = cam_ts[fi] - prev_t
            for k, i in enumerate(sel):
                if i in prev_norm and dt > 0:
                    vel[k] = (rays[k, :2] - prev_norm[i]) / dt
        prev_norm = {i: rays[k, :2] for k, i in enumerate(sel)}
        prev_t = cam_ts[fi]
        frames.append(dict(ids=sel.astype(np.int32), rays=rays, uv=uvs, vel=vel))

    return SimData(
        cam_ts=cam_ts,
        gt_p=p_wb, gt_q=traj.q[cam_idx], gt_v=traj.v[cam_idx],
        imu_ts=traj.ts, imu_acc=imu_acc, imu_gyr=imu_gyr,
        frames=frames, landmarks=lm,
        gravity=np.asarray([0.0, 0.0, cfg.g_norm]),
    )


_RAY_CACHE: dict = {}


def _camera_ray_grid(camera) -> np.ndarray:
    """(H, W, 3) unit rays for every pixel (cached per camera geometry)."""
    key = (id(camera), camera.width, camera.height)
    if key not in _RAY_CACHE:
        h, w = camera.height, camera.width
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float64) + 0.5,
                             np.arange(h, dtype=np.float64) + 0.5)
        uv = np.stack([uu.ravel(), vv.ravel()], axis=-1)
        rays = _cam_call(camera.lift, camera, uv)
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        _RAY_CACHE[key] = rays.reshape(h, w, 3)
    return _RAY_CACHE[key]


def _render_walls(sim_data: SimData, fi: int, camera, r_ic, t_ic,
                  room_half: float = 4.0) -> np.ndarray:
    """Raycast the box room; smooth 3D procedural texture at the hit point."""
    rays_c = _camera_ray_grid(camera)
    R_wb = _quat_to_rot_np(sim_data.gt_q[fi])
    R_wc = R_wb @ r_ic
    t_wc = sim_data.gt_p[fi] + R_wb @ t_ic
    d = rays_c @ R_wc.T                      # (H, W, 3) world ray dirs
    h, w = d.shape[:2]
    o = t_wc

    # Closest positive intersection with the 6 box planes
    # (x=±L, y=±L, z=-0.4, z=2.8 — matching make_landmarks' room).
    t_best = np.full((h, w), np.inf)
    bounds = [(0, room_half), (0, -room_half), (1, room_half),
              (1, -room_half), (2, 2.8), (2, -0.4)]
    eps = 1e-9
    for axis, val in bounds:
        da = d[..., axis]
        t = (val - o[axis]) / np.where(np.abs(da) < eps, eps, da)
        ok = t > 0.05
        t_best = np.where(ok & (t < t_best), t, t_best)
    t_best = np.where(np.isfinite(t_best), t_best, 12.0)
    hit = o[None, None, :] + d * t_best[..., None]

    # Smooth multi-scale 3D texture (no sharp corners — the sprites are the
    # trackable structure).
    x, y, z = hit[..., 0], hit[..., 1], hit[..., 2]
    tex = (55.0
           + 16.0 * np.sin(2.1 * x + 0.7) * np.cos(1.7 * y + 0.3)
           + 10.0 * np.sin(3.3 * y + 1.9) * np.cos(2.7 * z + 1.1)
           + 7.0 * np.sin(4.9 * z + 0.5) * np.cos(3.9 * x + 2.3))
    return tex


def render_frame(sim_data: SimData, fi: int, camera, r_ic: np.ndarray,
                 t_ic: np.ndarray, margin: float = 8.0,
                 sprite: int = 7, seed: int = 3) -> np.ndarray:
    """Render a synthetic grayscale frame: geometrically-consistent corner
    sprites (2x2 checker patterns) splatted at every visible landmark's
    subpixel projection, over a low-texture background. Lets the full image
    frontend (CLAHE + LK + Shi-Tomasi) run end-to-end without dataset files.
    """
    rng = np.random.default_rng(seed)
    h_img, w_img = camera.height, camera.width
    # Geometrically-consistent background: raycast the box room and sample a
    # smooth procedural 3D texture at the hit point, so the backdrop moves
    # correctly with the camera (an image-fixed pattern would be tracked as
    # zero-motion poison) while giving CLAHE real content to equalize.
    img = _render_walls(sim_data, fi, camera, r_ic, t_ic)

    R_wb = _quat_to_rot_np(sim_data.gt_q[fi])
    R_wc = R_wb @ r_ic
    t_wc = sim_data.gt_p[fi] + R_wb @ t_ic
    pts_c = (sim_data.landmarks - t_wc) @ R_wc
    depth = pts_c[:, 2]
    uv = _cam_call(camera.project, camera, pts_c)
    vis = ((depth > 0.3) & (depth < 12.0)
           & (uv[:, 0] > margin) & (uv[:, 0] < w_img - margin)
           & (uv[:, 1] > margin) & (uv[:, 1] < h_img - margin))

    half = sprite // 2
    # Deterministic per-landmark contrast.
    brightness = rng.uniform(120, 195, len(sim_data.landmarks))
    phases = rng.integers(0, 2, len(sim_data.landmarks))
    for li in np.where(vis)[0]:
        cx_f, cy_f = uv[li]
        x0 = int(np.floor(cx_f)) - half
        y0 = int(np.floor(cy_f)) - half
        fx = cx_f - np.floor(cx_f)
        fy = cy_f - np.floor(cy_f)
        ys, xs = np.mgrid[0:sprite + 1, 0:sprite + 1]
        # 2x2 checker centered at the subpixel position -> strong corner.
        # Band-limited edges (tanh, ~0.7 px transition) emulate optics blur:
        # a hard sign() edge sampled at integer pixels aliases, so subpixel
        # motion does not translate appearance smoothly and ANY tracker hits
        # a ~0.4 px localization floor — real TUM-VI frames are lens-blurred
        # and cv2 LK localizes them to ~0.1-0.2 px.
        u_rel = xs - half - fx
        v_rel = ys - half - fy
        checker = (np.tanh(u_rel / 0.7) * np.tanh(v_rel / 0.7) + 1) / 2
        if phases[li]:
            checker = 1 - checker
        env = np.exp(-(u_rel ** 2 + v_rel ** 2) / (2 * (half * 0.9) ** 2))
        # Alpha-composite (smooth in subpixel position) instead of max().
        sprite_val = 40.0 + checker * brightness[li]
        ya, yb = max(y0, 0), min(y0 + sprite + 1, h_img)
        xa, xb = max(x0, 0), min(x0 + sprite + 1, w_img)
        if ya >= yb or xa >= xb:
            continue
        a = env[ya - y0:yb - y0, xa - x0:xb - x0]
        sv = sprite_val[ya - y0:yb - y0, xa - x0:xb - x0]
        img[ya:yb, xa:xb] = img[ya:yb, xa:xb] * (1 - a) + sv * a
    return np.clip(img, 0, 255).astype(np.uint8)


def imu_between(sim: SimData, t0: float, t1: float):
    """IMU samples with timestamps in (t0, t1] (the reference's slicing,
    measurement_processor.cpp:272-286). Returns (dt, acc, gyr) arrays where
    dt[i] is the step ending at sample i."""
    sel = (sim.imu_ts > t0) & (sim.imu_ts <= t1)
    idx = np.where(sel)[0]
    if len(idx) == 0:
        return (np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)))
    ts = sim.imu_ts[idx]
    prev_ts = np.concatenate([[t0], ts[:-1]])
    dt = ts - prev_ts
    return dt, sim.imu_acc[idx], sim.imu_gyr[idx]
