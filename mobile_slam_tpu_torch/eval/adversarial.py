"""Adversarial validation tier — de-circularized accuracy evidence (the
port's copy of mobile_slam_tpu.eval.adversarial).

The clean simulator (eval/simulation.py) renders frames through the SAME
camera-model code the tracker lifts with, and draws IMU error from EXACTLY
the iid-Gaussian + random-walk model the estimator whitens with — so "ATE
0.007 m on the clean sim" is partially self-referential. This module breaks
that symmetry two ways:

1. **Independent geometry oracle.** Every projection / unprojection here
   follows OpenCV's documented camera models, written out in numpy — the
   ``cv2.fisheye`` model θd = θ(1 + k1θ² + k2θ⁴ + k3θ⁶ + k4θ⁸) for
   Kannala-Brandt, radial-tangential ``cv2.projectPoints`` and the
   fixed-point ``cv2.undistortPoints`` for pinhole — and never goes through
   ``mobile_slam_tpu_torch.models.cameras``. The machine the port runs on
   has no OpenCV; tests/test_torch_adversarial.py holds this oracle, the
   motion-blur line raster (``cv2.line``, 8-connected) and the correlation
   (``cv2.filter2D``, reflect-101 borders) against OpenCV itself.

2. **Nuisance injection.** Real-sensor effects the clean sim lacks and the
   estimator's noise model does NOT include:

   * exposure flicker        — per-frame global gain oscillation + jitter
   * vignetting              — radial gain falloff toward the image corners
   * motion blur             — directional blur along the true image motion
   * colored IMU noise       — AR(1) noise (the estimator whitens iid)
   * accel scale-factor error— violates the linear measurement model
   * camera-IMU time offset  — constant td + per-frame jitter
   * moving objects          — independently-moving sprite clusters that
                               violate the static-world assumption
   * rolling shutter         — row-time exposure (level 4)

Each nuisance scales with a LEVEL (0 = clean oracle, 3 = harsh). Rendering
is host numpy, as in the reference: it is the data generator, not the
system under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mobile_slam_tpu_torch.eval.simulation import (SimConfig, SimData,
                                                   _quat_to_rot_np, make_landmarks,
                                                   make_trajectory)


# ---------------------------------------------------------------------------
# Independent projection oracles (OpenCV's models, in numpy)
# ---------------------------------------------------------------------------

UNDISTORT_ITERS = 100   # the reference's undistortPoints criteria
UNDISTORT_EPS = 1e-12   # (COUNT | EPS, 100, 1e-12), in pixels


def oracle_project(cam_cfg, pts_c: np.ndarray) -> np.ndarray:
    """(N, 3) camera-frame points -> (N, 2) pixels by OpenCV's models.

    KANNALA_BRANDT is cv2.fisheye.projectPoints' model (θd = θ(1 + k1θ² +
    k2θ⁴ + k3θ⁶ + k4θ⁸), θ = atan(r) of the z=1 point, r the point's radius
    — the polynomial of EquidistantCamera.cc:357 with the config's (k2..k5)
    as (k1..k4)); PINHOLE is cv2.projectPoints' radial-tangential model
    (k1, k2, p1, p2).
    """
    pts_c = np.asarray(pts_c, np.float64).reshape(-1, 3)
    mt = cam_cfg.model_type.upper()
    x = pts_c[:, 0] / pts_c[:, 2]
    y = pts_c[:, 1] / pts_c[:, 2]
    if mt == "KANNALA_BRANDT":
        k1, k2, k3, k4 = np.asarray(cam_cfg.dist[:4], np.float64)
        r = np.sqrt(x * x + y * y)
        th = np.arctan(r)
        th2 = th * th
        th_d = th * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
        big = r > 1e-8
        cdist = np.where(big, th_d / np.where(big, r, 1.0), 1.0)
        xd, yd = x * cdist, y * cdist
    elif mt == "PINHOLE":
        k1, k2, p1, p2 = np.asarray(cam_cfg.dist[:4], np.float64)
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    else:
        raise ValueError(f"no oracle for model {mt}")
    return np.stack([cam_cfg.fx * xd + cam_cfg.cx, cam_cfg.fy * yd + cam_cfg.cy], axis=-1)


def _undistort_points(cam_cfg, uv: np.ndarray) -> np.ndarray:
    """cv2.undistortPoints' fixed-point compensation of the radial-
    tangential model, per point until its reprojection is within
    UNDISTORT_EPS px or UNDISTORT_ITERS iterations have run. Returns the
    (N, 2) z=1-plane coordinates."""
    k1, k2, p1, p2 = np.asarray(cam_cfg.dist[:4], np.float64)
    u, v = uv[:, 0], uv[:, 1]
    x0 = (u - cam_cfg.cx) / cam_cfg.fx
    y0 = (v - cam_cfg.cy) / cam_cfg.fy
    x, y = x0.copy(), y0.copy()
    live = np.ones(len(uv), bool)
    for _ in range(UNDISTORT_ITERS):
        if not live.any():
            break
        xl, yl = x[live], y[live]
        r2 = xl * xl + yl * yl
        icdist = 1.0 / (1 + (k2 * r2 + k1) * r2)
        dx = 2 * p1 * xl * yl + p2 * (r2 + 2 * xl * xl)
        dy = p1 * (r2 + 2 * yl * yl) + 2 * p2 * xl * yl
        xn = (x0[live] - dx) * icdist
        yn = (y0[live] - dy) * icdist
        # A negative icdist: OpenCV resets the point and stops it.
        neg = icdist < 0
        xn = np.where(neg, x0[live], xn)
        yn = np.where(neg, y0[live], yn)
        r2 = xn * xn + yn * yn
        cdist = 1 + k1 * r2 + k2 * r2 * r2
        xd = xn * cdist + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
        yd = yn * cdist + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
        err = np.sqrt((xd * cam_cfg.fx + cam_cfg.cx - u[live]) ** 2
                      + (yd * cam_cfg.fy + cam_cfg.cy - v[live]) ** 2)
        idx = np.flatnonzero(live)
        x[idx], y[idx] = xn, yn
        live[idx[neg | (err < UNDISTORT_EPS)]] = False
    return np.stack([x, y], axis=-1)


_KB_LUT_CACHE: dict = {}


def _kb_theta_lut(dist, theta_max: float = 2.6, n: int = 16384):
    """Monotone (r, θ) lookup table for the KB polynomial r(θ) = θ + k2θ³ +
    k3θ⁵ + k4θ⁷ + k5θ⁹, built with plain numpy. Inverting by table gives an
    unprojection oracle that is independent of the cameras' Newton solver AND
    covers θ ≥ 90° (where cv2.fisheye.undistortPoints cannot go — it returns
    z=1-plane coordinates, which don't exist behind the camera plane; the
    TUM-VI 512² fisheye's corners sit at θ ≈ 108°)."""
    key = tuple(dist)
    if key not in _KB_LUT_CACHE:
        k2, k3, k4, k5 = dist
        th = np.linspace(0.0, theta_max, n)
        t2 = th * th
        r = th * (1 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5))))
        # keep the strictly-increasing prefix (the polynomial may turn over
        # far outside the lens's working range)
        d = np.diff(r)
        last = int(np.argmax(d <= 0)) + 1 if (d <= 0).any() else n
        _KB_LUT_CACHE[key] = (r[:last], th[:last])
    return _KB_LUT_CACHE[key]


def oracle_unproject(cam_cfg, uv: np.ndarray) -> np.ndarray:
    """(N, 2) pixels -> (N, 3) unit rays, independently of our camera code:
    pinhole+radtan by cv2.undistortPoints' iteration (_undistort_points);
    Kannala-Brandt by a lookup-table inversion of the model polynomial
    (see _kb_theta_lut)."""
    uv = np.asarray(uv, np.float64).reshape(-1, 2)
    mt = cam_cfg.model_type.upper()
    if mt == "KANNALA_BRANDT":
        mx = (uv[:, 0] - cam_cfg.cx) / cam_cfg.fx
        my = (uv[:, 1] - cam_cfg.cy) / cam_cfg.fy
        r_obs = np.hypot(mx, my)
        r_lut, th_lut = _kb_theta_lut(cam_cfg.dist[:4])
        theta = np.interp(r_obs, r_lut, th_lut)
        phi = np.arctan2(my, mx)
        st = np.sin(theta)
        return np.stack([st * np.cos(phi), st * np.sin(phi),
                         np.cos(theta)], axis=-1)
    if mt == "PINHOLE":
        # OpenCV's default criteria run a loose fixed-count compensation
        # (0.18 px round-trip error at the EuRoC corners); the reference's
        # tight criteria bring it to ~1e-12 px.
        n = _undistort_points(cam_cfg, uv)
        rays = np.concatenate([n, np.ones((len(n), 1))], axis=-1)
        return rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    raise ValueError(f"no unprojection oracle for model {mt}")


_ORACLE_RAY_CACHE: dict = {}


def oracle_ray_grid(cam_cfg) -> np.ndarray:
    """(H, W, 3) per-pixel unit rays through the oracle (cached)."""
    key = (cam_cfg.model_type, cam_cfg.width, cam_cfg.height, cam_cfg.fx,
           cam_cfg.fy, cam_cfg.cx, cam_cfg.cy, tuple(cam_cfg.dist))
    if key not in _ORACLE_RAY_CACHE:
        h, w = cam_cfg.height, cam_cfg.width
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float64) + 0.5,
                             np.arange(h, dtype=np.float64) + 0.5)
        uv = np.stack([uu.ravel(), vv.ravel()], axis=-1)
        _ORACLE_RAY_CACHE[key] = oracle_unproject(cam_cfg, uv).reshape(h, w, 3)
    return _ORACLE_RAY_CACHE[key]


# ---------------------------------------------------------------------------
# Nuisance configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NuisanceConfig:
    """Magnitudes of the injected real-sensor effects (all 0 = clean)."""

    exposure_flicker: float = 0.0   # relative gain amplitude (0.15 = ±15%)
    flicker_hz: float = 1.7         # slow drift component frequency
    vignette: float = 0.0           # corner gain loss fraction (0.4 = -40%)
    motion_blur_px: float = 0.0     # blur streak length for 1 px/ms motion
    pixel_noise_std: float = 0.0    # additive sensor noise (grey levels)
    imu_ar1_rho: float = 0.0        # AR(1) correlation of added IMU noise
    imu_ar1_acc: float = 0.0        # AR(1) noise std (m/s²)
    imu_ar1_gyr: float = 0.0        # AR(1) noise std (rad/s)
    acc_scale_err: float = 0.0      # accelerometer scale-factor error
    cam_time_offset_s: float = 0.0  # constant camera-vs-IMU time offset (td)
    cam_time_jitter_s: float = 0.0  # per-frame timestamp jitter std
    n_moving_objects: int = 0       # independently-moving sprite clusters
    moving_speed: float = 0.4       # m/s of the movers
    # Rolling-shutter row readout time (s for a full frame scan, top->bottom,
    # centered on the frame timestamp). The one real-sensor effect the
    # reference's own analysis names as unmodeled (docs/analysis-report.md:
    # 408-418); a global-shutter estimator must degrade gracefully.
    rs_readout_s: float = 0.0
    seed: int = 0


#: Degradation-curve presets. Level 0 is the CLEAN ORACLE arm: identical
#: physics to the standard bench sim, but rendered through the oracle —
#: its ATE isolates the circularity question from the robustness question.
LEVELS: dict[int, NuisanceConfig] = {
    0: NuisanceConfig(),
    1: NuisanceConfig(exposure_flicker=0.08, vignette=0.25,
                      motion_blur_px=1.0, pixel_noise_std=2.0,
                      imu_ar1_rho=0.95, imu_ar1_acc=0.01, imu_ar1_gyr=0.001,
                      acc_scale_err=0.01, cam_time_jitter_s=0.0005,
                      n_moving_objects=1),
    2: NuisanceConfig(exposure_flicker=0.15, vignette=0.40,
                      motion_blur_px=2.0, pixel_noise_std=4.0,
                      imu_ar1_rho=0.98, imu_ar1_acc=0.02, imu_ar1_gyr=0.002,
                      acc_scale_err=0.02, cam_time_offset_s=0.002,
                      cam_time_jitter_s=0.001, n_moving_objects=2),
    3: NuisanceConfig(exposure_flicker=0.25, vignette=0.55,
                      motion_blur_px=3.5, pixel_noise_std=6.0,
                      imu_ar1_rho=0.99, imu_ar1_acc=0.04, imu_ar1_gyr=0.004,
                      acc_scale_err=0.04, cam_time_offset_s=0.005,
                      cam_time_jitter_s=0.002, n_moving_objects=3),
    # Level 4: level-2 moderate nuisances + a 20 ms rolling-shutter readout
    # (typical mobile CMOS full-frame scan). Row-time pose divergence under
    # rotation is the dominant unmodeled geometry error on phones.
    4: NuisanceConfig(exposure_flicker=0.15, vignette=0.40,
                      motion_blur_px=2.0, pixel_noise_std=4.0,
                      imu_ar1_rho=0.98, imu_ar1_acc=0.02, imu_ar1_gyr=0.002,
                      acc_scale_err=0.02, cam_time_offset_s=0.002,
                      cam_time_jitter_s=0.001, n_moving_objects=2,
                      rs_readout_s=0.020),
}


# ---------------------------------------------------------------------------
# Nuisanced simulation (oracle geometry end-to-end)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MovingObject:
    center: np.ndarray   # (3,) orbit center
    radius: float
    omega: float         # rad/s
    phase: float
    n_pts: int = 4
    offsets: np.ndarray = None  # (n_pts, 3) rigid cluster offsets

    def positions(self, t: float) -> np.ndarray:
        c = self.center + self.radius * np.array([
            np.cos(self.omega * t + self.phase),
            np.sin(self.omega * t + self.phase), 0.0])
        return c[None, :] + self.offsets


def make_adversarial_data(scfg: SimConfig, cam_cfg, r_ic: np.ndarray,
                          t_ic: np.ndarray, nuis: NuisanceConfig) -> SimData:
    """SimData twin of simulation.simulate(), with oracle geometry and the
    IMU/timestamp nuisances applied. Frame feature lists are NOT produced
    (the adversarial tier always runs the full image path)."""
    rng = np.random.default_rng(scfg.seed)
    nrng = np.random.default_rng(nuis.seed + 7919)
    traj = make_trajectory(scfg.duration, scfg.imu_rate, scfg.g_norm,
                           seed=scfg.seed)
    lm = make_landmarks(scfg.num_landmarks, scfg.seed + 1)

    # iid noise exactly as the clean sim draws it (same rng stream), THEN
    # the adversarial additions the estimator's model does not contain.
    imu_acc = (traj.acc_body + np.asarray(scfg.acc_bias)
               + rng.normal(size=traj.acc_body.shape) * scfg.acc_noise)
    imu_gyr = (traj.gyr_body + np.asarray(scfg.gyr_bias)
               + rng.normal(size=traj.gyr_body.shape) * scfg.gyr_noise)

    if nuis.acc_scale_err:
        # Per-axis scale-factor error (violates the additive-bias model).
        scale = 1.0 + nuis.acc_scale_err * nrng.uniform(-1, 1, 3)
        imu_acc = imu_acc * scale[None, :]
    if nuis.imu_ar1_rho and (nuis.imu_ar1_acc or nuis.imu_ar1_gyr):
        # Colored AR(1) noise: x[t] = rho x[t-1] + sqrt(1-rho²) w[t].
        n = len(traj.ts)
        w_a = nrng.normal(size=(n, 3)) * nuis.imu_ar1_acc
        w_g = nrng.normal(size=(n, 3)) * nuis.imu_ar1_gyr
        rho = nuis.imu_ar1_rho
        s = np.sqrt(1.0 - rho * rho)
        col_a, col_g = np.zeros((n, 3)), np.zeros((n, 3))
        for t in range(1, n):
            col_a[t] = rho * col_a[t - 1] + s * w_a[t]
            col_g[t] = rho * col_g[t - 1] + s * w_g[t]
        imu_acc = imu_acc + col_a
        imu_gyr = imu_gyr + col_g

    stride = int(round(scfg.imu_rate / scfg.cam_rate))
    cam_idx = np.arange(0, len(traj.ts), stride)
    cam_ts = traj.ts[cam_idx].copy()

    # Timestamp nuisances: the FRAME CONTENT corresponds to the true time,
    # but the timestamp handed to the engine is offset/jittered (a real
    # unsynchronized camera). Ground truth stays indexed by the true time.
    ts_reported = cam_ts + nuis.cam_time_offset_s
    if nuis.cam_time_jitter_s:
        jit = nrng.normal(size=len(cam_ts)) * nuis.cam_time_jitter_s
        # keep monotone: jitter bounded by half a frame interval
        jit = np.clip(jit, -0.4 / scfg.cam_rate, 0.4 / scfg.cam_rate)
        ts_reported = ts_reported + jit
        ts_reported = np.maximum.accumulate(ts_reported + 1e-6 *
                                            np.arange(len(ts_reported)))

    data = SimData(
        cam_ts=ts_reported,
        gt_p=traj.p[cam_idx], gt_q=traj.q[cam_idx], gt_v=traj.v[cam_idx],
        imu_ts=traj.ts, imu_acc=imu_acc, imu_gyr=imu_gyr,
        frames=[None] * len(cam_idx), landmarks=lm,
        gravity=np.asarray([0.0, 0.0, scfg.g_norm]),
    )
    # stash true frame times for rendering (content time ≠ reported time)
    data.true_cam_ts = cam_ts  # type: ignore[attr-defined]
    return data


def make_movers(nuis: NuisanceConfig, room_half: float = 4.0):
    nrng = np.random.default_rng(nuis.seed + 104729)
    movers = []
    for _ in range(nuis.n_moving_objects):
        center = np.array([nrng.uniform(-2, 2), nrng.uniform(-2, 2),
                           nrng.uniform(0.6, 2.0)])
        offs = nrng.uniform(-0.25, 0.25, (4, 3))
        movers.append(MovingObject(
            center=center, radius=nrng.uniform(0.8, 1.8),
            omega=nuis.moving_speed / 1.2, phase=nrng.uniform(0, 6.28),
            offsets=offs))
    return movers


def _walls_from_rays(rays_c: np.ndarray, R_wc: np.ndarray, t_wc: np.ndarray,
                     room_half: float = 4.0) -> np.ndarray:
    """Box-room raycast + smooth 3D texture (same world as make_landmarks;
    the LENS geometry comes from the oracle ray grid, not our camera code)."""
    d = rays_c @ R_wc.T
    h, w = d.shape[:2]
    t_best = np.full((h, w), np.inf)
    bounds = [(0, room_half), (0, -room_half), (1, room_half),
              (1, -room_half), (2, 2.8), (2, -0.4)]
    eps = 1e-9
    for axis, val in bounds:
        da = d[..., axis]
        t = (val - t_wc[axis]) / np.where(np.abs(da) < eps, eps, da)
        ok = t > 0.05
        t_best = np.where(ok & (t < t_best), t, t_best)
    t_best = np.where(np.isfinite(t_best), t_best, 12.0)
    hit = t_wc[None, None, :] + d * t_best[..., None]
    x, y, z = hit[..., 0], hit[..., 1], hit[..., 2]
    return (55.0
            + 16.0 * np.sin(2.1 * x + 0.7) * np.cos(1.7 * y + 0.3)
            + 10.0 * np.sin(3.3 * y + 1.9) * np.cos(2.7 * z + 1.1)
            + 7.0 * np.sin(4.9 * z + 0.5) * np.cos(3.9 * x + 2.3))


def _splat_sprites(img: np.ndarray, uv: np.ndarray, vis: np.ndarray,
                   brightness: np.ndarray, phases: np.ndarray,
                   sprite: int = 7) -> None:
    """Checker-corner sprites at subpixel positions (in-place composite)."""
    h_img, w_img = img.shape
    half = sprite // 2
    ys, xs = np.mgrid[0:sprite + 1, 0:sprite + 1]
    for li in np.where(vis)[0]:
        cx_f, cy_f = uv[li]
        x0 = int(np.floor(cx_f)) - half
        y0 = int(np.floor(cy_f)) - half
        fx = cx_f - np.floor(cx_f)
        fy = cy_f - np.floor(cy_f)
        u_rel = xs - half - fx
        v_rel = ys - half - fy
        checker = (np.tanh(u_rel / 0.7) * np.tanh(v_rel / 0.7) + 1) / 2
        if phases[li]:
            checker = 1 - checker
        env = np.exp(-(u_rel ** 2 + v_rel ** 2) / (2 * (half * 0.9) ** 2))
        sprite_val = 40.0 + checker * brightness[li]
        ya, yb = max(y0, 0), min(y0 + sprite + 1, h_img)
        xa, xb = max(x0, 0), min(x0 + sprite + 1, w_img)
        if ya >= yb or xa >= xb:
            continue
        a = env[ya - y0:yb - y0, xa - x0:xb - x0]
        sv = sprite_val[ya - y0:yb - y0, xa - x0:xb - x0]
        img[ya:yb, xa:xb] = img[ya:yb, xa:xb] * (1 - a) + sv * a


def _slerp_np(q0: np.ndarray, q1: np.ndarray, a: float) -> np.ndarray:
    """Quaternion slerp (wxyz), numpy, shortest arc."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + a * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - a) * th) * q0 + np.sin(a * th) * q1) / np.sin(th)


def _gt_pose_at(data: SimData, t: float) -> tuple[np.ndarray, np.ndarray]:
    """Interpolated ground-truth body pose (R_wb, p_w) at an arbitrary time
    on the TRUE camera clock (rolling-shutter rows expose off-grid)."""
    ts = getattr(data, "true_cam_ts", data.cam_ts)
    j = int(np.clip(np.searchsorted(ts, t) - 1, 0, len(ts) - 2))
    a = float(np.clip((t - ts[j]) / max(ts[j + 1] - ts[j], 1e-9), 0.0, 1.0))
    q = _slerp_np(data.gt_q[j], data.gt_q[j + 1], a)
    p = (1.0 - a) * data.gt_p[j] + a * data.gt_p[j + 1]
    return _quat_to_rot_np(q), p


_VIGNETTE_CACHE: dict = {}


def _vignette_map(h: int, w: int, strength: float) -> np.ndarray:
    key = (h, w, round(strength, 4))
    if key not in _VIGNETTE_CACHE:
        yy, xx = np.mgrid[0:h, 0:w]
        r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2)
        _VIGNETTE_CACHE[key] = 1.0 - strength * np.clip(r2 / 2.0, 0, 1)
    return _VIGNETTE_CACHE[key]


def _draw_line(img: np.ndarray, p0, p1, value: float) -> None:
    """cv2.line(img, p0, p1, value, 1) with its default 8-connected line:
    OpenCV's LineIterator (points (x, y), drawn left to right, Bresenham
    error dx - 2dy along the major axis, a minor step where it goes
    negative), in place; every point must lie inside ``img``."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        img[y, x] = value
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if steep:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


def _filter2d(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kern) for float64: correlation (the kernel not
    flipped), anchored at the kernel's center, reflect-101 borders
    (BORDER_DEFAULT); zero taps skipped."""
    kh, kw = kern.shape
    ry, rx = kh // 2, kw // 2
    h, w = img.shape
    p = np.pad(img, ((ry, kh - 1 - ry), (rx, kw - 1 - rx)), mode="reflect")
    out = np.zeros((h, w))
    for i, j in zip(*np.nonzero(kern)):
        out += kern[i, j] * p[i:i + h, j:j + w]
    return out


def render_frame_adversarial(data: SimData, fi: int, cam_cfg,
                             r_ic: np.ndarray, t_ic: np.ndarray,
                             nuis: NuisanceConfig, movers=(),
                             sprite: int = 7, seed: int = 3) -> np.ndarray:
    """Render frame ``fi`` with ORACLE geometry + photometric nuisances."""
    rng = np.random.default_rng(seed)       # per-landmark appearance (fixed)
    frng = np.random.default_rng(nuis.seed * 100003 + fi)  # per-frame draws
    h_img, w_img = cam_cfg.height, cam_cfg.width
    t_true = getattr(data, "true_cam_ts", data.cam_ts)[fi]

    R_wb = _quat_to_rot_np(data.gt_q[fi])
    R_wc = R_wb @ r_ic
    t_wc = data.gt_p[fi] + R_wb @ t_ic

    def project_world(t_at: float, R_wc_a: np.ndarray, t_wc_a: np.ndarray):
        """All world sprites (landmarks + movers at time t_at) through the
        oracle projection under the given camera pose."""
        world_pts = [data.landmarks]
        for m in movers:
            world_pts.append(m.positions(t_at))
        world = np.concatenate(world_pts, axis=0)
        pts_c = (world - t_wc_a) @ R_wc_a
        depth = pts_c[:, 2]
        in_front = depth > 0.05
        uv = np.zeros((len(world), 2))
        if in_front.any():
            uv[in_front] = oracle_project(cam_cfg, pts_c[in_front])
        margin = 8.0
        vis = (in_front & (depth > 0.3) & (depth < 12.0)
               & (uv[:, 0] > margin) & (uv[:, 0] < w_img - margin)
               & (uv[:, 1] > margin) & (uv[:, 1] < h_img - margin))
        return world, uv, vis

    world, uv, vis = project_world(t_true, R_wc, t_wc)

    brightness = rng.uniform(120, 195, len(data.landmarks))
    phases = rng.integers(0, 2, len(data.landmarks))
    if len(world) > len(data.landmarks):
        n_m = len(world) - len(data.landmarks)
        mrng = np.random.default_rng(nuis.seed + 31337)
        brightness = np.concatenate([brightness, mrng.uniform(140, 200, n_m)])
        phases = np.concatenate([phases, mrng.integers(0, 2, n_m)])

    if not nuis.rs_readout_s:
        img = _walls_from_rays(oracle_ray_grid(cam_cfg), R_wc, t_wc)
        _splat_sprites(img, uv, vis, brightness, phases, sprite)
    else:
        # Rolling shutter: rows expose top->bottom over rs_readout_s,
        # centered on the frame timestamp. Rendered in B horizontal bands,
        # each from the interpolated GT pose at its mid-row exposure time;
        # sprites are assigned to the band of their global-shutter row and
        # re-projected under that band's pose (one fixed-point step of the
        # row/pose circularity — sub-band-height accurate).
        B = 16
        rays = oracle_ray_grid(cam_cfg)
        edges = np.linspace(0, h_img, B + 1).astype(int)
        band_of = np.clip((uv[:, 1] / h_img * B).astype(int), 0, B - 1)
        img = np.empty((h_img, w_img))
        for b in range(B):
            r0, r1 = edges[b], edges[b + 1]
            t_b = t_true + nuis.rs_readout_s * (
                (0.5 * (r0 + r1)) / h_img - 0.5)
            R_wb_b, p_b = _gt_pose_at(data, t_b)
            R_wc_b = R_wb_b @ r_ic
            t_wc_b = p_b + R_wb_b @ t_ic
            img[r0:r1] = _walls_from_rays(rays[r0:r1], R_wc_b, t_wc_b)
            sel = vis & (band_of == b)
            if sel.any():
                _, uv_b, vis_b = project_world(t_b, R_wc_b, t_wc_b)
                _splat_sprites(img, uv_b, vis_b & sel, brightness, phases,
                               sprite)

    # --- photometric nuisances --------------------------------------------
    if nuis.vignette:
        img = img * _vignette_map(h_img, w_img, nuis.vignette)
    if nuis.exposure_flicker:
        gain = (1.0 + nuis.exposure_flicker
                * np.sin(2 * np.pi * nuis.flicker_hz * t_true)
                + 0.3 * nuis.exposure_flicker * frng.normal())
        img = img * max(gain, 0.1)
    if nuis.motion_blur_px and fi > 0:
        # Blur along the true mean image motion since the previous frame.
        t_prev = getattr(data, "true_cam_ts", data.cam_ts)[fi - 1]
        R_wb0 = _quat_to_rot_np(data.gt_q[fi - 1])
        dw = R_wb0 @ r_ic  # previous camera orientation
        t_wc0 = data.gt_p[fi - 1] + R_wb0 @ t_ic
        c_pts = data.landmarks[::17]
        pc1 = (c_pts - t_wc) @ R_wc
        pc0 = (c_pts - t_wc0) @ dw
        okm = (pc1[:, 2] > 0.3) & (pc0[:, 2] > 0.3)
        if okm.sum() >= 3:
            du = (oracle_project(cam_cfg, pc1[okm])
                  - oracle_project(cam_cfg, pc0[okm]))
            flow = np.median(du, axis=0)
            speed = float(np.hypot(*flow))
            length = min(nuis.motion_blur_px * speed / 4.0, 9.0)
            if length >= 1.0:
                n_k = int(length) * 2 + 1
                c = n_k // 2
                ox = int(round(flow[0] / max(speed, 1e-6) * length / 2))
                oy = int(round(flow[1] / max(speed, 1e-6) * length / 2))
                kern = np.zeros((n_k, n_k))
                _draw_line(kern, (c - ox, c - oy), (c + ox, c + oy), 1.0)
                s = kern.sum()
                if s > 0:
                    img = _filter2d(img, kern / s)
    if nuis.pixel_noise_std:
        img = img + frng.normal(size=img.shape) * nuis.pixel_noise_std
    return np.clip(img, 0, 255).astype(np.uint8)
