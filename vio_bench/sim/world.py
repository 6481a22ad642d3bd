"""The synthetic world of a recording: the room-scale trajectory, the IMU
with biases and noise, and the box-room landmarks. A frozen copy of the
port's ``eval/simulation.py`` (``make_trajectory``, ``make_landmarks`` and
the IMU and timing of ``simulate``), with two changes: the figure can start
at a phase ``t0`` of its period (so that recordings of one run differ), and
the per-frame feature lists are not made (the image path finds its own).

Every recording is made from a seed: the same seed gives the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

G_NORM = 9.81007


def quat_to_rot(q: np.ndarray) -> np.ndarray:
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


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def make_trajectory(duration: float, rate: float, t0: float = 0.0, g_norm: float = G_NORM,
                    scale: float = 1.5, excitation_warmup: float = 2.0):
    """Smooth room-scale figure with full 3-axis rotation, sampled at
    ``rate`` from the figure's time ``t0``, and the excitation wiggle over
    the recording's first ``excitation_warmup`` seconds. Returns (ts, p, q
    wxyz body-to-world, v, ideal accelerometer, ideal gyroscope)."""
    n = int(duration * rate) + 1
    ts = np.arange(n) / rate
    tf = ts + t0
    w1 = 2 * np.pi / 9.0
    w2 = 2 * np.pi / 6.5
    p = np.stack([
        scale * np.sin(w1 * tf),
        scale * 0.8 * np.sin(w2 * tf + 0.7),
        0.35 * np.sin(2 * w1 * tf + 0.3),
    ], axis=-1)
    yaw = 0.55 * np.sin(w1 * tf + 0.4)
    pitch = 0.22 * np.sin(w2 * tf + 1.1)
    roll = 0.18 * np.sin(1.7 * w1 * tf + 2.0)
    if excitation_warmup > 0:
        env = np.clip(1.0 - ts / excitation_warmup, 0.0, 1.0)
        env = env * env * (3 - 2 * env)
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
    q = np.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], axis=-1)
    v = np.gradient(p, ts, axis=0)
    a_w = np.gradient(v, ts, axis=0)
    qdot = np.gradient(q, ts, axis=0)
    gyr = (2.0 * _quat_mul(q * np.asarray([1.0, -1, -1, -1]), qdot))[:, 1:4]
    acc = np.einsum("nji,nj->ni", quat_to_rot(q), a_w + np.asarray([0.0, 0.0, g_norm]))
    return ts, p, q, v, acc, gyr


def make_landmarks(num: int, seed: int, room_half: float = 4.0,
                   min_sep: float = 0.30) -> np.ndarray:
    """Landmarks on the walls, floor and ceiling of a box room, at least
    ``min_sep`` apart (greedy rejection in draw order)."""
    rng = np.random.default_rng(seed)
    n_try = num * 6
    face = rng.integers(0, 6, n_try)
    pts = rng.uniform(-room_half, room_half, (n_try, 3))
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    pts[np.arange(n_try), axis] = sign * room_half
    pts[:, 2] = pts[:, 2] * 0.35 + 1.2
    pts[face % 3 == 2, 2] = np.where(sign[face % 3 == 2] > 0, 2.8, -0.4)
    kept = np.empty((num, 3))
    n = 0
    for p in pts:
        if n >= num:
            break
        if n and np.min(np.sum((kept[:n] - p) ** 2, axis=1)) < min_sep * min_sep:
            continue
        kept[n] = p
        n += 1
    return kept[:n]


@dataclasses.dataclass
class Recording:
    """One simulated recording: ground truth at the frame stamps, the
    poses the camera saw (``cam_time_offset`` later), the IMU and the
    landmarks. ``frames`` (N, H, W) uint8 is filled by ``render``."""

    cam_ts: np.ndarray      # (N,)
    gt_p: np.ndarray        # (N, 3) body positions at cam_ts
    gt_q: np.ndarray        # (N, 4)
    seen_p: np.ndarray      # (N, 3) body poses the frames show
    seen_q: np.ndarray      # (N, 4)
    imu_ts: np.ndarray      # (M,)
    imu_acc: np.ndarray     # (M, 3) biased, noisy
    imu_gyr: np.ndarray
    landmarks: np.ndarray   # (L, 3)
    frames: np.ndarray | None = None


def simulate(sim: dict, seed: int, t0: float = 0.0) -> Recording:
    """A recording of ``sim`` (the configuration's ``sim`` block: duration
    set by the caller) from ``seed``, the figure starting at phase ``t0``."""
    rng = np.random.default_rng(seed)
    imu_rate, cam_rate = float(sim["imu_rate"]), float(sim["cam_rate"])
    ts, p, q, _, acc, gyr = make_trajectory(float(sim["duration"]), imu_rate, t0)
    lm = make_landmarks(int(sim["num_landmarks"]), seed + 1)
    acc = acc + np.asarray(sim["acc_bias"]) + rng.normal(size=acc.shape) * sim["acc_noise"]
    gyr = gyr + np.asarray(sim["gyr_bias"]) + rng.normal(size=gyr.shape) * sim["gyr_noise"]
    stride = int(round(imu_rate / cam_rate))
    cam_idx = np.arange(0, len(ts), stride)
    shift = int(round(float(sim["cam_time_offset"]) * imu_rate))
    seen = np.clip(cam_idx + shift, 0, len(ts) - 1)
    return Recording(cam_ts=ts[cam_idx], gt_p=p[cam_idx], gt_q=q[cam_idx],
                     seen_p=p[seen], seen_q=q[seen], imu_ts=ts, imu_acc=acc,
                     imu_gyr=gyr, landmarks=lm)


def recording_seeds(seed: int, n: int) -> list[int]:
    """``n`` recording seeds derived from a run's seed (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 63))
    return [int(s) for s in ss.generate_state(n, np.uint32)]


def phase_order(seed: int, phases: list, n: int) -> list[float]:
    """The figure phases of a run's ``n`` recordings: the traffic's fixed
    set, in an order drawn from the seed (every seed the same motions)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 63), 1]))
    order = rng.permutation(len(phases))
    return [float(phases[order[i % len(phases)]]) for i in range(n)]
