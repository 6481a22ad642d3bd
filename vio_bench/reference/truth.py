"""The program's outputs against the simulator's ground truth.

- ``trajectory_errors``: served body positions against the true ones at the
  same stamps, after the least-squares similarity (Umeyama, with scale) that
  a monocular-inertial trajectory is defined up to, fitted again to the
  nine tenths of the poses it fits best, so that one answer gone wrong
  cannot pull the alignment towards itself; the RMSE is the ATE and the
  largest single error catches that answer.
- ``track_drift_px``: how far the frontend's tracked corners wander from
  the landmark each was found on. A corner is tied, where its track is
  first seen, to the nearest landmark's true image position; the offset
  between the two (the detector finds a checker sprite's corner a pixel or
  two off its centre) must then stay as it was in every later frame of the
  track, whatever the motion.
"""

from __future__ import annotations

import numpy as np

from vio_bench.sim.cameras import Camera
from vio_bench.sim.world import Recording, quat_to_rot

STAMP_TOL = 1e-6    # s: served stamps are the frame stamps the client sent
FIT_SHARE = 0.9     # the share of poses the second alignment is fitted to


def umeyama(src: np.ndarray, dst: np.ndarray):
    """s, R, t minimising |dst - (s R src + t)|^2."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(xd.T @ xs / len(src))
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    scale = np.trace(np.diag(d) @ s_mat) / max(np.mean(np.sum(xs * xs, axis=1)), 1e-12)
    return scale, r, mu_d - scale * r @ mu_s


def trajectory_errors(rec: Recording, ts, p) -> np.ndarray | None:
    """Per-pose errors (m) of positions ``p`` served at stamps ``ts``
    after the similarity alignment; None if fewer than 3 poses, a stamp
    that is not a frame's, or a non-finite position."""
    ts, p = np.asarray(ts, float), np.asarray(p, float).reshape(-1, 3)
    if len(ts) < 3 or not np.isfinite(p).all():
        return None
    idx = np.searchsorted(rec.cam_ts, ts - STAMP_TOL)
    idx = np.clip(idx, 0, len(rec.cam_ts) - 1)
    if np.abs(rec.cam_ts[idx] - ts).max() > STAMP_TOL:
        return None
    g = rec.gt_p[idx]
    s, r, t = umeyama(p, g)
    err = np.linalg.norm(s * p @ r.T + t - g, axis=1)
    best = err <= np.quantile(err, FIT_SHARE)
    if best.sum() >= 3:
        s, r, t = umeyama(p[best], g[best])
        err = np.linalg.norm(s * p @ r.T + t - g, axis=1)
    return err


def landmark_pixels(rec: Recording, fi: int, cam: Camera, r_ic, t_ic) -> np.ndarray:
    """(L, 2) image positions of every landmark in frame ``fi``, NaN for
    those behind the camera."""
    r_wb = quat_to_rot(rec.seen_q[fi])
    r_wc = r_wb @ r_ic
    t_wc = rec.seen_p[fi] + r_wb @ t_ic
    pts = (rec.landmarks - t_wc) @ r_wc
    uv = cam.project_np(np.where(pts[:, 2:] > 0.3, pts, 1.0))
    return np.where(pts[:, 2:] > 0.3, uv, np.nan)


def track_drift_px(rec: Recording, cam: Camera, r_ic, t_ic, samples) -> np.ndarray:
    """Drift (px) of each later sighting of each track over ``samples``
    [(frame, ids (n,), points (n, 2))] in frame order: |offset now - offset
    at the track's first sighting|, the offset being the point less the
    true position of the landmark nearest it at that first sighting."""
    tied, drift = {}, []
    for fi, ids, pts in samples:
        uv = landmark_pixels(rec, fi, cam, r_ic, t_ic)
        seen = np.isfinite(uv[:, 0])
        for i, p in zip(np.asarray(ids).tolist(), np.asarray(pts, float).reshape(-1, 2)):
            if i not in tied:
                if not seen.any():
                    continue
                d2 = np.where(seen, ((uv - p) ** 2).sum(-1), np.inf)
                lm = int(np.argmin(d2))
                tied[i] = (lm, p - uv[lm])
            else:
                lm, off0 = tied[i]
                if seen[lm]:
                    drift.append(float(np.linalg.norm(p - uv[lm] - off0)))
    return np.asarray(drift)
