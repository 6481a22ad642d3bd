"""Trajectory evaluation: association, Umeyama alignment, ATE/RPE.

Equivalent of the reference ``TrajectoryEvaluator``
(src/utility/trajectory_evaluator.cpp) and the offline
scripts/evaluation/compare_trajectories.py: timestamp association via
binary search with a 10ms window (:104-145), Sim(3)/SE(3) Umeyama alignment
(:147-179), ATE RMSE/mean/median/std/min/max (:181-228), and RPE
translation/rotation at configurable deltas (:230-336; the reference stubs
rotation RPE to 0 — implemented properly here).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    num_pairs: int


@dataclasses.dataclass
class RPEResult:
    delta: float
    trans_rmse: float
    trans_mean: float
    rot_rmse_deg: float
    num_pairs: int


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.01):
    """Nearest-timestamp association within max_diff
    (trajectory_evaluator.cpp:104-145). Returns index pairs (i_a, i_b)."""
    ia, ib = [], []
    j = np.searchsorted(ts_b, ts_a)
    for i, t in enumerate(ts_a):
        best, bd = -1, max_diff
        for k in (j[i] - 1, j[i]):
            if 0 <= k < len(ts_b):
                d = abs(ts_b[k] - t)
                if d <= bd:
                    best, bd = k, d
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=True):
    """Least-squares similarity transform s,R,t with dst ≈ s R src + t
    (Eigen::umeyama parity, trajectory_evaluator.cpp:147-179)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    R = u @ s_mat @ vt
    if with_scale:
        var_s = np.mean(np.sum(xs * xs, axis=1))
        scale = np.trace(np.diag(d) @ s_mat) / max(var_s, 1e-12)
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def compute_ate(est_ts, est_p, gt_ts, gt_p, with_scale=True,
                max_diff: float = 0.01) -> ATEResult:
    """Absolute trajectory error after association + Umeyama alignment
    (trajectory_evaluator.cpp:181-228)."""
    ia, ib = associate(est_ts, gt_ts, max_diff)
    if len(ia) < 3:
        return ATEResult(np.inf, np.inf, np.inf, np.inf, np.inf, np.inf, 0)
    e = est_p[ia]
    g = gt_p[ib]
    s, R, t = umeyama_alignment(e, g, with_scale)
    aligned = (s * (e @ R.T)) + t
    err = np.linalg.norm(aligned - g, axis=1)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        min=float(err.min()),
        max=float(err.max()),
        num_pairs=len(err),
    )


def _rot_angle(R):
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    return np.degrees(np.arccos(c))


def compute_rpe(est_ts, est_p, est_R, gt_ts, gt_p, gt_R, delta: float = 1.0,
                max_diff: float = 0.01) -> RPEResult:
    """Relative pose error at time delta (trajectory_evaluator.cpp:230-336;
    rotation RPE implemented, not stubbed)."""
    ia, ib = associate(est_ts, gt_ts, max_diff)
    if len(ia) < 3:
        return RPEResult(delta, np.inf, np.inf, np.inf, 0)
    ts = est_ts[ia]
    terr, rerr = [], []
    k = np.searchsorted(ts, ts + delta)
    for i in range(len(ts)):
        j = k[i]
        if j >= len(ts):
            break
        if abs((ts[j] - ts[i]) - delta) > 0.1 * delta:
            continue
        ei, ej = ia[i], ia[j]
        gi, gj = ib[i], ib[j]
        # Relative motions.
        dp_e = est_R[ei].T @ (est_p[ej] - est_p[ei])
        dp_g = gt_R[gi].T @ (gt_p[gj] - gt_p[gi])
        terr.append(np.linalg.norm(dp_e - dp_g))
        dR_e = est_R[ei].T @ est_R[ej]
        dR_g = gt_R[gi].T @ gt_R[gj]
        rerr.append(_rot_angle(dR_e.T @ dR_g))
    if not terr:
        return RPEResult(delta, np.inf, np.inf, np.inf, 0)
    terr = np.asarray(terr)
    rerr = np.asarray(rerr)
    return RPEResult(
        delta=delta,
        trans_rmse=float(np.sqrt(np.mean(terr ** 2))),
        trans_mean=float(terr.mean()),
        rot_rmse_deg=float(np.sqrt(np.mean(rerr ** 2))),
        num_pairs=len(terr),
    )
