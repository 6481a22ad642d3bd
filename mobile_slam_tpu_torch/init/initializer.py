"""Initialization orchestrator (host side).

Mirror of ``frontend::initialization::Initializer``
(src/frontend/initialization/initializer.cpp): IMU excitation check ->
reference-frame selection + essential-matrix relative pose (relativePose,
:210-244) -> vision-only SfM (init/sfm.py) -> PnP for all non-keyframes
(:246-346) -> visual-inertial alignment (init/alignment.py). The state
injection (visualInitialAlign's window rewrite, :348-424) happens on device
via engine/estimator.apply_initialization so the repropagation and
re-triangulation reuse the jitted kernels.

Runs in numpy float64 — initialization is the once-per-session cold path,
exactly as in the reference where it is CPU OpenCV/Ceres work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.init import np_geometry as g
from mobile_slam_tpu_torch.init import sfm as sfm_mod
from mobile_slam_tpu_torch.init.alignment import (HostFrame, check_imu_excitation,
                                            visual_imu_alignment)

W = NUM_SLOTS


@dataclasses.dataclass
class InitResult:
    ok: bool
    reason: str = ""
    # Window injection payload (valid when ok):
    p_cam: np.ndarray | None = None     # (11, 3) camera positions (scale-free)
    q_body: np.ndarray | None = None    # (11, 4) body orientations wxyz
    v_world: np.ndarray | None = None   # (11, 3) world-frame velocities
    bg: np.ndarray | None = None        # (3,)
    gravity: np.ndarray | None = None   # (3,) in the l-frame (pre-rotation)
    scale: float = 0.0


def _feature_tracks(table_np):
    """Extract per-feature observation lists from the pulled feature table."""
    fid = table_np["fid"]
    start = table_np["start"]
    obs = table_np["obs"]
    mask = table_np["mask"]
    feats = []
    for s in range(len(fid)):
        if fid[s] < 0:
            continue
        observation = []
        for w in range(W):
            if mask[s, w]:
                observation.append((w, obs[s, w, :2] / obs[s, w, 2]))
        if observation:
            feats.append(sfm_mod.SFMFeature(int(fid[s]), observation))
    return feats


def _relative_pose(feats, focal):
    """Find frame l with >20 correspondences to the latest frame and mean
    parallax*focal > 30, then solve the essential relative pose
    (initializer.cpp:210-244)."""
    for l in range(W - 1):
        corres = []
        for f in feats:
            obs_l = obs_r = None
            for fr, xy in f.observation:
                if fr == l:
                    obs_l = xy
                if fr == W - 1:
                    obs_r = xy
            if obs_l is not None and obs_r is not None:
                corres.append((np.append(obs_l, 1.0), np.append(obs_r, 1.0)))
        if len(corres) > 20:
            par = np.mean([np.linalg.norm(a[:2] - b[:2]) for a, b in corres])
            if par * focal > 30:
                ok, R, T = g.solve_relative_rt(corres, focal)
                if ok:
                    return l, R, T
    return None, None, None


def try_initialize(
    frames: list[HostFrame],
    window_ts: np.ndarray,       # (11,) window slot timestamps
    table_np: dict,              # pulled feature table arrays
    focal: float,
    r_ic: np.ndarray,
    t_ic: np.ndarray,
    g_norm: float,
) -> InitResult:
    if not check_imu_excitation(frames):
        return InitResult(False, "imu_excitation")

    feats = _feature_tracks(table_np)
    l, rel_R, rel_T = _relative_pose(feats, focal)
    if l is None:
        return InitResult(False, "parallax")

    ok, q_cam, T_cam, tracked = sfm_mod.construct(W, l, rel_R, rel_T, feats,
                                                  focal=focal)
    if not ok:
        return InitResult(False, "sfm")

    # PnP for every recorded frame; keyframes matched by timestamp
    # (solvePnPForAllFrames, initializer.cpp:246-346).
    r_ic_t = r_ic.T
    i = 0
    for fr in frames:
        if i < W and fr.ts == window_ts[i]:
            fr.is_key_frame = True
            fr.R = g.quat_to_rot(q_cam[i]) @ r_ic_t
            fr.T = T_cam[i].copy()
            i += 1
            continue
        if i < W and fr.ts > window_ts[i]:
            i += 1
        if i >= W:
            fr.is_key_frame = False
            continue
        R_init = g.quat_to_rot(q_cam[i]).T
        t_init = -R_init @ T_cam[i]
        pts3, pts2 = [], []
        for fid_, ray in fr.points.items():
            if fid_ in tracked:
                pts3.append(tracked[fid_])
                pts2.append(ray[:2] / ray[2])
        if len(pts3) < 6:
            return InitResult(False, "pnp_points")
        okp, R_cw, t_cw = g.solve_pnp(pts3, pts2, R_init=R_init, t_init=t_init)
        if not okp:
            return InitResult(False, "pnp")
        fr.is_key_frame = False
        fr.R = R_cw.T @ r_ic_t
        fr.T = R_cw.T @ (-t_cw)

    ok, delta_bg, gvec, x = visual_imu_alignment(frames, g_norm, t_ic)
    if not ok:
        return InitResult(False, "alignment")
    scale = float(x[-1])

    # Collect keyframe states in window order.
    p_cam = np.zeros((W, 3))
    q_body = np.zeros((W, 4))
    v_world = np.zeros((W, 3))
    kv = -1
    ki = 0
    for fr in frames:
        if fr.is_key_frame:
            kv += 1
            if ki < W and fr.ts == window_ts[ki]:
                p_cam[ki] = fr.T
                q_body[ki] = g.rot_to_quat(fr.R)
                v_world[ki] = fr.R @ x[kv * 3: kv * 3 + 3]
                ki += 1
    if ki != W:
        return InitResult(False, "keyframe_match")

    return InitResult(True, "", p_cam=p_cam, q_body=q_body, v_world=v_world,
                      bg=delta_bg, gravity=gvec, scale=scale)
