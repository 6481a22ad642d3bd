"""Vision-only SfM over the initialization window (host, numpy float64).

Mirror of ``InitialSFM`` (src/frontend/initialization/initial_sfm.cpp):
fix the reference frame l and the latest frame from the essential-matrix
relative pose, alternate PnP + two-frame DLT triangulation sweeps forward
(l -> latest) and backward (l-1 -> 0) (initial_sfm.cpp:136-199), catch-all
first/last-observation triangulation, then a global bundle adjustment with
the reference rotation and ref/latest translations held constant
(initial_sfm.cpp:202-249). The Ceres auto-diff BA becomes a
Levenberg-Marquardt loop with analytic Jacobians and landmark Schur
elimination.

Conventions: q[i], T[i] are world(=frame-l)-from-camera; internally the
projection poses are cam-from-world [R_cw | t_cw].
"""

from __future__ import annotations

import numpy as np

from mobile_slam_tpu_torch.init import np_geometry as g


class SFMFeature:
    __slots__ = ("fid", "state", "position", "observation")

    def __init__(self, fid, observation):
        self.fid = fid
        self.state = False
        self.position = np.zeros(3)
        # observation: list of (frame_idx, xy normalized)
        self.observation = observation


def _triangulate_two_frames(i0, pose0, i1, pose1, feats):
    for f in feats:
        if f.state:
            continue
        p0 = p1 = None
        for fr, xy in f.observation:
            if fr == i0:
                p0 = xy
            if fr == i1:
                p1 = xy
        if p0 is not None and p1 is not None:
            f.position = g.triangulate_point(pose0, pose1, p0, p1)
            f.state = True


def _solve_frame_pnp(R, t, frame_idx, feats):
    """PnP against already-triangulated features observed in frame_idx
    (solveFrameByPnP, initial_sfm.cpp:22-66)."""
    pts3, pts2 = [], []
    for f in feats:
        if not f.state:
            continue
        for fr, xy in f.observation:
            if fr == frame_idx:
                pts3.append(f.position)
                pts2.append(xy)
                break
    if len(pts3) < 15:
        return False, R, t
    ok, R2, t2 = g.solve_pnp(pts3, pts2, R_init=R, t_init=t)
    if not ok:
        return False, R, t
    return True, R2, t2


def _bundle_adjust(c_R, c_t, feats, ref, latest, iters=40, focal=460.0):
    """Global BA: minimize reprojection over cam rotations/translations and
    landmark positions; gauge fixed like the reference (ref rotation const,
    ref+latest translations const)."""
    frame_num = len(c_R)
    solved = [f for f in feats if f.state]
    L = len(solved)
    if L == 0:
        return False, c_R, c_t

    # Parameter indexing: frames (3 rot + 3 trans each), landmarks 3.
    def pack():
        return [r.copy() for r in c_R], [t.copy() for t in c_t], \
               np.stack([f.position for f in solved])

    Rs, ts, X = pack()
    obs = []
    for li, f in enumerate(solved):
        for fr, xy in f.observation:
            # Whiten by the local pixel-noise scale: normalized-plane noise
            # grows as (1 + r^2)/focal across a fisheye FOV.
            obs.append((fr, li, xy, 1.0 / (1.0 + float(xy @ xy))))

    n_fr = frame_num
    mu = 1e-4
    last_cost = None
    huber = 3.0 / focal  # ~3px in whitened units

    def rho_w(r2):
        s = np.sqrt(max(r2, 1e-30))
        return 1.0 if s <= huber else huber / s

    for _ in range(iters):
        H = np.zeros((6 * n_fr + 3 * L, 6 * n_fr + 3 * L))
        b = np.zeros(6 * n_fr + 3 * L)
        cost = 0.0
        for fr, li, xy, w_px in obs:
            pc = Rs[fr] @ X[li] + ts[fr]
            z = pc[2] if abs(pc[2]) > 1e-9 else 1e-9
            proj = pc[:2] / z
            r = w_px * (proj - xy)
            w_r = rho_w(float(r @ r))
            cost += 0.5 * w_r * float(r @ r)
            r = w_r * r
            dp = (w_r * w_px) * np.array([[1 / z, 0, -pc[0] / z / z],
                                          [0, 1 / z, -pc[1] / z / z]])
            J_th = dp @ (-Rs[fr] @ g.skew(X[li]))
            J_t = dp
            J_x = dp @ Rs[fr]
            fi = 6 * fr
            xi = 6 * n_fr + 3 * li
            for Ja, ia in ((J_th, fi), (J_t, fi + 3), (J_x, xi)):
                b[ia:ia + 3] += Ja.T @ r
                for Jb, ib in ((J_th, fi), (J_t, fi + 3), (J_x, xi)):
                    H[ia:ia + 3, ib:ib + 3] += Ja.T @ Jb

        # Gauge fixing (initial_sfm.cpp:216-222).
        fixed = list(range(6 * ref, 6 * ref + 3)) \
            + list(range(6 * ref + 3, 6 * ref + 6)) \
            + list(range(6 * latest + 3, 6 * latest + 6))
        for k in fixed:
            H[k, :] = 0.0
            H[:, k] = 0.0
            H[k, k] = 1.0
            b[k] = 0.0

        Hd = H + mu * np.diag(np.maximum(np.diag(H), 1e-8))
        try:
            delta = -np.linalg.solve(Hd, b)
        except np.linalg.LinAlgError:
            return False, c_R, c_t

        Rs_new = [Rs[i] @ g.exp_so3(delta[6 * i:6 * i + 3]) for i in range(n_fr)]
        ts_new = [ts[i] + delta[6 * i + 3:6 * i + 6] for i in range(n_fr)]
        X_new = X + delta[6 * n_fr:].reshape(L, 3)

        cost_new = 0.0
        for fr, li, xy, w_px in obs:
            pc = Rs_new[fr] @ X_new[li] + ts_new[fr]
            z = pc[2] if abs(pc[2]) > 1e-9 else 1e-9
            r = w_px * (pc[:2] / z - xy)
            cost_new += 0.5 * rho_w(float(r @ r)) * float(r @ r)
        if cost_new < cost:
            Rs, ts, X = Rs_new, ts_new, X_new
            mu = max(mu / 3, 1e-9)
            if last_cost is not None and abs(last_cost - cost_new) < 1e-12:
                break
            last_cost = cost_new
        else:
            mu = min(mu * 5, 1e6)

    # Convergence check in PIXEL units: normalized-plane residuals scale
    # with (1 + r^2)/focal across a fisheye's FOV, so a flat normalized
    # threshold (the reference's final_cost < 2e-2, initial_sfm.cpp:252)
    # misjudges wide-angle cameras. Accept when the median reprojection
    # error is below ~3px.
    px_errs = []
    for fr, li, xy, w_px in obs:
        pc = Rs[fr] @ X[li] + ts[fr]
        z = pc[2] if abs(pc[2]) > 1e-9 else 1e-9
        r = pc[:2] / z - xy
        px_errs.append(np.linalg.norm(r) * focal * w_px)
    converged = bool(np.median(px_errs) < 3.0) if px_errs else False
    for li, f in enumerate(solved):
        f.position = X[li]
    return converged, Rs, ts


def construct(frame_num, ref, relative_R, relative_T, feats, focal=460.0):
    """InitialSFM::construct parity (initial_sfm.cpp:98-270).

    Returns (ok, q (frame_num, 4) wxyz world-from-cam, T (frame_num, 3),
    tracked_points dict fid -> (3,))."""
    latest = frame_num - 1
    q = [None] * frame_num
    T = [None] * frame_num

    # World(=l)-from-camera for ref and latest.
    R_wc = [None] * frame_num
    R_wc[ref] = np.eye(3)
    T[ref] = np.zeros(3)
    R_wc[latest] = relative_R.copy()
    T[latest] = relative_T.copy()

    # Cam-from-world projection poses.
    c_R = [None] * frame_num
    c_t = [None] * frame_num
    for i in (ref, latest):
        c_R[i] = R_wc[i].T
        c_t[i] = -R_wc[i].T @ T[i]

    pose = lambda i: np.hstack([c_R[i], c_t[i][:, None]])

    # Sweep 1/2: PnP + triangulate against the fixed latest frame.
    for i in range(ref, latest):
        if i > ref:
            ok, R2, t2 = _solve_frame_pnp(c_R[i - 1].copy(), c_t[i - 1].copy(),
                                          i, feats)
            if not ok:
                return False, None, None, None
            c_R[i], c_t[i] = R2, t2
        _triangulate_two_frames(i, pose(i), latest, pose(latest), feats)

    # Sweep 3: triangulate in-between frames against the reference frame.
    for i in range(ref + 1, latest):
        _triangulate_two_frames(ref, pose(ref), i, pose(i), feats)

    # Sweep 4/5: backward chain to the oldest frame.
    for i in range(ref - 1, -1, -1):
        ok, R2, t2 = _solve_frame_pnp(c_R[i + 1].copy(), c_t[i + 1].copy(),
                                      i, feats)
        if not ok:
            return False, None, None, None
        c_R[i], c_t[i] = R2, t2
        _triangulate_two_frames(i, pose(i), ref, pose(ref), feats)

    # Catch-all: first/last observation triangulation (initial_sfm.cpp:179-199).
    for f in feats:
        if f.state or len(f.observation) < 2:
            continue
        fr0, p0 = f.observation[0]
        fr1, p1 = f.observation[-1]
        f.position = g.triangulate_point(pose(fr0), pose(fr1), p0, p1)
        f.state = True

    ok, c_R, c_t = _bundle_adjust(c_R, c_t, feats, ref, latest, focal=focal)
    if not ok:
        return False, None, None, None

    q_out = np.zeros((frame_num, 4))
    T_out = np.zeros((frame_num, 3))
    for i in range(frame_num):
        R_wc_i = c_R[i].T
        q_out[i] = g.rot_to_quat(R_wc_i)
        T_out[i] = -R_wc_i @ c_t[i]
    tracked = {f.fid: f.position.copy() for f in feats if f.state}
    return True, q_out, T_out, tracked
