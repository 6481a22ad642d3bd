"""Camera calibration (torch twin of mobile_slam_tpu.models.cameras.calibration).

Intrinsic refinement, pose refinement, camera-odometry (hand-eye)
calibration and from-scratch calibration from checkerboard views, as the
reference's CostFunctionFactory and estimateIntrinsics
(src/common/camera_models/CostFunctionFactory.cc:446-470, PinholeCamera.cc:
257, EquidistantCamera.cc:234, CataCamera.cc:282, ScaramuzzaCamera.cc:204).
Every model exposes ``project(params, pts)``, so one damped Gauss-Newton
loop serves Pinhole, Kannala-Brandt, Mei and Scaramuzza (the last through a
flat parameter vector).

The Gauss-Newton loops run in float64 on ``device`` (the card unless
given); their damping schedules and accept/reject rules are the
reference's. Each Jacobian is automatic differentiation of the residual
(``_jacobian``): reverse mode on the card, where forward mode pays for
every product with a constant operand (the board points;
``probes/forward_ad_cost.py``), forward mode on the CPU, where reverse
mode's per-output cotangents cost more. The bootstraps are numpy on the
host, with ``cv_geometry``'s homography and planar PnP in place of
OpenCV's; the pinhole bootstrap keeps the reference's float32 cast of the
points before the homography. Results come back as numpy arrays, as the
reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from mobile_slam_tpu_torch.models.cameras import (cv_geometry, equidistant, mei, pinhole,
                                                  scaramuzza)
from mobile_slam_tpu_torch.utils import gpl
from mobile_slam_tpu_torch.utils import rotations as rot

F64 = torch.float64


def _kw(device) -> dict:
    return dict(dtype=F64, device=torch.device("cuda" if device is None else device))


def _np(x) -> np.ndarray:
    """A tensor on any device, or an array, as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _t(x, kw) -> torch.Tensor:
    return torch.tensor(_np(x), **kw)


def _jacobian(residual, *args) -> torch.Tensor:
    """d residual / d args[0]: reverse mode on the card, forward mode on the
    CPU, each the faster there (the bundle's 2700 x 158 Jacobian at 25
    views on the card: 6.78 ms reverse, 17.37 ms forward; on an 8-thread
    CPU the order flips, 233 against 33 ms; PERF.md §6)."""
    mode = torch.func.jacrev if args[0].device.type == "cuda" else torch.func.jacfwd
    return mode(residual)(*args)


def _scaramuzza_project_flat(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Scaramuzza projection over a FLAT parameter vector [inv_poly
    (INV_POLY_SIZE), cx, cy, c, d, e] (the parameters the reference's
    Scaramuzza reprojection cost refines). The forward poly only enters
    lifting, not projection."""
    q = scaramuzza.INV_POLY_SIZE
    return scaramuzza.project(
        {"inv_poly": params[:q], "center": params[q:q + 2],
         "affine": params[q + 2:q + 5]}, pts)


def scaramuzza_flat_params(params: dict) -> np.ndarray:
    return np.concatenate([_np(params["inv_poly"]), _np(params["center"]),
                           _np(params["affine"])])


_PROJECT = {
    "PINHOLE": pinhole.project,
    "KANNALA_BRANDT": equidistant.project,
    "MEI": mei.project,
    "SCARAMUZZA": _scaramuzza_project_flat,
}


def _damp(H: torch.Tensor, mu: float) -> torch.Tensor:
    """H + mu diag(max(diag H, 1e-12)) + 1e-12 I."""
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return H + mu * torch.diag(torch.clamp(torch.diagonal(H), min=1e-12)) + 1e-12 * eye


def refine_intrinsics(model_type: str, params0, pts_cam, uv_obs, iters: int = 20,
                      mask=None, device=None):
    """Gauss-Newton refinement of the intrinsic vector from (N, 3) camera-
    frame points and their (N, 2) observed pixels; ``mask`` marks the free
    parameters. Returns (params, rms_px_before, rms_px_after)."""
    project = _PROJECT[model_type.upper()]
    kw = _kw(device)
    params0 = _t(params0, kw)
    pts = _t(pts_cam, kw)
    uv = _t(uv_obs, kw)
    free = (torch.ones(params0.shape, dtype=torch.bool, device=kw["device"]) if mask is None
            else torch.as_tensor(_np(mask) != 0, device=kw["device"]))

    def residual(p):
        return (project(p, pts) - uv).reshape(-1)

    r0 = residual(params0)
    rms_before = float(torch.sqrt(torch.mean(r0 ** 2)))
    params = params0
    mu = 1e-6
    cost = float(torch.sum(r0 ** 2))
    for _ in range(iters):
        r = residual(params)
        J = torch.where(free[None, :], _jacobian(residual, params), 0.0)
        try:
            delta = -torch.linalg.solve(_damp(J.T @ J, mu), J.T @ r)
        except torch.linalg.LinAlgError:
            break
        new_params = params + torch.where(free, delta, 0.0)
        new_cost = float(torch.sum(residual(new_params) ** 2))
        if new_cost < cost:
            params, cost = new_params, new_cost
            mu = max(mu / 3, 1e-12)
        else:
            mu = min(mu * 10, 1e6)
    rms_after = float(np.sqrt(cost / r0.shape[0]))
    return _np(params), rms_before, rms_after


def refine_extrinsics(model_type: str, params, q0, t0, world_pts, uv_obs,
                      iters: int = 20, device=None):
    """Gauss-Newton refinement of a camera pose (wxyz cam-from-world q0, t0)
    from (N, 3) world points and their (N, 2) pixels, intrinsics fixed,
    rotation updates by quaternion box-plus. Returns (q, t, rms_before,
    rms_after)."""
    project = _PROJECT[model_type.upper()]
    kw = _kw(device)
    params = _t(params, kw)
    wp = _t(world_pts, kw)
    uv = _t(uv_obs, kw)
    q = _t(q0, kw)
    t = _t(t0, kw)

    def residual(dx, q_lin, t_lin):
        q_new = rot.quat_boxplus(q_lin, dx[:3])
        pc = wp @ rot.quat_to_rot(q_new).T + (t_lin + dx[3:])
        return (project(params, pc) - uv).reshape(-1)

    zero = torch.zeros(6, **kw)
    rms_before = float(torch.sqrt(torch.mean(residual(zero, q, t) ** 2)))
    mu = 1e-6
    cost = float(torch.sum(residual(zero, q, t) ** 2))
    for _ in range(iters):
        r = residual(zero, q, t)
        J = _jacobian(residual, zero, q, t)
        H = J.T @ J + mu * torch.eye(6, **kw)
        delta = -torch.linalg.solve(H, J.T @ r)
        q_new = rot.quat_boxplus(q, delta[:3])
        t_new = t + delta[3:]
        new_cost = float(torch.sum(residual(zero, q_new, t_new) ** 2))
        if new_cost < cost:
            q, t, cost = q_new, t_new, new_cost
            mu = max(mu / 3, 1e-12)
        else:
            mu = min(mu * 10, 1e6)
    rms_after = float(np.sqrt(cost / (2 * wp.shape[0])))
    return _np(q), _np(t), rms_before, rms_after


def calibrate_camera_odometry(model_type: str, params, q_oc0, t_oc0, odo_q0, odo_t0,
                              world_pts, uv_obs, iters: int = 25, device=None):
    """Joint hand-eye calibration: the camera-odometry transform (q_oc0,
    t_oc0) and the per-view world-from-odometry poses (odo_q0 (V, 4),
    odo_t0 (V, 3)) refined together from (V, N, 3) world points and their
    (V, N, 2) pixels, intrinsics fixed; the first odometry pose is held to
    pin the gauge. Returns (q_oc, t_oc, odo_q, odo_t, rms_before,
    rms_after)."""
    project = _PROJECT[model_type.upper()]
    kw = _kw(device)
    params = _t(params, kw)
    wp = _t(world_pts, kw)
    uv = _t(uv_obs, kw)
    V = wp.shape[0]
    q_oc, t_oc = _t(q_oc0, kw), _t(t_oc0, kw)
    odo_q, odo_t = _t(odo_q0, kw), _t(odo_t0, kw)
    ndx = 6 + 6 * (V - 1)
    z3 = torch.zeros((1, 3), **kw)

    def unpack(dx, q_oc_l, t_oc_l, odo_q_l, odo_t_l):
        d = dx[6:].reshape(V - 1, 6)
        return (rot.quat_boxplus(q_oc_l, dx[0:3]), t_oc_l + dx[3:6],
                rot.quat_boxplus(odo_q_l, torch.cat([z3, d[:, 0:3]])),
                odo_t_l + torch.cat([z3, d[:, 3:6]]))

    def residual(dx, *lin):
        q1, t1, oq, ot = unpack(dx, *lin)
        # world -> odometry -> camera
        x_o = torch.einsum("vij,vnj->vni", rot.quat_to_rot(oq).transpose(1, 2),
                           wp - ot[:, None, :])
        x_c = torch.einsum("ij,vnj->vni", rot.quat_to_rot(q1).T, x_o - t1[None, None, :])
        return (project(params, x_c.reshape(-1, 3)) - uv.reshape(-1, 2)).reshape(-1)

    zero = torch.zeros(ndx, **kw)
    r0 = residual(zero, q_oc, t_oc, odo_q, odo_t)
    rms_before = float(torch.sqrt(torch.mean(r0 ** 2)))
    mu = 1e-6
    cost = float(torch.sum(r0 ** 2))
    for _ in range(iters):
        r = residual(zero, q_oc, t_oc, odo_q, odo_t)
        J = _jacobian(residual, zero, q_oc, t_oc, odo_q, odo_t)
        delta = -torch.linalg.solve(_damp(J.T @ J, mu), J.T @ r)
        q1, t1, oq, ot = unpack(delta, q_oc, t_oc, odo_q, odo_t)
        new_cost = float(torch.sum(residual(zero, q1, t1, oq, ot) ** 2))
        if new_cost < cost:
            q_oc, t_oc, odo_q, odo_t, cost = q1, t1, oq, ot, new_cost
            mu = max(mu / 3, 1e-12)
        else:
            mu = min(mu * 10, 1e6)
    rms_after = float(np.sqrt(cost / r0.shape[0]))
    return _np(q_oc), _np(t_oc), _np(odo_q), _np(odo_t), rms_before, rms_after


# ---------------------------------------------------------------------------
# Intrinsic bootstrap from checkerboard views (estimateIntrinsics parity)
# ---------------------------------------------------------------------------


def _bootstrap_pinhole(board_size, object_points, image_points, width, height,
                       device=None):
    """Zhang-2000 closed-form focal bootstrap (PinholeCamera.cc:257-336):
    principal point pinned at the image center, per-view board homography,
    two orthogonality constraints per view on the rotation columns, linear
    least squares in (1/fx², 1/fy²)."""
    cx, cy = width / 2.0, height / 2.0
    rows_a, rows_b = [], []
    for obj, img in zip(object_points, image_points):
        M = np.asarray(obj, np.float64)[:, :2]
        # The reference hands cv2.findHomography float32 points.
        H = cv_geometry.find_homography(M.astype(np.float32),
                                        np.asarray(img, np.float32))
        if H is None:
            continue
        # Remove the principal point so H's left 3x2 block is K_f·[r1 r2]
        # with K_f = diag(fx, fy, 1).
        H[0] -= H[2] * cx
        H[1] -= H[2] * cy
        h, v = H[:, 0], H[:, 1]
        d1, d2 = (h + v) * 0.5, (h - v) * 0.5
        hn, vn = h / np.linalg.norm(h), v / np.linalg.norm(v)
        d1n, d2n = d1 / np.linalg.norm(d1), d2 / np.linalg.norm(d2)
        # r1 ⟂ r2 and |r1| = |r2| expressed on the normalized columns:
        # sum_j w_j · (col_a)_j (col_b)_j = 0 with w = (1/fx², 1/fy², 1).
        rows_a.append([hn[0] * vn[0], hn[1] * vn[1], hn[2] * vn[2]])
        rows_b.append([d1n[0] * d2n[0], d1n[1] * d2n[1], d1n[2] * d2n[2]])
    A = np.asarray(rows_a + rows_b)
    sol, *_ = np.linalg.lstsq(A[:, :2], -A[:, 2], rcond=None)
    fx = np.sqrt(np.abs(1.0 / sol[0]))
    fy = np.sqrt(np.abs(1.0 / sol[1]))
    return pinhole.make_params(fx, fy, cx, cy, **_kw(device))


def _board_pnp(params, model_type, obj, img):
    """Extrinsics (R, t) for one board view: lift pixels through the
    CANDIDATE model to the z=1 plane, then planar PnP with identity K
    (Camera::estimateExtrinsics parity); None when PnP finds no pose."""
    lift = {"KANNALA_BRANDT": equidistant.lift,
            "MEI": mei.lift,
            "PINHOLE": pinhole.lift}[model_type]
    rays = _np(lift(params, torch.as_tensor(_np(img), dtype=F64, device=params.device)))
    zs = rays[:, 2:3]
    zs = np.where(np.abs(zs) < 1e-9, 1e-9, zs)
    pose = cv_geometry.solve_pnp_planar(np.asarray(obj, np.float64), (rays / zs)[:, :2])
    if pose is None:
        return None
    return cv_geometry.rodrigues(pose[0]), pose[1]


def _reproj_err_with_poses(params, model_type, objs, uvs, poses):
    """Board reprojection RMS (px) of ``params`` (a tensor) with the given
    per-view (R, t); inf when a projection is not finite."""
    project = _PROJECT[model_type]
    total, count = 0.0, 0
    for (R, t), obj, img in zip(poses, objs, uvs):
        pc = np.asarray(obj, np.float64) @ np.asarray(R).T + t
        uv = _np(project(params, torch.as_tensor(pc, dtype=F64, device=params.device)))
        if not np.all(np.isfinite(uv)):
            return np.inf
        total += float(np.sum((uv - np.asarray(img)) ** 2))
        count += len(obj)
    return np.sqrt(total / max(count, 1))


def _reproj_err(params, model_type, object_points, image_points):
    poses = []
    for obj, img in zip(object_points, image_points):
        ext = _board_pnp(params, model_type, obj, img)
        if ext is None:
            return np.inf
        poses.append(ext)
    return _reproj_err_with_poses(params, model_type, object_points, image_points, poses)


def _bootstrap_kb(board_size, object_points, image_points, width, height, device=None):
    """Hughes-2010 vanishing-point focal bootstrap for the equidistant
    fisheye (EquidistantCamera.cc:234-318): each board row's corners lie on
    a circle in the fisheye image; each pair of row circles intersects in
    the two vanishing points of that direction, and f = |v1 - v2| / π.
    Every candidate f is scored by board reprojection (PnP per view); the
    best one wins."""
    u0, v0 = width / 2.0, height / 2.0
    cols, rows = board_size
    cands = []
    for img in image_points:
        img = np.asarray(img, np.float64).reshape(rows, cols, 2)
        fits = [gpl.fit_circle(img[r]) for r in range(rows)]
        for j in range(rows):
            for k in range(j + 1, rows):
                ipts = gpl.intersect_circles(*fits[j], *fits[k])
                if len(ipts) < 2:
                    continue
                f = float(np.linalg.norm(ipts[0] - ipts[1])) / np.pi
                if np.isfinite(f) and f > 0:
                    cands.append(f)
    best_f, _ = _score_focal_candidates(
        cands, lambda f: equidistant.make_params(f, f, u0, v0, **_kw(device)),
        "KANNALA_BRANDT", object_points, image_points)
    if best_f <= 0.0:
        raise ValueError("Kannala-Brandt bootstrap failed with given data")
    return equidistant.make_params(best_f, best_f, u0, v0, **_kw(device))


def _score_focal_candidates(cands, make, model_type, object_points,
                            image_points, max_eval: int = 12,
                            score_views: int = 4):
    """Dedupe focal candidates to a 1.5%-relative grid, cap the number of
    full reprojection scorings (each costs PnP per view), and score on a
    view subset."""
    if not cands:
        return 0.0, np.inf
    uniq: list[float] = []
    for f in sorted(cands):
        if not uniq or f > uniq[-1] * 1.015:
            uniq.append(f)
    if len(uniq) > max_eval:
        idx = np.linspace(0, len(uniq) - 1, max_eval).astype(int)
        uniq = [uniq[i] for i in idx]
    objs = object_points[:score_views]
    imgs = image_points[:score_views]
    best_f, best_err = 0.0, np.inf
    for f in uniq:
        err = _reproj_err(make(f), model_type, objs, imgs)
        if err < best_err:
            best_err, best_f = err, f
    return best_f, best_err


def _bootstrap_mei(board_size, object_points, image_points, width, height, device=None):
    """Mei focal bootstrap at xi=1 (CataCamera.cc:282-370): under the
    unified-sphere model with xi=1, the image of any space line lies on a
    circle satisfying [u, v, 0.5, -0.5(u²+v²)]·C = 0 with
    gamma = sqrt(C3/C4); each non-radial board row contributes a candidate,
    scored by board reprojection."""
    u0, v0 = width / 2.0, height / 2.0
    cols, rows = board_size
    cands = []
    for img in image_points:
        img = np.asarray(img, np.float64).reshape(rows, cols, 2)
        for r in range(rows):
            u = img[r, :, 0] - u0
            v = img[r, :, 1] - v0
            P = np.stack([u, v, np.full_like(u, 0.5),
                          -0.5 * (u * u + v * v)], axis=-1)
            _, _, vt = np.linalg.svd(P)
            C = vt[-1]
            t = C[0] ** 2 + C[1] ** 2 + C[2] * C[3]
            if t < 0.0:
                continue
            d = np.sqrt(1.0 / t)
            nx, ny = C[0] * d, C[1] * d
            if np.hypot(nx, ny) > 0.95:  # radial line: no focal information
                continue
            if C[2] / C[3] <= 0:
                continue
            cands.append(float(np.sqrt(C[2] / C[3])))
    best_g, _ = _score_focal_candidates(
        cands, lambda g: mei.make_params(g, g, u0, v0, xi=1.0, **_kw(device)),
        "MEI", object_points, image_points)
    if best_g <= 0.0:
        raise ValueError("Mei bootstrap failed with given data")
    return mei.make_params(best_g, best_g, u0, v0, xi=1.0, **_kw(device))


def _bootstrap_scaramuzza(board_size, object_points, image_points, width,
                          height):
    """Scaramuzza-thesis closed-form OCAM bootstrap
    (ScaramuzzaCamera.cc:204-557 estimateIntrinsics; ETH thesis 17635,
    calibrate.m), numpy on the host:

    1. per view, the z=0 board plane gives 2N homogeneous equations in the
       scaled partial extrinsics h = (r11, r12, r21, r22, t1, t2) — SVD
       null vector;
    2. the dropped third row (r31, r32) is recovered from orthonormality
       (a quadratic in r32²), sign candidates disambiguated by a per-view
       quadratic-poly least squares (small residual, board in front);
    3. one global least squares over all views solves the forward
       polynomial [a0, 0, a2, a3, a4] jointly with every view's t3.

    The reference's two deviations from ScaramuzzaCamera.cc are kept:
    pixels are centered before step 1, and candidates are selected by
    equation residual + front-of-camera gate. Returns (flat_params,
    poses) with poses in the repo's z-forward camera frame."""
    u0, v0 = width / 2.0, height / 2.0
    views = []
    for obj, img in zip(object_points, image_points):
        o = np.asarray(obj, np.float64)
        X, Y = o[:, 0], o[:, 1]
        im = np.asarray(img, np.float64)
        u, v = im[:, 0] - u0, im[:, 1] - v0
        rho = np.hypot(u, v)
        M = np.stack([-v * X, -v * Y, u * X, u * Y, -v, u], axis=-1)
        _, _, vt = np.linalg.svd(M)
        sr11, sr12, sr21, sr22, st1, st2 = vt[-1]
        AA = (sr11 * sr12 + sr21 * sr22) ** 2
        BB = sr11 * sr11 + sr21 * sr21
        CC = sr12 * sr12 + sr22 * sr22
        disc = np.sqrt((CC - BB) ** 2 + 4.0 * AA)
        thirds = []
        for r2 in ((-(CC - BB) + disc) / 2.0, (-(CC - BB) - disc) / 2.0):
            if r2 > 1e-14:
                for s in (1.0, -1.0):
                    sr32 = s * np.sqrt(r2)
                    thirds.append((-(sr11 * sr12 + sr21 * sr22) / sr32, sr32))
            elif abs(r2) <= 1e-14:
                sr31 = np.sqrt(max(CC - BB, 0.0))
                thirds += [(sr31, 0.0), (-sr31, 0.0)]
        best = None
        for sr31, sr32 in thirds:
            lam = 1.0 / np.sqrt(sr11 * sr11 + sr21 * sr21 + sr31 * sr31)
            for sgn in (lam, -lam):
                H = sgn * np.array([[sr11, sr12, st1],
                                    [sr21, sr22, st2],
                                    [sr31, sr32, 0.0]])
                A = H[1, 0] * X + H[1, 1] * Y + H[1, 2]
                C = H[0, 0] * X + H[0, 1] * Y + H[0, 2]
                rz = H[2, 0] * X + H[2, 1] * Y
                Am = np.zeros((2 * len(X), 4))
                Bv = np.empty(2 * len(X))
                for k, pw in enumerate((np.ones_like(rho), rho, rho * rho)):
                    Am[0::2, k] = A * pw
                    Am[1::2, k] = C * pw
                Am[0::2, 3] = -v
                Am[1::2, 3] = -u
                Bv[0::2] = v * rz
                Bv[1::2] = u * rz
                x, *_ = np.linalg.lstsq(Am, Bv, rcond=None)
                resid = float(np.linalg.norm(Am @ x - Bv))
                # Front-of-camera gates in the thesis (z-flipped) frame:
                # f(0) = a0 < 0 and board depth t3 < 0.
                if x[0] < 0.0 and x[3] < 0.0:
                    if best is None or resid < best[0]:
                        best = (resid, H)
        if best is not None:
            views.append((best[1], X, Y, u, v, rho))
    if len(views) < 2:
        raise ValueError("Scaramuzza bootstrap failed with given data")

    # Global solve: [a0, a2, a3, a4] + per-view t3 (a1 = 0, thesis §3).
    nv = len(views)
    blocks, rhs = [], []
    for i, (H, X, Y, u, v, rho) in enumerate(views):
        A = H[1, 0] * X + H[1, 1] * Y + H[1, 2]
        C = H[0, 0] * X + H[0, 1] * Y + H[0, 2]
        rz = H[2, 0] * X + H[2, 1] * Y
        blk = np.zeros((2 * len(X), 4 + nv))
        for k, pw in enumerate((np.ones_like(rho), rho ** 2, rho ** 3,
                                rho ** 4)):
            blk[0::2, k] = A * pw
            blk[1::2, k] = C * pw
        blk[0::2, 4 + i] = -v
        blk[1::2, 4 + i] = -u
        b = np.empty(2 * len(X))
        b[0::2] = v * rz
        b[1::2] = u * rz
        blocks.append(blk)
        rhs.append(b)
    sol, *_ = np.linalg.lstsq(np.concatenate(blocks), np.concatenate(rhs),
                              rcond=None)
    poly = np.array([sol[0], 0.0, sol[1], sol[2], sol[3]])
    t3s = sol[4:]

    # Poses to the repo's z-forward frame: P_repo = diag(1,1,-1) P_thesis.
    poses = []
    for i, (H, *_rest) in enumerate(views):
        R12 = np.stack([H[:, 0], H[:, 1]], axis=1)
        R12[2, :] *= -1.0
        R = np.stack([R12[:, 0], R12[:, 1],
                      np.cross(R12[:, 0], R12[:, 1])], axis=1)
        U, _, Vt = np.linalg.svd(R)
        R = U @ Vt
        if np.linalg.det(R) < 0:
            R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
        poses.append((R, np.array([H[0, 2], H[1, 2], -t3s[i]])))

    inv_poly = scaramuzza.fit_inverse_poly(poly, 0.5 * np.hypot(width, height))
    flat = np.concatenate([inv_poly, [u0, v0, 1.0, 0.0, 0.0]])
    return flat, poses


_BOOTSTRAP = {
    "PINHOLE": _bootstrap_pinhole,
    "KANNALA_BRANDT": _bootstrap_kb,
    "MEI": _bootstrap_mei,
}


def calibrate_from_board(model_type: str, board_size, object_points, image_points,
                         width: int, height: int, refine: bool = True,
                         refine_iters: int = 30, device=None):
    """From-scratch intrinsic calibration from checkerboard views: the
    model's bootstrap, then (``refine``) the joint Gauss-Newton bundle over
    the intrinsics and every view's board pose on ``device``.

    board_size: (cols, rows) inner-corner grid.
    object_points: list of (cols*rows, 3) board-frame corners (z = 0).
    image_points: list of (cols*rows, 2) detected pixels, row-major.
    Returns (params, rms_px) with params in the model's flat layout.
    """
    mt = model_type.upper()
    kw = _kw(device)
    objs = [np.asarray(o, np.float64) for o in object_points]
    uvs = [np.asarray(i, np.float64) for i in image_points]
    if mt == "SCARAMUZZA":
        # OCAM solves its own per-view extrinsics in the bootstrap; the
        # flat layout carries no forward poly for _board_pnp's lift.
        params, poses = _bootstrap_scaramuzza(board_size, objs, uvs, width, height)
        rms = _reproj_err_with_poses(_t(params, kw), mt, objs, uvs, poses)
        if not refine:
            return params, rms
        return _refine_board_joint(mt, params, objs, uvs, poses, iters=refine_iters,
                                   device=device)
    if mt not in _BOOTSTRAP:
        raise ValueError(f"no bootstrap for model {mt}")
    params = _BOOTSTRAP[mt](board_size, object_points, image_points, width, height,
                            device=device)
    rms = _reproj_err(params, mt, object_points, image_points)
    if not refine:
        return _np(params), rms
    # Joint calibration bundle: intrinsics and per-view board poses refined
    # TOGETHER (alternating PnP / intrinsic passes stall in a focal-
    # distortion local minimum under strong tilt).
    poses0, objs_ok, uvs_ok = [], [], []
    for obj, img in zip(objs, uvs):
        ext = _board_pnp(params, mt, obj, img)
        if ext is None:
            continue
        poses0.append(ext)
        objs_ok.append(obj)
        uvs_ok.append(img)
    return _refine_board_joint(mt, params, objs_ok, uvs_ok, poses0, iters=refine_iters,
                               device=device)


def _board_residual(project, wp, uv, n_i):
    """The calibration bundle's residual (V*N*2,) at the increment dx
    (n_i intrinsic steps, then each view's box-plus rotation and
    translation steps) from (params, q (V, 4), t (V, 3)), over board points
    wp (V, N, 3) observed at uv (V, N, 2)."""
    V = wp.shape[0]

    def unpack(dx, params_l, q_l, t_l):
        d = dx[n_i:].reshape(V, 6)
        return params_l + dx[:n_i], rot.quat_boxplus(q_l, d[:, :3]), t_l + d[:, 3:]

    def residual(dx, params_l, q_l, t_l):
        p1, q1, t1 = unpack(dx, params_l, q_l, t_l)
        pc = torch.einsum("vij,vnj->vni", rot.quat_to_rot(q1), wp) + t1[:, None, :]
        return (project(p1, pc.reshape(-1, 3)) - uv.reshape(-1, 2)).reshape(-1)

    return unpack, residual


def _refine_board_joint(model_type, params0, objs, uvs, poses0, iters: int = 30,
                        device=None):
    """Joint damped GN over [intrinsic vector, per-view (q, t)], rotation
    updates by quaternion box-plus. Returns (params, rms_px)."""
    kw = _kw(device)
    params = _t(params0, kw)
    n_i = int(params.shape[0])
    q = torch.as_tensor(np.stack([gpl._rotation_to_quat(R) for R, _ in poses0]), **kw)
    t = torch.as_tensor(np.stack([np.asarray(t_, np.float64) for _, t_ in poses0]), **kw)
    wp = torch.as_tensor(np.stack(objs), **kw)         # (V, N, 3)
    uv = torch.as_tensor(np.stack(uvs), **kw)          # (V, N, 2)
    ndx = n_i + 6 * wp.shape[0]
    unpack, residual = _board_residual(_PROJECT[model_type], wp, uv, n_i)

    zero = torch.zeros(ndx, **kw)
    r = residual(zero, params, q, t)
    cost = float(torch.sum(r ** 2))
    mu = 1e-4
    for _ in range(iters):
        r = residual(zero, params, q, t)
        J = _jacobian(residual, zero, params, q, t)
        try:
            delta = -torch.linalg.solve(_damp(J.T @ J, mu), J.T @ r)
        except torch.linalg.LinAlgError:
            break
        p1, q1, t1 = unpack(delta, params, q, t)
        new_cost = float(torch.sum(residual(zero, p1, q1, t1) ** 2))
        if np.isfinite(new_cost) and new_cost < cost:
            params, q, t, cost = p1, q1, t1, new_cost
            mu = max(mu / 3, 1e-12)
        else:
            mu = min(mu * 10, 1e6)
    rms = float(np.sqrt(cost / r.shape[0]))
    return _np(params), rms


def calibrate_from_observations(model_type: str, params0, world_pts, uv_obs, poses,
                                iters: int = 20, device=None):
    """Multi-view intrinsic calibration with known camera poses:
    world_pts (V, N, 3), uv_obs (V, N, 2), poses = list of (R_cw, t_cw)."""
    pts_cam = [np.asarray(wp) @ np.asarray(R).T + np.asarray(t)
               for (R, t), wp in zip(poses, world_pts)]
    return refine_intrinsics(model_type, params0, np.concatenate(pts_cam),
                             np.concatenate([np.asarray(ob) for ob in uv_obs]),
                             iters=iters, device=device)
