"""Board geometry without OpenCV: a least-squares homography, planar PnP and
Rodrigues, in numpy.

The reference's calibration (mobile_slam_tpu/models/cameras/calibration.py)
calls ``cv2.findHomography`` (method 0), ``cv2.solvePnP``
(``SOLVEPNP_ITERATIVE``, identity K, no distortion, a z=0 board) and
``cv2.Rodrigues``. The machine the port runs on has no OpenCV, so these are
written here from OpenCV's documented algorithms:

* ``find_homography`` — the normalized DLT (Hartley: centroid at the origin,
  mean distance sqrt(2)), then Levenberg-Marquardt over the eight entries
  of H (H[2, 2] = 1) on the reprojection error in the destination image.
* ``solve_pnp_planar`` — the board's homography to the normalized image
  (``find_homography``), its decomposition (columns normalized, the third
  the cross product, R made orthonormal through the SVD), then
  Levenberg-Marquardt on the reprojection error over a local angle-axis
  increment of R and the translation, as ``cvFindExtrinsicCameraParams2``
  does for planar points.
* ``rodrigues`` — rotation vector -> matrix.

Both solvers run to convergence, where OpenCV stops after 10 and 20
iterations: on the boards the calibration sees the two meet at the same
least-squares optimum (tests/test_torch_calibration.py holds them against
cv2).
"""

from __future__ import annotations

import numpy as np

from mobile_slam_tpu_torch.utils import gpl

LM_MAX_ITERS = 100
LM_STEP_TOL = 1e-14    # relative parameter step that ends the iteration


def rodrigues(rvec) -> np.ndarray:
    """Rotation vector (3,) -> rotation matrix (3, 3)."""
    return gpl.angle_axis_to_rotation(np.asarray(rvec, np.float64).reshape(3))


def _lm(x, residual_jac, retract, flat):
    """Levenberg-Marquardt with Marquardt's diagonal scaling. ``residual_jac(x)``
    gives the residual and its Jacobian over the local increment,
    ``retract(x, dx)`` applies an increment, ``flat(x)`` the vector whose
    norm scales the step test. A step that lowers the cost is taken and
    lambda divided by 10, else lambda is multiplied by 10; the iteration
    ends when a taken step is below LM_STEP_TOL relative to ``flat(x)``."""
    r, J = residual_jac(x)
    cost = float(r @ r)
    lam = 1e-3
    for _ in range(LM_MAX_ITERS):
        A = J.T @ J
        try:
            dx = -np.linalg.solve(A + lam * np.diag(np.maximum(np.diagonal(A), 1e-300)),
                                  J.T @ r)
        except np.linalg.LinAlgError:
            break
        x_new = retract(x, dx)
        r_new, J_new = residual_jac(x_new)
        cost_new = float(r_new @ r_new)
        if np.isfinite(cost_new) and cost_new <= cost:
            x, r, J, cost = x_new, r_new, J_new, cost_new
            lam = max(lam / 10.0, 1e-12)
            if np.linalg.norm(dx) <= LM_STEP_TOL * max(np.linalg.norm(flat(x)), 1.0):
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    return x


def _normalizer(p: np.ndarray) -> np.ndarray:
    """Hartley's similarity: centroid to the origin, mean distance sqrt(2)."""
    c = p.mean(axis=0)
    d = np.mean(np.linalg.norm(p - c, axis=1))
    s = np.sqrt(2.0) / max(d, 1e-300)
    return np.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]])


def _homography_residual(src, dst):
    x, y = src[:, 0], src[:, 1]

    def fn(h):
        w = h[6] * x + h[7] * y + 1.0
        u = (h[0] * x + h[1] * y + h[2]) / w
        v = (h[3] * x + h[4] * y + h[5]) / w
        r = np.stack([u - dst[:, 0], v - dst[:, 1]], axis=1).reshape(-1)
        J = np.zeros((2 * len(x), 8))
        J[0::2, 0], J[0::2, 1], J[0::2, 2] = x / w, y / w, 1.0 / w
        J[1::2, 3], J[1::2, 4], J[1::2, 5] = x / w, y / w, 1.0 / w
        J[0::2, 6], J[0::2, 7] = -u * x / w, -u * y / w
        J[1::2, 6], J[1::2, 7] = -v * x / w, -v * y / w
        return r, J

    return fn


def find_homography(src, dst):
    """The homography H (3, 3), H[2, 2] = 1, with dst ~ H src for (N, 2)
    point sets, N >= 4, least squares in the destination image (what
    ``cv2.findHomography(src, dst)`` with method 0 computes). Returns None
    for fewer than 4 points or a degenerate set."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    if len(src) < 4 or len(src) != len(dst):
        return None
    Ts, Td = _normalizer(src), _normalizer(dst)
    sn = src @ Ts[:2, :2].T + Ts[:2, 2]
    dn = dst @ Td[:2, :2].T + Td[:2, 2]
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2], A[0::2, 2] = sn, 1.0
    A[0::2, 6:8], A[0::2, 8] = -dn[:, :1] * sn, -dn[:, 0]
    A[1::2, 3:5], A[1::2, 5] = sn, 1.0
    A[1::2, 6:8], A[1::2, 8] = -dn[:, 1:] * sn, -dn[:, 1]
    Hn = np.linalg.svd(A)[2][-1].reshape(3, 3)
    H = np.linalg.solve(Td, Hn @ Ts)
    if not np.all(np.isfinite(H)) or abs(H[2, 2]) < 1e-300:
        return None
    H = H / H[2, 2]
    h = _lm(H.reshape(-1)[:8], _homography_residual(src, dst),
            lambda h, dh: h + dh, lambda h: h)
    return np.append(h, 1.0).reshape(3, 3)


def _pose_residual(obj, img):
    """Reprojection residual (2N,) of the pose (R, t), x ~ R X + t, and its
    Jacobian over the local increment (δθ, δt): R <- exp(δθ) R, t <- t + δt."""

    def fn(pose):
        R, t = pose
        pr = obj @ R.T                         # R X
        pc = pr + t
        z = pc[:, 2]
        u, v = pc[:, 0] / z, pc[:, 1] / z
        r = np.stack([u - img[:, 0], v - img[:, 1]], axis=1).reshape(-1)
        # d(u, v)/d(pc), then d(pc)/d(δθ) = -[R X]x and d(pc)/d(δt) = I.
        dproj = np.zeros((len(z), 2, 3))
        dproj[:, 0, 0] = dproj[:, 1, 1] = 1.0 / z
        dproj[:, 0, 2], dproj[:, 1, 2] = -u / z, -v / z
        skew = np.zeros((len(z), 3, 3))
        skew[:, 0, 1], skew[:, 0, 2] = pr[:, 2], -pr[:, 1]
        skew[:, 1, 0], skew[:, 1, 2] = -pr[:, 2], pr[:, 0]
        skew[:, 2, 0], skew[:, 2, 1] = pr[:, 1], -pr[:, 0]
        return r, np.concatenate([dproj @ skew, dproj], axis=2).reshape(-1, 6)

    return fn


def solve_pnp_planar(obj, img_norm):
    """Pose (rvec (3,), tvec (3,)) of a planar board from its (N, 3) points
    and their (N, 2) normalized image points (identity K, no distortion),
    x ~ R X + t. Raises ValueError when the points do not lie on one plane
    (OpenCV's test: the smallest singular value of the centered points
    below 1e-3 of the middle one); returns None when the board's homography
    cannot be found."""
    obj = np.asarray(obj, np.float64).reshape(-1, 3)
    img = np.asarray(img_norm, np.float64).reshape(-1, 2)
    mc = obj.mean(axis=0)
    _, w, vt = np.linalg.svd((obj - mc).T @ (obj - mc))
    if not w[2] < 1e-3 * w[1]:
        raise ValueError("solve_pnp_planar needs points on one plane")
    # The plane's frame: identity when the board already lies in z = const.
    Rp = np.eye(3) if vt[0, 2] ** 2 + vt[1, 2] ** 2 < 1e-10 else vt
    if np.linalg.det(Rp) < 0:
        Rp = -Rp
    Tp = -Rp @ mc
    mxy = (obj @ Rp.T + Tp)[:, :2]
    H = find_homography(mxy, img)
    if H is None:
        return None
    h1n, h2n = np.linalg.norm(H[:, 0]), np.linalg.norm(H[:, 1])
    h1, h2 = H[:, 0] / max(h1n, 1e-300), H[:, 1] / max(h2n, 1e-300)
    t = H[:, 2] * 2.0 / max(h1n + h2n, 1e-300)
    U, _, Vt = np.linalg.svd(np.stack([h1, h2, np.cross(h1, h2)], axis=1))
    Rh = U @ Vt
    if np.linalg.det(Rh) < 0:
        Rh = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    R, t = _lm((Rh @ Rp, Rh @ Tp + t), _pose_residual(obj, img),
               lambda x, d: (rodrigues(d[:3]) @ x[0], x[1] + d[3:]), lambda x: x[1])
    return gpl.rotation_to_angle_axis(R), t
