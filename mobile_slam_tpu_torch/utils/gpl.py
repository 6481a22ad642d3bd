"""General-purpose calibration-support geometry (gpl), the port's numpy
copy of mobile_slam_tpu.utils.gpl.

Host-side equivalents of the reference's gpl utility library
(include/common/gpl/gpl.h, src/common/gpl/gpl.cc): angle helpers,
rasterization (Bresenham line/circle), circle fitting/intersection for
the calibration-target geometry, and WGS84 lat-lon <-> UTM conversion
used by odometry/georeferencing tooling. None of this is estimator
hot-path, so it is plain numpy (device dispatch of scalar math would be
pure overhead); the hot-path math lives in utils/rotations.py and ops/.
"""

from __future__ import annotations

import math

import numpy as np

# WGS84 ellipsoid (gpl.cc LLtoUTM constants).
_WGS84_A = 6378137.0
_WGS84_ECC_SQ = 0.00669438
_UTM_K0 = 0.9996


def clamp(v, lo, hi):
    """gpl.h clamp."""
    return min(max(v, lo), hi)


def hypot3(x: float, y: float, z: float) -> float:
    """sqrt(x^2+y^2+z^2) (gpl.h hypot3)."""
    return math.sqrt(x * x + y * y + z * z)


def normalize_theta(theta: float) -> float:
    """Wrap an angle to (-pi, pi] (gpl.h normalizeTheta)."""
    return math.atan2(math.sin(theta), math.cos(theta))


def d2r(deg: float) -> float:
    return deg * math.pi / 180.0


def r2d(rad: float) -> float:
    return rad * 180.0 / math.pi


def sinc(theta: float) -> float:
    """sin(x)/x with the removable singularity handled (gpl.h sinc)."""
    if abs(theta) < 1e-10:
        return 1.0
    return math.sin(theta) / theta


def bres_line(x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """Integer points of the Bresenham segment, (N, 2) int32 [x, y]
    (gpl.cc bresLine)."""
    dx = abs(x1 - x0)
    dy = abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    pts = []
    x, y = x0, y0
    while True:
        pts.append((x, y))
        if x == x1 and y == y1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x += sx
        if e2 < dx:
            err += dx
            y += sy
    return np.asarray(pts, np.int32)


def bres_circle(x0: int, y0: int, r: int) -> np.ndarray:
    """Integer points of the Bresenham (midpoint) circle, (N, 2) int32
    (gpl.cc bresCircle). Deduplicated, unordered."""
    x, y, err = r, 0, 1 - r
    pts = set()
    while x >= y:
        for dx, dy in ((x, y), (y, x), (-y, x), (-x, y),
                       (-x, -y), (-y, -x), (y, -x), (x, -y)):
            pts.add((x0 + dx, y0 + dy))
        y += 1
        if err < 0:
            err += 2 * y + 1
        else:
            x -= 1
            err += 2 * (y - x) + 1
    return np.asarray(sorted(pts), np.int32)


def fit_circle(points: np.ndarray) -> tuple[float, float, float]:
    """Least-squares circle fit (Kasa linearization, gpl.cc fitCircle):
    minimizes sum((x-cx)^2 + (y-cy)^2 - r^2)^2 which is linear in
    (2cx, 2cy, r^2 - cx^2 - cy^2). Returns (cx, cy, r)."""
    p = np.asarray(points, np.float64)
    A = np.column_stack([2.0 * p[:, 0], 2.0 * p[:, 1], np.ones(len(p))])
    b = p[:, 0] ** 2 + p[:, 1] ** 2
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    cx, cy, c = sol
    r = math.sqrt(max(c + cx * cx + cy * cy, 0.0))
    return float(cx), float(cy), float(r)


def intersect_circles(x1, y1, r1, x2, y2, r2) -> np.ndarray:
    """Intersection points of two circles, (0|1|2, 2) float64
    (gpl.cc intersectCircles)."""
    d = math.hypot(x2 - x1, y2 - y1)
    if d > r1 + r2 or d < abs(r1 - r2) or d == 0.0:
        return np.zeros((0, 2))
    a = (r1 * r1 - r2 * r2 + d * d) / (2.0 * d)
    h2 = r1 * r1 - a * a
    xm = x1 + a * (x2 - x1) / d
    ym = y1 + a * (y2 - y1) / d
    if h2 <= 0.0:
        return np.asarray([[xm, ym]])
    h = math.sqrt(h2)
    rx = -h * (y2 - y1) / d
    ry = h * (x2 - x1) / d
    return np.asarray([[xm + rx, ym + ry], [xm - rx, ym - ry]])


def _utm_zone(lat: float, lon: float) -> str:
    zone = int((lon + 180.0) / 6.0) + 1
    if 56.0 <= lat < 64.0 and 3.0 <= lon < 12.0:
        zone = 32
    if 72.0 <= lat < 84.0:
        if 0.0 <= lon < 9.0:
            zone = 31
        elif 9.0 <= lon < 21.0:
            zone = 33
        elif 21.0 <= lon < 33.0:
            zone = 35
        elif 33.0 <= lon < 42.0:
            zone = 37
    letters = "CDEFGHJKLMNPQRSTUVWX"
    idx = clamp(int((lat + 80.0) / 8.0), 0, len(letters) - 1)
    return f"{zone}{letters[idx]}"


def ll_to_utm(lat: float, lon: float) -> tuple[float, float, str]:
    """WGS84 lat/lon (deg) -> (northing, easting, zone)
    (gpl.cc LLtoUTM; standard USGS series expansion)."""
    a = _WGS84_A
    e2 = _WGS84_ECC_SQ
    ep2 = e2 / (1.0 - e2)
    lon_norm = (lon + 180.0) - int((lon + 180.0) / 360.0) * 360.0 - 180.0
    zone_str = _utm_zone(lat, lon_norm)
    zone = int(zone_str[:-1])
    lon0 = (zone - 1) * 6.0 - 180.0 + 3.0

    phi = d2r(lat)
    lam = d2r(lon_norm)
    lam0 = d2r(lon0)

    N = a / math.sqrt(1.0 - e2 * math.sin(phi) ** 2)
    T = math.tan(phi) ** 2
    C = ep2 * math.cos(phi) ** 2
    A = math.cos(phi) * (lam - lam0)
    M = a * (
        (1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256) * phi
        - (3 * e2 / 8 + 3 * e2 ** 2 / 32 + 45 * e2 ** 3 / 1024)
        * math.sin(2 * phi)
        + (15 * e2 ** 2 / 256 + 45 * e2 ** 3 / 1024) * math.sin(4 * phi)
        - (35 * e2 ** 3 / 3072) * math.sin(6 * phi)
    )
    easting = _UTM_K0 * N * (
        A + (1 - T + C) * A ** 3 / 6
        + (5 - 18 * T + T * T + 72 * C - 58 * ep2) * A ** 5 / 120
    ) + 500000.0
    northing = _UTM_K0 * (
        M + N * math.tan(phi) * (
            A * A / 2 + (5 - T + 9 * C + 4 * C * C) * A ** 4 / 24
            + (61 - 58 * T + T * T + 600 * C - 330 * ep2) * A ** 6 / 720
        )
    )
    if lat < 0.0:
        northing += 10000000.0
    return northing, easting, zone_str


def utm_to_ll(northing: float, easting: float,
              zone: str) -> tuple[float, float]:
    """UTM -> WGS84 lat/lon (deg) (gpl.cc UTMtoLL)."""
    a = _WGS84_A
    e2 = _WGS84_ECC_SQ
    ep2 = e2 / (1.0 - e2)
    e1 = (1.0 - math.sqrt(1.0 - e2)) / (1.0 + math.sqrt(1.0 - e2))
    zone_num = int(zone[:-1])
    northern = zone[-1].upper() >= "N"
    y = northing if northern else northing - 10000000.0
    x = easting - 500000.0
    lon0 = d2r((zone_num - 1) * 6.0 - 180.0 + 3.0)

    M = y / _UTM_K0
    mu = M / (a * (1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256))
    phi1 = mu + (
        (3 * e1 / 2 - 27 * e1 ** 3 / 32) * math.sin(2 * mu)
        + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * math.sin(4 * mu)
        + (151 * e1 ** 3 / 96) * math.sin(6 * mu)
    )
    N1 = a / math.sqrt(1.0 - e2 * math.sin(phi1) ** 2)
    T1 = math.tan(phi1) ** 2
    C1 = ep2 * math.cos(phi1) ** 2
    R1 = a * (1.0 - e2) / (1.0 - e2 * math.sin(phi1) ** 2) ** 1.5
    D = x / (N1 * _UTM_K0)

    lat = phi1 - (N1 * math.tan(phi1) / R1) * (
        D * D / 2
        - (5 + 3 * T1 + 10 * C1 - 4 * C1 * C1 - 9 * ep2) * D ** 4 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1 * T1 - 252 * ep2
           - 3 * C1 * C1) * D ** 6 / 720
    )
    lon = lon0 + (
        D - (1 + 2 * T1 + C1) * D ** 3 / 6
        + (5 - 2 * C1 + 28 * T1 - 3 * C1 * C1 + 8 * ep2
           + 24 * T1 * T1) * D ** 5 / 120
    ) / math.cos(phi1)
    return r2d(lat), r2d(lon)


# ---------------------------------------------------------------------------
# EigenUtils analogs (include/common/gpl/EigenUtils.h) — host-side numpy.
# The quaternion/rotation hot-path versions live in utils/rotations.py
# (torch); these are the remaining generic geometry helpers the reference's
# calibration tooling uses.
# ---------------------------------------------------------------------------


def skew(v) -> np.ndarray:
    """3-vector -> 3x3 skew-symmetric matrix (EigenUtils.h:14)."""
    x, y, z = np.asarray(v, np.float64)
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def sqrtm_psd(A) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition
    (EigenUtils.h:19 operatorSqrt parity)."""
    A = np.asarray(A, np.float64)
    w, V = np.linalg.eigh(0.5 * (A + A.T))
    return (V * np.sqrt(np.clip(w, 0.0, None))[None, :]) @ V.T


def angle_axis_to_rotation(rvec) -> np.ndarray:
    """Rodrigues: rotation vector -> matrix (EigenUtils.h:26)."""
    rvec = np.asarray(rvec, np.float64)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3) + skew(rvec)
    k = rvec / theta
    K = skew(k)
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)


def rotation_to_angle_axis(R) -> np.ndarray:
    """Matrix -> rotation vector (EigenUtils.h:59)."""
    R = np.asarray(R, np.float64)
    q = _rotation_to_quat(R)
    return quat_to_angle_axis(q)


def angle_axis_to_quat(rvec) -> np.ndarray:
    """Rotation vector -> wxyz quaternion (EigenUtils.h:42)."""
    rvec = np.asarray(rvec, np.float64)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.concatenate([[1.0], 0.5 * rvec])
    axis = rvec / theta
    return np.concatenate([[math.cos(theta / 2)],
                           math.sin(theta / 2) * axis])


def quat_to_angle_axis(q) -> np.ndarray:
    """wxyz quaternion -> rotation vector (EigenUtils.h:66)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    sin_half = np.linalg.norm(q[1:])
    if sin_half < 1e-12:
        return 2.0 * q[1:]
    theta = 2.0 * math.atan2(sin_half, q[0])
    return theta * q[1:] / sin_half


def _rotation_to_quat(R) -> np.ndarray:
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diagonal(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def rpy_to_mat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Roll-pitch-yaw -> rotation matrix, Rz(yaw)Ry(pitch)Rx(roll)
    (EigenUtils.h:140 RPY2mat parity)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def mat_to_rpy(R) -> tuple[float, float, float]:
    """Rotation matrix -> (roll, pitch, yaw) (EigenUtils.h:163)."""
    R = np.asarray(R, np.float64)
    roll = math.atan2(R[2, 1], R[2, 2])
    pitch = math.atan2(-R[2, 0], math.hypot(R[2, 1], R[2, 2]))
    yaw = math.atan2(R[1, 0], R[0, 0])
    return roll, pitch, yaw


def homogeneous_transform(R, t) -> np.ndarray:
    """(R, t) -> 4x4 (EigenUtils.h:170)."""
    H = np.eye(4)
    H[:3, :3] = np.asarray(R, np.float64)
    H[:3, 3] = np.asarray(t, np.float64)
    return H


def pose_with_spherical_translation(q, p, scale: float = 1.0) -> np.ndarray:
    """4x4 pose with translation on the unit sphere parameterized by
    (theta, phi) — the hand-eye calibration's scale-free translation
    parameterization (EigenUtils.h:200)."""
    theta, phi = float(p[0]), float(p[1])
    R = angle_axis_to_rotation(quat_to_angle_axis(q))
    t = scale * np.array([math.sin(theta) * math.cos(phi),
                          math.sin(theta) * math.sin(phi),
                          math.cos(theta)])
    return homogeneous_transform(R, t)


def angle_axis_translation_to_screw(rvec, tvec):
    """Screw decomposition (theta, d, l, m) of a rigid motion
    (EigenUtils.h:116: rotation angle, translation along the axis, axis
    direction, axis moment)."""
    rvec = np.asarray(rvec, np.float64)
    tvec = np.asarray(tvec, np.float64)
    theta = float(np.linalg.norm(rvec))
    if theta == 0.0:
        return 0.0, 0.0, np.zeros(3), np.zeros(3)
    axis = rvec / theta
    d = float(tvec @ axis)
    c = 0.5 * (tvec - d * axis
               + np.cross(axis / math.tan(theta / 2.0), tvec))
    m = np.cross(c, axis)
    return theta, d, axis, m


def sampson_error(E, p1, p2) -> float:
    """First-order geometric (Sampson) error of an essential/fundamental
    matrix on a homogeneous point pair (EigenUtils.h:222)."""
    E = np.asarray(E, np.float64)
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    Ex1 = E @ p1
    Etx2 = E.T @ p2
    num = float(p2 @ Ex1) ** 2
    den = Ex1[0] ** 2 + Ex1[1] ** 2 + Etx2[0] ** 2 + Etx2[1] ** 2
    return num / den


def sampson_error_rt(R, t, p1, p2) -> float:
    """Sampson error of a rotation/translation pair: E = [t]x R
    (EigenUtils.h:236)."""
    return sampson_error(skew(t) @ np.asarray(R, np.float64), p1, p2)


def sampson_error_h(H, p1, p2) -> float:
    """Sampson error of a 4x4 rigid transform (EigenUtils.h:254)."""
    H = np.asarray(H, np.float64)
    return sampson_error_rt(H[:3, :3], H[:3, 3], p1, p2)


def transform_point(H, P) -> np.ndarray:
    """Apply a 4x4 rigid transform to a 3D point (EigenUtils.h:262)."""
    H = np.asarray(H, np.float64)
    return H[:3, :3] @ np.asarray(P, np.float64) + H[:3, 3]


def estimate_3d_rigid_transform(points1, points2) -> np.ndarray:
    """Kabsch: least-squares R,t with points2 ≈ R points1 + t
    (EigenUtils.h:269)."""
    X = np.asarray(points1, np.float64)
    Y = np.asarray(points2, np.float64)
    c1, c2 = X.mean(axis=0), Y.mean(axis=0)
    H = (X - c1).T @ (Y - c2)
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    if np.linalg.det(U) * np.linalg.det(V) < 0:
        V[:, 2] *= -1
    R = V @ U.T
    return homogeneous_transform(R, c2 - R @ c1)


def estimate_3d_similarity_transform(points1, points2) -> np.ndarray:
    """Umeyama with scale: points2 ≈ s R points1 + t (EigenUtils.h:310).
    The trajectory evaluator's umeyama_alignment is the batched production
    version; this is the 4x4 convenience form the reference tooling uses."""
    X = np.asarray(points1, np.float64)
    Y = np.asarray(points2, np.float64)
    c1, c2 = X.mean(axis=0), Y.mean(axis=0)
    Xc, Yc = X - c1, Y - c2
    H = Xc.T @ Yc
    U, S, Vt = np.linalg.svd(H)
    V = Vt.T
    d = np.ones(3)
    if np.linalg.det(U) * np.linalg.det(V) < 0:
        d[2] = -1
    R = V @ np.diag(d) @ U.T
    var1 = (Xc ** 2).sum() / len(X)
    s = float((S * d).sum() / (len(X) * var1))
    H4 = homogeneous_transform(s * R, c2 - s * R @ c1)
    return H4
