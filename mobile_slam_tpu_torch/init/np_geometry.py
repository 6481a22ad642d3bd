"""Host-side (numpy, float64) geometry kernels for one-time initialization.

Initialization is the cold path (runs once per session / reset), so it runs
on host in double precision, mirroring the reference's design where the
init pipeline is CPU-side OpenCV+Ceres
(src/frontend/initialization/solve_5pts.cpp, initial_sfm.cpp).

Self-contained replacements for the OpenCV calls the reference uses:
* ``solve_relative_rt``  — cv::findEssentialMat(RANSAC) + cv::recoverPose
  (solve_5pts.cpp:7-43), built on the normalized 8-point algorithm with
  cheirality-based disambiguation.
* ``triangulate_point``  — the 4x4 DLT SVD (initial_sfm.cpp:8-20).
* ``solve_pnp``          — cv::solvePnP with K = I (initial_sfm.cpp:22-66):
  DLT initialization + Gauss-Newton refinement on SE(3).
"""

from __future__ import annotations

import numpy as np


def quat_to_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rot_to_quat(R):
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = np.argmax(np.diag(R))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3) + skew(w)
    k = w / th
    K = skew(k)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


# ---------------------------------------------------------------------------
# Essential matrix + relative pose
# ---------------------------------------------------------------------------

def _essential_8pt(p1, p2):
    """E from >=8 normalized-image-plane correspondences (N,2)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                  x1, y1, np.ones_like(x1)], axis=-1)
    _, _, vt = np.linalg.svd(A, full_matrices=False)
    E = vt[-1].reshape(3, 3)
    u, s, vt = np.linalg.svd(E)
    # Project onto the essential manifold (two equal singular values).
    return u @ np.diag([1.0, 1.0, 0.0]) @ vt


# Monomial order for the Stewenius 5-point action matrix: the 10 degree-3
# monomials first (eliminated), then the 10-dim quotient basis.
_MONO3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
          (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_MONO_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
               (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]

# Coefficient recovery by interpolation: each of the ten constraint
# polynomials is a cubic form in (x, y, z) with 20 unknown monomial
# coefficients; evaluating all ten at 20 fixed generic sample points and
# solving against the (precomputed) monomial Vandermonde recovers the
# coefficient matrix with batched 3x3 numpy ops instead of symbolic
# polynomial expansion (~50x faster per hypothesis).
_S_RNG = np.random.default_rng(20260821)
_SAMPLES = _S_RNG.normal(size=(20, 3))
_VAND = np.stack([
    np.prod(_SAMPLES ** np.asarray(m), axis=1)
    for m in _MONO3 + _MONO_BASIS], axis=1)        # (20 points, 20 monos)
_VAND_INV = np.linalg.inv(_VAND)


def _essential_5pt_candidates(p1, p2):
    """Essential-matrix candidates from exactly >=5 correspondences
    (Stewenius et al., "Recent developments on direct relative
    orientation"): nullspace basis E = x E1 + y E2 + z E3 + E4, the ten
    cubic constraints det(E)=0 and 2 E E^T E - tr(E E^T) E = 0 reduced by
    Gauss-Jordan to a 10x10 action matrix whose real eigenvectors give
    (x, y, z). Returns a list of up to 10 (3,3) candidates. This is the
    reference's bootstrap solver family (cv::findEssentialMat 5-point,
    solve_5pts.cpp:7-43) — the 8-point fallback is degenerate on planar
    scenes (see scripts/dev_5pt_ab.py)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                  x1, y1, np.ones_like(x1)], axis=-1)
    _, _, vt = np.linalg.svd(A, full_matrices=A.shape[0] < 9)
    basis = vt[-4:][::-1]  # E1..E4; E4 = smallest singular vector
    Es = np.stack([b.reshape(3, 3) for b in basis])  # (4, 3, 3)

    # Evaluate the ten cubic constraints det(E)=0 and
    # 2 E E^T E - tr(E E^T) E = 0 at the fixed sample points (batched),
    # then recover all monomial coefficients through the Vandermonde.
    xyz1 = np.concatenate([_SAMPLES, np.ones((20, 1))], axis=1)  # (20, 4)
    Esamp = np.einsum("sk,kij->sij", xyz1, Es)                   # (20, 3, 3)
    dets = np.linalg.det(Esamp)                                  # (20,)
    EEt = Esamp @ np.transpose(Esamp, (0, 2, 1))                 # (20, 3, 3)
    tr = np.trace(EEt, axis1=1, axis2=2)
    G = 2.0 * EEt @ Esamp - tr[:, None, None] * Esamp            # (20, 3, 3)
    vals = np.concatenate([dets[:, None], G.reshape(20, 9)], axis=1)
    M = (_VAND_INV @ vals).T                                     # (10, 20)

    A1, A2 = M[:, :10], M[:, 10:]
    try:
        B = np.linalg.solve(A1, A2)
    except np.linalg.LinAlgError:
        return []

    # Action matrix for multiplication by x on the quotient basis.
    act = np.zeros((10, 10))
    act[0] = -B[0]   # x*x^2  = x^3
    act[1] = -B[1]   # x*xy   = x^2 y
    act[2] = -B[2]   # x*xz   = x^2 z
    act[3] = -B[3]   # x*y^2  = x y^2
    act[4] = -B[4]   # x*yz   = x y z
    act[5] = -B[5]   # x*z^2  = x z^2
    act[6][0] = 1.0  # x*x    = x^2
    act[7][1] = 1.0  # x*y    = x y
    act[8][2] = 1.0  # x*z    = x z
    act[9][6] = 1.0  # x*1    = x
    try:
        w, v = np.linalg.eig(act)
    except np.linalg.LinAlgError:
        return []

    out = []
    for i in range(10):
        if abs(w[i].imag) > 1e-8:
            continue
        vec = v[:, i].real
        if abs(vec[9]) < 1e-12:
            continue
        x, y, z = vec[6] / vec[9], vec[7] / vec[9], vec[8] / vec[9]
        E = x * Es[0] + y * Es[1] + z * Es[2] + Es[3]
        n = np.linalg.norm(E)
        if n > 1e-12 and np.isfinite(n):
            out.append(E / n)
    return out


def _epipolar_dist(E, p1, p2):
    h1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=1)
    h2 = np.concatenate([p2, np.ones((len(p2), 1))], axis=1)
    l2 = h1 @ E.T
    l1 = h2 @ E
    d2 = np.abs(np.sum(l2 * h2, axis=1)) / np.maximum(
        np.linalg.norm(l2[:, :2], axis=1), 1e-12)
    d1 = np.abs(np.sum(l1 * h1, axis=1)) / np.maximum(
        np.linalg.norm(l1[:, :2], axis=1), 1e-12)
    return np.maximum(d1, d2)


def triangulate_point(pose0, pose1, p0, p1):
    """Two-view DLT (initial_sfm.cpp:8-20). pose = (3,4) [R|t] cam-from-world;
    p = (2,) normalized image coords. Returns (3,) world point."""
    A = np.empty((4, 4))
    A[0] = p0[0] * pose0[2] - pose0[0]
    A[1] = p0[1] * pose0[2] - pose0[1]
    A[2] = p1[0] * pose1[2] - pose1[0]
    A[3] = p1[1] * pose1[2] - pose1[1]
    _, _, vt = np.linalg.svd(A)
    X = vt[-1]
    return X[:3] / X[3]


def solve_relative_rt(corres, threshold_focal: float = 460.0,
                      seed: int = 0, method: str = "5pt"):
    """Relative pose from normalized-plane correspondences
    (MotionEstimator::solveRelativeRT, solve_5pts.cpp:7-43): RANSAC
    essential (threshold 1/focal, 0.99-confidence adaptive budget) +
    cheirality pose recovery. corres: list of (ray_i (3,), ray_j (3,)).

    method="5pt" (default, the reference's solver family): Stewenius
    minimal solver, up to 10 candidates per 5-sample, refit by re-solving
    on inlier subsamples. method="8pt": normalized 8-point + linear
    inlier refit — cheaper per hypothesis but DEGENERATE on planar scenes
    and starved at minimal correspondence counts (the A/B that forced the
    default flip: scripts/dev_5pt_ab.py / artifacts/ab_5pt_r5.json —
    planar tdir error 70 deg median, success 0.03-0.13 at 16 corres).

    Returns (ok, R, t) with the reference's output convention: R, t map
    frame-j points into frame-i (R = R_ij^T applied as in solve_5pts.cpp's
    final transpose — here directly the i<-j rotation)."""
    if len(corres) < 15:
        return False, None, None
    p1 = np.asarray([c[0][:2] / c[0][2] for c in corres])
    p2 = np.asarray([c[1][:2] / c[1][2] for c in corres])
    n = len(p1)
    # Adaptive RANSAC threshold ~1px in normalized coords (solve_5pts.cpp:17-19),
    # scaled per-point by the local pixel->normalized-plane Jacobian
    # (1 + r^2)/f so wide-FOV edge features are judged in pixel units rather
    # than dominating the normalized-coordinate metric.
    base = 1.0 / threshold_focal if threshold_focal > 0 else 0.003
    r2 = np.minimum(np.sum(p1 * p1, axis=1), np.sum(p2 * p2, axis=1))
    thresh = base * (1.0 + r2)

    rng = np.random.default_rng(seed)
    k = 5 if method == "5pt" else 8

    def hypotheses(idx):
        if method == "5pt":
            return _essential_5pt_candidates(p1[idx], p2[idx])
        return [_essential_8pt(p1[idx], p2[idx])]

    # Hypotheses are ranked by (inlier count, truncated-error score): at
    # low noise most candidates saturate the count, and keeping the first
    # one found leaves an arbitrary-quality E (planar tdir error ~20 deg
    # median in the A/B); the truncated mean error (MSAC-style) breaks the
    # ties by actual fit quality.
    best_inl = None
    best_cnt = -1
    best_score = np.inf
    best_E = None
    max_iters = 200
    it = 0

    def consider(E):
        nonlocal best_inl, best_cnt, best_score, best_E, max_iters
        d = _epipolar_dist(E, p1, p2)
        inl = d < thresh
        cnt = int(inl.sum())
        score = float(np.minimum(d / thresh, 1.0).sum())
        if cnt > best_cnt or (cnt == best_cnt and score < best_score):
            best_cnt, best_score, best_inl, best_E = cnt, score, inl, E
            return True
        return False

    while it < max_iters:
        idx = rng.choice(n, k, replace=False)
        for E in hypotheses(idx):
            if consider(E):
                # 0.99-confidence adaptive budget (RANSAC standard), with
                # a floor of 48 samples: once the inlier count saturates
                # (clean data) the winner is chosen by the truncated-error
                # score, and collapsing to ~16 samples starves that
                # contest of diversity (observed as 2-8 deg seed-rotation
                # scatter on narrow-FOV EuRoC init windows, enough to send
                # the e2e run through a reset).
                ratio = best_cnt / n
                if ratio > 0.999:
                    max_iters = min(max_iters, max(it + 16, 48))
                elif ratio > 0:
                    need = np.log(0.01) / np.log(
                        max(1.0 - ratio ** k, 1e-12))
                    max_iters = min(max_iters,
                                    max(it + 1 + int(np.ceil(need)), 48))
        it += 1
    if best_cnt < 12 or best_E is None:
        return False, None, None
    inl = best_inl
    if method == "5pt":
        # Refit: minimal re-solves on inlier subsamples (an 8-point linear
        # refit here would re-introduce the planar degeneracy).
        inl_idx = np.where(best_inl)[0]
        for r in range(15):
            if len(inl_idx) < 5:
                break
            # Alternate minimal and least-squares draws: with N>5 points
            # the same solver runs on the 4 smallest singular vectors (the
            # LS nullspace), which averages noise down — the cubic
            # constraints still enforce essential structure, so this does
            # NOT re-introduce the 8-point planar degeneracy.
            m = 5 if r % 2 == 0 else min(10, len(inl_idx))
            sub = rng.choice(inl_idx, m, replace=False)
            for Ec in hypotheses(sub):
                if consider(Ec):
                    inl_idx = np.where(best_inl)[0]
        E, inl = best_E, best_inl
    else:
        # Two linear refit passes on the inlier set.
        for _ in range(2):
            E = _essential_8pt(p1[inl], p2[inl])
            new_inl = _epipolar_dist(E, p1, p2) < thresh
            if new_inl.sum() < 8:
                break
            inl = new_inl

    # Pose recovery with cheirality test (cv::recoverPose equivalent).
    u, _, vt = np.linalg.svd(E)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    candidates = []
    for R2 in (u @ W @ vt, u @ W.T @ vt):
        for t2 in (u[:, 2], -u[:, 2]):
            candidates.append((R2, t2))

    def count_front(R2, t2):
        # Camera 1 at identity; camera 2 = [R2 | t2] (cam2-from-cam1).
        P0 = np.hstack([np.eye(3), np.zeros((3, 1))])
        P1 = np.hstack([R2, t2[:, None]])
        cnt = 0
        for a, b in zip(p1[inl], p2[inl]):
            X = triangulate_point(P0, P1, a, b)
            z1 = X[2]
            z2 = (R2 @ X + t2)[2]
            if z1 > 0 and z2 > 0:
                cnt += 1
        return cnt

    counts = [count_front(R2, t2) for R2, t2 in candidates]
    R21, t21 = candidates[int(np.argmax(counts))]
    if max(counts) < max(8, 0.5 * inl.sum()):
        return False, None, None
    if inl.sum() <= 12:
        return False, None, None
    # Convention per solve_5pts.cpp:30-41: return R = R21^T, T = -R21^T t21
    # (the transform of frame-j coordinates into frame-i).
    R = R21.T
    T = -R21.T @ t21
    return True, R, T


def solve_relative_rt_5pt(corres, threshold_focal: float = 460.0,
                          seed: int = 0):
    """Explicit 5-point arm (A/B harness: scripts/dev_5pt_ab.py)."""
    return solve_relative_rt(corres, threshold_focal, seed, method="5pt")


def solve_relative_rt_8pt(corres, threshold_focal: float = 460.0,
                          seed: int = 0):
    """Explicit 8-point arm (A/B harness: scripts/dev_5pt_ab.py)."""
    return solve_relative_rt(corres, threshold_focal, seed, method="8pt")


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def solve_pnp(pts3d, pts2d, R_init=None, t_init=None, iters=10):
    """Minimal PnP on normalized coordinates (K = I): optional DLT init,
    Gauss-Newton refinement of the cam-from-world pose. Returns
    (ok, R_cw, t_cw)."""
    pts3d = np.asarray(pts3d, float)
    pts2d = np.asarray(pts2d, float)
    n = len(pts3d)
    if n < 6:
        return False, None, None

    if R_init is None:
        # DLT for P = [R|t] up to scale.
        A = np.zeros((2 * n, 12))
        for i, (X, x) in enumerate(zip(pts3d, pts2d)):
            Xh = np.append(X, 1.0)
            A[2 * i, 0:4] = Xh
            A[2 * i, 8:12] = -x[0] * Xh
            A[2 * i + 1, 4:8] = Xh
            A[2 * i + 1, 8:12] = -x[1] * Xh
        _, _, vt = np.linalg.svd(A)
        P = vt[-1].reshape(3, 4)
        Rr = P[:, :3]
        u, s, vt2 = np.linalg.svd(Rr)
        R = u @ vt2
        if np.linalg.det(R) < 0:
            R = -R
            P = -P
            u, s, vt2 = np.linalg.svd(-Rr)
        scale = np.mean(s)
        t = P[:, 3] / scale
        # Cheirality fix.
        z = (pts3d @ R.T + t)[:, 2]
        if np.median(z) < 0:
            return False, None, None
    else:
        R, t = R_init.copy(), t_init.copy()

    for _ in range(iters):
        pc = pts3d @ R.T + t
        z = pc[:, 2]
        z = np.where(np.abs(z) < 1e-8, 1e-8, z)
        proj = pc[:, :2] / z[:, None]
        r = (proj - pts2d).reshape(-1)
        # Jacobian wrt (δθ (right-perturbation R·exp(δθ)), δt).
        J = np.zeros((2 * n, 6))
        inv_z = 1.0 / z
        x, y = pc[:, 0], pc[:, 1]
        # d proj / d pc
        dp = np.zeros((n, 2, 3))
        dp[:, 0, 0] = inv_z
        dp[:, 0, 2] = -x * inv_z * inv_z
        dp[:, 1, 1] = inv_z
        dp[:, 1, 2] = -y * inv_z * inv_z
        # d pc / dδθ = -R [X]x ; d pc / dδt = I
        for i in range(n):
            J[2 * i:2 * i + 2, 0:3] = dp[i] @ (-R @ skew(pts3d[i]))
            J[2 * i:2 * i + 2, 3:6] = dp[i]
        H = J.T @ J + 1e-9 * np.eye(6)
        g = J.T @ r
        try:
            delta = -np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            return False, None, None
        R = R @ exp_so3(delta[0:3])
        t = t + delta[3:6]
        if np.linalg.norm(delta) < 1e-10:
            break
    if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
        return False, None, None
    return True, R, t
