"""Visual-inertial alignment (host, numpy float64).

Mirror of src/frontend/initialization/initial_alignment.cpp:
* ``preintegrate_np``     — minimal midpoint preintegration (Δp, Δq, Δv +
  the dq/dbg Jacobian block) for the host-side all-frame records, matching
  IntegrationBase (integration_base.h:66-133) without covariance.
* ``solve_gyroscope_bias`` — rotation-matching least squares with the
  condition-number guard and ±0.05 rad/s clamp (:10-66).
* ``linear_alignment``     — per-frame-pair 6x10 blocks solving velocities +
  gravity + scale with the x100 scale conditioning and x1000 system scaling,
  plus g-norm/scale sanity (:154-240).
* ``refine_gravity``       — 4 iterations of 2-dof tangent-basis refinement
  (:84-150).
"""

from __future__ import annotations

import numpy as np

from mobile_slam_tpu_torch.init import np_geometry as g


class NpPreintegration:
    """Host preintegration record for one inter-frame interval."""

    def __init__(self, acc0, gyr0, dt, acc, gyr):
        self.acc0 = np.asarray(acc0, float)
        self.gyr0 = np.asarray(gyr0, float)
        self.dt = np.asarray(dt, float)
        self.acc = np.asarray(acc, float).reshape(-1, 3)
        self.gyr = np.asarray(gyr, float).reshape(-1, 3)
        self.repropagate(np.zeros(3), np.zeros(3))

    def repropagate(self, ba, bg):
        # Linearization biases are recorded so a later bias solve can
        # express its correction RELATIVE to them (solve_gyroscope_bias).
        self.ba_lin = np.asarray(ba, float).copy()
        self.bg_lin = np.asarray(bg, float).copy()
        dp = np.zeros(3)
        dq = np.array([1.0, 0, 0, 0])
        dv = np.zeros(3)
        jac_q_bg = np.zeros((3, 3))
        a0, g0 = self.acc0.copy(), self.gyr0.copy()
        sum_dt = 0.0
        for k in range(len(self.dt)):
            dt = self.dt[k]
            a1, g1 = self.acc[k], self.gyr[k]
            un_gyr = 0.5 * (g0 + g1) - bg
            R0 = g.quat_to_rot(dq)
            dq_new = g.quat_mul(dq, np.concatenate([[1.0], un_gyr * dt / 2]))
            dq_new = dq_new / np.linalg.norm(dq_new)
            R1 = g.quat_to_rot(dq_new)
            un_acc = 0.5 * (R0 @ (a0 - ba) + R1 @ (a1 - ba))
            dp = dp + dv * dt + 0.5 * un_acc * dt * dt
            dv = dv + un_acc * dt
            # dθ/dbg recursion: J <- (I - [w]x dt) J - I dt.
            jac_q_bg = (np.eye(3) - g.skew(un_gyr) * dt) @ jac_q_bg \
                - np.eye(3) * dt
            dq = dq_new
            sum_dt += dt
            a0, g0 = a1, g1
        self.delta_p = dp
        self.delta_q = dq
        self.delta_v = dv
        self.jac_q_bg = jac_q_bg
        self.sum_dt = sum_dt


class HostFrame:
    """Host mirror of common::ImageFrame (include/common/image_frame.h)."""

    __slots__ = ("ts", "points", "pre", "R", "T", "is_key_frame")

    def __init__(self, ts, points, pre):
        self.ts = ts
        self.points = points      # dict fid -> ray (3,)
        self.pre = pre            # NpPreintegration or None (first frame)
        self.R = np.eye(3)        # body rotation (world-from-imu)
        self.T = np.zeros(3)      # CAMERA position (VINS convention)
        self.is_key_frame = False


def check_imu_excitation(frames, threshold=0.25):
    """std of per-interval mean acceleration (Δv/Δt) must exceed threshold
    (initializer.cpp:47-129)."""
    gs = []
    for f in frames[1:]:
        if f.pre is not None and f.pre.sum_dt > 0:
            gs.append(f.pre.delta_v / f.pre.sum_dt)
    if len(gs) <= 1:
        return False
    gs = np.asarray(gs)
    aver = gs.mean(axis=0)
    var = np.sum((gs - aver) ** 2) / (len(gs) - 1)
    return np.sqrt(var) >= threshold


def solve_gyroscope_bias(frames):
    """Returns the ABSOLUTE gyro-bias estimate (clamped flag set when it
    is implausibly large); repropagates every frame's preintegration with
    it (initial_alignment.cpp:10-66).

    Two state-leak subtleties the reference never faces (it re-creates
    all_image_frame per run; our HostFrame preintegrations persist across
    init ATTEMPTS):

    * The LS solves a CORRECTION relative to the preintegrations' current
      linearization bias (jac_q_bg is evaluated there) — after a previous
      attempt repropagated them, treating the correction as absolute
      poisons the bias by the previous attempt's value. Observed on the
      noiseless EuRoC e2e: a rejected first attempt left bg=+0.05 behind,
      the second attempt solved -0.045 "absolute", and tracking started
      with a 2.6 deg/s orientation-rate error that ran away into a reset
      at frame 60.
    * A REJECTED (clamped) attempt must not mutate the shared
      preintegrations at all — the rejection exists precisely because its
      estimate is garbage.
    """
    A = np.zeros((3, 3))
    b = np.zeros(3)
    bg_lin = np.zeros(3)
    for fi, fj in zip(frames[:-1], frames[1:]):
        if fj.pre is None:
            continue
        bg_lin = getattr(fj.pre, "bg_lin", bg_lin)
        q_ij = g.rot_to_quat(fi.R.T @ fj.R)
        tmp_A = fj.pre.jac_q_bg
        dq_inv = fj.pre.delta_q * np.array([1.0, -1, -1, -1])
        tmp_b = 2.0 * g.quat_mul(dq_inv, q_ij)[1:4]
        A += tmp_A.T @ tmp_A
        b += tmp_A.T @ tmp_b
    sv = np.linalg.svd(A, compute_uv=False)
    cond = sv[0] / max(sv[2], 1e-30)
    if cond > 1e10 or not np.isfinite(cond):
        delta = np.zeros(3)
    else:
        delta = np.linalg.solve(A, b)
    bg_new = bg_lin + delta
    clamped = bool(np.any(np.abs(bg_new) > 0.05))
    if clamped:
        return np.clip(bg_new, -0.05, 0.05), True
    for fj in frames[1:]:
        if fj.pre is not None:
            fj.pre.repropagate(np.zeros(3), bg_new)
    return bg_new, clamped


def _tangent_basis(g0):
    a = g0 / np.linalg.norm(g0)
    tmp = np.array([0.0, 0, 1])
    if np.allclose(a, tmp):
        tmp = np.array([1.0, 0, 0])
    b = tmp - a * (a @ tmp)
    b /= np.linalg.norm(b)
    c = np.cross(a, b)
    return np.stack([b, c], axis=1)


def refine_gravity(frames, gvec, g_norm, t_ic):
    """4-iteration 2-dof gravity refinement (initial_alignment.cpp:84-150)."""
    g0 = gvec / np.linalg.norm(gvec) * g_norm
    n = len(frames)
    n_state = n * 3 + 2 + 1
    x = None
    for _ in range(4):
        lxly = _tangent_basis(g0)
        A = np.zeros((n_state, n_state))
        b = np.zeros(n_state)
        for i, (fi, fj) in enumerate(zip(frames[:-1], frames[1:])):
            dt = fj.pre.sum_dt
            tmp_A = np.zeros((6, 9))
            tmp_b = np.zeros(6)
            tmp_A[0:3, 0:3] = -dt * np.eye(3)
            tmp_A[0:3, 6:8] = fi.R.T @ (dt * dt / 2 * np.eye(3)) @ lxly
            tmp_A[0:3, 8] = fi.R.T @ (fj.T - fi.T) / 100.0
            tmp_b[0:3] = (fj.pre.delta_p + fi.R.T @ fj.R @ t_ic - t_ic
                          - fi.R.T @ (dt * dt / 2 * g0))
            tmp_A[3:6, 0:3] = -np.eye(3)
            tmp_A[3:6, 3:6] = fi.R.T @ fj.R
            tmp_A[3:6, 6:8] = fi.R.T @ (dt * np.eye(3)) @ lxly
            tmp_b[3:6] = fj.pre.delta_v - fi.R.T @ (dt * g0)

            rA = tmp_A.T @ tmp_A
            rb = tmp_A.T @ tmp_b
            A[i * 3:i * 3 + 6, i * 3:i * 3 + 6] += rA[:6, :6]
            b[i * 3:i * 3 + 6] += rb[:6]
            A[-3:, -3:] += rA[-3:, -3:]
            b[-3:] += rb[-3:]
            A[i * 3:i * 3 + 6, -3:] += rA[:6, -3:]
            A[-3:, i * 3:i * 3 + 6] += rA[-3:, :6]
        A *= 1000.0
        b *= 1000.0
        x = np.linalg.solve(A, b)
        dg = x[-3:-1]
        g0 = (g0 + lxly @ dg)
        g0 = g0 / np.linalg.norm(g0) * g_norm
    return g0, x


# Scale-observability gate threshold (see the in-function comment): the
# relative marginal sigma of the scale state above which an init attempt
# is rejected. None disables. Telemetry of the last attempt is kept in
# last_scale_rel_sigma (probe: scripts/dev_scale_observability.py).
SCALE_REL_SIGMA_MAX: float | None = None
last_scale_rel_sigma: float = float("nan")


def linear_alignment(frames, g_norm, t_ic):
    """Velocities + gravity + scale LS (initial_alignment.cpp:154-240).
    Returns (ok, gvec, x) with x = [v_0..v_{n-1} (body frames), g_refine(2),
    s] — after refinement the last entry is the metric scale."""
    n = len(frames)
    n_state = n * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    for i, (fi, fj) in enumerate(zip(frames[:-1], frames[1:])):
        dt = fj.pre.sum_dt
        tmp_A = np.zeros((6, 10))
        tmp_b = np.zeros(6)
        tmp_A[0:3, 0:3] = -dt * np.eye(3)
        tmp_A[0:3, 6:9] = fi.R.T @ (dt * dt / 2 * np.eye(3))
        tmp_A[0:3, 9] = fi.R.T @ (fj.T - fi.T) / 100.0
        tmp_b[0:3] = fj.pre.delta_p + fi.R.T @ fj.R @ t_ic - t_ic
        tmp_A[3:6, 0:3] = -np.eye(3)
        tmp_A[3:6, 3:6] = fi.R.T @ fj.R
        tmp_A[3:6, 6:9] = fi.R.T @ (dt * np.eye(3))
        tmp_b[3:6] = fj.pre.delta_v

        rA = tmp_A.T @ tmp_A
        rb = tmp_A.T @ tmp_b
        A[i * 3:i * 3 + 6, i * 3:i * 3 + 6] += rA[:6, :6]
        b[i * 3:i * 3 + 6] += rb[:6]
        A[-4:, -4:] += rA[-4:, -4:]
        b[-4:] += rb[-4:]
        A[i * 3:i * 3 + 6, -4:] += rA[:6, -4:]
        A[-4:, i * 3:i * 3 + 6] += rA[-4:, :6]
    A *= 1000.0
    b *= 1000.0
    try:
        x = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return False, None, None
    if not np.all(np.isfinite(x)):
        return False, None, None
    s = x[-1] / 100.0
    gvec = x[-4:-1]
    if abs(np.linalg.norm(gvec) - g_norm) > 2.5 or s < 0:
        return False, None, None
    # Scale-observability telemetry (beyond the reference, which accepts
    # any s > 0 with a sane |g|): the marginal standard deviation of the
    # scale state relative to its estimate, from the unwhitened normal
    # matrix — a comparative degeneracy signal for init-quality probing.
    # The optional gate (SCALE_REL_SIGMA_MAX) is OFF by default: measured
    # values do not cleanly separate good from bad windows (a
    # well-conditioned window can still produce a bad init through other
    # paths, e.g. the bias state-leak fixed in solve_gyroscope_bias).
    global last_scale_rel_sigma
    try:
        # A is unwhitened and can be numerically indefinite; a negative
        # marginal variance means "unmeasurable", not an error.
        var_s = float(np.linalg.inv(A)[-1, -1])
        sigma_s = float(np.sqrt(var_s)) if var_s > 0 else float("inf")
        last_scale_rel_sigma = sigma_s / max(abs(float(x[-1])), 1e-9)
    except np.linalg.LinAlgError:
        last_scale_rel_sigma = float("inf")
    if (SCALE_REL_SIGMA_MAX is not None
            and last_scale_rel_sigma > SCALE_REL_SIGMA_MAX):
        return False, None, None
    gvec, x = refine_gravity(frames, gvec, g_norm, t_ic)
    s = x[-1] / 100.0
    x[-1] = s
    if s < 0:
        return False, None, None
    return True, gvec, x


def visual_imu_alignment(frames, g_norm, t_ic):
    """VisualIMUAlignment (initial_alignment.cpp:242-249). Returns
    (ok, delta_bg, gvec, x).

    Deviation from the reference: a gyro-bias estimate that hits the
    ±0.05 rad/s clamp indicates garbage SfM rotations; instead of clamping
    and proceeding (which poisons the whole alignment), the attempt is
    rejected so a later, better-conditioned window can initialize."""
    delta_bg, clamped = solve_gyroscope_bias(frames)
    if clamped:
        return False, delta_bg, None, None
    ok, gvec, x = linear_alignment(frames, g_norm, t_ic)
    return ok, delta_bg, gvec, x
