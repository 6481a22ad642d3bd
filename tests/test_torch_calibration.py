"""Camera calibration of the port against the JAX package's, float64 on the
CPU, and its OpenCV-free board geometry against OpenCV.

* ``cv_geometry`` against cv2 on seeded 9x6 boards, noise-free and with
  0.1 px of noise: ``find_homography`` against ``cv2.findHomography``
  (method 0, float32 points as the pinhole bootstrap hands them over),
  ``solve_pnp_planar`` against ``cv2.solvePnP`` (SOLVEPNP_ITERATIVE,
  identity K), ``rodrigues`` against ``cv2.Rodrigues``. OpenCV ends its
  Levenberg-Marquardt after 10 (homography) and 20 (pose) iterations at
  FLT_EPSILON; the port's runs to convergence. Bars: H within 1e-6
  relative, the pose within 1e-5 (rad, board units), and the port's cost
  never above OpenCV's (1e-12 relative); Rodrigues 1e-15.
* Every public function of ``calibration`` against the reference's on
  identical inputs (the reference tests' cameras and scenes): the
  ``refine_*`` loops and ``calibrate_camera_odometry`` at a few
  iterations, ``calibrate_from_board`` once per model at 3 joint
  iterations, pinhole at 10: its bootstrap starts from homographies that
  differ from cv2's by the above, 1e-7 relative, and an unconverged bundle
  carries that into the RMS (6e-6 relative after 3 iterations, 1e-9 after
  7, 6e-15 after 10). More iterations do not help Scaramuzza: its inverse
  polynomial is ill-conditioned, so two correct solvers part by rounding
  as the iterations grow (parameters 1e-10 after 3, 1e-7 after 10). Bars: parameters and poses within 1e-7 relative, RMS within 1e-9
  relative plus 1e-11 px (a fit of noise-free data ends near 0).
* The calibration bundle's Jacobian, in forward mode (the CPU's) and in
  reverse mode (the card's), against ``jax.jacfwd`` of the reference's
  residual at 1e-10.

Each reference computation runs once per file (module fixtures), with the
reference's lifts and projections compiled once per file: called eagerly,
each lift's ``fori_loop`` compiles again on every call (its body is a new
closure each time) and each projection dispatches operation by operation."""

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from tests._torch_parity import reference_compile_cache, t64  # noqa: F401
from tests.test_calibration_bootstrap import BOARD, _board_object_points, _render_views

from mobile_slam_tpu.models.cameras import calibration as jcal
from mobile_slam_tpu.models.cameras import equidistant as jeq, mei as jmei
from mobile_slam_tpu.models.cameras import pinhole as jpin, scaramuzza as jscara
from mobile_slam_tpu.utils import rotations as jrot
from mobile_slam_tpu_torch.models.cameras import calibration as cal, cv_geometry as cg

H_RTOL = 1e-6
POSE_TOL = 1e-5
PARAM_RTOL = 1e-7
RMS_RTOL = 1e-9
RMS_ATOL = 1e-11   # px, where a fit reaches the noise-free data
JAC_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def reference_cameras_jitted():
    """The reference's camera functions as ``jax.jit`` of themselves for the
    length of this file: the same programs, compiled once per shape."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jpin, jeq, jmei):
            mp.setattr(mod, "lift", jax.jit(mod.lift))
        for mt, fn in list(jcal._PROJECT.items()):
            mp.setitem(jcal._PROJECT, mt, jax.jit(fn))
        yield


# ---------------------------------------------------------------------------
# cv_geometry against OpenCV
# ---------------------------------------------------------------------------

def _board_views(noise_px, n=8, seed=0):
    """(object points, pixels of a 400 px pinhole, normalized points) per
    seeded view of the 9x6 board."""
    rng = np.random.default_rng(seed)
    obj = _board_object_points()
    out = []
    for _ in range(n):
        R = cg.rodrigues(rng.uniform(-0.6, 0.6, 3))
        t = np.array([*rng.uniform(-0.1, 0.1, 2), rng.uniform(0.35, 0.8)])
        pc = (obj - obj.mean(0)) @ R.T + t
        pix = pc[:, :2] / pc[:, 2:] * 400.0 + [376.0, 240.0]
        pix = pix + rng.normal(size=pix.shape) * noise_px
        out.append((obj, pix, (pix - [376.0, 240.0]) / 400.0))
    return out


def _h_cost(H, src, dst):
    p = np.c_[src, np.ones(len(src))] @ H.T
    return float(np.sum((p[:, :2] / p[:, 2:] - dst) ** 2))


def _pose_cost(rvec, tvec, obj, img):
    pc = obj @ cg.rodrigues(rvec).T + tvec
    return float(np.sum((pc[:, :2] / pc[:, 2:] - img) ** 2))


@pytest.mark.parametrize("noise_px", [0.0, 0.1])
def test_find_homography_matches_cv2(noise_px):
    for obj, pix, _ in _board_views(noise_px):
        src, dst = obj[:, :2].astype(np.float32), pix.astype(np.float32)
        want, _ = cv2.findHomography(src, dst)
        got = cg.find_homography(src, dst)
        assert np.abs(got - want).max() <= H_RTOL * np.abs(want).max()
        s64, d64 = src.astype(np.float64), dst.astype(np.float64)
        assert _h_cost(got, s64, d64) <= _h_cost(want, s64, d64) * (1 + 1e-12) + 1e-20
    assert cg.find_homography(np.zeros((3, 2)), np.zeros((3, 2))) is None


@pytest.mark.parametrize("noise_px", [0.0, 0.1])
def test_solve_pnp_planar_matches_cv2(noise_px):
    for obj, _, img in _board_views(noise_px, seed=1):
        ok, rvec, tvec = cv2.solvePnP(obj.reshape(-1, 1, 3), np.ascontiguousarray(img).reshape(-1, 1, 2),
                                      np.eye(3), None)
        assert ok
        r, t = cg.solve_pnp_planar(obj, img)
        assert np.abs(r - rvec.ravel()).max() <= POSE_TOL
        assert np.abs(t - tvec.ravel()).max() <= POSE_TOL
        assert (_pose_cost(r, t, obj, img)
                <= _pose_cost(rvec.ravel(), tvec.ravel(), obj, img) * (1 + 1e-12) + 1e-24)
        np.testing.assert_allclose(cg.rodrigues(rvec), cv2.Rodrigues(rvec)[0], rtol=0, atol=1e-15)
    with pytest.raises(ValueError):
        cg.solve_pnp_planar(np.random.default_rng(2).normal(size=(20, 3)), np.zeros((20, 2)))


# ---------------------------------------------------------------------------
# calibration against the reference
# ---------------------------------------------------------------------------

def _close(want, got, rtol=PARAM_RTOL):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0), \
        (np.abs(got - want).max(), want, got)


def _rms_close(want, got):
    assert abs(got - want) <= RMS_RTOL * abs(want) + RMS_ATOL, (want, got)


def _fisheye_points(rng, n, theta_max):
    theta = rng.uniform(0.05, theta_max, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                     np.cos(theta)], -1) * rng.uniform(2, 6, n)[:, None]


def _intrinsic_cases():
    """model -> (true params, initial params, camera-frame points): the
    reference's test_calibration.py scenes."""
    rng = np.random.default_rng(0)
    flat = np.stack([rng.uniform(-1.2, 1.2, 300), rng.uniform(-1.2, 1.2, 300),
                     rng.uniform(2.0, 6.0, 300)], -1)
    poly = np.array([-250.0, 0.0, 1.2e-3, 0.0, 6e-9])
    inv_poly = jscara.fit_inverse_poly(poly, 360.0)
    scara_true = jcal.scaramuzza_flat_params(jscara.make_params(
        poly, inv_poly, (378.0, 242.0), (1.001, 1e-4, -2e-4), dtype=jnp.float64))
    scara_init = jcal.scaramuzza_flat_params(jscara.make_params(
        poly, inv_poly * rng.uniform(0.97, 1.03, len(inv_poly)), (372.0, 247.0),
        (1.0, 0.0, 0.0), dtype=jnp.float64))
    return {
        "PINHOLE": (jpin.make_params(460.0, 458.0, 376.0, 240.0, -0.28, 0.07, 1e-4, -2e-4,
                                     dtype=jnp.float64),
                    jpin.make_params(450.0, 450.0, 370.0, 245.0, dtype=jnp.float64), flat),
        "KANNALA_BRANDT": (jeq.make_params(191.0, 190.9, 255.0, 257.0, 0.0035, 0.0007,
                                           -0.002, 0.0002, dtype=jnp.float64),
                           jeq.make_params(185.0, 185.0, 250.0, 252.0, dtype=jnp.float64),
                           _fisheye_points(rng, 400, 1.1)),
        "MEI": (jmei.make_params(350.0, 348.0, 376.0, 240.0, -0.1, 0.02, 1e-4, -1e-4, xi=0.9,
                                 dtype=jnp.float64),
                jmei.make_params(340.0, 340.0, 370.0, 245.0, xi=0.85, dtype=jnp.float64), flat),
        "SCARAMUZZA": (scara_true, scara_init, _fisheye_points(rng, 400, 1.2)),
    }


INTRINSIC_ITERS = 4
MODELS = ["PINHOLE", "KANNALA_BRANDT", "MEI", "SCARAMUZZA"]


@pytest.fixture(scope="module")
def intrinsic_runs():
    out = {}
    for mt, (true, init, pts) in _intrinsic_cases().items():
        uv = np.asarray(jcal._PROJECT[mt](jnp.asarray(true), jnp.asarray(pts)))
        mask = np.arange(len(init)) != 3          # one parameter held
        out[mt] = (np.asarray(init), pts, uv, mask,
                   jcal.refine_intrinsics(mt, init, pts, uv, iters=INTRINSIC_ITERS, mask=mask))
    return out


@pytest.mark.parametrize("mt", MODELS)
def test_refine_intrinsics_matches_reference(intrinsic_runs, mt):
    init, pts, uv, mask, (p_ref, rms0_ref, rms1_ref) = intrinsic_runs[mt]
    p, rms0, rms1 = cal.refine_intrinsics(mt, init, pts, uv, iters=INTRINSIC_ITERS, mask=mask,
                                          device="cpu")
    assert p[3] == init[3]
    _close(p_ref, p)
    _rms_close(rms0_ref, rms0)
    _rms_close(rms1_ref, rms1)
    assert rms1 < rms0


def test_calibrate_from_observations_matches_reference():
    true, init, _ = _intrinsic_cases()["PINHOLE"]
    rng = np.random.default_rng(3)
    poses = [(np.asarray(jrot.quat_to_rot(jnp.asarray(q / np.linalg.norm(q)))), rng.normal(size=3) * 0.2)
             for q in rng.normal(size=(3, 4)) * [0.1, 0.1, 0.1, 0.1] + [1, 0, 0, 0]]
    wps, uvs = [], []
    for R, t in poses:
        pc = np.stack([rng.uniform(-1, 1, 60), rng.uniform(-1, 1, 60), rng.uniform(2, 5, 60)], -1)
        wps.append((pc - t) @ R)
        uvs.append(np.asarray(jpin.project(true, jnp.asarray(pc))))
    want = jcal.calibrate_from_observations("PINHOLE", init, wps, uvs, poses, iters=4)
    got = cal.calibrate_from_observations("PINHOLE", np.asarray(init), wps, uvs, poses, iters=4,
                                          device="cpu")
    _close(want[0], got[0])
    _rms_close(want[1], got[1])
    _rms_close(want[2], got[2])


@pytest.mark.parametrize("mt", ["PINHOLE", "KANNALA_BRANDT"])
def test_refine_extrinsics_matches_reference(mt):
    true, _, _ = _intrinsic_cases()[mt]
    rng = np.random.default_rng(6)
    pc = _fisheye_points(rng, 150, 1.0)
    q_true = np.array([0.99, 0.05, -0.08, 0.03])
    q_true /= np.linalg.norm(q_true)
    t_true = np.array([-0.1, 0.15, 0.2])
    wp = (pc - t_true) @ np.asarray(jrot.quat_to_rot(jnp.asarray(q_true)))
    uv = np.asarray(jcal._PROJECT[mt](true, jnp.asarray(pc)))
    q0, t0 = np.array([1.0, 0, 0, 0]), np.zeros(3)
    want = jcal.refine_extrinsics(mt, true, q0, t0, wp, uv, iters=5)
    got = cal.refine_extrinsics(mt, np.asarray(true), q0, t0, wp, uv, iters=5, device="cpu")
    for a, b in zip(want[:2], got[:2]):
        _close(a, b)
    _rms_close(want[2], got[2])
    _rms_close(want[3], got[3])


def test_calibrate_camera_odometry_matches_reference():
    """The reference test's hand-eye scene (5 views, 120 points each) at 3
    iterations."""
    true, _, _ = _intrinsic_cases()["PINHOLE"]
    rng = np.random.default_rng(11)
    V, N = 5, 120
    q_oc = np.array([np.cos(0.2), 0.1, np.sin(0.2), -0.05])
    q_oc /= np.linalg.norm(q_oc)
    t_oc = np.array([0.12, -0.06, 0.30])
    R_oc = np.asarray(jrot.quat_to_rot(jnp.asarray(q_oc)))
    odo_q = np.stack([[np.cos(0.075 * i), 0.0, 0.0, np.sin(0.075 * i)] for i in range(V)])
    odo_t = np.stack([[0.4 * i, 0.1 * i, 0.0] for i in range(V)])
    wps, uvs = [], []
    for i in range(V):
        pc = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.0, 1.0, N),
                       rng.uniform(2.0, 6.0, N)], -1)
        R_wo = np.asarray(jrot.quat_to_rot(jnp.asarray(odo_q[i])))
        wps.append((pc @ R_oc.T + t_oc) @ R_wo.T + odo_t[i])
        uvs.append(np.asarray(jpin.project(true, jnp.asarray(pc))))
    q0 = np.asarray(jrot.quat_boxplus(jnp.asarray(q_oc), jnp.asarray([0.05, -0.04, 0.06])))
    oq0, ot0 = odo_q.copy(), odo_t.copy()
    for i in range(1, V):
        oq0[i] = np.asarray(jrot.quat_boxplus(jnp.asarray(odo_q[i]),
                                              jnp.asarray(rng.uniform(-0.03, 0.03, 3))))
        ot0[i] = odo_t[i] + rng.uniform(-0.05, 0.05, 3)
    args = (q0, t_oc + [0.05, 0.08, -0.06], oq0, ot0, np.stack(wps), np.stack(uvs))
    want = jcal.calibrate_camera_odometry("PINHOLE", true, *args, iters=3)
    got = cal.calibrate_camera_odometry("PINHOLE", np.asarray(true), *args, iters=3, device="cpu")
    for a, b in zip(want[:4], got[:4]):
        _close(a, b)
    _rms_close(want[4], got[4])
    _rms_close(want[5], got[5])
    assert got[5] < 0.1 * got[4]


BOARD_CASES = {   # model -> (reference project, true params, width, height, view options)
    "PINHOLE": (jpin.project, jpin.make_params(460.0, 455.0, 376.0, 240.0, -0.28, 0.07, 2e-4,
                                               1e-5, dtype=jnp.float64), 752, 480, {}),
    "KANNALA_BRANDT": (jeq.project, jeq.make_params(190.978, 190.973, 256.0, 256.0, 0.00348,
                                                    0.000715, -0.00205, 0.000203,
                                                    dtype=jnp.float64),
                       512, 512, dict(depth=0.45)),
    "MEI": (jmei.project, jmei.make_params(380.0, 378.0, 320.0, 240.0, xi=0.95,
                                           dtype=jnp.float64), 640, 480, dict(depth=0.5)),
    "SCARAMUZZA": (jcal._scaramuzza_project_flat, None, 752, 480, dict(depth=0.4, lateral=0.22)),
}
BOARD_ITERS = {"PINHOLE": 10, "KANNALA_BRANDT": 3, "MEI": 3, "SCARAMUZZA": 3}


def _scaramuzza_true():
    poly = np.array([-250.0, 0.0, 1.8e-3, -2.0e-6, 8.0e-9])
    inv_poly = jscara.fit_inverse_poly(poly, 0.5 * np.hypot(752, 480))
    return jnp.asarray(np.concatenate([inv_poly, [376.0, 240.0, 1.0, 0.0, 0.0]]))


@pytest.fixture(scope="module")
def board_runs():
    out = {}
    for mt, (project, true, w, h, opts) in BOARD_CASES.items():
        true = _scaramuzza_true() if true is None else true
        objs, imgs = _render_views(project, true, w, h, n_views=6, **opts)
        out[mt] = (objs, imgs, jcal.calibrate_from_board(mt, BOARD, objs, imgs, w, h,
                                                         refine_iters=BOARD_ITERS[mt]))
    return out


@pytest.mark.parametrize("mt", MODELS)
def test_calibrate_from_board_matches_reference(board_runs, mt):
    objs, imgs, (p_ref, rms_ref) = board_runs[mt]
    _, _, w, h, _ = BOARD_CASES[mt]
    p, rms = cal.calibrate_from_board(mt, BOARD, objs, imgs, w, h, refine_iters=BOARD_ITERS[mt],
                                      device="cpu")
    _close(p_ref, p)
    _rms_close(rms_ref, rms)


def test_scaramuzza_flat_params_and_projection():
    poly = np.array([-250.0, 0.0, 1.2e-3, 0.0, 6e-9])
    inv = jscara.fit_inverse_poly(poly, 360.0)
    d = jscara.make_params(poly, inv, (378.0, 242.0), (1.001, 1e-4, -2e-4), dtype=jnp.float64)
    flat = cal.scaramuzza_flat_params({k: t64(v) for k, v in d.items()})
    np.testing.assert_array_equal(flat, jcal.scaramuzza_flat_params(d))
    pts = _fisheye_points(np.random.default_rng(4), 50, 1.2)
    np.testing.assert_allclose(cal._scaramuzza_project_flat(t64(flat), t64(pts)).numpy(),
                               np.asarray(jcal._scaramuzza_project_flat(jnp.asarray(flat),
                                                                        jnp.asarray(pts))),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("mt", MODELS)
def test_bundle_jacobian_matches_jax_jacfwd(board_runs, mt):
    """The joint bundle's residual Jacobian at a perturbed state: the port's
    (``calibration._board_residual``, both AD modes) against jax.jacfwd of
    the reference's residual expression (calibration.py:614-626)."""
    objs, imgs, (p_ref, _) = board_runs[mt]
    V = 3
    rng = np.random.default_rng(7)
    params = np.asarray(p_ref) * (1 + 1e-3 * rng.normal(size=len(p_ref)))
    q = rng.normal(size=(V, 4)) * 0.1 + [1, 0, 0, 0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(V, 3)) * 0.05 + [0, 0, 0.5]
    wp, uv = np.stack(objs[:V]), np.stack(imgs[:V])
    n_i = len(params)
    dx = rng.normal(size=n_i + 6 * V) * 1e-4
    project = jcal._PROJECT[mt]

    def jres(d):
        p1 = jnp.asarray(params) + d[:n_i]
        dd = d[n_i:].reshape(V, 6)
        q1 = jrot.quat_boxplus(jnp.asarray(q), dd[:, :3])
        t1 = jnp.asarray(t) + dd[:, 3:]
        pc = jnp.einsum("vij,vnj->vni", jax.vmap(jrot.quat_to_rot)(q1), jnp.asarray(wp)) + t1[:, None]
        return (project(p1, pc.reshape(-1, 3)) - jnp.asarray(uv).reshape(-1, 2)).reshape(-1)

    want = np.asarray(jax.jit(jax.jacfwd(jres))(jnp.asarray(dx)))
    _, residual = cal._board_residual(cal._PROJECT[mt], t64(wp), t64(uv), n_i)
    x = (t64(dx), t64(params), t64(q), t64(t))
    got = cal._jacobian(residual, *x).numpy()
    rev = torch.func.jacrev(residual)(*x).numpy()      # the card's mode
    np.testing.assert_allclose(residual(t64(dx), t64(params), t64(q), t64(t)).numpy(),
                               np.asarray(jres(jnp.asarray(dx))), rtol=0, atol=JAC_TOL)
    for j in (got, rev):
        assert np.abs(j - want).max() <= JAC_TOL * max(np.abs(want).max(), 1.0)


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (cal.refine_intrinsics, cal.refine_extrinsics, cal.calibrate_camera_odometry,
               cal.calibrate_from_board, cal.calibrate_from_observations):
        assert inspect.signature(fn).parameters["device"].default is None
    if not torch.cuda.is_available():
        true, init, pts = _intrinsic_cases()["PINHOLE"]
        with pytest.raises((RuntimeError, AssertionError)):
            cal.refine_intrinsics("PINHOLE", np.asarray(init), pts, np.zeros((len(pts), 2)))
