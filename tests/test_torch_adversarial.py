"""The adversarial tier of the port (``eval/adversarial.py``) against OpenCV
and against the JAX package's, on the CPU.

* The numpy oracle against OpenCV, on the reference test's cameras and
  points (tests/test_adversarial.py): Kannala-Brandt projection against
  ``cv2.fisheye.projectPoints``, pinhole projection against
  ``cv2.projectPoints``, pinhole unprojection against
  ``cv2.undistortPoints`` at the reference's criteria (100 iterations,
  1e-12), and the round trips through both; 1e-9 px (unprojection compared
  on the z=1 plane, scaled by the focal length). Kannala-Brandt
  unprojection is the reference's own lookup table (no OpenCV call
  reaches past 90°): equal to the reference's, and its round trip through
  cv2.fisheye within 1e-9 px of the oracle's over the rays in front.
* The port's cameras against the oracle at the reference test's bars
  (project 1e-4 px, lift 1e-6 / 1e-5): the de-circularization anchor.
* The motion-blur line raster against ``cv2.line`` (thickness 1, LINE_8)
  for every kernel size the renderer draws (3-19) and every direction
  that fits it: equal. The correlation against ``cv2.filter2D``
  (reflect-101) for line kernels and dense ones: 1e-9 on a 0..255 image
  (OpenCV correlates kernels of 11x11 and more through the DFT).
* ``make_adversarial_data`` against the reference's for every level:
  1e-12. ``render_frame_adversarial`` against the reference's for two
  frames of every level (both blurred at levels 1-4, level 4 with the
  rolling shutter): at most 1 grey level, on at most 1e-4 of the pixels
  (measured: none differs).
* The module imports neither cv2 nor the port's camera models."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cv2

from tests._torch_parity import t64
from tests.test_adversarial import EUROC_PINHOLE, R_IC, T_IC, TUMVI_KB, _test_points

from mobile_slam_tpu.eval import adversarial as ref
from mobile_slam_tpu.eval import simulation as ref_sim
from mobile_slam_tpu_torch import config as cfgmod
from mobile_slam_tpu_torch.eval import adversarial as adv
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.models.cameras.base import make_camera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX_TOL = 1e-9
DATA_TOL = 1e-12
MAX_GREY = 1
MAX_SHARE = 1e-4
CAMS = {"KANNALA_BRANDT": TUMVI_KB, "PINHOLE": EUROC_PINHOLE}


def _points(mt, seed):
    rng = np.random.default_rng(seed)
    if mt == "PINHOLE":
        pts = _test_points(rng, fov_z=1.0)
        pts[:, :2] *= 0.7
        return pts
    return _test_points(rng)


def _pixels(mt, seed):
    rng = np.random.default_rng(seed)
    if mt == "PINHOLE":
        return rng.uniform((60, 60), (690, 420), (200, 2))
    return rng.uniform(40, 470, (200, 2))


def _cv2_project(cam, pts):
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]])
    p = np.ascontiguousarray(pts.reshape(-1, 1, 3), np.float64)
    z3 = np.zeros(3)
    if cam.model_type == "KANNALA_BRANDT":
        return cv2.fisheye.projectPoints(p, z3, z3, K, np.asarray(cam.dist[:4]))[0].reshape(-1, 2)
    return cv2.projectPoints(p, z3, z3, K, np.asarray(cam.dist))[0].reshape(-1, 2)


def _cv2_undistort(cam, uv):
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]])
    crit = (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 100, 1e-12)
    return cv2.undistortPoints(np.ascontiguousarray(uv.reshape(-1, 1, 2)), K,
                               np.asarray(cam.dist), criteria=crit).reshape(-1, 2)


@pytest.mark.parametrize("mt", ["KANNALA_BRANDT", "PINHOLE"])
def test_oracle_projection_matches_cv2(mt):
    cam, pts = CAMS[mt], _points(mt, 0)
    assert np.abs(adv.oracle_project(cam, pts) - _cv2_project(cam, pts)).max() <= PX_TOL


def test_pinhole_unprojection_and_round_trip_match_cv2():
    cam, uv = EUROC_PINHOLE, _pixels("PINHOLE", 3)
    rays = adv.oracle_unproject(cam, uv)
    plane = rays[:, :2] / rays[:, 2:]
    assert np.abs(plane - _cv2_undistort(cam, uv)).max() * cam.fx <= PX_TOL
    np.testing.assert_allclose(np.linalg.norm(rays, axis=1), 1.0, rtol=0, atol=1e-15)
    back = adv.oracle_project(cam, rays)
    cv2_back = _cv2_project(cam, np.c_[_cv2_undistort(cam, uv), np.ones(len(uv))])
    assert np.abs(back - cv2_back).max() <= PX_TOL
    assert np.abs(back - uv).max() <= 1e-6      # the iteration's own accuracy


def test_kb_unprojection_is_the_reference_table_and_round_trips_through_cv2():
    cam, uv = TUMVI_KB, _pixels("KANNALA_BRANDT", 1)
    rays = adv.oracle_unproject(cam, uv)
    np.testing.assert_array_equal(rays, ref.oracle_unproject(cam, uv))
    front = rays[:, 2] > 0.05
    assert front.sum() > 150
    assert np.abs(adv.oracle_project(cam, rays[front])
                  - _cv2_project(cam, rays[front])).max() <= PX_TOL
    assert np.abs(adv.oracle_project(cam, rays[front]) - uv[front]).max() <= 0.01  # the table's step
    grid = adv.oracle_ray_grid(TUMVI_KB)
    assert grid.shape == (512, 512, 3) and adv.oracle_ray_grid(TUMVI_KB) is grid


@pytest.mark.parametrize("mt", ["KANNALA_BRANDT", "PINHOLE"])
def test_port_cameras_match_the_oracle(mt):
    """The reference test's anchor, for the port's camera models."""
    cc = CAMS[mt]
    cam = make_camera(cfgmod.CameraConfig(
        model_type=cc.model_type, width=cc.width, height=cc.height,
        focal_length=cc.focal_length, fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy,
        dist=cc.dist), dtype=torch.float64, device="cpu")
    pts = _points(mt, 0 if mt == "KANNALA_BRANDT" else 2)
    ours = cam.project(t64(pts)).numpy()
    oracle = adv.oracle_project(cc, pts)
    inside = ((oracle[:, 0] > 0) & (oracle[:, 0] < cc.width)
              & (oracle[:, 1] > 0) & (oracle[:, 1] < cc.height))
    assert inside.sum() > 50
    assert np.abs(ours - oracle)[inside].max() < 1e-4
    uv = _pixels(mt, 1 if mt == "KANNALA_BRANDT" else 3)
    lifted = cam.lift(t64(uv)).numpy()
    lifted /= np.linalg.norm(lifted, axis=-1, keepdims=True)
    assert np.abs(lifted - adv.oracle_unproject(cc, uv)).max() < (1e-6 if mt == "KANNALA_BRANDT"
                                                                   else 1e-5)


@pytest.mark.parametrize("n_k", list(range(3, 20, 2)))
def test_line_raster_matches_cv2_line(n_k):
    c = n_k // 2
    for ox in range(-c, c + 1):
        for oy in range(-c, c + 1):
            want, got = np.zeros((n_k, n_k)), np.zeros((n_k, n_k))
            cv2.line(want, (c - ox, c - oy), (c + ox, c + oy), 1.0, 1)
            adv._draw_line(got, (c - ox, c - oy), (c + ox, c + oy), 1.0)
            np.testing.assert_array_equal(got, want, err_msg=f"{n_k} {ox} {oy}")


@pytest.mark.parametrize("shape", [(3, 3), (7, 5), (19, 19), "line"])
def test_correlation_matches_cv2_filter2d(shape):
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (96, 128))
    if shape == "line":
        kern = np.zeros((13, 13))
        cv2.line(kern, (2, 4), (10, 8), 1.0, 1)
    else:
        kern = rng.uniform(size=shape)
    kern /= kern.sum()
    assert np.abs(adv._filter2d(img, kern) - cv2.filter2D(img, -1, kern)).max() <= PX_TOL


LEVELS = sorted(adv.LEVELS)


@pytest.fixture(scope="module")
def sequences():
    """Per level: (the reference's data, the port's data) of a 1 s sequence
    through the TUM-VI camera (the reference test's)."""
    out = {}
    for lvl in LEVELS:
        kw = dict(duration=1.0, cam_rate=20.0, imu_rate=200.0, num_landmarks=150, seed=5)
        out[lvl] = (ref.make_adversarial_data(ref_sim.SimConfig(**kw), TUMVI_KB, R_IC, T_IC,
                                              ref.LEVELS[lvl]),
                    adv.make_adversarial_data(sim.SimConfig(**kw), TUMVI_KB, R_IC, T_IC,
                                              adv.LEVELS[lvl]))
    return out


@pytest.mark.parametrize("lvl", LEVELS)
def test_adversarial_data_matches_reference(sequences, lvl):
    want, got = sequences[lvl]
    assert adv.LEVELS[lvl] == adv.NuisanceConfig(**vars(ref.LEVELS[lvl]))
    for f in ("cam_ts", "true_cam_ts", "gt_p", "gt_q", "gt_v", "imu_ts", "imu_acc", "imu_gyr",
              "landmarks", "gravity"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0, atol=DATA_TOL,
                                   err_msg=f)
    assert len(got.frames) == len(want.frames)
    for a, b in zip(adv.make_movers(adv.LEVELS[lvl]), ref.make_movers(ref.LEVELS[lvl])):
        for t in (0.0, 0.7):
            np.testing.assert_allclose(a.positions(t), b.positions(t), rtol=0, atol=DATA_TOL)


@pytest.mark.parametrize("lvl", LEVELS)
def test_rendered_frames_match_reference(sequences, lvl):
    want_data, got_data = sequences[lvl]
    movers_ref, movers = ref.make_movers(ref.LEVELS[lvl]), adv.make_movers(adv.LEVELS[lvl])
    for fi in (2, 10):
        want = ref.render_frame_adversarial(want_data, fi, TUMVI_KB, R_IC, T_IC,
                                            ref.LEVELS[lvl], movers_ref)
        got = adv.render_frame_adversarial(got_data, fi, TUMVI_KB, R_IC, T_IC,
                                           adv.LEVELS[lvl], movers)
        assert got.dtype == np.uint8 and got.shape == (512, 512)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= MAX_GREY and (d > 0).mean() <= MAX_SHARE, (fi, d.max(), (d > 0).mean())


def test_module_imports_neither_cv2_nor_the_port_cameras():
    probe = (
        "import sys\n"
        "from mobile_slam_tpu_torch.eval import adversarial as adv, simulation as sim\n"
        "from mobile_slam_tpu_torch.engine.example import bench_config\n"
        "cam = bench_config().camera\n"
        "nuis = adv.LEVELS[4]\n"
        "d = adv.make_adversarial_data(sim.SimConfig(duration=0.3, num_landmarks=50), cam,\n"
        "                              cam.r_ic_mat, cam.t_ic_vec, nuis)\n"
        "img = adv.render_frame_adversarial(d, 2, cam, cam.r_ic_mat, cam.t_ic_vec, nuis,\n"
        "                                   adv.make_movers(nuis))\n"
        "bad = [m for m in sys.modules if m == 'cv2' or m.startswith('cv2.') or m == 'jax'\n"
        "       or m.startswith('mobile_slam_tpu_torch.models.cameras')]\n"
        "print(img.shape, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
