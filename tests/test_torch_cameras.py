"""The Mei and Scaramuzza cameras of the port against the JAX package's,
float64 on the CPU: ``project``, ``lift``, ``lift_normalized`` and
``lift_sphere``, ``make_camera`` from a config (Scaramuzza with and
without its inverse polynomial, which is then fitted on the host), the
parameters carried over by ``convert.camera``, and the tracker's
``lift_normalized`` through both models, alone and under
``torch.func.vmap`` with the camera as a closure (the fleet's form).

Bars: rtol 1e-9 (atol 1e-9 px / 1e-12 on rays); the fitted inverse
polynomial within 1e-9 of the reference's fit; the Scaramuzza round trip
within the reference test's 0.05 px (the fit's own error).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_parity import reference_compile_cache, t64  # noqa: F401

from mobile_slam_tpu import config as jcfg
from mobile_slam_tpu.models.cameras import mei as jmei, scaramuzza as jscara
from mobile_slam_tpu.models.cameras.base import make_camera as jax_camera
from mobile_slam_tpu_torch import config as cfgmod, convert
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras import mei, scaramuzza
from mobile_slam_tpu_torch.models.cameras.base import MODELS, make_camera

F = 190.0
POLY = (-F, 0.0, 1.0 / (2 * F), 0.0, 1.0 / (8 * F ** 3))


def _configs(mod):
    """The same camera in the two packages' config classes."""
    mei_kw = dict(model_type="MEI", width=752, height=480, focal_length=460.0,
                  fx=460.0, fy=459.0, cx=376.0, cy=240.0,
                  dist=(-0.01, 0.005, 1e-4, -2e-4), xi=0.95)
    scara_kw = dict(model_type="SCARAMUZZA", width=512, height=512, focal_length=F,
                    ocam_poly=POLY, ocam_center=(256.0, 250.0),
                    ocam_affine=(1.0005, 0.0008, -0.0006))
    return {"mei": mod.CameraConfig(**mei_kw), "scaramuzza": mod.CameraConfig(**scara_kw)}


def _pixels(cc, n=96, margin=60, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, cc.width - margin, n),
                     rng.uniform(margin, cc.height - margin, n)], -1)


def _points(seed=1, n=96):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(0.5, 4, (n, 1))], -1)


def _close(want, got, rtol=1e-9, atol=1e-9):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("model", ["mei", "scaramuzza"])
def test_make_camera_project_lift_match_reference(model):
    jc = jax_camera(_configs(jcfg)[model], dtype=jnp.float64)
    tc = make_camera(_configs(cfgmod)[model], dtype=torch.float64, device="cpu")
    assert tc.model_type == jc.model_type and tc.dtype == torch.float64
    uv, pts = _pixels(tc), _points()
    if model == "scaramuzza":     # the scaramuzza camera looks down -z
        pts = pts * np.array([1.0, 1.0, -1.0])
        _close(jc.params["inv_poly"], tc.params["inv_poly"].numpy())
    _close(jc.project(jnp.asarray(pts)), tc.project(t64(pts)))
    _close(jc.lift(jnp.asarray(uv)), tc.lift(t64(uv)), atol=1e-12)
    _close(jc.lift_normalized(jnp.asarray(uv)), tc.lift_normalized(t64(uv)), atol=1e-12)
    # float32 pixels are promoted against the float64 parameters, as in JAX.
    assert tc.lift(t64(uv).float()).dtype == torch.float64


def test_mei_module_functions_match_reference():
    cc = _configs(cfgmod)["mei"]
    args = (cc.fx, cc.fy, cc.cx, cc.cy, *cc.dist)
    jp = jmei.make_params(*args, xi=cc.xi, dtype=jnp.float64)
    tp = mei.make_params(*args, xi=cc.xi, dtype=torch.float64, device="cpu")
    _close(jp, tp.numpy(), atol=0)
    uv = _pixels(cc, seed=2)
    _close(jmei.lift_sphere(jp, jnp.asarray(uv)), mei.lift_sphere(tp, t64(uv)), atol=1e-12)
    # project(lift(uv)) returns the pixel: the fixed point has converged.
    _close(uv, mei.project(tp, mei.lift(tp, t64(uv))).numpy(), rtol=0, atol=1e-6)


def test_scaramuzza_fit_and_round_trip():
    poly = np.asarray(POLY)
    inv = scaramuzza.fit_inverse_poly(poly, 300.0)
    _close(jscara.fit_inverse_poly(poly, 300.0), inv)
    assert inv.shape == (scaramuzza.INV_POLY_SIZE,)
    cc = cfgmod.CameraConfig(model_type="SCARAMUZZA", width=512, height=512,
                             focal_length=F, ocam_poly=POLY, ocam_inv_poly=tuple(inv),
                             ocam_center=(256.0, 256.0))
    cam = make_camera(cc, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(cam.params["inv_poly"].numpy(), inv)
    uv = _pixels(cc, margin=80, seed=4)
    back = cam.project(cam.lift(t64(uv))).numpy()
    np.testing.assert_allclose(back, uv, atol=0.05)


@pytest.mark.parametrize("model", ["mei", "scaramuzza"])
def test_convert_carries_reference_parameters(model):
    jc = jax_camera(_configs(jcfg)[model], dtype=jnp.float64)
    tc = convert.camera(jc, dtype=torch.float64, device="cpu")
    mod = MODELS[tc.model_type]
    assert tc._lift is mod.lift and tc._project is mod.project
    uv = _pixels(tc, seed=5)
    _close(jc.lift_normalized(jnp.asarray(uv)), tc.lift_normalized(t64(uv)), atol=1e-12)
    if model == "scaramuzza":
        assert set(tc.params) == {"poly", "inv_poly", "center", "affine"}


@pytest.mark.parametrize("model", ["mei", "scaramuzza"])
def test_tracker_lift_through_the_model_alone_and_under_vmap(model):
    jc = jax_camera(_configs(jcfg)[model], dtype=jnp.float64)
    tc = make_camera(_configs(cfgmod)[model], dtype=torch.float64, device="cpu")
    uv = np.stack([_pixels(tc, n=32, seed=6), _pixels(tc, n=32, seed=7)])
    cx, cy = tc.width / 2.0, tc.height / 2.0
    got = trk._virtual_pinhole(tc, t64(uv[0]), tc.focal, cx, cy)
    ray = np.asarray(jc.lift_normalized(jnp.asarray(uv[0])))
    _close(np.stack([tc.focal * ray[:, 0] + cx, tc.focal * ray[:, 1] + cy], -1),
           got.numpy())
    fleet = torch.func.vmap(lambda p: trk._virtual_pinhole(tc, p, tc.focal, cx, cy))(t64(uv))
    for b in range(2):
        np.testing.assert_array_equal(
            fleet[b].numpy(), trk._virtual_pinhole(tc, t64(uv[b]), tc.focal, cx, cy).numpy())
