"""Elementwise math of the PyTorch port against the JAX package, float64:
rotations, the pinhole and Kannala-Brandt cameras, image primitives, CLAHE
and the corner detector. Tolerance: rtol 1e-9 (plus a tiny atol for values
near zero); CLAHE bins and detected corners identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_parity import reference_compile_cache, t64, texture  # noqa: F401

from mobile_slam_tpu import config as cfgmod
from mobile_slam_tpu.models.cameras.base import make_camera as jax_camera
from mobile_slam_tpu.ops import clahe as jclahe, corners as jcorners, image as jim
from mobile_slam_tpu.utils import rotations as jrot
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.ops import clahe, corners, image as im
from mobile_slam_tpu_torch.utils import rotations as rot

RTOL, ATOL = 1e-9, 1e-12


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def quats():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True), rng.normal(size=(16, 3))


@pytest.mark.parametrize("name", ["quat_to_rot", "skew", "q_left", "q_right",
                                  "delta_q", "quat_normalize", "quat_conjugate"])
def test_rotation_unary(quats, name):
    q, v = quats
    arg = v if name in ("skew", "delta_q") else q
    _close(getattr(jrot, name)(jnp.asarray(arg)), getattr(rot, name)(t64(arg)))


def test_rotation_binary_and_conversions(quats):
    q, v = quats
    qj, qt = jnp.asarray(q), t64(q)
    _close(jrot.quat_mul(qj, qj[::-1]), rot.quat_mul(qt, qt.flip(0)))
    _close(jrot.quat_rotate(qj, jnp.asarray(v)), rot.quat_rotate(qt, t64(v)))
    _close(jrot.quat_boxplus(qj, jnp.asarray(v) * 0.1), rot.quat_boxplus(qt, t64(v) * 0.1))
    _close(jrot.quat_boxminus(qj, qj[::-1]), rot.quat_boxminus(qt, qt.flip(0)))
    R = jrot.quat_to_rot(qj)
    _close(jrot.rot_to_quat(R), rot.rot_to_quat(t64(R)))
    _close(jrot.r2ypr(R), rot.r2ypr(t64(R)))
    ypr = np.asarray(jrot.r2ypr(R))
    _close(jrot.ypr2r(jnp.asarray(ypr)), rot.ypr2r(t64(ypr)))
    _close(jrot.g2r(jnp.asarray(v)), rot.g2r(t64(v)))


CAMERAS = {
    "pinhole": cfgmod.CameraConfig(
        model_type="PINHOLE", width=752, height=480, focal_length=458.6,
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    "kannala_brandt": cfgmod.CameraConfig(
        model_type="KANNALA_BRANDT", width=512, height=512,
        focal_length=190.978, fx=190.978, fy=190.973, cx=254.932, cy=256.897,
        dist=(0.0034823894, 0.0007150348, -0.0020532361, 0.0002029367)),
}


@pytest.mark.parametrize("model", sorted(CAMERAS))
def test_camera_project_lift(model):
    cc = CAMERAS[model]
    jc = jax_camera(cc, dtype=jnp.float64)
    tc = make_camera(cc, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(20, cc.width - 20, 64),
                   rng.uniform(20, cc.height - 20, 64)], -1)
    pts = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(1, 4, (64, 1))], -1)
    _close(jc.project(jnp.asarray(pts)), tc.project(t64(pts)))
    _close(jc.lift(jnp.asarray(uv)), tc.lift(t64(uv)))
    _close(jc.lift_normalized(jnp.asarray(uv)), tc.lift_normalized(t64(uv)))


def test_camera_models_not_ported_raise():
    """Every model of the JAX package is ported (tests/test_torch_cameras.py
    holds Mei and Scaramuzza against it); a model it does not know raises
    ValueError, as the reference's factory does."""
    for model in ("MEI", "SCARAMUZZA"):
        assert make_camera(cfgmod.CameraConfig(model_type=model), device="cpu").model_type == model
    with pytest.raises(ValueError):
        jax_camera(cfgmod.CameraConfig(model_type="CATADIOPTRIC"))
    with pytest.raises(ValueError):
        make_camera(cfgmod.CameraConfig(model_type="CATADIOPTRIC"), device="cpu")


@pytest.fixture(scope="module")
def image():
    return texture(np.random.RandomState(5), 64, 96).astype(np.float64)


def test_bilinear_pyramid_scharr(image):
    rng = np.random.default_rng(2)
    xy = rng.uniform(-3, 100, (50, 2))
    _close(jim.bilinear_sample(jnp.asarray(image), jnp.asarray(xy)),
           im.bilinear_sample(t64(image), t64(xy)))
    for a, b in zip(jim.build_pyramid(jnp.asarray(image), 2),
                    im.build_pyramid(t64(image), 2)):
        _close(a, b)
    for a, b in zip(jim.scharr_derivatives(jnp.asarray(image)),
                    im.scharr_derivatives(t64(image))):
        _close(a, b)
    _close(jim.box_filter(jnp.asarray(image), 3), im.box_filter(t64(image), 3))


def test_clahe_bins_identical():
    rs = np.random.RandomState(7)
    img = np.clip(texture(rs, 64, 64) * 0.6 + 40, 0, 255).round()
    a = np.asarray(jclahe.clahe(jnp.asarray(img), 3.0, 8))
    b = clahe.clahe(t64(img), 3.0, 8).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)


def test_min_eig_and_detect_grid(image):
    ra = jcorners.min_eig_response(jnp.asarray(image))
    rb = corners.min_eig_response(t64(image))
    _close(ra, rb, rtol=1e-9, atol=1e-6)
    pts_a, val_a = jcorners.detect_grid(ra, 8, 32)
    pts_b, val_b = corners.detect_grid(t64(np.asarray(ra)), 8, 32)
    np.testing.assert_array_equal(np.asarray(val_a), val_b.numpy())
    np.testing.assert_array_equal(np.asarray(pts_a), pts_b.numpy())
    pts = np.asarray(pts_a)[:6]
    act = np.array([True, True, False, True, True, True])
    occ_a = jcorners.occupancy_suppression(ra, jnp.asarray(pts), jnp.asarray(act), 8)
    occ_b = corners.occupancy_suppression(t64(np.asarray(ra)), t64(pts), torch.as_tensor(act), 8)
    np.testing.assert_array_equal(np.asarray(occ_a), occ_b.numpy())
